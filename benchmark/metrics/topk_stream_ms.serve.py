"""Device ms a served call's top-k takes on its stream: the stream seconds
of the program's span `serve.topk` (arec_torch.obs), timed by a pair of
CUDA events the program records on the current stream around the top-k
(from the end of the stream's earlier work to the end of the top-k's),
over the window's calls. The CPU has no such events: None there."""


def read(run):
    try:
        from arec_torch import obs
    except ImportError:            # a program without its spans
        return None
    s = obs.snapshot()["spans"].get("serve.topk")
    calls = run.counts.get("calls")
    if not calls or s is None or s["stream_s"] is None:
        return None
    return 1e3 * s["stream_s"] / calls
