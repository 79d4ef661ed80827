"""Host ms a served call waits for its ids: the program's span `serve.d2h`
(arec_torch.obs: the host's wait for the device's work and the copy of
the ids back) over the window's calls."""


def read(run):
    try:
        from arec_torch import obs
    except ImportError:            # a program without its spans
        return None
    s = obs.snapshot()["spans"].get("serve.d2h")
    calls = run.counts.get("calls")
    if not calls or s is None:
        return None
    return 1e3 * s["total_s"] / calls
