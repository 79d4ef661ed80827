"""Host ms a served call spends copying its batches to the device: the
program's span `serve.h2d` (arec_torch.obs: the pageable copies of
`shard_from_hosts`) over the window's calls."""


def read(run):
    try:
        from arec_torch import obs
    except ImportError:            # a program without its spans
        return None
    s = obs.snapshot()["spans"].get("serve.h2d")
    calls = run.counts.get("calls")
    if not calls or s is None:
        return None
    return 1e3 * s["total_s"] / calls
