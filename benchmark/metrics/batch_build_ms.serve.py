"""Host ms a served call spends building its padded numpy batches: the
program's span `serve.batch` (arec_torch.obs: padding to serve_batch and
the seen lists' slab) over the window's calls."""


def read(run):
    try:
        from arec_torch import obs
    except ImportError:            # a program without its spans
        return None
    s = obs.snapshot()["spans"].get("serve.batch")
    calls = run.counts.get("calls")
    if not calls or s is None:
        return None
    return 1e3 * s["total_s"] / calls
