"""Host ms a training step spends in `graph.replay()`: the program's span
`dispatch.replay` (arec_torch.obs), the host blocked enqueuing the K
steps' graph, over the window's steps."""


def read(run):
    try:
        from arec_torch import obs
    except ImportError:            # a program without its spans
        return None
    s = obs.snapshot()["spans"].get("dispatch.replay")
    steps = run.counts.get("steps")
    if not steps or s is None:
        return None
    return 1e3 * s["total_s"] / steps
