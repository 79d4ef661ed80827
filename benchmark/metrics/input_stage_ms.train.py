"""Host ms a training step's batches take to stage on the prefetch worker:
the program's span `input.stage` (arec_torch.obs: the ring slot's wait,
the pinned copy, the launch of the non-blocking H2D copy and the event
record of `data.prefetch.PinnedStager`) over the window's steps."""


def read(run):
    try:
        from arec_torch import obs
    except ImportError:            # a program without its spans
        return None
    s = obs.snapshot()["spans"].get("input.stage")
    steps = run.counts.get("steps")
    if not steps or s is None:
        return None
    return 1e3 * s["total_s"] / steps
