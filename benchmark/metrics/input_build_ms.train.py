"""Host ms a training step's batches take to build on the prefetch worker:
the program's span `input.build` (arec_torch.obs: the worker's `next` of
the batch iterator, the C++ packer) over the window's steps. The worker's
spans are not on the device trace's clock; they are read from the
program's aggregate."""


def read(run):
    try:
        from arec_torch import obs
    except ImportError:            # a program without its spans
        return None
    s = obs.snapshot()["spans"].get("input.build")
    steps = run.counts.get("steps")
    if not steps or s is None:
        return None
    return 1e3 * s["total_s"] / steps
