"""Host ms a training step spends before its graph's replay: the program's
span `dispatch.prepare` (arec_torch.obs: `train.graph.scan_multi`'s
checks, the static inputs' stacks and the generators' re-seeding) over
the window's steps."""


def read(run):
    try:
        from arec_torch import obs
    except ImportError:            # a program without its spans
        return None
    s = obs.snapshot()["spans"].get("dispatch.prepare")
    steps = run.counts.get("steps")
    if not steps or s is None:
        return None
    return 1e3 * s["total_s"] / steps
