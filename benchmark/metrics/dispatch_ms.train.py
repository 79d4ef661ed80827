"""Host ms a training step spends in its `multi_step_fn` call (the static
inputs' copies, the generators' re-seeding, the replay's enqueue, the
metrics' clones): the harness's span around each call, over the window's
steps."""


def read(run):
    steps = run.counts.get("steps")
    if not steps or "dispatch" not in run.spans:
        return None
    return 1e3 * run.spans["dispatch"] / steps
