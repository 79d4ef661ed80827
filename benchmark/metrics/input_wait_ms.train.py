"""Host ms a training step waits for its staged batch: the harness's span
around the loop's pull of the next K batches from `data.prefetch`, over
the window's steps."""


def read(run):
    steps = run.counts.get("steps")
    if not steps or "input_wait" not in run.spans:
        return None
    return 1e3 * run.spans["input_wait"] / steps
