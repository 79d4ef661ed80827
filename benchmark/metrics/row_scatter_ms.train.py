"""Device ms a step of the row-scatter kernel (the sparse step's
write-back, both tables), by symbol in the trace, over the window's
steps. Its rows are read moments after the step gathered them, so the
kernel runs from the L2 cache and an HBM roofline does not bound it."""

SYMBOLS = r"::scatter<"


def read(run):
    steps = run.counts.get("steps")
    spent, n = run.recorded.kernel_s(SYMBOLS)
    if not steps or not n:
        return None
    return 1e3 * spent / steps
