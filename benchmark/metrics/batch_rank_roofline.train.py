"""The fused in-batch ranking loss kernels' share of their roofline in
training, in %: each step's forward and backward least time
(roofline/counts.py's `batch_rank_s`, at the step's rows and width, with
the HT weights where the configuration has them) summed over the window,
over the device time of every `batch_rank_*_kernel` in the trace. The
count is of the loss's work, whatever computes it; a trace in which no
such kernel ran (the library ops, or another loss) reads nothing."""

from roofline.counts import batch_rank_s

SYMBOLS = r"\bbatch_rank_\w+_kernel\b"


def read(run):
    c = run.counts
    spent, n = run.recorded.kernel_s(SYMBOLS)
    if not c.get("steps") or not n:
        return None
    ht = bool(c.get("ht"))
    least = c["steps"] * (batch_rank_s(c["B"], c["D"], False, ht=ht)
                          + batch_rank_s(c["B"], c["D"], True, ht=ht))
    return 100.0 * least / spent
