"""The fused sampled-CE kernels' share of their roofline in training, in
%: each step's forward and backward least time (roofline/counts.py, at
the step's rows, negatives and widths) summed over the window, over the
device time of every `sampled_ce_*` kernel in the trace."""

from roofline.counts import ce_s

SYMBOLS = r"\bsampled_ce_\w*kernel\b"


def read(run):
    c = run.counts
    spent, n = run.recorded.kernel_s(SYMBOLS)
    if not c.get("steps") or not n:
        return None
    if "valid" in c:                    # the sequence family: aug rows
        N, Dt = c["B"] * c["L"], c["D"] + 1
    else:
        N, Dt = c["B"], c["D"]
    least = c["steps"] * (ce_s(N, c["S"], c["D"], Dt, False)
                          + ce_s(N, c["S"], c["D"], Dt, True))
    return 100.0 * least / spent
