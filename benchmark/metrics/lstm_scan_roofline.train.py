"""The LSTM scan kernels' share of their roofline in training, in %: the
least time of each step's training forward launch and backward (from the
batch's valid positions, roofline/counts.py) summed over the window,
over the device time of their kernels by symbol in the trace."""

from roofline.counts import scan_bwd_s, scan_fwd_resid_s

SYMBOLS = (r"\blstm_(fwd_mma(_reg)?|scan_fwd|sweep(_reg)?|scan_bwd|dwh"
           r"|dwh_reduce)_kernel\b|\bgates_kernel\b|\bdwh_(mma|reduce)_kernel\b")


def read(run):
    valid = run.counts.get("valid")
    spent, n = run.recorded.kernel_s(SYMBOLS)
    if not valid or not n:
        return None
    c = run.counts
    least = sum(scan_fwd_resid_s(c["L"], c["B"], c["H"], v)
                + scan_bwd_s(c["L"], c["B"], c["H"], v) for v in valid)
    return 100.0 * least / spent
