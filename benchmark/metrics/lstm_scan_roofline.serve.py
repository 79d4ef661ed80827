"""The LSTM scan's serving launch's share of its roofline, in %: the least
time of each launch (the padded batch of serve_batch rows, its live
requests' valid steps, roofline/counts.py) summed over the window, over
the device time of its kernel by symbol in the trace."""

from roofline.counts import scan_fwd_s

SYMBOLS = r"\blstm_(fwd_mma(_reg)?|scan_fwd)_kernel\b"


def read(run):
    launches = run.counts.get("scan_launches")
    spent, n = run.recorded.kernel_s(SYMBOLS)
    if not launches or not n:
        return None
    c = run.counts
    least = sum(scan_fwd_s(c["L"], c["serve_batch"], c["H"], v)
                for v in launches)
    return 100.0 * least / spent
