"""The GRU scan kernels' share of their roofline in training, in %: the
least time of each step's training forward launch and backward (from the
batch's valid positions, roofline/counts.py with the GRU's three gates)
summed over the window, over the device time of their kernels by symbol
in the trace.

The GRU's backward runs its gate and dWh stages through kernels it shares
with the LSTM's (`gates_kernel`, `dwh_mma_kernel`, `dwh_reduce_kernel`
of csrc/scan_mma.cuh), so they are counted here, beside the `gru_*`
kernels: without them the share would leave out a third of the scan's
device time. In an LSTM cell the same symbols are the LSTM's, so this
metric lists only GRU cells (and `lstm_scan_roofline.train` only LSTM
cells); a trace in which no `gru_*` kernel ran reads nothing."""

from roofline.counts import scan_bwd_s, scan_fwd_resid_s

OWN = r"\bgru_\w+_kernel\b"
SYMBOLS = OWN + r"|\bgates_kernel\b|\bdwh_(mma|reduce)_kernel\b"


def read(run):
    valid = run.counts.get("valid")
    spent, n = run.recorded.kernel_s(SYMBOLS)
    if not valid or not n or not run.recorded.kernel_s(OWN)[1]:
        return None
    c = run.counts
    least = sum(scan_fwd_resid_s(c["L"], c["B"], c["H"], v, "gru")
                + scan_bwd_s(c["L"], c["B"], c["H"], v, "gru")
                for v in valid)
    return 100.0 * least / spent
