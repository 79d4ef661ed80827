"""The served calls' share of the card's bf16 peak, in %: the FLOPs
the window's live requests need (roofline/counts.py: their encode, scan
and scores over V; the padding to serve_batch is not counted, so its
waste shows) over the traced window's wall time at 989 TFLOP/s."""

from roofline.counts import PEAK_FLOPS


def read(run):
    flops = run.counts.get("flops")
    if not flops or run.window_s <= 0:
        return None
    return 100.0 * flops / (run.window_s * PEAK_FLOPS["bfloat16"])
