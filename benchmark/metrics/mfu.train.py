"""The whole training step's share of the card's bf16 peak, in %: the
FLOPs the window's steps need (roofline/counts.py, from their shapes and
valid positions) over the traced window's wall time at 989 TFLOP/s."""

from roofline.counts import PEAK_FLOPS


def read(run):
    flops = run.counts.get("flops")
    if not flops or run.window_s <= 0:
        return None
    return 100.0 * flops / (run.window_s * PEAK_FLOPS["bfloat16"])
