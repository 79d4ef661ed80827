"""The GRU scan's roofline reader (`metrics/gru_scan_roofline.train.py`)
on synthetic traces: which kernel symbols it takes (the `gru_*` kernels
and the backward's stage kernels it shares with the LSTM, no `lstm_*`
kernel), when it reads nothing, the GRU's byte counts by hand, and the
LSTM reader's pattern against every GRU kernel the port defines."""

import os
import re

import pytest

from harness import bench
from harness.trace import Trace
from roofline import counts as rc

GRU = bench.reader("gru_scan_roofline.train")
LSTM_SYMBOLS = bench._module(
    os.path.join(bench.HERE, "metrics", "lstm_scan_roofline.train.py"),
    "bench_metric_lstm_symbols").SYMBOLS
SHAPE = {"L": 50, "B": 128, "H": 128}

# as the profiler names them: the GRU's training forward and backward,
# the shared stage kernels, and kernels the reader must leave out
GRU_OPS = [("void gru_fwd_mma_reg_kernel<128, true>(float const*)", 0.0,
            7.5e-5),
           ("void gru_sweep_reg_kernel<128>(__nv_bfloat16 const*)", 1e-4,
            1.75e-4)]
STAGE_OPS = [("void gates_kernel<true>(float const*)", 2e-4, 2.19e-4),
             ("void gates_kernel<false>(float const*)", 3e-4, 3.11e-4),
             ("void dwh_mma_kernel(float const*, float const*)", 4e-4,
              4.15e-4),
             ("dwh_reduce_kernel(float const*, float*, int)", 5e-4, 5.01e-4)]
OTHER_OPS = [("void lstm_sweep_reg_kernel<128>(__nv_bfloat16 const*)", 6e-4,
              9e-4),
             ("void sampled_ce_fwd_kernel<64>(float const*)", 1e-3, 1.2e-3),
             ("void at::native::elementwise_kernel<128, 4>()", 2e-3,
              2.5e-3)]


def _run(device, counts):
    r = bench.Run(None, 1, 10, True, 0.0)
    r.recorded = Trace(device=device)
    r.counts.update(counts)
    return r


def test_it_takes_the_gru_and_stage_kernels_and_no_lstm_kernel():
    valid = [6400.0, 5000.0]
    r = _run(GRU_OPS + STAGE_OPS + OTHER_OPS, {**SHAPE, "valid": valid})
    spent = sum(e - s for _, s, e in GRU_OPS + STAGE_OPS)
    least = sum(rc.scan_fwd_resid_s(50, 128, 128, v, "gru")
                + rc.scan_bwd_s(50, 128, 128, v, "gru") for v in valid)
    assert GRU(r) == pytest.approx(100.0 * least / spent)
    # at c4's shape and full valid positions: 4.95 + 7.94 µs a step
    assert rc.scan_fwd_resid_s(50, 128, 128, 6400, "gru") + rc.scan_bwd_s(
        50, 128, 128, 6400, "gru") == pytest.approx(12.89e-6, rel=1e-3)


@pytest.mark.parametrize("case", ["not a sequence cell", "no valid steps",
                                  "no gru kernel", "empty trace"])
def test_it_reads_nothing_where_no_gru_scan_ran(case):
    counts = {**SHAPE, "valid": [6400.0]}
    device = GRU_OPS + STAGE_OPS
    if case == "not a sequence cell":
        counts.pop("valid")
    elif case == "no valid steps":
        counts["valid"] = []
    elif case == "no gru kernel":
        device = STAGE_OPS + OTHER_OPS       # an LSTM cell's trace
    else:
        device = []
    assert GRU(_run(device, counts)) is None


def test_the_gru_bytes_by_hand():
    # L 2, B 3, H 4, GRU: G = 12, one carry;
    # 4·(xw 72 + mask 6 + h0 12 + h_all 24) + 2·Wh 96 = 552 bytes
    assert rc.scan_fwd_bytes(2, 3, 4, "gru") == 552
    # the training launch adds hp: 4·L·B·H = 96 bytes
    assert rc.scan_fwd_resid_s(2, 3, 4, 5, "gru") == pytest.approx(
        648 / 3.35e12)
    # backward: 4·(2·72 + 6 + 2·24 + 12 + 48) + 2·48 = 1128 bytes;
    # 3·2·12·4·valid FLOPs
    assert rc.scan_bwd_s(2, 3, 4, 10**6, "gru") == pytest.approx(
        max(1128 / 3.35e12, 3 * 2 * 12 * 4 * 10**6 / 989e12))


def _kernels(*names):
    """The `__global__` kernels' names in the port's CUDA sources."""
    csrc = os.path.join(bench.REPO, "arec_torch", "csrc")
    out = set()
    for n in names:
        with open(os.path.join(csrc, n)) as f:
            out |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                  r"\([^)]*\)\s+)?(\w+)\(", f.read()))
    return out


def test_the_symbols_split_the_ports_scan_kernels_by_cell():
    gru = _kernels("gru_scan_fwd.cu", "gru_scan_bwd.cu")
    lstm = _kernels("lstm_scan_fwd.cu", "lstm_scan_bwd.cu")
    stages = _kernels("scan_mma.cuh")
    assert {"gru_fwd_mma_reg_kernel", "gru_sweep_reg_kernel"} <= gru
    assert {"gates_kernel", "dwh_mma_kernel", "dwh_reduce_kernel"} <= stages
    gru_rx = re.compile(bench._module(
        os.path.join(bench.HERE, "metrics", "gru_scan_roofline.train.py"),
        "bench_metric_gru_symbols").SYMBOLS)
    lstm_rx = re.compile(LSTM_SYMBOLS)
    for k in gru:
        assert gru_rx.search(f"void {k}<128>(float const*)"), k
        assert not lstm_rx.search(f"void {k}<128>(float const*)"), k
    for k in stages:
        assert gru_rx.search(f"void {k}<true>(float const*)"), k
    for k in lstm:
        assert not gru_rx.search(f"void {k}<128>(float const*)"), k
