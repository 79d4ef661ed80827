"""The in-batch loss kernels' roofline reader
(`metrics/batch_rank_roofline.train.py`) on synthetic traces: which kernel
symbols it takes (every `batch_rank_*_kernel`, no `sampled_ce_*` kernel
and no library op), when it reads nothing, its least time against a hand
count of `batch_rank_s` at xing-mf's batch with HT weights, and its
pattern against every kernel of the port's CUDA sources."""

import os
import re

import pytest

from harness import bench
from harness.trace import Trace
from roofline import counts as rc

READ = bench.reader("batch_rank_roofline.train")
SYMBOLS = bench._module(
    os.path.join(bench.HERE, "metrics", "batch_rank_roofline.train.py"),
    "bench_metric_batch_rank_symbols").SYMBOLS
SHAPE = {"B": 8192, "D": 128, "ht": True, "steps": 2}

# as the profiler names them: the kernels' passes, and kernels and library
# ops the reader must leave out
OWN = [("(anonymous namespace)::batch_rank_prep_kernel(float const*)", 0.0,
        1e-5),
       ("void (anonymous namespace)::batch_rank_fwd_kernel<true>(float4*)",
        1e-5, 3.1e-4),
       ("(anonymous namespace)::batch_rank_merge_kernel(float4 const*)",
        3.1e-4, 3.12e-4),
       ("void (anonymous namespace)::batch_rank_bwd_rows_kernel<16, true>"
        "(float*)", 4e-4, 7.6e-4),
       ("(anonymous namespace)::batch_rank_rows_combine_kernel(float*)",
        7.6e-4, 7.66e-4),
       ("void (anonymous namespace)::batch_rank_bwd_cols_kernel<16, true>"
        "(float*)", 8e-4, 1.16e-3),
       ("(anonymous namespace)::batch_rank_cols_reduce_kernel(float*)",
        1.16e-3, 1.166e-3)]
OTHER = [("void (anonymous namespace)::sampled_ce_fwd_mma_kernel(float2*)",
          2e-3, 2.05e-3),
         ("void sampled_ce_bwd_rows_mma_kernel<16>(float*)", 2.1e-3,
          2.35e-3),
         ("void at::native::elementwise_kernel<128, 4>()", 3e-3, 4e-3),
         ("ampere_sgemm_128x64_nn", 4e-3, 4.5e-3),
         ("void at::native::reduce_kernel<512, 1>()", 5e-3, 5.3e-3)]


def _run(device, counts):
    r = bench.Run(None, 1, 10, True, 0.0)
    r.recorded = Trace(device=device)
    r.counts.update(counts)
    return r


def test_it_takes_the_batch_rank_kernels_and_nothing_else():
    spent = sum(e - s for _, s, e in OWN)
    least = 2 * (rc.batch_rank_s(8192, 128, False, ht=True)
                 + rc.batch_rank_s(8192, 128, True, ht=True))
    assert READ(_run(OWN + OTHER, SHAPE)) == pytest.approx(
        100.0 * least / spent)
    assert READ(_run(OWN, SHAPE)) == READ(_run(OWN + OTHER, SHAPE))


def test_the_least_time_by_hand():
    """At N 8192, D 128 with HT the products bound both passes: forward
    2·N²·D = 17.18 GFLOP, backward 4·N²·D = 34.36 GFLOP at 989 TFLOP/s,
    0.0174 + 0.0347 = 0.0521 ms a step; the bytes (≈ 8.4 MB forward and
    backward, 2.5 µs) do not bind."""
    n, d = 8192, 128
    fwd_bytes = 4 * (2 * n * d + 3 * n + n)
    bwd_bytes = 4 * (2 * n * d + 3 * n + 2 * n * d + n)
    assert fwd_bytes / 3.35e12 < 2 * n * n * d / 989e12
    assert bwd_bytes / 3.35e12 < 4 * n * n * d / 989e12
    step = (rc.batch_rank_s(n, d, False, ht=True)
            + rc.batch_rank_s(n, d, True, ht=True))
    assert step == pytest.approx(6 * n * n * d / 989e12)
    assert step == pytest.approx(0.0521e-3, rel=1e-3)


@pytest.mark.parametrize("case", ["no batch_rank kernel", "empty trace",
                                  "no steps"])
def test_it_reads_nothing_where_no_batch_rank_kernel_ran(case):
    counts, device = dict(SHAPE), OWN
    if case == "no batch_rank kernel":
        device = OTHER            # the library ops, or the sampled CE
    elif case == "empty trace":
        device = []
    else:
        counts.pop("steps")
    assert READ(_run(device, counts)) is None


def _kernels(name):
    """The `__global__` kernels' names in one of the port's CUDA sources."""
    with open(os.path.join(bench.REPO, "arec_torch", "csrc", name)) as f:
        return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                              r"\((?:[^()]|\([^()]*\))*\)\s+)?(\w+)\(",
                              f.read()))


def test_the_pattern_splits_the_ports_kernels():
    rx = re.compile(SYMBOLS)
    own = _kernels("batch_rank.cu")
    assert {"batch_rank_fwd_kernel", "batch_rank_bwd_rows_kernel",
            "batch_rank_bwd_cols_kernel", "batch_rank_prep_kernel"} <= own
    for k in own:
        assert rx.search(f"void (anonymous namespace)::{k}<16, true>()"), k
    csrc = os.path.join(bench.REPO, "arec_torch", "csrc")
    for f in os.listdir(csrc):
        if f.endswith((".cu", ".cuh")) and f != "batch_rank.cu":
            for k in _kernels(f):
                assert not rx.search(f"void {k}<16>(float const*)"), (f, k)
