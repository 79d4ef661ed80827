"""The card's bf16 tensor-core sums against an exact sum, with the inputs
of Fasi et al. (2021, "Numerical behavior of NVIDIA tensor cores").

`sampled_ce.cu`'s rounding window rests on one premise about `mma.sync`
m16n8k16 (bf16 operands, f32 accumulators): a product of depth D, chained
over D / 16 instructions from a zero accumulator, is within
2·D·2^-24·Σ_d |a_d·b_d| of the exact sum (products exact, blocks of terms
aligned to the largest and truncated). Fasi et al. measured that model on
Volta to Ampere; these cases check it on this card through
`kernels/mma_probe.py`, against a float64 reference. Their inputs:
alignment (small terms shifted out past the largest one's exponent),
truncation (a sum just above a tie of f32), block size (cancelling large
terms in various k-steps of a chain), one large product among many small
ones, and random rows at the CE's and the scans' depths.

Marked `cuda`: they skip where no CUDA device is present. On a machine with
one (and no jax), run them without the jax-loading conftest (`-s` prints
each case's worst error as a share of the bound):

    python -m pytest tests/test_torch_mma_probe_cuda.py --noconftest -q -s
"""

import numpy as np
import pytest
import torch

from arec_torch.kernels import mma_probe as tp

U = 2.0 ** -24      # f32's unit roundoff


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(name, K, seed):
    """a [16, K], b [8, K] as float64 arrays of bf16 values."""
    rng = np.random.default_rng(seed)
    a = np.zeros((16, K))
    b = np.zeros((8, K))
    rows = np.arange(16)[:, None]
    cols = np.arange(8)[:, None]
    if name == "alignment":
        # 1 + (K-1) terms of about 2^-24·(1..2): all below the f32 ulp of 1
        a[:, 0], b[:, 0] = 1.0, 1.0
        a[:, 1:] = 2.0 ** -(12 + rows % 4)
        b[:, 1:] = 2.0 ** -12 * (1 + cols / 8)
    elif name == "truncation":
        # 1 + 1.5·2^-24 (rounds up to 1 + 2^-23, truncates to 1), and its
        # negative in odd rows
        a[:, 0] = np.where(rows[:, 0] % 2, -1.0, 1.0)
        b[:, 0] = 1.0
        a[:, 1] = a[:, 0] * 2.0 ** -12
        b[:, 1] = 1.5 * 2.0 ** -12
    elif name == "block_size":
        # ±2^20 pairs placed in k-step (row % (K/16)), lane (row % 16),
        # cancelling, beside small terms of mixed signs
        a[:] = rng.choice([-1.0, 1.0], (16, K)) * 2.0 ** -6
        b[:] = rng.choice([1.0, 1.5], (8, K)) * 2.0 ** -6
        for i in range(16):
            k = 16 * (i % (K // 16)) + i % 16
            k2 = (k + 1 + i % 15) % K
            a[i, k], a[i, k2] = 2.0 ** 10, -(2.0 ** 10)
            b[:, k], b[:, k2] = 2.0 ** 10, 2.0 ** 10
    elif name == "one_large":
        a[:] = rng.standard_normal((16, K)) * 2.0 ** -6
        b[:] = rng.standard_normal((8, K)) * 2.0 ** -6
        big = (7 * np.arange(16)) % K     # row i's one large product
        a[np.arange(16), big] = 2.0 ** 7
        b[:, big] = 2.0 ** 7
    elif name == "random":
        a[:] = rng.standard_normal((16, K))
        b[:] = rng.standard_normal((8, K)) * 0.3
    else:
        raise ValueError(name)
    # the values the card sees: bf16
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tb = torch.from_numpy(b).to(torch.bfloat16)
    return ta, tb


@pytest.mark.cuda
@pytest.mark.parametrize("K", [16, 64, 128])
@pytest.mark.parametrize("name,seed", [
    ("alignment", 0), ("truncation", 0), ("block_size", 1), ("block_size", 2),
    ("one_large", 3), ("random", 4), ("random", 5), ("random", 6)])
def test_tensor_core_sum_within_the_ce_window_premise(dev, name, seed, K):
    ta, tb = _case(name, K, seed)
    c = torch.zeros(16, 8, dtype=torch.float32, device=dev)
    before = tp.mma_probe.launches
    got = tp.mma_probe(ta.to(dev), tb.to(dev), c)
    torch.cuda.synchronize()
    assert tp.mma_probe.launches == before + 1
    a, b = ta.double(), tb.double()
    exact = a @ b.T
    mag = a.abs() @ b.abs().T                 # Σ_d |a_d·b_d|
    err = (got.cpu().double() - exact).abs()
    bound = 2 * K * U * mag
    share = float((err / (K * U * mag).clamp_min(1e-300)).max())
    print(f"{name} seed {seed} K={K}: worst |x' - x| = {share:.3f} "
          f"K·2^-24·Σ|ab| (premise: <= 2)")
    assert (err <= bound).all(), (name, K, share)


@pytest.mark.cuda
def test_probe_matches_an_f32_product_on_exact_inputs(dev):
    """Small integers: every partial sum is exact, so any order agrees."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-8, 9, (16, 64)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-8, 9, (8, 64)).astype(np.float32))
    c = torch.from_numpy(rng.integers(-8, 9, (16, 8)).astype(np.float32))
    got = tp.mma_probe(a.to(torch.bfloat16).to(dev), b.to(torch.bfloat16).to(dev),
                       c.to(dev))
    want = tp.mma_probe_plain(a.to(torch.bfloat16), b.to(torch.bfloat16), c)
    assert torch.equal(got.cpu(), want)
