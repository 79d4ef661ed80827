"""sampled_ce_fwd / sampled_ce_bwd CUDA kernels vs their plain PyTorch
versions, on the card, at c4's training shape (N = 6400, S = 1024,
D = 128), MF's (N = 8192, S = 2048, D = 128) and shapes that cross every
tile edge of the bf16 tensor-core kernels (N off the 64-row tile, S off
the 64-column tile and the range split, S < 64, D off the MMA depth 16,
D = 256, row ranges without a weighted row), aug and non-aug, weighted,
with forced accidental hits; the scratch size the library reports and
the entry points' check of it; and the loss's gradients through the
autograd Function.

Marked `cuda`: they skip where no CUDA device is present. On a machine with
one (and no jax), run them without the jax-loading conftest:

    python -m pytest tests/test_torch_sampled_softmax_cuda.py --noconftest -q

f32 is held to tests/test_fused_softmax.py's tolerances (values rtol 1e-5,
atol 1e-6 on the per-row ce/lse and rtol 1e-5 on the sums; gradients rtol
2e-4, atol 2e-5). bf16 rounds q, v_samp and the softmax residue wp at the
same points on both sides but sums in other orders, so a product can land
one bf16 ulp (2^-8) apart: values at rtol 1e-3, gradients at rtol 2e-2,
atol 1e-4 (the gradients here are O(1e-2))."""

import numpy as np
import pytest
import torch

from arec_torch.kernels import sampled_softmax as tks

VAL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.bfloat16: dict(rtol=1e-3, atol=1e-3)}
GRAD = {torch.float32: dict(rtol=2e-4, atol=2e-5),
        torch.bfloat16: dict(rtol=2e-2, atol=1e-4)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(N, S, D, aug, dev, seed=0):
    rng = np.random.default_rng(seed)
    V = 50 * S
    true_ids = rng.integers(0, V, N).astype(np.int32)
    sampled_ids = rng.integers(0, V, S).astype(np.int32)
    sampled_ids[: S // 8] = true_ids[: S // 8]          # forced hits
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    arrays = [f(N, D), f(N, D + aug) * 0.3, f(S, D) * 0.3, f(S) * 0.5,
              f(N) * 0.5, true_ids, sampled_ids,
              rng.integers(0, 2, N).astype(np.float32)]
    return [torch.from_numpy(a).to(dev) for a in arrays]


SHAPES = [(6400, 1024, 128), (8192, 2048, 128), (77, 40, 16), (1, 3, 8),
          (4133, 1000, 40), (300, 50, 129), (513, 300, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aug", [0, 1])
@pytest.mark.parametrize("N,S,D", SHAPES)
def test_kernels_match_plain(dev, N, S, D, aug, dtype):
    _match_plain(_inputs(N, S, D, aug, dev, seed=N + aug), dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("zero", ["first_half", "all"])
def test_row_ranges_without_weight(dev, zero, dtype):
    """Weight 0 on whole row ranges of the d(v_samp) pass (N = 4133 makes
    17 ranges of 256 rows in bf16) or on every row."""
    args = _inputs(4133, 1000, 40, 1, dev, seed=5)
    args[7][: 4133 // 2 if zero == "first_half" else None] = 0.0
    _match_plain(args, dev, dtype)


def _match_plain(args, dev, dtype):
    f0, b0 = tks.sampled_ce_fwd.launches, tks.sampled_ce_bwd.launches
    got = tks.sampled_ce_fwd(*args, dtype)
    torch.cuda.synchronize()
    want = tks.sampled_ce_fwd_plain(*args, dtype)
    for name, g, w in zip(("num", "den", "ce", "lse"), got, want):
        torch.testing.assert_close(g, w, msg=name, **VAL[dtype])
    again = tks.sampled_ce_fwd(*args, dtype)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    g_num = torch.tensor(0.7, device=dev)
    lse = want[3]
    gb = tks.sampled_ce_bwd(*args, lse, g_num, dtype)
    torch.cuda.synchronize()
    wb = tks.sampled_ce_bwd_plain(*args, lse, g_num, dtype)
    for name, g, w in zip(("dq", "dv_true", "dv_samp", "dc_samp", "dtl"),
                          gb, wb):
        torch.testing.assert_close(g, w, msg=name, **GRAD[dtype])
    assert tks.sampled_ce_fwd.launches == f0 + 2
    assert tks.sampled_ce_bwd.launches == b0 + 1
    again = tks.sampled_ce_bwd(*args, lse, g_num, dtype)
    for g, a in zip(gb, again):
        assert torch.equal(g, a)          # no atomics: bit-for-bit repeats


@pytest.mark.cuda
@pytest.mark.parametrize("aug", [0, 1])
def test_function_gradients_match_plain_autograd(dev, aug):
    """fused_sampled_ce_sums on CUDA tensors, weighted, f32: the quotient
    num / max(den, 1) differentiated through the Function (kernels) equals
    torch autograd through the plain forward."""
    q, vt, vs, cs, tl, tid, sid, w = _inputs(500, 64, 32, aug, dev, seed=9)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (q, vt, vs, cs, tl, w)]
        num, den = fn(*leaves[:5], tid, sid, leaves[5])
        (num / torch.clamp(den, min=1.0)).backward()
        return [t.grad for t in leaves]

    got = grads(lambda *a: tks.fused_sampled_ce_sums(*a, torch.float32))
    want = grads(lambda *a: tks.sampled_ce_fwd_plain(*a, torch.float32)[:2])
    for name, g, w_ in zip(("q", "v_true", "v_samp", "c_samp", "tl_base",
                            "weights"), got, want):
        torch.testing.assert_close(g, w_, msg=name, **GRAD[torch.float32])


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(dev):
    args = _inputs(10, 8, 16, 0, dev)
    with pytest.raises(ValueError, match="int32"):
        tks.sampled_ce_fwd(*args[:5], args[5].long(), *args[6:])
    with pytest.raises(ValueError, match="width"):
        tks.sampled_ce_fwd(args[0], args[1][:, :3], *args[2:])
    with pytest.raises(ValueError, match="dtype"):
        tks.sampled_ce_fwd(*args, torch.float16)
    with pytest.raises(ValueError, match="cuda"):
        tks.sampled_ce_fwd(*[a.cpu() for a in args])


@pytest.mark.cuda
@pytest.mark.parametrize("N,S,D", SHAPES + [(100_000, 16, 8)])
def test_scratch_bytes(dev, N, S, D):
    """`scratch_bytes` (the library's own layout) at every tile edge: whole
    256-byte pieces, at least the bf16 copies of q and v_samp padded to
    64-row tiles and a depth of a multiple of 16, and under 20 MB at c4's
    and MF's training shapes; dimensions the kernels do not take raise."""
    for dtype in (torch.float32, torch.bfloat16):
        for backward in (False, True):
            n = tks.scratch_bytes(N, S, D, dtype, backward)
            assert n > 0 and n % 256 == 0
            if dtype == torch.bfloat16:
                pad = lambda x, m: -(-x // m) * m
                assert n > 2 * (pad(N, 64) + pad(S, 64)) * pad(D, 16)
            if (N, S) in ((6400, 1024), (8192, 2048)):
                assert n < 20 * 2**20
    for bad in ((N, S, 257), (0, S, D), (N, 0, D), (N, S, 0)):
        with pytest.raises(ValueError, match="does not take"):
            tks.scratch_bytes(*bad, torch.bfloat16, True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backward", [False, True])
def test_entry_points_refuse_a_short_scratch(dev, backward, dtype):
    """The C entry points launch nothing and return cudaErrorInvalidValue
    (1) for a scratch one byte shorter than `scratch_bytes`; 0 for it."""
    N, S, D = 300, 200, 40
    args = _inputs(N, S, D, 0, dev)
    nbytes = tks.scratch_bytes(N, S, D, dtype, backward)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    if backward:
        lse = tks.sampled_ce_fwd_plain(*args, dtype)[3]
        outs = [lse, torch.tensor(0.7, **f32), torch.empty(N, D, **f32),
                torch.empty(N, D, **f32), torch.empty(S, D, **f32),
                torch.empty(S, **f32), torch.empty(N, **f32)]
        fn = tks._fn("sampled_ce_bwd", 16, 5)
    else:
        outs = [torch.empty(N, **f32), torch.empty(N, **f32),
                torch.empty(2, **f32)]
        fn = tks._fn("sampled_ce_fwd", 12, 5)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rcs = [fn(*(t.data_ptr() for t in args + outs), scratch.data_ptr(), N, D,
              D, S, int(dtype == torch.bfloat16), n, stream)
           for n in (nbytes - 1, nbytes)]
    torch.cuda.synchronize()
    assert rcs == [1, 0]
