"""sampled_ce_fwd / sampled_ce_bwd CUDA kernels vs their plain PyTorch
versions, on the card, at c4's training shape (N = 6400, S = 1024,
D = 128) and small ragged ones, aug and non-aug, weighted, with forced
accidental hits; and the loss's gradients through the autograd Function.

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


SHAPES = [(6400, 1024, 128), (77, 40, 16), (1, 3, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aug", [0, 1])
@pytest.mark.parametrize("N,S,D", SHAPES)
def test_kernels_match_plain(dev, N, S, D, aug, dtype):
    args = _inputs(N, S, D, aug, dev, seed=N + aug)
    f0, b0 = tks.sampled_ce_fwd.launches, tks.sampled_ce_bwd.launches
    got = tks.sampled_ce_fwd(*args, dtype)
    torch.cuda.synchronize()
    want = tks.sampled_ce_fwd_plain(*args, dtype)
    for name, g, w in zip(("num", "den", "ce", "lse"), got, want):
        torch.testing.assert_close(g, w, msg=name, **VAL[dtype])
    g_num = torch.tensor(0.7, device=dev)
    lse = want[3]
    gb = tks.sampled_ce_bwd(*args, lse, g_num, dtype)
    torch.cuda.synchronize()
    wb = tks.sampled_ce_bwd_plain(*args, lse, g_num, dtype)
    for name, g, w in zip(("dq", "dv_true", "dv_samp", "dc_samp", "dtl"),
                          gb, wb):
        torch.testing.assert_close(g, w, msg=name, **GRAD[dtype])
    assert tks.sampled_ce_fwd.launches == f0 + 1
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
