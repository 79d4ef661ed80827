"""gru_scan_fwd / gru_scan_bwd CUDA kernels vs their plain PyTorch versions,
on the card, and the layer's gradients on CUDA tensors.

Marked `cuda`: they skip where no CUDA device is present. On a machine with
one (and no jax), run them without the jax-loading conftest:

    python -m pytest tests/test_torch_gru_scan_cuda.py --noconftest -q

Tolerances are those of tests/test_torch_lstm_scan_cuda.py, for the same
reasons: f32 forward rtol 1e-4 / atol 1e-5; bf16 forward 1e-2 / 1e-2 (both
sides round h and r⊙h to bf16 at the same points but sum in different
orders, so a value on a rounding boundary can land one bf16 ulp apart and
carry that through later steps); the backward at tests/test_seq.py's
gradient tolerance in f32 (rtol 2e-3, atol 2e-4) and 2e-2 / 2e-2 in bf16
(the gate derivatives are rounded to bf16 before the products). The bf16
forward's and the backward's cases are the LSTM card tests' (forward: B =
256, 200, 128, 100, 13 at H = 128, 64, 48, 16 and 24; backward: c4's
shape, ragged B, B = 1024 at H = 64, B = 129, Wh read from global at
H = 192, small widths)."""

import numpy as np
import pytest
import torch

from arec_torch.kernels import gru_scan as tg
from arec_torch.kernels import lstm_scan as tk

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
BWD_TOL = {torch.float32: dict(rtol=2e-3, atol=2e-4),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(L, B, H, dev, seed=0):
    """xw, wh, a left-padded mask with a few all-pad rows, a nonzero h0 and
    a cotangent of h_all."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, L + 1, B)
    lengths[: min(B, 3)] = 0
    lengths[-1] = L
    mask = (np.arange(L)[None, :] >= (L - lengths)[:, None])
    arrays = (rng.standard_normal((L, B, 3 * H)),
              rng.standard_normal((H, 3 * H)) / np.sqrt(2 * H),
              mask,
              rng.standard_normal((B, H)) * 0.5,
              rng.standard_normal((L, B, H)))
    return [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,B,H", [(50, 256, 128), (50, 200, 128),
                                   (50, 128, 128), (50, 100, 128),
                                   (7, 5, 32), (1, 1, 16)])
def test_kernel_matches_plain(dev, dtype, L, B, H):
    xw, wh, mask, h0, _ = _inputs(L, B, H, dev)
    before = tg.gru_layer.launches
    got = tg.gru_layer(xw, wh, mask, h0, dtype)
    torch.cuda.synchronize()
    assert tg.gru_layer.launches == before + 1
    want = tg.gru_layer_plain(xw, wh, mask, h0, dtype)
    torch.testing.assert_close(got, want, **TOL[dtype])
    # all-pad rows keep their carried-in state exactly
    pad = mask.sum(dim=1) == 0
    assert torch.equal(got[:, pad], h0[pad].expand(L, -1, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("residuals", [False, True])
@pytest.mark.parametrize("B", [256, 200, 128, 100, 13])
@pytest.mark.parametrize("H", [128, 64, 48, 16, 24])
def test_bf16_forward_matches_plain(dev, residuals, B, H):
    """The bf16 serving (residuals=False) and training launches against the
    plain version: the tensor-core kernel at H = 128, 64 (Whᵀ in registers)
    and 48, 16 (the general kernel), the CUDA-core kernel at H = 24. Each
    repeats bit for bit, and its residual is the state before each step:
    h0, then the previous step's."""
    L, dt = 50, torch.bfloat16
    xw, wh, mask, h0, _ = _inputs(L, B, H, dev, seed=B + H)
    assert tk.fwd_route(dt, H) == ("mma" if H % 16 == 0 else "cuda_core")
    fwd = lambda: tg.gru_scan_fwd(xw, wh, mask, h0, dt, residuals=residuals)
    before = tg.gru_layer.launches
    got = fwd()
    torch.cuda.synchronize()
    assert tg.gru_layer.launches == before + 1
    want = tg.gru_layer_plain(xw, wh, mask, h0, dt, residuals=residuals)
    want = want if residuals else (want,)
    for name, g, w in zip(("h_all", "hp"), got, want):
        torch.testing.assert_close(g, w, msg=name, **TOL[dt])
    for g, a in zip(got, fwd()):
        assert torch.equal(g, a)
    if residuals:
        h_all, hp = got
        assert torch.equal(hp[0], h0) and torch.equal(hp[1:], h_all[:-1])


@pytest.mark.cuda
@pytest.mark.parametrize("H", [128, 64])
def test_bf16_forward_keeps_its_registers(dev, H):
    """At the configs' widths the tensor-core forward holds Whᵀ and the
    carry in registers: no spilled (local) bytes in either launch."""
    for launch, k in tk.fwd_kernel_info(tg.KERNEL, H).items():
        assert k["local_bytes"] == 0 and k["blocks_per_sm"] >= 1, (launch, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,B,H", [(50, 128, 128), (50, 100, 128),
                                   (30, 1024, 64), (50, 129, 128),
                                   (5, 3, 192), (7, 5, 32), (1, 1, 16)])
def test_backward_kernel_matches_plain(dev, dtype, L, B, H):
    xw, wh, mask, h0, dh = _inputs(L, B, H, dev)
    got_res = tg.gru_scan_fwd(xw, wh, mask, h0, dtype, residuals=True)
    want_res = tg.gru_layer_plain(xw, wh, mask, h0, dtype, residuals=True)
    for g, w in zip(got_res, want_res):
        torch.testing.assert_close(g, w, **TOL[dtype])
    hp = want_res[1]
    before = tg.gru_layer_bwd.launches
    got = tg.gru_layer_bwd(xw, wh, mask, hp, dh, dtype)
    torch.cuda.synchronize()
    assert tg.gru_layer_bwd.launches == before + 1
    want = tg.gru_layer_bwd_plain(xw, wh, mask, hp, dh, dtype)
    for name, g, w in zip(("dxw", "dwh", "dh0"), got, want):
        torch.testing.assert_close(g, w, msg=name, **BWD_TOL[dtype])
    # runs repeat bit for bit (no atomics)
    again = tg.gru_layer_bwd(xw, wh, mask, hp, dh, dtype)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(dev):
    xw, wh, mask, h0, dh = _inputs(4, 3, 16, dev)
    with pytest.raises(ValueError, match="contiguous"):
        tg.gru_layer(xw.transpose(0, 1).contiguous().transpose(0, 1), wh,
                     mask, h0, torch.float32)
    with pytest.raises(ValueError, match="float32"):
        tg.gru_layer(xw, wh, mask.double(), h0, torch.float32)
    with pytest.raises(ValueError, match="is on"):
        tg.gru_layer(xw, wh, mask.cpu(), h0, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        tg.gru_layer(xw, wh, mask, h0, torch.float16)
    with pytest.raises(ValueError, match="3H"):
        tg.gru_layer(xw[..., :-1].contiguous(), wh, mask, h0, torch.float32)
    with pytest.raises(ValueError, match="must be"):
        tg.gru_layer_bwd(xw, wh, mask, dh[:, :2].contiguous(), dh,
                         torch.float32)


@pytest.mark.cuda
def test_bf16_backward_refuses_a_width_off_the_mma(dev):
    """The bf16 backward runs on the tensor cores (depth 16): H = 24 raises
    before any launch; f32 takes it."""
    xw, wh, mask, h0, dh = _inputs(4, 3, 24, dev)
    hp = tg.gru_layer_plain(xw, wh, mask, h0, torch.float32,
                            residuals=True)[1]
    before = tg.gru_layer_bwd.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        tg.gru_layer_bwd(xw, wh, mask, hp, dh, torch.bfloat16)
    assert tg.gru_layer_bwd.launches == before
    got = tg.gru_layer_bwd(xw, wh, mask, hp, dh, torch.float32)
    want = tg.gru_layer_bwd_plain(xw, wh, mask, hp, dh, torch.float32)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BWD_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_gradients_reach_every_input_on_cuda(dev, dtype):
    """Under grad mode gru_layer's gradients to xw, Wh and h0 equal those
    of the plain version (differentiated by torch autograd) on the same
    inputs."""
    L, B, H = 20, 33, 64
    xw, wh, mask, h0, dh = _inputs(L, B, H, dev)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (xw, wh, h0)]
        h_all = fn(leaves[0], leaves[1], mask, leaves[2], dtype)
        assert h_all.grad_fn is not None
        (h_all * dh).sum().backward()
        return [t.grad for t in leaves]

    fwd0, bwd0 = tg.gru_layer.launches, tg.gru_layer_bwd.launches
    got = grads(tg.gru_layer)
    assert tg.gru_layer.launches == fwd0 + 1
    assert tg.gru_layer_bwd.launches == bwd0 + 1
    want = grads(tg.gru_layer_plain)
    for name, g, w in zip(("xw", "wh", "h0"), got, want):
        assert g is not None, name
        torch.testing.assert_close(g, w, msg=name, **BWD_TOL[dtype])


@pytest.mark.cuda
def test_serving_launch_under_inference_mode_keeps_no_residuals(dev):
    xw, wh, mask, h0, _ = _inputs(6, 4, 16, dev)
    with torch.inference_mode():
        out = tg.gru_layer(xw, wh.requires_grad_(), mask, h0)
    assert out.shape == (6, 4, 16) and out.grad_fn is None
