"""lstm_scan_fwd / lstm_scan_bwd CUDA kernels vs their plain PyTorch
versions, on the card, and the layer's gradients on CUDA tensors.

Marked `cuda`: they skip where no CUDA device is present. On a machine with
one (and no jax), run them without the jax-loading conftest:

    python -m pytest tests/test_torch_lstm_scan_cuda.py --noconftest -q

f32 is held to rtol 1e-4 / atol 1e-5. bf16 is held to atol 1e-2 / rtol
1e-2: both sides round h to bf16 at the same points, but their f32 sums
run in different orders, so an h that sits on a bf16 rounding boundary can
land one bf16 ulp (2^-8 relative) apart and carry that through later
steps. The bf16 forward's cases cross the tensor-core kernel's edges:
both launches at the serving and training batches and ragged ones (B =
256, 200, 128, 100, 13: tiles of 8 rows), at the register-resident widths
(H = 128, 64), the general kernel's (48, 16) and one off the mma's depth
(24, the CUDA-core kernel). The backward is held to tests/test_seq.py's
gradient tolerance in f32 (rtol 2e-3, atol 2e-4) and to atol 2e-2 / rtol
2e-2 in bf16 (the gate derivatives are rounded to bf16 before both
products, where an ulp-apart pair shifts a term by 2^-8 of its size). The
backward's cases cross the bf16 kernels' edges: c4's shape and a ragged B,
the widest config batch at the syn configs' width (B = 1024, H = 64: a
128-CTA sweep), one row past a tile (B = 129), Wh too large for shared
memory (H = 192: read from global), and small widths."""

import numpy as np
import pytest
import torch

from arec_torch.kernels import lstm_scan as tk

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(L, B, H, dev, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, L + 1, B)
    lengths[: min(B, 3)] = 0                      # a few all-pad rows
    lengths[-1] = L
    mask = (np.arange(L)[None, :] >= (L - lengths)[:, None])
    arrays = (rng.standard_normal((L, B, 4 * H)),
              rng.standard_normal((H, 4 * H)) / np.sqrt(2 * H),
              mask,
              rng.standard_normal((B, H)) * 0.5,
              rng.standard_normal((B, H)) * 0.5)
    return [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,B,H", [(50, 256, 128), (50, 200, 128),
                                   (7, 5, 32), (1, 1, 16)])
def test_kernel_matches_plain(dev, dtype, L, B, H):
    xw, wh, mask, h0, c0 = _inputs(L, B, H, dev)
    before = tk.lstm_layer.launches
    got_h, got_c = tk.lstm_layer(xw, wh, mask, h0, c0, dtype)
    torch.cuda.synchronize()
    assert tk.lstm_layer.launches == before + 1
    want_h, want_c = tk.lstm_layer_plain(xw, wh, mask, h0, c0, dtype)
    torch.testing.assert_close(got_h, want_h, **TOL[dtype])
    torch.testing.assert_close(got_c, want_c, **TOL[dtype])
    # all-pad rows keep their carried-in state exactly
    pad = mask.sum(dim=1) == 0
    assert torch.equal(got_h[:, pad], h0[pad].expand(L, -1, -1))
    assert torch.equal(got_c[pad], c0[pad])


@pytest.mark.cuda
@pytest.mark.parametrize("residuals", [False, True])
@pytest.mark.parametrize("B", [256, 200, 128, 100, 13])
@pytest.mark.parametrize("H", [128, 64, 48, 16, 24])
def test_bf16_forward_matches_plain(dev, residuals, B, H):
    """The bf16 serving (residuals=False) and training launches against the
    plain version: the tensor-core kernel at H = 128, 64 (Whᵀ in registers)
    and 48, 16 (the general kernel), the CUDA-core kernel at H = 24. Each
    repeats bit for bit, and its residuals are the states before each step:
    (h0, c0), then the previous step's."""
    L, dt = 50, torch.bfloat16
    xw, wh, mask, h0, c0 = _inputs(L, B, H, dev, seed=B + H)
    assert tk.fwd_route(dt, H) == ("mma" if H % 16 == 0 else "cuda_core")
    fwd = lambda: tk.lstm_scan_fwd(xw, wh, mask, h0, c0, dt,
                                   residuals=residuals)
    before = tk.lstm_layer.launches
    got = fwd()
    torch.cuda.synchronize()
    assert tk.lstm_layer.launches == before + 1
    want = tk.lstm_layer_plain(xw, wh, mask, h0, c0, dt, residuals=residuals)
    for name, g, w in zip(("h_all", "cT", "hp", "cp"), got, want):
        torch.testing.assert_close(g, w, msg=name, **TOL[dt])
    for g, a in zip(got, fwd()):
        assert torch.equal(g, a)
    if residuals:
        h_all, _, hp, cp = got
        assert torch.equal(hp[0], h0) and torch.equal(hp[1:], h_all[:-1])
        assert torch.equal(cp[0], c0)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [128, 64])
def test_bf16_forward_keeps_its_registers(dev, H):
    """At the configs' widths the tensor-core forward holds Whᵀ and the
    carries in registers: no spilled (local) bytes in either launch."""
    for launch, k in tk.fwd_kernel_info(tk.KERNEL, H).items():
        assert k["local_bytes"] == 0 and k["blocks_per_sm"] >= 1, (launch, k)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(dev):
    xw, wh, mask, h0, c0 = _inputs(4, 3, 16, dev)
    with pytest.raises(ValueError, match="contiguous"):
        tk.lstm_layer(xw.transpose(0, 1).contiguous().transpose(0, 1), wh,
                      mask, h0, c0, torch.float32)
    with pytest.raises(ValueError, match="float32"):
        tk.lstm_layer(xw, wh, mask.double(), h0, c0, torch.float32)
    with pytest.raises(ValueError, match="is on"):
        tk.lstm_layer(xw, wh, mask.cpu(), h0, c0, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        tk.lstm_layer(xw, wh, mask, h0, c0, torch.float16)


BWD_TOL = {torch.float32: dict(rtol=2e-3, atol=2e-4),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _cotangents(L, B, H, dev, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dev) for s in ((L, B, H), (B, H))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,B,H", [(50, 128, 128), (50, 100, 128),
                                   (30, 1024, 64), (50, 129, 128),
                                   (5, 3, 192), (7, 5, 32), (1, 1, 16)])
def test_backward_kernel_matches_plain(dev, dtype, L, B, H):
    xw, wh, mask, h0, c0 = _inputs(L, B, H, dev)
    dh, dcT = _cotangents(L, B, H, dev)
    got_res = tk.lstm_scan_fwd(xw, wh, mask, h0, c0, dtype, residuals=True)
    want_res = tk.lstm_layer_plain(xw, wh, mask, h0, c0, dtype,
                                   residuals=True)
    for g, w in zip(got_res, want_res):
        torch.testing.assert_close(g, w, **TOL[dtype])
    hp, cp = want_res[2:]
    before = tk.lstm_layer_bwd.launches
    got = tk.lstm_layer_bwd(xw, wh, mask, hp, cp, dh, dcT, dtype)
    torch.cuda.synchronize()
    assert tk.lstm_layer_bwd.launches == before + 1
    want = tk.lstm_layer_bwd_plain(xw, wh, mask, hp, cp, dh, dcT, dtype)
    for name, g, w in zip(("dxw", "dwh", "dh0", "dc0"), got, want):
        torch.testing.assert_close(g, w, msg=name, **BWD_TOL[dtype])
    # runs repeat bit for bit (no atomics)
    again = tk.lstm_layer_bwd(xw, wh, mask, hp, cp, dh, dcT, dtype)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_bf16_backward_refuses_a_width_off_the_mma(dev):
    """The bf16 backward runs on the tensor cores (depth 16): H = 24 raises
    before any launch; f32 takes it."""
    L, B, H = 4, 3, 24
    xw, wh, mask, h0, c0 = _inputs(L, B, H, dev)
    dh, dcT = _cotangents(L, B, H, dev)
    hp, cp = tk.lstm_layer_plain(xw, wh, mask, h0, c0, torch.float32,
                                 residuals=True)[2:]
    before = tk.lstm_layer_bwd.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        tk.lstm_layer_bwd(xw, wh, mask, hp, cp, dh, dcT, torch.bfloat16)
    assert tk.lstm_layer_bwd.launches == before
    got = tk.lstm_layer_bwd(xw, wh, mask, hp, cp, dh, dcT, torch.float32)
    want = tk.lstm_layer_bwd_plain(xw, wh, mask, hp, cp, dh, dcT,
                                   torch.float32)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BWD_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_gradients_reach_every_input_on_cuda(dev, dtype):
    """Regression: the CUDA launch must keep the autograd graph. Under grad
    mode lstm_layer's gradients to xw, Wh, h0 and c0 equal those of the
    plain version (differentiated by torch autograd) on the same inputs."""
    L, B, H = 20, 33, 64
    xw, wh, mask, h0, c0 = _inputs(L, B, H, dev)
    dh, dcT = _cotangents(L, B, H, dev)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (xw, wh, h0, c0)]
        h_all, cT = fn(leaves[0], leaves[1], mask, leaves[2], leaves[3],
                       dtype)
        assert h_all.grad_fn is not None and cT.grad_fn is not None
        ((h_all * dh).sum() + (cT * dcT).sum()).backward()
        return [t.grad for t in leaves]

    fwd0, bwd0 = tk.lstm_layer.launches, tk.lstm_layer_bwd.launches
    got = grads(tk.lstm_layer)
    assert tk.lstm_layer.launches == fwd0 + 1
    assert tk.lstm_layer_bwd.launches == bwd0 + 1
    want = grads(tk.lstm_layer_plain)
    for name, g, w in zip(("xw", "wh", "h0", "c0"), got, want):
        assert g is not None, name
        torch.testing.assert_close(g, w, msg=name, **BWD_TOL[dtype])


@pytest.mark.cuda
def test_serving_launch_under_inference_mode_keeps_no_residuals(dev):
    xw, wh, mask, h0, c0 = _inputs(6, 4, 16, dev)
    with torch.inference_mode():
        out = tk.lstm_layer(xw, wh.requires_grad_(), mask, h0, c0)
    assert len(out) == 2 and out[0].grad_fn is None
