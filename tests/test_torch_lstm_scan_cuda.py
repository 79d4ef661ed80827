"""lstm_scan_fwd CUDA kernel vs its plain PyTorch version, on the card.

Marked `cuda`: they skip where no CUDA device is present. On a machine with
one (and no jax), run them without the jax-loading conftest:

    python -m pytest tests/test_torch_lstm_scan_cuda.py --noconftest -q

f32 is held to rtol 1e-4 / atol 1e-5. bf16 is held to atol 1e-2 / rtol
1e-2: both sides round h to bf16 at the same points, but their f32 sums
run in different orders, so an h that sits on a bf16 rounding boundary can
land one bf16 ulp (2^-8 relative) apart and carry that through later
steps."""

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
