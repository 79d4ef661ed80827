"""arec_torch GRU layer backward vs arec's: the plain backward against the
Pallas backward kernel `_backward` (interpret mode on the CPU, as arec's own
tests run it), and the gradients of the port's `gru_layer` (the `GRULayer`
autograd Function, its plain versions on CPU tensors) against `jax.grad`
of `gru_layer_pallas`, with ragged B, all-pad rows and a nonzero h0.

Inputs come from numpy with a fixed seed and go to both sides; f32 at
tests/test_seq.py's gradient tolerance (rtol 2e-3, atol 2e-4). bf16 is held
to the same tolerance at these small widths: both sides round h, r⊙h and
the gate derivatives to bf16 at the same points, and the f32 sums of a
16- or 32-term product differ by far less than one bf16 ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arec.kernels.gru_scan import _backward, _forward, gru_layer_pallas
from arec_torch.kernels import gru_scan as tg
from arec_torch.models import seq as tseq

torch.set_num_threads(1)

TOL = dict(rtol=2e-3, atol=2e-4)


def _layer_inputs(L, B, H, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, L + 1, B)
    lengths[0], lengths[-1] = 0, L                  # an all-pad and a full row
    mask = (np.arange(L)[None, :] >= (L - lengths)[:, None])
    arrays = (rng.standard_normal((L, B, 3 * H)),
              rng.standard_normal((H, 3 * H)) / np.sqrt(H),
              mask,
              rng.standard_normal((B, H)) * 0.5,
              rng.standard_normal((L, B, H)))      # cotangent of h_all
    return [np.asarray(a, np.float32) for a in arrays]


@pytest.mark.parametrize("L,B,H", [(7, 3, 8), (9, 5, 16)])
def test_plain_backward_matches_pallas_backward(L, B, H):
    xw, wh, mask, h0, dh = _layer_inputs(L, B, H, seed=L * B)
    _, hp = _forward(*map(jnp.asarray, (xw, wh, mask, h0)),
                     dtype=jnp.float32)
    want = _backward(*map(jnp.asarray, (xw, wh, mask)), hp,
                     jnp.asarray(dh), dtype=jnp.float32)
    t = lambda a: torch.from_numpy(np.array(a))
    got = tg.gru_layer_bwd_plain(*map(t, (xw, wh, mask, hp, dh)),
                                 torch.float32)
    for name, g, w in zip(("dxw", "dwh", "dh0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,B,H", [(6, 4, 8), (10, 7, 16)])
def test_layer_gradients_match_jax_grad(L, B, H, dtype):
    """Gradients to xw, Wh and h0 through h_all."""
    xw, wh, mask, h0, dh = _layer_inputs(L, B, H, seed=L + B)
    jdt = jnp.dtype(dtype)

    def jloss(xw, wh, h0):
        return jnp.sum(gru_layer_pallas(xw, wh, jnp.asarray(mask), h0, jdt)
                       * dh)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (xw, wh, h0)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xw, wh, h0)]
    h_all = tg.gru_layer(leaves[0], leaves[1], torch.from_numpy(mask),
                         leaves[2], getattr(torch, dtype))
    assert h_all.grad_fn is not None
    (h_all * torch.from_numpy(dh)).sum().backward()
    for name, leaf, w in zip(("xw", "wh", "h0"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   err_msg=name, **TOL)


def test_final_state_gradient_only():
    """Only the final state h_all[-1] feeds the loss (a carried segment):
    h0 and xw get arec's gradients through the masked steps."""
    xw, wh, mask, h0, dh = _layer_inputs(6, 4, 8, seed=2)

    def jloss(xw, h0):
        return jnp.sum(gru_layer_pallas(xw, jnp.asarray(wh),
                                        jnp.asarray(mask), h0,
                                        jnp.float32)[-1] * dh[0])

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xw), jnp.asarray(h0))
    x, h = (torch.from_numpy(a).requires_grad_() for a in (xw, h0))
    h_all = tg.gru_layer(x, torch.from_numpy(wh), torch.from_numpy(mask), h,
                         torch.float32)
    (h_all[-1] * torch.from_numpy(dh[0])).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(want[1]), **TOL)


def test_segmented_scan_has_the_unsegmented_gradient():
    """Two carried segments through the Function give the one-pass scan's
    gradients to x and every weight."""
    rng = np.random.default_rng(4)
    B, L, D = 4, 8, 8
    layer = {"w": torch.from_numpy((rng.standard_normal((2 * D, 3 * D))
                                    / np.sqrt(2 * D)).astype(np.float32)),
             "b": torch.from_numpy(rng.standard_normal(3 * D).astype(
                 np.float32) * 0.1)}
    x = torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32))
    lengths = np.array([0, 3, 6, 8])
    mask = torch.from_numpy((np.arange(L)[None] >= (L - lengths)[:, None])
                            .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32))

    def grads(segments):
        p = {k: v.clone().requires_grad_() for k, v in layer.items()}
        xx = x.clone().requires_grad_()
        st, hs, seg = None, [], L // segments
        for s in range(segments):
            sl = slice(s * seg, (s + 1) * seg)
            h, st = tg.gru_scan([p], xx[:, sl], mask[:, sl],
                                dtype=torch.float32, states=st,
                                return_states=True)
            hs.append(h)
        (torch.cat(hs, 1) * w).sum().backward()
        return xx.grad, p["w"].grad, p["b"].grad

    for a, b in zip(grads(1), grads(2)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_output_dropout_is_a_pure_function_of_the_key():
    """The kernel path and the plain scan draw the same per-layer masks
    from one key, and the same key draws them again."""
    from arec_torch.rng import generator

    rng = np.random.default_rng(5)
    D = 8
    layers = [{"w": torch.from_numpy((rng.standard_normal((2 * D, 3 * D))
                                      / 4).astype(np.float32)),
               "b": torch.zeros(3 * D)} for _ in range(2)]
    x = torch.from_numpy(rng.standard_normal((3, 6, D)).astype(np.float32))
    mask = torch.ones(3, 6)
    runs = [tg.gru_scan(layers, x, mask, torch.float32,
                        dropout_gen=generator(11), keep_prob=0.5)
            for _ in range(2)]
    plain = tseq.rnn_scan(layers, "gru", x, mask, torch.float32,
                          dropout_gen=generator(11), keep_prob=0.5)
    assert torch.equal(runs[0], runs[1])
    torch.testing.assert_close(runs[0], plain, rtol=1e-5, atol=1e-6)
    kept = (runs[0] != 0).float().mean()
    assert 0.3 < kept < 0.7
