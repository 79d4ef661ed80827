"""arec_torch GRU scan vs arec's: the kernel module's plain version and the
stacked scan against the Pallas forward kernel (interpret mode on the CPU,
as arec's own tests run it) and against arec's lax.scan reference, with
both carried states (the GRU's c slot rides along untouched).

Inputs come from numpy with a fixed seed and go to both sides; parity runs
in f32 at the tolerance of tests/test_seq.py (rtol 1e-4, atol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arec.kernels.gru_scan import _forward, gru_layer_pallas, pallas_gru_scan
from arec.models.seq import rnn_scan as jax_rnn_scan
from arec_torch.kernels import gru_scan as tg
from test_torch_lstm_scan import (CASES, D, EDGES, _layers, _mask,
                                  _pad_tile_inputs, _to_j, _to_t)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    B, L = case["B"], case["L"]
    layers = _layers(rng, case["layers"], gates=3)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = _mask(rng, B, L)
    states = None
    if case.get("states"):
        states = [tuple(rng.standard_normal((B, D)).astype(np.float32) * 0.5
                        for _ in range(2)) for _ in layers]
    return layers, x, mask, states


def _run_both(case, jax_fn, seed=0):
    layers, x, mask, states = _inputs(case, seed)
    tm = case.get("time_major", False)
    if tm:
        x, mask = x.transpose(1, 0, 2), mask.T
    rs = states is not None
    want = jax_fn(_to_j(layers), jnp.asarray(x), jnp.asarray(mask),
                  _to_j(states), rs, tm)
    got = tg.gru_scan(_to_t(layers), torch.from_numpy(x),
                      torch.from_numpy(mask), dtype=torch.float32,
                      states=_to_t(states), return_states=rs, time_major=tm)
    if rs:
        (want, want_st), (got, got_st) = want, got
        for (wh, wc), (gh, gc), (_, c0) in zip(want_st, got_st, states):
            np.testing.assert_allclose(gh.numpy(), np.asarray(wh),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(gc.numpy(), np.asarray(wc),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_array_equal(gc.numpy(), c0)   # untouched
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_gru_scan_matches_pallas_kernel(name):
    _run_both(CASES[name], lambda p, x, m, st, rs, tm: pallas_gru_scan(
        p, x, m, dtype=jnp.float32, states=st, return_states=rs,
        time_major=tm))


@pytest.mark.parametrize("name", list(CASES))
def test_gru_scan_matches_lax_scan(name):
    _run_both(CASES[name], lambda p, x, m, st, rs, tm: jax_rnn_scan(
        p, "gru", x, m, jnp.float32, states=st, return_states=rs,
        time_major=tm), seed=1)


def _layer_inputs(L, B, H, seed):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((L, B, 3 * H)).astype(np.float32)
    wh = (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    mask = _mask(rng, B, L)
    h0 = rng.standard_normal((B, H)).astype(np.float32)
    return xw, wh, mask, h0


@pytest.mark.parametrize("B", [3, 9])
def test_gru_layer_plain_matches_pallas_layer(B):
    """One layer with a nonzero carried-in h0: h_all, and the residual hp
    (the state before each step) against the Pallas forward's."""
    L, H = 10, 32
    xw, wh, mask, h0 = _layer_inputs(L, B, H, seed=B)
    args_j = [jnp.asarray(a) for a in (xw, wh, mask, h0)]
    want_h = gru_layer_pallas(*args_j, jnp.float32)
    want_h2, want_hp = _forward(*args_j, dtype=jnp.float32)
    args_t = [torch.from_numpy(a) for a in (xw, wh, mask, h0)]
    got_h = tg.gru_layer_plain(*args_t, torch.float32)
    got_h2, got_hp = tg.gru_layer_plain(*args_t, torch.float32,
                                        residuals=True)
    for g, w in ((got_h, want_h), (got_h2, want_h2), (got_hp, want_hp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    assert torch.equal(got_h, got_h2)
    # the all-pad row keeps its carried-in state exactly
    np.testing.assert_array_equal(got_h.numpy()[:, 0], np.repeat(
        h0[None, 0], L, axis=0))


@pytest.mark.parametrize("B,H,pad_tile", EDGES)
def test_gru_layer_plain_matches_pallas_layer_at_kernel_edges(B, H,
                                                              pad_tile):
    """At the tensor-core forward's edges (those of the LSTM's), with a
    nonzero h0: h_all and the residual hp against the Pallas forward's."""
    L = 10
    xw, wh, mask, h0, _ = _pad_tile_inputs(B, H, 3, pad_tile, L)
    want = _forward(*map(jnp.asarray, (xw, wh, mask, h0)), dtype=jnp.float32)
    got = tg.gru_layer_plain(*map(torch.from_numpy, (xw, wh, mask, h0)),
                             torch.float32, residuals=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    if pad_tile:   # the all-pad tile keeps its carried-in state exactly
        np.testing.assert_array_equal(got[0].numpy()[:, 8:16], np.repeat(
            h0[None, 8:16], L, axis=0))


def test_gru_layer_on_cpu_takes_plain_version_without_launching():
    xw, wh, mask, h0 = map(torch.from_numpy, _layer_inputs(5, 3, 8, seed=3))
    before = tg.gru_layer.launches
    got = tg.gru_layer(xw, wh, mask, h0, dtype=torch.bfloat16)
    want = tg.gru_layer_plain(xw, wh, mask, h0, dtype=torch.bfloat16)
    assert tg.gru_layer.launches == before
    assert torch.equal(got, want)


def test_gru_layer_refuses_other_devices():
    meta = [torch.empty(s, device="meta") for s in
            ((2, 1, 6), (2, 6), (1, 2), (1, 2))]
    with pytest.raises(ValueError, match="cuda or cpu"):
        tg.gru_layer(*meta)
