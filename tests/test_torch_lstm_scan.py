"""arec_torch LSTM scan vs arec's: the kernel module's plain version and the
stacked scan against the Pallas forward kernel (interpret mode on the CPU,
as arec's own tests run it) and against arec's lax.scan reference.

Inputs come from numpy with a fixed seed and go to both sides; parity runs
in f32 at the tolerance of tests/test_seq.py (rtol 1e-4, atol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arec.kernels.lstm_scan import (_forward, lstm_layer_pallas,
                                    pallas_lstm_scan)
from arec.models.seq import rnn_scan as jax_rnn_scan
from arec_torch.kernels import lstm_scan as tk
from arec_torch.models import seq as tseq

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
D = 16

CASES = {
    "left_pad": dict(B=4, L=8, layers=1),
    "ragged_batch": dict(B=5, L=9, layers=1),
    "carried_state": dict(B=4, L=8, layers=1, states=True),
    "time_major": dict(B=6, L=8, layers=1, time_major=True),
    "two_layers": dict(B=4, L=12, layers=2, states=True),
}


def _layers(rng, n, d=D, gates=4):
    out = []
    for _ in range(n):
        w = (rng.standard_normal((2 * d, gates * d)) / np.sqrt(2 * d))
        b = rng.standard_normal(gates * d) * 0.1
        out.append({"w": w.astype(np.float32), "b": b.astype(np.float32)})
    return out


def _mask(rng, b, L):
    """Left-padded rows of varied length, one all-pad and one full row."""
    lengths = rng.integers(1, L + 1, b)
    lengths[0], lengths[-1] = 0, L
    return (np.arange(L)[None, :] >= (L - lengths)[:, None]).astype(
        np.float32)


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    B, L = case["B"], case["L"]
    layers = _layers(rng, case["layers"])
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = _mask(rng, B, L)
    states = None
    if case.get("states"):
        states = [tuple(rng.standard_normal((B, D)).astype(np.float32) * 0.5
                        for _ in range(2)) for _ in layers]
    return layers, x, mask, states


def _to_t(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_t(v) for v in tree)
    return torch.from_numpy(np.asarray(tree))


def _to_j(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_j(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_j(v) for v in tree)
    return jnp.asarray(tree)


def _run_both(case, jax_fn, seed=0):
    layers, x, mask, states = _inputs(case, seed)
    tm = case.get("time_major", False)
    if tm:
        x, mask = x.transpose(1, 0, 2), mask.T
    rs = states is not None
    want = jax_fn(_to_j(layers), jnp.asarray(x), jnp.asarray(mask),
                  _to_j(states), rs, tm)
    got = tk.lstm_scan(_to_t(layers), torch.from_numpy(x),
                       torch.from_numpy(mask), dtype=torch.float32,
                       states=_to_t(states), return_states=rs, time_major=tm)
    if rs:
        (want, want_st), (got, got_st) = want, got
        for (wh, wc), (gh, gc) in zip(want_st, got_st):
            np.testing.assert_allclose(gh.numpy(), np.asarray(wh),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(gc.numpy(), np.asarray(wc),
                                       rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_lstm_scan_matches_pallas_kernel(name):
    _run_both(CASES[name], lambda p, x, m, st, rs, tm: pallas_lstm_scan(
        p, x, m, dtype=jnp.float32, states=st, return_states=rs,
        time_major=tm))


@pytest.mark.parametrize("name", list(CASES))
def test_lstm_scan_matches_lax_scan(name):
    _run_both(CASES[name], lambda p, x, m, st, rs, tm: jax_rnn_scan(
        p, "lstm", x, m, jnp.float32, states=st, return_states=rs,
        time_major=tm), seed=1)


@pytest.mark.parametrize("B", [3, 9])
def test_lstm_layer_plain_matches_pallas_layer(B):
    """One layer with nonzero carried-in (h0, c0): h_all and cT."""
    rng = np.random.default_rng(B)
    L, H = 10, 32
    xw = rng.standard_normal((L, B, 4 * H)).astype(np.float32)
    wh = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    mask = _mask(rng, B, L)
    h0, c0 = (rng.standard_normal((B, H)).astype(np.float32) for _ in "hc")
    want_h, want_c = lstm_layer_pallas(*map(jnp.asarray, (xw, wh, mask, h0,
                                                          c0)), jnp.float32)
    got_h, got_c = tk.lstm_layer_plain(*map(torch.from_numpy,
                                            (xw, wh, mask, h0, c0)),
                                       torch.float32)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               rtol=RTOL, atol=ATOL)
    # the all-pad row keeps its carried-in state exactly
    np.testing.assert_array_equal(got_h.numpy()[:, 0], np.repeat(
        h0[None, 0], L, axis=0))
    np.testing.assert_array_equal(got_c.numpy()[0], c0[0])


# the bf16 tensor-core forward's edges: a batch off its 8-row tiles
# (B = 13), an all-pad tile of 8 rows (rows 8-15; at B = 21 a ragged tile
# follows), the general kernel's widths (16, 48) and a width off the MMA's
# depth (24: the CUDA-core kernel)
EDGES = [(13, 16, False), (16, 48, True), (21, 48, True), (13, 24, False)]


def _pad_tile_inputs(B, H, gates, pad_tile, L=10):
    """xw, wh, a left-padded mask (rows 8-15 all padding when pad_tile) and
    nonzero carried-in states (h0, c0)."""
    rng = np.random.default_rng(B + H)
    xw = rng.standard_normal((L, B, gates * H)).astype(np.float32)
    wh = (rng.standard_normal((H, gates * H)) / np.sqrt(H)).astype(np.float32)
    mask = _mask(rng, B, L)
    if pad_tile:
        mask[8:16] = 0.0
    h0, c0 = (rng.standard_normal((B, H)).astype(np.float32) for _ in "hc")
    return xw, wh, mask, h0, c0


@pytest.mark.parametrize("B,H,pad_tile", EDGES)
def test_lstm_layer_plain_matches_pallas_layer_at_kernel_edges(B, H,
                                                               pad_tile):
    """At the tensor-core forward's edges, with nonzero carries: h_all, cT
    and the residuals hp, cp against the Pallas forward's."""
    L = 10
    xw, wh, mask, h0, c0 = _pad_tile_inputs(B, H, 4, pad_tile, L)
    h_all, c_all, hp, cp = _forward(*map(jnp.asarray, (xw, wh, mask, h0, c0)),
                                    dtype=jnp.float32)
    got = tk.lstm_layer_plain(*map(torch.from_numpy, (xw, wh, mask, h0, c0)),
                              torch.float32, residuals=True)
    for g, w in zip(got, (h_all, c_all[-1], hp, cp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    if pad_tile:   # the all-pad tile keeps its carried-in state exactly
        np.testing.assert_array_equal(got[0].numpy()[:, 8:16], np.repeat(
            h0[None, 8:16], L, axis=0))
        np.testing.assert_array_equal(got[1].numpy()[8:16], c0[8:16])


@pytest.mark.parametrize("dtype,H,route", [
    (torch.bfloat16, 128, "mma"), (torch.bfloat16, 64, "mma"),
    (torch.bfloat16, 48, "mma"), (torch.bfloat16, 16, "mma"),
    (torch.bfloat16, 24, "cuda_core"), (torch.bfloat16, 8, "cuda_core"),
    (torch.float32, 128, "cuda_core"), (torch.float32, 24, "cuda_core")])
def test_forward_route_by_dtype_and_width(dtype, H, route):
    """The forward's kernel by dtype and width: the tensor-core kernel for
    bf16 at a multiple of 16 (the MMA's depth), else the CUDA-core kernel;
    the weight handed to it follows (Whᵀ for the tensor cores, Wh else),
    cast, contiguous."""
    assert tk.fwd_route(dtype, H) == route
    wh = torch.randn(H, 4 * H)
    got, _, w, shape = tk._fwd_weight(wh, dtype, H, 4 * H)
    assert got == route and tuple(w.shape) == shape and w.is_contiguous()
    assert torch.equal(w, (wh.t() if route == "mma" else wh).to(dtype))


def test_lstm_layer_on_cpu_takes_plain_version_without_launching():
    rng = np.random.default_rng(3)
    L, B, H = 5, 3, 8
    args = [torch.from_numpy(a) for a in (
        rng.standard_normal((L, B, 4 * H)).astype(np.float32),
        rng.standard_normal((H, 4 * H)).astype(np.float32),
        _mask(rng, B, L),
        np.zeros((B, H), np.float32), np.zeros((B, H), np.float32))]
    before = tk.lstm_layer.launches
    got = tk.lstm_layer(*args, dtype=torch.bfloat16)
    want = tk.lstm_layer_plain(*args, dtype=torch.bfloat16)
    assert tk.lstm_layer.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_lstm_layer_refuses_other_devices():
    meta = [torch.empty(s, device="meta") for s in
            ((2, 1, 8), (2, 8), (1, 2), (1, 2), (1, 2))]
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.lstm_layer(*meta)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_plain_rnn_scan_matches_arec(cell):
    """The port's plain reference scan (both cells) against arec's."""
    rng = np.random.default_rng(7)
    g = 4 if cell == "lstm" else 3
    layers = _layers(rng, 2, gates=g)
    x = rng.standard_normal((5, 8, D)).astype(np.float32)
    mask = _mask(rng, 5, 8)
    want = jax_rnn_scan(_to_j(layers), cell, jnp.asarray(x),
                        jnp.asarray(mask), jnp.float32)
    got = tseq.rnn_scan(_to_t(layers), cell, torch.from_numpy(x),
                        torch.from_numpy(mask), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_gru_kernel_path_raises_instead_of_falling_back():
    """seq_hidden's GRU kernel path goes through the GRU kernel wrapper:
    on CPU tensors its plain versions, with no launch, matching arec's
    Pallas GRU scan; on a device it cannot launch on it raises rather than
    falling back to the plain scan."""
    from arec.kernels.gru_scan import pallas_gru_scan
    from arec_torch.data.schema import AttributeData, EntitySchema
    from arec_torch.kernels import gru_scan as tg
    from arec_torch.tables.engine import EncoderSpec, attrs_to_device

    schema = EntitySchema("item", 10, (EntitySchema.id_field("item", 10),))
    spec = tseq.SeqSpec(item_in=EncoderSpec(schema, D), user=None,
                        cell="gru", use_pallas_scan=True,
                        compute_dtype="float32")
    params = tseq.init_seq(torch.Generator().manual_seed(0), spec)
    item_dev = attrs_to_device(
        AttributeData(schema, AttributeData.id_identity(schema)),
        spec.item_in)
    rng = np.random.default_rng(8)
    batch = {"inputs": torch.from_numpy(
                 rng.integers(0, 10, (3, 5)).astype(np.int32)),
             "mask": torch.from_numpy(_mask(rng, 3, 5))}
    before = tk.lstm_layer.launches, tg.gru_layer.launches
    got = tseq.seq_hidden(params, spec, item_dev, None, batch)
    assert (tk.lstm_layer.launches, tg.gru_layer.launches) == before
    x = tseq.seq_inputs(params, spec, item_dev, None, batch)
    want = pallas_gru_scan(
        [{k: jnp.asarray(v.numpy()) for k, v in p.items()}
         for p in params["rnn"]], jnp.asarray(x.numpy()),
        jnp.asarray(batch["mask"].numpy()), dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    meta = {"w": params["rnn"][0]["w"].to("meta"),
            "b": params["rnn"][0]["b"].to("meta")}
    with pytest.raises(ValueError, match="cuda or cpu"):
        tg.gru_scan([meta], x.to("meta"), batch["mask"].to("meta"),
                    dtype=torch.float32)
