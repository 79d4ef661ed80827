"""The reference's recurrent cells on the CPU: the GRU reference held to
the program's plain GRU scan (`arec_torch.models.seq.layer_scan`) in
float32, on seeded weights and the tiny twin's first batch: hidden states,
the sampled-softmax loss and the gradients of `rnn_w` and `rnn_b`; and the
LSTM's weights pinned, leaf by leaf, to what the harness drew before the
recurrent cell chose its shapes."""

import hashlib
import itertools

import pytest
import torch

import conftest
from harness import bench
from reference import data as rdata, keys, model, weights

SEED = 2**31 + 7

# sha256 (first 16 hex digits) of each LSTM leaf of weights.make at the
# tiny c4 size and SEED on the CPU, taken from the harness as it was when
# every sequence configuration was an LSTM
LSTM_LEAVES = {
    "item_in.table": ((3094, 16), "83e81fa257a64fd8"),
    "item_in.w1": ((64, 16), "caf3443923df9e98"),
    "item_in.b1": ((16,), "077b678a40ed1336"),
    "rnn_w": ((32, 64), "266df7fbda93fef1"),
    "rnn_b": ((64,), "0de0cf57e6457a0d"),
    "item_out": ((3001, 17), "015ccd540bd70283"),
}


def _tiny_c4(rnn_cell=None):
    return conftest.tiny(bench.Cell.find("c4-train"), rnn_cell).config[
        "config"]


def test_the_lstm_weights_are_what_they_were():
    ents = rdata.entities(_tiny_c4())
    w = weights.make("seq", ents, SEED, torch.device("cpu"), "lstm")
    got = {k: (tuple(v.shape),
               hashlib.sha256(v.numpy().tobytes()).hexdigest()[:16])
           for k, v in w.items()}
    assert got == LSTM_LEAVES


def test_the_gru_weights_take_three_gates():
    ents = rdata.entities(_tiny_c4("gru"))
    w = weights.make("seq", ents, SEED, torch.device("cpu"), "gru")
    lstm = weights.make("seq", ents, SEED, torch.device("cpu"), "lstm")
    assert w["rnn_w"].shape == (32, 48) and w["rnn_b"].shape == (48,)
    # no forget-gate + 1: every bias is a plain N(0, 0.01²) draw
    assert float(w["rnn_b"].abs().max()) < 0.1
    assert float(lstm["rnn_b"][16:32].mean()) > 0.9
    with pytest.raises(ValueError, match="cell"):
        weights.shapes("seq", ents, None)


def _port_hidden(P, m, inputs, mask, dt):
    """The program's plain GRU scan over the reference's encode."""
    from arec_torch.models import seq
    assert dt == "float32"
    x, _ = model.encode(P["item_in"], m["item"], m["item_slots"], inputs)
    return seq.layer_scan({"w": P["rnn_w"], "b": P["rnn_b"]}, "gru", x,
                          mask, torch.float32)


def test_the_gru_reference_is_the_programs_plain_gru(cache_dir,
                                                     monkeypatch):
    torch.set_num_threads(2)
    cfg = _tiny_c4("gru")
    ents = rdata.entities(cfg)
    d = rdata.load(cfg["data"], cache_dir)
    dev = torch.device("cpu")
    m = rdata.static_parts(ents, d, dev)
    b = next(itertools.islice(rdata.batches(d, cfg, SEED), 1))
    inputs, targets, mask = (torch.as_tensor(b[k]) for k in
                             ("inputs", "targets", "mask"))
    assert 0 < float(mask.sum()) < mask.numel()     # left padding in it
    negs = keys.negatives(SEED, 0, cfg["train"]["num_sampled"],
                          ents["item"].num, dev)
    monkeypatch.setitem(model.HIDDEN, "port", _port_hidden)
    got = {}
    for side in ("gru", "port"):
        P = weights.nest(weights.make("seq", ents, SEED, dev, "gru"))
        P["rnn_w"].requires_grad_()
        P["rnn_b"].requires_grad_()
        h = model.HIDDEN[side](P, m, inputs, mask, "float32")
        loss = model.seq_loss(P, m, inputs, targets, mask, negs, "float32",
                              side)
        gw, gb = torch.autograd.grad(loss, [P["rnn_w"], P["rnn_b"]])
        got[side] = (h.detach(), loss.detach(), gw, gb)
    ref, port = got["gru"], got["port"]
    # both sides run the same float32 arithmetic, the two gate sums in
    # the same order; what may differ is the matmuls' blocking, a few
    # ulps of a value of order 1 (h is in (-1, 1), the loss ≈ 7)
    torch.testing.assert_close(port[0], ref[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(port[1], ref[1], rtol=1e-6, atol=0)
    # gradients sum 320 positions' terms through 10 steps, in an order
    # autograd chooses on each side: relative to the largest entry
    for g_port, g_ref in zip(port[2:], ref[2:]):
        torch.testing.assert_close(g_port, g_ref, rtol=1e-4,
                                   atol=1e-5 * float(g_ref.abs().max()))
    assert float(ref[2].abs().max()) > 0 and float(ref[3].abs().max()) > 0
