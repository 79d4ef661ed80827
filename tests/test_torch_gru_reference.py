"""The port's GRU next-item loss against the benchmark's plain reference,
on the CPU at a tiny size in float32: `arec_torch.models.seq.seq_loss`
with `cell="gru"` (its plain scan, and the kernel wrapper's plain
version) on weights from `benchmark/reference/weights.make`, against
`reference/model.seq_loss` with `gru_hidden` (TF1's GRUCell, r applied to
h before U_n) on the same batch and negatives: hidden states, loss, and
the gradients of `rnn_w`, `rnn_b` and the input table. A cuDNN-order GRU
(r scaling h·U_n after the product) must fall outside the tolerances.
The weights' shapes are pinned by cell.

The reference is imported by path from `benchmark/`; it imports nothing
of the port and takes nothing the port made: its batches and attribute
maps come from its own copy of the synthetic twin. The port prepares the
same twin itself."""

import json
import os
import sys

import pytest
import torch

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
sys.path.insert(0, BENCH)
try:
    from reference import data as rdata, keys, model, weights
finally:
    sys.path.remove(BENCH)

SEED = 2**31 + 19
# c4-gru-xing's configuration cut to a CPU test's size; widths are the
# test's own, every other key the benchmark configuration's
TINY = {"data": {"syn_items": 3000, "syn_users": 2000,
                 "syn_interactions": 40000, "syn_tag_vocab": 64},
        "train": {"batch_size": 32, "num_sampled": 64,
                  "compute_dtype": "float32"},
        "model": {"dim": 16, "max_seq_len": 10}}


def _config(data_dir: str, cell: str = "gru") -> dict:
    with open(os.path.join(BENCH, "configs", "c4-gru-xing.json")) as f:
        body = json.load(f)["config"]
    for sec, kv in TINY.items():
        body[sec].update(kv)
    body["model"]["cell"] = cell
    body["data"]["data_dir"] = data_dir
    return body


def gru_cudnn_hidden(P, m, inputs, mask, dt):
    """`gru_hidden` with cuDNN's order: n = tanh(x·W_xn + r ⊙ (h·U_n) +
    b_n), the reset gate applied after the product. Another cell."""
    x, _ = model.encode(P["item_in"], m["item"], m["item_slots"], inputs)
    D = x.shape[-1]
    w, b = P["rnn_w"], P["rnn_b"]
    xw = model.mm(x, w[:D], dt) + b
    B, T = inputs.shape
    h = torch.zeros(B, D)
    out = []
    for t in range(T):
        hw = model.mm(h, w[D:], dt)
        r = torch.sigmoid(xw[:, t, :D] + hw[:, :D])
        u = torch.sigmoid(xw[:, t, D:2 * D] + hw[:, D:2 * D])
        n = torch.tanh(xw[:, t, 2 * D:] + r * hw[:, 2 * D:])
        keep = mask[:, t:t + 1]
        h = keep * (u * h + (1.0 - u) * n) + (1.0 - keep) * h
        out.append(h)
    return torch.stack(out, 1)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The tiny configuration, the reference's twin, static parts and
    first training batch, and the step's negatives."""
    root = tmp_path_factory.mktemp("gru_reference")
    body = _config(str(root / "data"))
    ents = rdata.entities(body)
    d = rdata.load(body["data"], str(root / "cache"))
    dev = torch.device("cpu")
    m = rdata.static_parts(ents, d, dev)
    b = next(rdata.batches(d, body, SEED))
    batch = {k: torch.as_tensor(b[k]) for k in ("inputs", "targets",
                                                "mask")}
    assert 0 < float(batch["mask"].sum()) < batch["mask"].numel()
    negs = keys.negatives(SEED, 0, body["train"]["num_sampled"],
                          ents["item"].num, dev)
    return body, ents, m, batch, negs


LEAVES = ("rnn_w", "rnn_b", "item_in.table")


def _reference(case, hidden):
    body, ents, m, batch, negs = case
    w = weights.make("seq", ents, SEED, torch.device("cpu"), "gru")
    for k in LEAVES:
        w[k].requires_grad_()
    P = weights.nest(w)
    model.HIDDEN["_case"] = hidden
    try:
        h = hidden(P, m, batch["inputs"], batch["mask"], "float32")
        loss = model.seq_loss(P, m, batch["inputs"], batch["targets"],
                              batch["mask"], negs, "float32", "_case")
    finally:
        del model.HIDDEN["_case"]
    grads = torch.autograd.grad(loss, [w[k] for k in LEAVES])
    return h.detach(), loss.detach(), dict(zip(LEAVES, grads))


def _port(case, use_kernel: bool):
    """The port's forward and loss on the reference's weights, through
    its own prepared twin, spec and attribute maps."""
    from arec_torch.config import Config
    from arec_torch.models import seq
    from arec_torch.rng import generator
    from arec_torch.train.loop import build_model
    body, ents, _, batch, negs = case
    body = json.loads(json.dumps(body))
    body["model"]["use_pallas_scan"] = use_kernel
    cfg = Config.from_json(json.dumps(body))
    _, spec, item_dev, _ = build_model(cfg, torch.device("cpu"))
    assert spec.cell == "gru" and spec.dtype == torch.float32
    w = weights.make("seq", ents, SEED, torch.device("cpu"), "gru")
    for k in LEAVES:
        w[k].requires_grad_()
    params = {"item_in": {"tables": {"__fused__": w["item_in.table"]},
                          "fusion": {"w1": w["item_in.w1"],
                                     "b1": w["item_in.b1"]}},
              "rnn": [{"w": w["rnn_w"], "b": w["rnn_b"]}],
              "item_out": w["item_out"]}
    h = seq.seq_hidden(params, spec, item_dev, None, batch)
    loss = seq.seq_loss(params, spec, item_dev, None, batch,
                        generator(SEED, torch.device("cpu")),
                        sampled=negs, use_kernel=use_kernel)
    grads = torch.autograd.grad(loss, [w[k] for k in LEAVES])
    return h.detach(), loss.detach(), dict(zip(LEAVES, grads))


def _assert_close(port, ref):
    """The tolerances, and why. Both sides run float32 on the CPU: the
    same gate arithmetic in the same order, the same encode and CE. What
    may differ is the matmuls' blocking and the order autograd sums in:
    h in (-1, 1) to a few ulps; the loss (≈ 6.4) to one or two; each
    gradient, a sum of 320 positions' terms through 10 steps, relative
    to its largest entry."""
    torch.testing.assert_close(port[0], ref[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(port[1], ref[1], rtol=1e-6, atol=0)
    for k in LEAVES:
        g = ref[2][k]
        assert float(g.abs().max()) > 0, k
        torch.testing.assert_close(port[2][k], g, rtol=1e-4,
                                   atol=1e-5 * float(g.abs().max()),
                                   msg=lambda s, k=k: f"{k}: {s}")


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain_scan", "kernel_wrapper"])
def test_the_ports_gru_loss_is_the_references(case, use_kernel):
    _assert_close(_port(case, use_kernel),
                  _reference(case, model.gru_hidden))


@pytest.mark.parametrize("part", ["hidden", "loss", "grads"])
def test_a_cudnn_order_gru_falls_outside_the_tolerances(case, part):
    ref = _reference(case, model.gru_hidden)
    other = _reference(case, gru_cudnn_hidden)
    pick = {"hidden": lambda x: (x[0], ref[1], ref[2]),
            "loss": lambda x: (ref[0], x[1], ref[2]),
            "grads": lambda x: (ref[0], ref[1], x[2])}[part]
    _assert_close(ref, ref)
    with pytest.raises(AssertionError):
        _assert_close(pick(other), ref)


@pytest.mark.parametrize("cell,gates", [("lstm", 4), ("gru", 3)])
def test_the_weights_take_their_shapes_from_the_cell(tmp_path, cell, gates):
    ents = rdata.entities(_config(str(tmp_path), cell))
    d = ents["item"].dim
    w = weights.make("seq", ents, SEED, torch.device("cpu"), cell)
    assert w["rnn_w"].shape == (2 * d, gates * d)
    assert w["rnn_b"].shape == (gates * d,)
    assert w["item_out"].shape == (ents["item"].num + 1, d + 1)
    bias = w["rnn_b"].reshape(gates, d).mean(1)
    if cell == "lstm":      # i | f | g | o: the forget gate's + 1
        assert float(bias[1]) > 0.9
        assert float(bias[[0, 2, 3]].abs().max()) < 0.1
    else:                   # r | u | n: every bias a plain draw
        assert float(bias.abs().max()) < 0.1
