"""The port's in-batch ranking losses (`mw`, `bbpr`, with and without the
Horvitz–Thompson weights) against the benchmark's plain reference, on the
CPU at a tiny size in float32: `arec_torch.models.mf.mf_loss` on weights
from `benchmark/reference/weights.make`, against `reference/model.py`'s
`mw_loss` / `bbpr_loss` on the same batch (one that repeats items), in the
loss and the gradients of both tables and both fusions; in bfloat16 both
round each product's operands and their gradients alike. `mw` with only
the diagonal masked, and `mw` with HT weights held to `mw` without, fall
outside the tolerances. The reference's item distribution equals the
port's `make_pop(item_freq, 1.0)[1]`.

The reference is imported by path from `benchmark/`; it imports nothing
of the port and takes nothing the port made: its batches, attribute maps
and item counts come from its own copy of the synthetic twin. The port
prepares the same twin itself."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
sys.path.insert(0, BENCH)
try:
    from reference import data as rdata, model, weights
finally:
    sys.path.remove(BENCH)

SEED = 2**31 + 24
LOSSES = [("mw", True), ("mw", False), ("bbpr", True), ("bbpr", False)]
IDS = [f"{k}{'-ht' if ht else ''}" for k, ht in LOSSES]
# xing-mf-bbpr's configuration cut to a CPU test's size, in float32;
# widths are the test's own, every other key the benchmark configuration's
TINY = {"data": {"syn_items": 3000, "syn_users": 2000,
                 "syn_interactions": 40000, "syn_tag_vocab": 64},
        "train": {"batch_size": 256, "compute_dtype": "float32"},
        "model": {"dim": 16}}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The tiny configuration, the reference's twin, static parts and
    first training batch, and the port's model built from its own
    prepared twin."""
    from arec_torch.config import Config
    from arec_torch.train.loop import build_model
    root = tmp_path_factory.mktemp("batch_rank_reference")
    with open(os.path.join(BENCH, "configs", "xing-mf-bbpr.json")) as f:
        body = json.load(f)["config"]
    for sec, kv in TINY.items():
        body[sec].update(kv)
    body["data"]["data_dir"] = str(root / "data")
    ents = rdata.entities(body)
    dev = torch.device("cpu")
    d = rdata.load(body["data"], str(root / "cache"))
    m = rdata.static_parts(ents, d, dev)
    b = next(rdata.batches(d, body, SEED))
    batch = {k: torch.as_tensor(b[k]) for k in ("user", "pos_item")}
    built = build_model(Config.from_json(json.dumps(body)), dev)
    return ents, d, m, batch, built


# the item fusion's b1 is left out: it adds u·b1 to every score of a
# row alike, which cancels in each (candidate − positive) difference, so
# its gradient is round-off on both sides (the check's leaf rule drops it)
LEAVES = ("user.table", "user.w1", "user.b1", "item.table", "item.w1")


def _weights(ents):
    w = weights.make("mf", ents, SEED, torch.device("cpu"))
    for k in LEAVES:
        w[k].requires_grad_()
    return w


def _reference(case, loss, ht, dt="float32"):
    ents, _, m, batch, _ = case
    w = _weights(ents)
    out = model.BATCH_LOSSES[loss](weights.nest(w), m, batch["user"],
                                   batch["pos_item"], dt, ht)
    return out.detach(), dict(zip(LEAVES, torch.autograd.grad(
        out, [w[k] for k in LEAVES])))


def _port(case, loss, ht, dt="float32"):
    """The port's `mf_loss` on the reference's weights, through its own
    spec, attribute maps and (with HT) item distribution, its products'
    operands in `dt`."""
    from arec_torch.losses.sampling import make_pop
    from arec_torch.models import mf
    from arec_torch.rng import generator
    ents, _, _, batch, (ds, spec, item_dev, user_dev) = case
    assert spec.dtype == torch.float32
    spec = dataclasses.replace(spec, loss=loss, batch_ht=ht,
                               compute_dtype=dt)
    w = _weights(ents)
    params = {e: {"tables": {"__fused__": w[f"{e}.table"]},
                  "fusion": {"w1": w[f"{e}.w1"], "b1": w[f"{e}.b1"]}}
              for e in ("user", "item")}
    out = mf.mf_loss(params, spec, user_dev, item_dev, batch,
                     generator(SEED),
                     pop=make_pop(ds.item_freq, 1.0) if ht else None)
    return out.detach(), dict(zip(LEAVES, torch.autograd.grad(
        out, [w[k] for k in LEAVES])))


def _assert_close(port, ref):
    """The tolerances, and why. Both sides run float32 on the CPU: the
    same encode and fusion, the same [B, B] product and the same masks
    and weights in the same order. What may differ is the matmuls'
    blocking and the order autograd sums in: the loss to a few ulps, and
    each gradient, a sum over the batch's B² pairs, relative to its
    largest entry."""
    torch.testing.assert_close(port[0], ref[0], rtol=1e-5, atol=0)
    for k in LEAVES:
        g = ref[1][k]
        assert float(g.abs().max()) > 0, k
        torch.testing.assert_close(port[1][k], g, rtol=1e-4,
                                   atol=1e-5 * float(g.abs().max()),
                                   msg=lambda s, k=k: f"{k}: {s}")


def test_the_batch_repeats_items(case):
    pos = case[3]["pos_item"]
    assert len(torch.unique(pos)) < len(pos)


@pytest.mark.parametrize("loss,ht", LOSSES, ids=IDS)
def test_the_ports_in_batch_loss_is_the_references(case, loss, ht):
    _assert_close(_port(case, loss, ht), _reference(case, loss, ht))


@pytest.mark.parametrize("loss,ht", LOSSES[::3], ids=IDS[::3])
def test_the_gradients_round_as_the_configurations_casts(case, loss, ht):
    """In bfloat16 the port rounds each product's operands and, as the
    autodiff of a cast does, their gradients; so does the reference
    (`model.mm_cast`). A reference whose rounding passed the gradient
    through unrounded (`model.mm`) falls outside."""
    port = _port(case, loss, ht, "bfloat16")
    _assert_close(port, _reference(case, loss, ht, "bfloat16"))
    with pytest.raises(AssertionError):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(model, "mm_cast", model.mm)
            _assert_close(port, _reference(case, loss, ht, "bfloat16"))


def _diagonal_only(P, m, users, pos, dt):
    """`_batch_scores` with only the diagonal masked: a repeated positive
    left in as a negative."""
    s, own, _ = SCORES(P, m, users, pos, dt)
    return s, own, torch.eye(len(pos), dtype=torch.bool)


SCORES = model._batch_scores


def test_mw_with_only_the_diagonal_masked_falls_outside(case, monkeypatch):
    port = _port(case, "mw", True)
    _assert_close(port, _reference(case, "mw", True))
    monkeypatch.setattr(model, "_batch_scores", _diagonal_only)
    with pytest.raises(AssertionError):
        _assert_close(port, _reference(case, "mw", True))


def test_mw_with_ht_weights_falls_outside_mw_without(case):
    with pytest.raises(AssertionError):
        _assert_close(_port(case, "mw", True), _reference(case, "mw", False))


def test_the_item_distribution_is_the_ports(case):
    """The reference's own counts and probabilities equal the port's
    `item_freq` and `make_pop(item_freq, 1.0)[1]`, array for array."""
    from arec_torch.losses.sampling import make_pop
    _, d, m, _, (ds, *_) = case
    np.testing.assert_array_equal(d.item_freq, ds.item_freq)
    assert torch.equal(m["item_probs"], make_pop(ds.item_freq, 1.0)[1])
    assert int(d.item_freq.min()) == 0       # the clamp to 1 is exercised
