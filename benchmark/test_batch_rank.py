"""MF's in-batch ranking losses (`mw`, `bbpr`, with and without the
Horvitz–Thompson weights) in the harness: the loss read in one place
(`program.mf_loss`), the reference held to the port's loss path on the
CPU in float32, a tiny MF cell that trains `mw` read end to end, the
checks failing what they must, and the FLOP and byte counts by hand."""

import copy
import json
import os
import re

import pytest
import torch

import control
import run as run_py
from conftest import use_tiny_cells
from harness import bench, program
from reference import data as rdata, model, weights
from roofline import counts as rc

SEED = 2**31 + 23
LOSSES = [("mw", True), ("mw", False), ("bbpr", True), ("bbpr", False)]
IDS = [f"{k}{'-ht' if ht else ''}" for k, ht in LOSSES]
# the tiny MF configuration's own size, in float32 (widths the test's)
TINY_F32 = {"data": {"syn_items": 3000, "syn_users": 2000,
                     "syn_interactions": 40000, "syn_tag_vocab": 64},
            "train": {"batch_size": 256, "compute_dtype": "float32"},
            "model": {"dim": 16}}


def use_loss(monkeypatch, cache_dir, loss: str, ht: bool):
    """Cell.find gives tiny cells whose MF configuration trains `loss`."""
    b = use_tiny_cells(monkeypatch, cache_dir)
    find = b.Cell.find

    def found(name, spec=None):
        cell = find(name, spec)
        if cell.config["config"]["model"]["model"] == "mf":
            cell.config["config"]["train"].update(loss=loss, batch_ht=ht)
        return cell
    monkeypatch.setattr(b.Cell, "find", staticmethod(found))
    return b


def _run(capsys, trace: int = 0) -> dict:
    assert run_py.main(["--workload", "xing-mf-train", "--seed", str(SEED),
                        "--seconds", "1", "--trace", str(trace)],
                       device="cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ---- the loss, read in one place -----------------------------------------

def _cfg(cell: str, **train):
    c = bench.Cell.find(cell)
    c.config = copy.deepcopy(c.config)
    c.config["config"]["train"].update(train)
    return program.config(c, 5)


@pytest.mark.parametrize("loss,ht", [("ce", False)] + LOSSES, ids=["ce"]
                         + IDS)
def test_mf_loss_reads_the_loss_and_its_weights(tiny_cells, loss, ht):
    cfg = _cfg("xing-mf-train", loss=loss, batch_ht=ht)
    assert program.mf_loss(cfg) == (loss, ht)


@pytest.mark.parametrize("cell,loss", [("xing-mf-train", "warp"),
                                       ("xing-mf-train", "bpr"),
                                       ("c4-train", "mce")])
def test_mf_loss_refuses_a_loss_the_reference_lacks(tiny_cells, cell,
                                                     loss):
    cfg = _cfg(cell, loss=loss)
    with pytest.raises(ValueError, match=repr(loss)):
        program.mf_loss(cfg)


def test_mf_loss_refuses_ht_weights_on_the_sampled_ce(tiny_cells):
    cfg = _cfg("xing-mf-train", batch_ht=True)
    with pytest.raises(ValueError, match="batch_ht"):
        program.mf_loss(cfg)


def test_only_program_reads_the_loss():
    """No other file of the harness reads `train.loss` or
    `train.batch_ht`."""
    pat = re.compile(r"train\.(loss|batch_ht)\b|[\"']batch_ht[\"']"
                     r"|\[[\"']train[\"']\]\s*\[[\"']loss[\"']\]")
    found = []
    for root, dirs, files in os.walk(bench.HERE):
        dirs[:] = [d for d in dirs if not d.startswith(("_", "."))]
        for f in files:
            path = os.path.join(root, f)
            if (f.endswith(".py") and not f.startswith("test_")
                    and path != program.__file__):
                with open(path) as fh:
                    found += [(f, m.group(0)) for m in pat.finditer(
                        fh.read())]
    assert found == []


# ---- the reference against the port's loss path -------------------------

@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The tiny MF configuration in float32, the reference's twin and
    static parts, its first training batch, and the port's model built
    from its own prepared twin."""
    from arec_torch.config import Config
    from arec_torch.train.loop import build_model
    root = tmp_path_factory.mktemp("batch_rank")
    with open(os.path.join(bench.HERE, "configs", "xing-mf.json")) as f:
        body = json.load(f)["config"]
    for sec, kv in TINY_F32.items():
        body[sec].update(kv)
    body["data"]["data_dir"] = str(root / "data")
    ents = rdata.entities(body)
    dev = torch.device("cpu")
    d = rdata.load(body["data"], str(root / "cache"))
    m = rdata.static_parts(ents, d, dev)
    b = next(rdata.batches(d, body, SEED))
    batch = {k: torch.as_tensor(b[k]) for k in ("user", "pos_item")}
    ds, spec, item_dev, user_dev = build_model(
        Config.from_json(json.dumps(body)), dev)
    return body, ents, d, m, batch, (ds, spec, item_dev, user_dev)


# the item fusion's b1 is left out: it adds u·b1 to every score of a
# row alike, which cancels in each (candidate − positive) difference, so
# its gradient is round-off on both sides (the check's leaf rule drops it)
LEAVES = ("user.table", "user.w1", "user.b1", "item.table", "item.w1")


def _reference(case, loss, ht, dt="float32"):
    _, ents, _, m, batch, _ = case
    w = weights.make("mf", ents, SEED, torch.device("cpu"))
    for k in LEAVES:
        w[k].requires_grad_()
    out = model.BATCH_LOSSES[loss](weights.nest(w), m, batch["user"],
                                   batch["pos_item"], dt, ht)
    return out.detach(), dict(zip(LEAVES, torch.autograd.grad(
        out, [w[k] for k in LEAVES])))


def _port(case, loss, ht, dt="float32"):
    """The port's `mf_loss` on the reference's weights, through its own
    spec, attribute maps and (with HT) item distribution, its products'
    operands in `dt`."""
    import dataclasses

    from arec_torch.losses.sampling import make_pop
    from arec_torch.models import mf
    from arec_torch.rng import generator
    _, ents, _, _, batch, (ds, spec, item_dev, user_dev) = case
    assert spec.dtype == torch.float32
    spec = dataclasses.replace(spec, loss=loss, batch_ht=ht,
                               compute_dtype=dt)
    w = weights.make("mf", ents, SEED, torch.device("cpu"))
    for k in LEAVES:
        w[k].requires_grad_()
    out = mf.mf_loss(program.param_tree("mf", w), spec, user_dev, item_dev,
                     batch, generator(SEED),
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
    pos = case[4]["pos_item"]
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


SCORES = model._batch_scores


def _diagonal_only(P, m, users, pos, dt):
    """`_batch_scores` with only the diagonal masked: a repeated positive
    left in as a negative."""
    s, own, _ = SCORES(P, m, users, pos, dt)
    return s, own, torch.eye(len(pos), dtype=torch.bool)


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
    import numpy as np

    from arec_torch.losses.sampling import make_pop
    _, _, d, m, _, (ds, *_) = case
    np.testing.assert_array_equal(d.item_freq, ds.item_freq)
    assert torch.equal(m["item_probs"], make_pop(ds.item_freq, 1.0)[1])
    assert int(d.item_freq.min()) == 0       # the clamp to 1 is exercised


# ---- a tiny in-batch cell, end to end ------------------------------------

@pytest.mark.parametrize("loss,ht", LOSSES, ids=IDS)
def test_an_in_batch_cell_is_correct(monkeypatch, cache_dir, capsys, loss,
                                     ht):
    use_loss(monkeypatch, cache_dir, loss, ht)
    line = _run(capsys)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0


def test_an_in_batch_cell_counts_its_own_flops(monkeypatch, cache_dir,
                                               capsys):
    use_loss(monkeypatch, cache_dir, "mw", True)
    got = []
    real = rc.mf_train_step_flops
    monkeypatch.setattr(rc, "mf_train_step_flops",
                        lambda *a: (got.append(a), real(*a))[1])
    line = _run(capsys, trace=1)
    assert line["correct"] is True, line["checks"]
    assert got and all(a[-1] == "mw" for a in got)
    assert line["metrics"]["mfu.train"]["value"] > 0


def test_a_cell_trained_with_another_loss_is_not_correct(monkeypatch,
                                                         cache_dir, capsys):
    """The program trains the sampled CE while the configuration, and so
    the reference, says `mw` with HT weights."""
    import dataclasses

    from arec_torch.models import mf
    use_loss(monkeypatch, cache_dir, "mw", True)
    real = mf.MFSpec.from_config
    monkeypatch.setattr(mf.MFSpec, "from_config", staticmethod(
        lambda *a: dataclasses.replace(real(*a), loss="ce",
                                       batch_ht=False)))
    assert _run(capsys)["correct"] is False


@pytest.mark.parametrize("variant", ["control", "half"])
def test_the_controls_fail_an_in_batch_cell(monkeypatch, cache_dir,
                                            variant):
    use_loss(monkeypatch, cache_dir, "mw", True)
    c = bench.Cell.find("xing-mf-train")
    got = control.train_readings(c, 13, variant, torch.device("cpu"))
    assert any(v > c.limits[k] for k, v in got.items()), got


# ---- the counts ----------------------------------------------------------

def test_the_ce_counts_are_what_they_were():
    """xing-mf's (N 8192, S 2048, D 128, 4 fields a side) and c4's (6,400
    valid positions, S 1024, D = H = 128, 4 item fields) step FLOPs, as
    the counts gave them before the loss was an argument."""
    assert rc.mf_train_step_flops(8192, 2048, 128, 4, 4) == 20138950656
    assert rc.mf_train_step_flops(8192, 2048, 128, 4, 4, "ce") == (
        20138950656)
    assert rc.seq_train_step_flops(6400, 1024, 128, 128, 4) == 12587827200
    assert rc.seq_train_step_flops(6400, 1024, 128, 128, 4, "gru") == (
        11329536000)
    with pytest.raises(ValueError, match="warp"):
        rc.mf_train_step_flops(8192, 2048, 128, 4, 4, "warp")


def test_the_in_batch_counts_by_hand():
    # N 2, D 4, fusions 2·2·16 = 64 (user) and 96 (item):
    # 3·2·(64 + 96) + 6·2·2·4, whatever S is
    for loss in ("mw", "bbpr"):
        assert rc.mf_train_step_flops(2, 3, 4, 2, 3, loss) == 1056
        assert rc.mf_train_step_flops(2, 99, 4, 2, 3, loss) == 1056
    # forward: q 8 + v 8 + bias 2 + ids 2 read, 2 row losses written;
    # 2·2·2·4 FLOPs
    assert rc.batch_rank_s(2, 4, False) == pytest.approx(
        max(4 * 22 / 3.35e12, 32 / 989e12))
    # backward with HT: + 2 probabilities read; dq 8, dv 8, db 2 written;
    # 4·2·2·4 FLOPs
    assert rc.batch_rank_s(2, 4, True, ht=True) == pytest.approx(
        max(4 * 40 / 3.35e12, 64 / 989e12))
    # at xing-mf's batch the products bound it
    n, d = 8192, 128
    assert rc.batch_rank_s(n, d, True) == pytest.approx(
        4 * n * n * d / 989e12)
