"""Training on a device mesh, part 4: the Trainer and the CLI on gloo
ranks (tests/torch_mesh_worker.py), against arec's Trainer on its 8 fake
devices and against the port's own single-device Trainer.

  * `Trainer(cfg).train()` on (2, 4), MF sparse and shuffled (the
    flagship's set-up) and the LSTM dense, against arec's Trainer on the
    same config and the same handed-in negatives: the loss of every step
    at rtol 2e-4 (tests/test_dist_e2e.py:266), the metrics records'
    keys. A rank takes the d::data part of each epoch's order, so the
    global batch is arec's as a set; only the primary writes metrics.
  * Checkpoints: a run to step 2 and a second invocation to 4 restore
    mid-epoch and end bit for bit where the straight run to 4 ends
    (exact resume); the mesh's checkpoint restores on one device with
    evaluate() equal to the mesh's; a checkpoint written on one device
    restores on the mesh and trains on to the straight mesh run's params
    (tests/test_dist_e2e.py:298, tests/test_sparse_mesh.py:217).
  * `exchange_dropped` is in the records at capacity_factor > 0 (its
    count is held to arec's in test_torch_mesh_steps.py).
  * `cli.main` trains on 2 ranks: the summary on both, one metrics
    stream, a checkpoint a one-device Trainer restores.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from arec.train.loop import Trainer as JTrainer
from arec_torch.config import Config
from arec_torch.train.checkpoint import Checkpointer
from arec_torch.train.loop import Trainer
from torch_mesh_train_check import (
    assert_params_close, config, hand_in, leaves, make_draw, numpy_state,
    port_json,
)
from torch_mesh_worker import run_ranks

torch.set_num_threads(1)

STEPS = 4
LOSS = dict(rtol=2e-4)
RESUMED = dict(rtol=2e-4, atol=2e-6)
TRAIN = dict(max_steps=STEPS, steps_per_checkpoint=1, lr_decay=1.0,
             eval_batch_size=64)
KEYS = {"step", "t", "loss", "recall_at_k", "lr", "examples_per_s",
        "examples_per_s_per_chip"}


def _metrics(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _port_hand_in(monkeypatch, draw):
    import arec_torch.losses.losses as tl
    import arec_torch.train.sparse as tsparse

    fixed = tuple(torch.from_numpy(x.copy()) for x in draw)
    for m in (tl, tsparse):
        monkeypatch.setattr(m, "draw", lambda *a, **k: fixed)


def _seed(train_dir, state0, cfg_json):
    """A step-0 checkpoint of arec's initial state (natural layout) under
    train_dir, so that the port's Trainer starts where arec's does."""
    from arec_torch import bridge
    from arec_torch.train.step import TrainState
    Checkpointer(train_dir).save(
        0, TrainState(**bridge.to_torch(state0)),
        {"epoch": 0, "step_in_epoch": 0, "prev_loss": None, "window": [],
         "best_recall": 0.0}, cfg_json)


def _ckpt_state(train_dir, step):
    return torch.load(os.path.join(train_dir, "ckpt", str(step),
                                   "state.pt"), weights_only=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_trainer")
    mp = pytest.MonkeyPatch()
    cfgs = {
        "mf": config(tmp, "mf", sparse=True, row_shard="shuffle", **TRAIN),
        "lstm": config(tmp, "lstm", model="lstm", **TRAIN),
    }
    arec, draws, state0 = {}, {}, {}
    try:
        for i, (name, cfg) in enumerate(cfgs.items()):
            jt = JTrainer(cfg.replace(train=cfg.train.__class__(**{
                **cfg.train.__dict__,
                "train_dir": cfg.train.train_dir + "_arec"})))
            state0[name] = numpy_state(jt)
            draws[name] = make_draw(jt.spec.vocab if jt.is_seq else
                                    jt.spec.item.schema.num_entities, i)
            hand_in(mp, draws[name])
            summary = jt.train()
            jax.effects_barrier()
            arec[name] = {"summary": summary,
                          "metrics": _metrics(jt.cfg.train.train_dir)}
        # a checkpoint written on one device, for the mesh to resume
        single = Config.from_json(port_json(cfgs["mf"])).override(
            {"mesh.data": 1, "mesh.model": 1, "train.max_steps": 2,
             "train.train_dir": str(tmp / "from_single")})
        for d in ("from_single", "resume"):
            _seed(str(tmp / d), state0["mf"], single.to_json())
        for name, cfg in cfgs.items():
            _seed(cfg.train.train_dir, state0[name], port_json(cfg))
        _port_hand_in(mp, draws["mf"])
        Trainer(single, device="cpu").train()
    finally:
        mp.undo()

    mf = Config.from_json(port_json(cfgs["mf"]))

    def case(cfg, draw, **sets):
        c = cfg.override(sets) if sets else cfg
        return {"config": c.to_json(), "draw": draw,
                "train_dir": c.train.train_dir}
    cases = {
        "mf": case(mf, draws["mf"]),
        "lstm": case(Config.from_json(port_json(cfgs["lstm"])),
                     draws["lstm"]),
        "resume_to_2": case(mf, draws["mf"], **{
            "train.max_steps": 2, "train.steps_per_checkpoint": 2,
            "train.train_dir": str(tmp / "resume")}),
        "resume_to_4": case(mf, draws["mf"], **{
            "train.steps_per_checkpoint": 2,
            "train.train_dir": str(tmp / "resume")}),
        "from_single": case(mf, draws["mf"], **{
            "train.train_dir": str(tmp / "from_single")}),
        "capacity": case(mf, draws["mf"], **{
            "mesh.capacity_factor": 1.0, "train.sparse_update": "false",
            "train.max_steps": 2,
            "train.train_dir": str(tmp / "capacity")}),
    }
    res = run_ranks("train", 8, tmp, {"cases": list(cases.values())})
    port = {name: [r[i] for r in res] for i, name in enumerate(cases)}
    return arec, port, cases, mf


@pytest.mark.parametrize("name", ["mf", "lstm"])
def test_mesh_trainer_matches_arec_step_for_step(runs, name):
    arec, port, _, _ = runs
    want = [r for r in arec[name]["metrics"] if "loss" in r]
    got = [r for r in port[name][0]["metrics"] if "loss" in r]
    assert [r["step"] for r in got] == [r["step"] for r in want] == list(
        range(1, STEPS + 1))
    np.testing.assert_allclose([r["loss"] for r in got],
                               [r["loss"] for r in want], **LOSS)
    assert set(got[0]) == set(want[0]) == KEYS
    # one metrics stream; every rank returns the same summary
    assert all("metrics" not in r for r in port[name][1:])
    assert all(r["summary"] == port[name][0]["summary"]
               for r in port[name])
    assert port[name][0]["summary"]["steps"] == STEPS


def test_resume_on_the_mesh_is_exact(runs):
    _, port, cases, _ = runs
    # both invocations append to one metrics stream
    recs = [r for r in port["resume_to_4"][0]["metrics"] if "loss" in r]
    assert [r["step"] for r in recs] == [2, 4]
    straight = [r for r in port["mf"][0]["metrics"] if "loss" in r]
    # the windows of 2 steps: the straight run's steps, averaged
    losses = [r["loss"] for r in recs]
    np.testing.assert_allclose(
        losses, [(straight[i]["loss"] + straight[i + 1]["loss"]) / 2
                 for i in (0, 2)], rtol=1e-6)
    assert "[ckpt] restored step 2 (epoch 0+2 steps)" in port[
        "resume_to_4"][0]["stdout"]
    a = dict(leaves(_ckpt_state(cases["mf"]["train_dir"], STEPS)))
    b = dict(leaves(_ckpt_state(cases["resume_to_4"]["train_dir"], STEPS)))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_mesh_checkpoint_restores_on_one_device(runs):
    _, port, cases, mf = runs
    one = mf.override({"mesh.data": 1, "mesh.model": 1,
                       "train.train_dir": cases["mf"]["train_dir"]})
    tr = Trainer(one, serve_only=True, device="cpu")
    assert int(tr.state.step) == STEPS
    want = port["mf"][0]["summary"]["recall_at_k"]
    assert tr.evaluate() == pytest.approx(want, abs=1e-6)
    # the file holds the natural layout: the one-device state is the file's
    saved = _ckpt_state(cases["mf"]["train_dir"], STEPS)
    assert_params_close(_np(tr.state.params), _np(saved["params"]),
                        dict(rtol=0, atol=0))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree.detach().numpy()


def test_one_device_checkpoint_trains_on_on_the_mesh(runs):
    _, port, cases, _ = runs
    out = port["from_single"][0]
    assert "[ckpt] restored step 2 (epoch 0+2 steps)" in out["stdout"]
    assert "[ckpt] restored step 0" in port["mf"][0]["stdout"]
    assert out["summary"]["steps"] == STEPS
    got = _ckpt_state(cases["from_single"]["train_dir"], STEPS)
    want = _ckpt_state(cases["mf"]["train_dir"], STEPS)
    assert_params_close(_np(got["params"]), _np(want["params"]), RESUMED)


def test_exchange_dropped_is_recorded(runs):
    _, port, _, _ = runs
    recs = [r for r in port["capacity"][0]["metrics"] if "loss" in r]
    assert recs and all(set(r) == KEYS | {"exchange_dropped"} for r in recs)
    drops = [r["exchange_dropped"] for r in recs]
    assert all(d == int(d) for d in drops) and sum(drops) > 0, drops


def test_cli_trains_on_two_ranks(tmp_path):
    cfg = config(tmp_path, "cli", mesh=(1, 2), sparse=True,
                 row_shard="shuffle", max_steps=3, steps_per_checkpoint=2)
    path = tmp_path / "cfg.json"
    path.write_text(port_json(cfg))
    res = run_ranks("train", 2, tmp_path, {"cases": [{
        "argv": ["--config", str(path)],
        "train_dir": cfg.train.train_dir}]})
    outs = [r[0] for r in res]
    assert [r["rc"] for r in outs] == [0, 0]
    summaries = [json.loads(r["stdout"].strip().splitlines()[-1])
                 for r in outs]
    assert summaries[0] == summaries[1] and summaries[0]["steps"] == 3
    assert [r["step"] for r in outs[0]["metrics"] if "loss" in r] == [2]
    assert "metrics" not in outs[1]
    assert Checkpointer(cfg.train.train_dir).latest_step() == 3
    one = Config.from_json(port_json(cfg)).override(
        {"mesh.data": 1, "mesh.model": 1})
    tr = Trainer(one, serve_only=True, device="cpu")
    assert int(tr.state.step) == 3
    assert tr.evaluate() == pytest.approx(summaries[0]["recall_at_k"],
                                          abs=1e-6)
