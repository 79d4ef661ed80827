"""arec_torch's Trainer against arec's on the same config: the eval and
save cadence (the metrics' steps, the checkpoint steps), and, on an
arec-trained tiny model whose state is bridged in, `evaluate()` (Recall
equal) and `recommend()` (ids equal up to ties, torch_topk_check); the
config knobs it honours or refuses."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from arec.config import Config as JConfig
from arec.train.loop import Trainer as JTrainer
from arec_torch import bridge
from arec_torch.config import (
    Config, DataConfig, MeshConfig, ModelConfig, TrainConfig,
)
from arec_torch.train.loop import Trainer
from arec_torch.train.step import _leaves
from torch_topk_check import assert_ids_equal_up_to_ties, ref_scores

torch.set_num_threads(1)

FAMILIES = {
    "mf_dense": dict(model="mf", dim=16, dense_vocab_threshold=16),
    "mf_sparse": dict(model="mf", dim=16, dense_vocab_threshold=16),
    "lstm": dict(model="lstm", dim=16, max_seq_len=8,
                 use_pallas_scan=False, dense_vocab_threshold=16),
}


def _cfg(tmp, family, train_dir):
    return Config(
        data=DataConfig(dataset="synthetic", data_dir=str(tmp / "d"),
                        syn_users=300, syn_items=250, syn_interactions=8000),
        model=ModelConfig(use_attributes=True, **FAMILIES[family]),
        # 4 LSTM batches an epoch, 120 MF ones
        train=TrainConfig(batch_size=64, num_sampled=32, n_epoch=12,
                          max_steps=45, steps_per_checkpoint=10,
                          save_every_evals=2, eval_batch_size=64,
                          compute_dtype="float32",
                          sparse_update=family == "mf_sparse",
                          train_dir=str(tmp / train_dir)))


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def trained(request, tmp_path_factory):
    """The same config trained by arec's Trainer and by the port's, and a
    port Trainer holding arec's trained state (bridged)."""
    family = request.param
    tmp = tmp_path_factory.mktemp(family)
    cfg = _cfg(tmp, family, "t_port")
    jcfg = JConfig.from_json(_cfg(tmp, family, "t_arec").to_json())
    jtr = JTrainer(jcfg)
    jtr.train()
    port = Trainer(cfg, device="cpu")
    port.train()
    port.close()
    held = Trainer(_cfg(tmp, family, "t_held"), serve_only=True,
                   device="cpu")
    state = jax.tree.map(np.asarray, jtr.state)
    held.state = (bridge.sparse_train_state_from_arec(state)
                  if family == "mf_sparse"
                  else bridge.train_state_from_arec(state))
    return family, tmp, jtr, port, held


def _metric_steps(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["step"] for line in f]


def _ckpt_steps(train_dir):
    return sorted(int(n) for n in os.listdir(os.path.join(train_dir, "ckpt"))
                  if n.isdigit())


def test_cadence_equals_arecs(trained):
    """Evals every 10 steps, a save every 2nd eval, the final checkpoint
    at max_steps, keep 3: the same steps on both sides."""
    _, tmp, jtr, port, _ = trained
    want = _metric_steps(jtr.cfg.train.train_dir)
    assert want == [10, 20, 30, 40, 45]
    assert _metric_steps(port.cfg.train.train_dir) == want
    assert _ckpt_steps(port.cfg.train.train_dir) == _ckpt_steps(
        jtr.cfg.train.train_dir) == [20, 40, 45]
    assert int(port.state.step) == int(jtr.state.step) == 45


def test_bridged_state_holds_arecs_values(trained):
    family, _, jtr, _, held = trained
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jtr.state.params)]
    got = _leaves(held.state.params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_evaluate_matches_arec(trained):
    _, _, jtr, _, held = trained
    want = jtr.evaluate(exact=True)
    assert held.evaluate(exact=True) == want
    assert held.evaluate() == jtr.evaluate()


def _port_scores(tr):
    """float64 masked scores of every eval row, from the port's queries."""
    from arec_torch.data.dataset import eval_batches
    params = tr._eval_params()
    with torch.no_grad():
        v, b = (x.float().numpy() for x in tr._item_latents(params))
        out = []
        L = tr.spec.pack_len if tr.is_seq else 0
        for batch in eval_batches(tr.ds, tr.cfg.train.eval_batch_size,
                                  max_seq_len=L):
            tb, seen = tr._stage_eval(batch)
            q = tr._query_fn(params, tb).numpy()
            ok = batch["valid"] > 0
            out.append(ref_scores(q[ok], v, b, seen.numpy()[ok]))
    return np.concatenate(out)


def test_recommend_matches_arec(trained, tmp_path):
    _, _, jtr, _, held = trained
    want = jtr.recommend(out_path=str(tmp_path / "arec.tsv"))
    got = held.recommend(out_path=str(tmp_path / "port.tsv"))
    assert [u for u, _ in got] == [u for u, _ in want]
    got_ids = np.array([r for _, r in got])
    want_ids = np.array([r for _, r in want])
    scores = _port_scores(held)
    want_vals = np.take_along_axis(scores, want_ids, axis=1)
    assert_ids_equal_up_to_ties(got_ids, want_vals, want_ids, scores)
    lines = (tmp_path / "port.tsv").read_text().splitlines()
    assert lines == [f"{u}\t{','.join(map(str, r))}" for u, r in got]
    assert len(lines) == len((tmp_path / "arec.tsv").read_text()
                             .splitlines())


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

def _tiny(tmp_path, **train):
    return Config(
        data=DataConfig(syn_users=120, syn_items=90, syn_interactions=2400,
                        data_dir=str(tmp_path / "data")),
        model=ModelConfig(model="mf", dim=8),
        train=TrainConfig(batch_size=32, compute_dtype="float32",
                          **{"train_dir": str(tmp_path / "t"), **train}))


TIMING = ("t", "examples_per_s", "examples_per_s_per_chip")

# Each case: the Trainer's runs (the train knobs of each invocation, in
# one train_dir), the model, and the steps a K = 4 run must dispatch K at
# a time. mf_sparse: max_steps 74, not a multiple of K, across an epoch of
# 71 batches that ends mid-group; lstm: the dense step of the sequence
# model (its scan and CE wrappers) over epochs of 14 batches, each ending
# mid-group; resume: 10 steps, then a second
# invocation to 30 that restores step 10, off the K grid; plateau: a
# learning rate high enough that a window's mean loss rises, so an eval
# inside the K = 4 run decays the lr (asserted below).
DISPATCH_CASES = {
    "mf_sparse": (dict(max_steps=74, n_epoch=2, steps_per_checkpoint=8,
                       sparse_update=True), [{}], "mf",
                  list(range(0, 68, 4))),
    "mf_dense": (dict(max_steps=30, steps_per_checkpoint=8), [{}], "mf",
                 [0, 4, 8, 12, 16, 20, 24]),
    "lstm": (dict(max_steps=22, steps_per_checkpoint=4, n_epoch=4,
                  batch_size=8), [{}], "lstm", [0, 4, 8, 16]),
    "resume": (dict(steps_per_checkpoint=8, sparse_update=True),
               [dict(max_steps=10), dict(max_steps=30)], "mf",
               [0, 4, 12, 16, 20, 24]),
    "plateau": (dict(max_steps=48, steps_per_checkpoint=4,
                     learning_rate=3.0, save_every_evals=3), [{}], "mf",
                list(range(0, 48, 4))),
}


def _dispatch_run(tmp_path, k, case):
    """The case's invocations at steps_per_dispatch k: (metrics records
    less their timings, {checkpoint step: its state}, the final state, the
    global steps at which K steps were dispatched)."""
    train, runs, model, _ = DISPATCH_CASES[case]
    d = tmp_path / f"k{k}"
    train = dict(train)
    batch = train.pop("batch_size", 32)
    cfg = _tiny(tmp_path, steps_per_dispatch=k, train_dir=str(d),
                **train).override({"train.batch_size": batch})
    if model == "lstm":
        cfg = cfg.replace(model=ModelConfig(model="lstm", dim=8,
                                            max_seq_len=6,
                                            use_pallas_scan=True))
    dispatched = []
    for run in runs:
        tr = Trainer(cfg.override({f"train.{a}": v for a, v in run.items()}),
                     device="cpu")
        if k > 1:
            multi = tr.multi_step_fn

            def counted(state, batches, gens, multi=multi):
                dispatched.append(int(state.step))
                return multi(state, batches, gens)
            tr.multi_step_fn = counted
        tr.train()
        tr.close()
    with open(d / "metrics.jsonl") as f:
        records = [{a: v for a, v in json.loads(line).items()
                    if a not in TIMING} for line in f]
    ckpts = {s: torch.load(d / "ckpt" / str(s) / "state.pt")
             for s in _ckpt_steps(str(d))}
    return records, ckpts, tr.state, dispatched


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_steps_per_dispatch_equals_single_steps(tmp_path, case):
    """K = 4 steps per dispatch (`make_multi_step` / `make_sparse_multi_step`,
    K single steps of the core on the CPU) against K = 1: the same metrics
    records, checkpoints and final state, bit for bit; K steps go out at
    once only from a K-aligned step with room for K, single steps fill in
    around them (arec's rule)."""
    one = _dispatch_run(tmp_path, 1, case)
    four = _dispatch_run(tmp_path, 4, case)
    assert four[0] == one[0]
    assert sorted(four[1]) == sorted(one[1])
    for step in one[1]:
        for a, b in zip(_leaves(one[1][step]), _leaves(four[1][step])):
            assert torch.equal(a, b), step
    for a, b in zip(_leaves(one[2]._asdict()), _leaves(four[2]._asdict())):
        assert torch.equal(a, b)
    assert four[3] == DISPATCH_CASES[case][3]
    if case == "mf_sparse":
        assert [r["step"] for r in one[0]] == list(range(8, 73, 8)) + [74]
    if case == "plateau":
        lrs = [r["lr"] for r in one[0] if "lr" in r]
        assert min(lrs) < lrs[0], lrs


@pytest.mark.parametrize("k,first", [(1, 10), (8, 8)])
def test_profile_window_at_steps_per_dispatch(tmp_path, monkeypatch, k,
                                              first):
    """AREC_PROFILE_DIR at the default window, steps [10, 15): the Trainer
    writes one trace, at K = 8 too, where the window lies inside the
    dispatch of steps 8..15 (the trace holds whole dispatches and is named
    after the first step it holds)."""
    out = tmp_path / "prof"
    monkeypatch.setenv("AREC_PROFILE_DIR", str(out))
    for var in ("AREC_PROFILE_START", "AREC_PROFILE_STEPS"):
        monkeypatch.delenv(var, raising=False)
    tr = Trainer(_tiny(tmp_path, steps_per_dispatch=k, max_steps=24,
                       steps_per_checkpoint=8), device="cpu")
    tr.train()
    tr.close()
    assert sorted(os.listdir(out)) == [f"trace_steps_{first}.json"]
    with open(out / f"trace_steps_{first}.json") as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("train,err,match", [
    (dict(steps_per_dispatch=8, steps_per_checkpoint=12), ValueError,
     "multiple of steps_per_dispatch"),
    (dict(batch_ht=True), ValueError, "batch_ht"),
])
def test_refused_knobs(tmp_path, train, err, match):
    with pytest.raises(err, match=match):
        Trainer(_tiny(tmp_path, **train), device="cpu")


@pytest.mark.parametrize("model", ["mf", "lstm"])
def test_refuses_a_device_mesh(tmp_path, model):
    """Training on a 2 x 4 mesh, refused until mesh training was ported,
    now runs: `Trainer(cfg).train()` on 8 gloo ranks takes the same steps,
    evaluates and saves on the same cadence as on one device (the
    metrics' and the checkpoints' steps), every rank returns the same
    summary, and a one-device Trainer restores the mesh's checkpoint and
    evaluates to its recall."""
    from arec_torch.data.io import load_or_prepare
    from torch_mesh_worker import run_ranks

    # bf16: the one-device top-k rounds its operands to bf16, the mesh's
    # runs in the compute dtype; in bf16 the two score alike
    cfg = _tiny(tmp_path, max_steps=6, steps_per_checkpoint=2,
                save_every_evals=2).override(
        {"train.compute_dtype": "bfloat16"})
    cfg = cfg.replace(model=ModelConfig(model=model, dim=8, max_seq_len=6),
                      mesh=MeshConfig(data=2, model=4))
    load_or_prepare(cfg.data)
    res = run_ranks("train", 8, tmp_path, {"cases": [{
        "config": cfg.to_json(), "train_dir": cfg.train.train_dir}]})
    outs = [r[0] for r in res]
    assert all(o["summary"] == outs[0]["summary"] for o in outs)
    assert outs[0]["summary"]["steps"] == 6
    # three evals and the final record; saves at every second eval and
    # the end (as on one device)
    assert _metric_steps(cfg.train.train_dir) == [2, 4, 6, 6]
    assert _ckpt_steps(cfg.train.train_dir) == [4, 6]
    one = Trainer(cfg.replace(mesh=MeshConfig()), serve_only=True,
                  device="cpu")
    assert int(one.state.step) == 6
    assert one.evaluate() == pytest.approx(
        outs[0]["summary"]["recall_at_k"], abs=1e-6)


def test_serve_only_trainer_allocates_nothing_and_cannot_train(tmp_path):
    tr = Trainer(_tiny(tmp_path, sparse_update=True), serve_only=True,
                 device="cpu")
    assert all(t.is_meta for t in _leaves(tr.state._asdict()))
    assert not os.path.exists(tmp_path / "t" / "metrics.jsonl")
    with pytest.raises(RuntimeError, match="cannot train"):
        tr.train()
