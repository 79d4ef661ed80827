"""The slice as a whole: arec_torch's `Recommender.from_histories` against
arec's, on the same trained weights, for both cells.

A tiny attribute-aware LSTM or GRU is trained with arec's Trainer (plain
scan, f32, as tests/test_serve.py does). arec's Recommender then serves it
with `use_pallas_scan=True`, so its queries run the Pallas forward kernel
of that cell (interpret mode on the CPU), and the weights go through the
bridge into the port's Recommender on the CPU. Query states are held to rtol 1e-4 /
atol 1e-5 (tests/test_seq.py's forward tolerance); ids are equal up to
ties (torch_topk_check)."""

import dataclasses
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arec.config import Config, DataConfig, ModelConfig, TrainConfig
from arec.serve import Recommender as JRecommender
from arec.train.loop import Trainer
from arec_torch import serve as tserve
from arec_torch.cli.main import load_config, parse_args
from arec_torch.config import Config as TConfig
from arec_torch.data.io import load_or_prepare
from arec_torch.models.seq import SeqSpec, init_seq
from arec_torch.train.loop import _query_fn
from torch_topk_check import assert_ids_equal_up_to_ties, ref_scores

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SERVE_BATCH = 16


@pytest.fixture(scope="module", params=["lstm", "gru"])
def served(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"slice_{request.param}")
    cfg = Config(
        data=DataConfig(dataset="synthetic", data_dir=str(tmp / "d"),
                        syn_users=300, syn_items=250, syn_interactions=8000),
        # threshold 16: item ids take the identity gather, genres the
        # gathered mulhot, category/year the dense map
        model=ModelConfig(model="lstm", cell=request.param, dim=16,
                          use_attributes=True,
                          max_seq_len=8, use_pallas_scan=False,
                          dense_vocab_threshold=16),
        train=TrainConfig(batch_size=64, num_sampled=32, n_epoch=1,
                          steps_per_checkpoint=500, compute_dtype="float32",
                          train_dir=str(tmp / "t")))
    tr = Trainer(cfg)
    tr.train()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, use_pallas_scan=True))
    jrec = JRecommender(cfg, serve_batch=SERVE_BATCH)
    params = jax.tree.map(np.asarray, jrec._params)
    trec = tserve.Recommender(TConfig.from_json(cfg.to_json()), params,
                              serve_batch=SERVE_BATCH, device="cpu")
    hists = [[int(x) for x in tr.ds.hist_items[u][: tr.ds.hist_lengths[u]]]
             for u in range(40)]
    return jrec, trec, hists


def _port_queries(trec, histories, **kw):
    """The port's query states and seen slabs for `histories`, batch by
    batch, as from_histories forms them."""
    qs, seens, batches = [], [], []
    for batch, n in trec._history_batches(histories, **kw):
        tb = {k: torch.from_numpy(v) for k, v in batch.items()
              if k != "seen"}
        with torch.inference_mode():
            q = _query_fn(trec.spec, trec._params, trec._item_dev,
                                 trec._user_dev, tb)
        qs.append(q[:n].numpy())
        seens.append(batch["seen"][:n])
        batches.append(batch)
    return np.concatenate(qs), np.concatenate(seens), batches


def _requests(hists, kind):
    if kind == "short":                       # shorter than one segment
        return [h[-5:] for h in hists[:20]], {}
    if kind == "long":                        # > 2·L: three carried segments
        return [(h * 4)[:21] for h in hists[:20]], {}
    if kind == "explicit_seen":
        reqs = [h[-12:] for h in hists[:20]]
        return reqs, {"seen": [h[:3] + [7, 7] for h in hists[:20]]}
    if kind in ("one", "nine"):               # below serve_batch: a bucket
        return [h[-12:] for h in hists[:{"one": 1, "nine": 9}[kind]]], {}
    raise ValueError(kind)


# each call's batches' rows: 20 requests at SERVE_BATCH 16 are 16 + 4
# live (buckets 16, the cap, and 8); 1 takes bucket 8, 9 the cap
ROWS = {"short": [16, 8], "long": [16, 8], "explicit_seen": [16, 8],
        "one": [8], "nine": [16]}


@pytest.mark.parametrize("kind", ["short", "long", "explicit_seen", "one",
                                  "nine"])
def test_from_histories_matches_arec(served, kind):
    """The port's batches at their row buckets against arec's, which pads
    every batch to serve_batch: the same ids up to ties."""
    jrec, trec, hists = served
    reqs, kw = _requests(hists, kind)
    want = jrec.from_histories(reqs, **kw)
    got = trec.from_histories(reqs, **kw)
    assert got.shape == want.shape == (len(reqs), 30)
    assert got.dtype == np.int32
    # ids up to ties, judged on the port's own query states
    q, seen, batches = _port_queries(trec, reqs, **kw)
    assert [len(b["inputs"]) for b in batches] == ROWS[kind]
    v, b = (x.float().numpy() for x in trec._vb)
    scores = ref_scores(q, v, b, seen)
    want_vals = np.take_along_axis(scores, want.astype(np.int64), axis=1)
    assert_ids_equal_up_to_ties(got, want_vals, want, scores)
    for row, s in zip(got, seen):
        assert not set(row.tolist()) & set(s[s >= 0].tolist())


@pytest.mark.parametrize("kind", ["short", "long"])
def test_query_states_match_arec(served, kind):
    """The kernel path's final states, segments carried, against arec's
    Pallas-kernel queries on the same padded batches."""
    jrec, trec, hists = served
    reqs, kw = _requests(hists, kind)
    q, _, batches = _port_queries(trec, reqs, **kw)
    t = jrec._trainer
    want = np.concatenate([
        np.asarray(t._query_fn(jrec._params, {
            "inputs": jnp.asarray(bt["inputs"]),
            "mask": jnp.asarray(bt["mask"])}))
        for bt in batches])[: len(reqs)]
    np.testing.assert_allclose(q, want, rtol=1e-4, atol=1e-5)


def test_empty_request_list(served):
    jrec, trec, _ = served
    assert trec.from_histories([]).shape == jrec.from_histories([]).shape \
        == (0, 30)


def test_serve_loop_lines(served):
    _, trec, hists = served
    h = hists[1][-6:]
    line = ",".join(map(str, h))
    inp = io.StringIO(f"{line}\n\nnot,ids\n!step\n!refresh\n!quit\n4,5\n")
    out = io.StringIO()
    assert tserve._serve_loop(trec, inp, out) == 0
    lines = out.getvalue().strip().split("\n")
    want = ",".join(map(str, trec.from_histories([h])[0].tolist()))
    assert lines[0] == f"{line}\t{want}"
    assert not set(h) & {int(x) for x in want.split(",")}
    assert lines[1].startswith("!err ValueError")
    assert lines[2] == "!ok step None"
    # handed-in weights follow no checkpoint: !refresh answers !err
    assert lines[3].startswith("!err RuntimeError: refresh follows")
    assert len(lines) == 4                     # nothing served after !quit


# ---------------------------------------------------------------------------
# MF family: for_users and the MF loop lines against arec's Recommender
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served_mf(tmp_path_factory):
    """A tiny attribute-aware MF trained by arec's Trainer with the sparse
    step (so its state holds packed [V, 2D] Adagrad tables); arec serves
    it from the checkpoint, the port from the packed tree as it is."""
    tmp = tmp_path_factory.mktemp("slice_mf")
    cfg = Config(
        data=DataConfig(dataset="synthetic", data_dir=str(tmp / "d"),
                        syn_users=300, syn_items=250, syn_interactions=8000),
        model=ModelConfig(model="mf", dim=16, use_attributes=True,
                          dense_vocab_threshold=16),
        train=TrainConfig(batch_size=64, num_sampled=32, n_epoch=1,
                          steps_per_checkpoint=500, compute_dtype="float32",
                          sparse_update=True, train_dir=str(tmp / "t")))
    tr = Trainer(cfg)
    tr.train()
    jrec = JRecommender(cfg, serve_batch=SERVE_BATCH)
    packed = jax.tree.map(np.asarray, jrec._trainer.state.params)
    tcfg = TConfig.from_json(cfg.to_json())
    trec = tserve.Recommender(tcfg, packed, serve_batch=SERVE_BATCH,
                              device="cpu")
    users = np.arange(40, dtype=np.int32)
    seen = [tr.ds.seen_items[u][tr.ds.seen_items[u] >= 0].tolist()
            for u in users]
    return jrec, trec, tcfg, users, seen


def _mf_scores(trec, users, seen):
    tb = {"user": torch.from_numpy(users)}
    with torch.inference_mode():
        q = _query_fn(trec.spec, trec._params, trec._item_dev,
                             trec._user_dev, tb).numpy()
    v, b = (x.float().numpy() for x in trec._vb)
    return ref_scores(q, v, b, tserve._pad_seen(
        seen, len(users), tserve._bucket_width(seen, 32)))


@pytest.mark.parametrize("with_seen, n", [(True, 40), (False, 40), (True, 1),
                                          (True, 9)],
                         ids=["True", "False", "one", "nine"])
def test_for_users_matches_arec(served_mf, with_seen, n):
    """40 users are batches of 16, 16 and 8 live rows (buckets 16, 16, 8),
    1 user bucket 8, 9 users the cap 16; arec pads each to 16."""
    jrec, trec, _, users, seen = served_mf
    users, seen = users[:n], seen[:n]
    seen = seen if with_seen else None
    want = jrec.for_users(users, seen=seen)
    got = trec.for_users(users, seen=seen)
    assert got.shape == want.shape == (len(users), 30)
    assert got.dtype == np.int32
    scores = _mf_scores(trec, users, seen)
    want_vals = np.take_along_axis(scores, want.astype(np.int64), axis=1)
    assert_ids_equal_up_to_ties(got, want_vals, want, scores)
    if seen is not None:
        for row, s in zip(got, seen):
            assert not set(row.tolist()) & set(s)


def test_mf_queries_and_latents_match_arec(served_mf):
    """The port, served from the packed tree, holds arec's unpacked eval
    params: user latents and the item latent matrix agree."""
    jrec, trec, _, users, _ = served_mf
    t = jrec._trainer
    want_q = np.asarray(t._query_fn(jrec._params,
                                    {"user": jnp.asarray(users)}))
    tb = {"user": torch.from_numpy(users)}
    with torch.inference_mode():
        got_q = _query_fn(trec.spec, trec._params, trec._item_dev,
                                 trec._user_dev, tb)
    np.testing.assert_allclose(got_q.numpy(), want_q, rtol=1e-4, atol=1e-5)
    for got, want in zip(trec._vb, jrec._vb):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-4, atol=1e-5)


def test_plain_and_packed_trees_serve_alike(served_mf):
    jrec, trec, tcfg, users, seen = served_mf
    plain = tserve.Recommender(tcfg, jax.tree.map(np.asarray, jrec._params),
                               serve_batch=SERVE_BATCH, device="cpu")
    np.testing.assert_array_equal(plain.for_users(users, seen=seen),
                                  trec.for_users(users, seen=seen))
    bad = jax.tree.map(np.asarray, jrec._params)
    bad["item"]["tables"]["__fused__"] = bad["item"]["tables"][
        "__fused__"][:, :5]
    with pytest.raises(ValueError, match="neither plain"):
        tserve.Recommender(tcfg, bad, serve_batch=SERVE_BATCH, device="cpu")


def test_mf_family_refuses_histories(served_mf):
    _, trec, *_ = served_mf
    with pytest.raises(ValueError, match="sequence family"):
        trec.from_histories([[1, 2]])
    assert trec.for_users([]).shape == (0, 30)


def test_mf_serve_loop_lines(served_mf):
    _, trec, _, users, seen = served_mf
    u = int(users[3])
    s = seen[3][:4]
    inp = io.StringIO(f"{u}\t{','.join(map(str, s))}\n{u}\nx\n!step\n"
                      f"!quit\n{u}\n")
    out = io.StringIO()
    assert tserve._serve_loop(trec, inp, out) == 0
    lines = out.getvalue().strip().split("\n")
    with_seen = trec.for_users([u], seen=[s])[0].tolist()
    plain = trec.for_users([u])[0].tolist()
    assert lines[0] == f"{u}\t{','.join(map(str, with_seen))}"
    assert not set(s) & set(with_seen)
    assert lines[1] == f"{u}\t{','.join(map(str, plain))}"
    assert lines[2].startswith("!err ValueError")
    assert lines[3] == "!ok step None"
    assert len(lines) == 4                     # nothing served after !quit


def test_seq_family_refuses_users(served):
    _, trec, _ = served
    with pytest.raises(ValueError, match="MF family"):
        trec.for_users([1, 2])


@pytest.mark.parametrize("config,mesh_data", [
    ("syn_lstm.json", 1), ("syn_lstm.json", 2), ("syn_sharded.json", 2)])
def test_recommender_refuses_a_device_mesh(tmp_path, config, mesh_data):
    """`Recommender` serves on a mesh that spans more than one device
    (syn_lstm.json with mesh.data = 2 on 2 gloo ranks; syn_sharded.json's
    MF on 2 x 4, 8 ranks), each rank answering the whole request list, as
    on the 1 x 1 config; and training on the mesh, refused until mesh
    training was ported, now runs in the same group first: 2 steps, the
    same summary on every rank, a checkpoint at step 2."""
    from arec_torch import bridge
    from arec_torch.models.mf import MFSpec, init_mf
    from arec_torch.train.checkpoint import Checkpointer
    from torch_mesh_worker import run_ranks

    cfg = load_config(parse_args([
        "--config", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "configs", config),
        "--set", f"mesh.data={mesh_data}", "--set", "model.dim=8",
        "--set", f"data.data_dir={tmp_path}", "--set", "data.syn_users=60",
        "--set", "data.syn_items=50", "--set", "data.syn_interactions=600"]))
    ds = load_or_prepare(cfg.data)
    gen = torch.Generator().manual_seed(0)
    if cfg.model.model == "lstm":
        spec = SeqSpec.from_config(cfg, ds.user_schema, ds.item_schema)
        params, req = init_seq(gen, spec), {"histories": [[1, 2, 3], [4]]}
    else:
        spec = MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
        params, req = init_mf(gen, spec), {"users": np.array([1, 2],
                                                             np.int32)}
    world = cfg.mesh.data * cfg.mesh.model
    if world == 1:
        rec = tserve.Recommender(cfg, params, serve_batch=4, device="cpu")
        ids = [rec.from_histories(req["histories"])]
    else:
        tcfg = cfg.override({"train.max_steps": 2,
                             "train.train_dir": str(tmp_path / "t")})
        res = run_ranks("chain", world, tmp_path, {"cases": [
            ("train", {"cases": [{"config": tcfg.to_json(),
                                  "train_dir": tcfg.train.train_dir}]}),
            ("recommend", {"cases": [{
                "config": cfg.to_json(), "params": bridge.to_numpy(params),
                "serve_batch": 4, "family": cfg.model.model,
                "out_dir": str(tmp_path), **req}]})]})
        trained = [r[0][0]["summary"] for r in res]
        assert all(t == trained[0] for t in trained)
        assert trained[0]["steps"] == 2
        assert Checkpointer(tcfg.train.train_dir).latest_step() == 2
        ids = [r[1][0]["ids"] for r in res]
    for got in ids:
        assert got.shape == (2, cfg.train.eval_topk)
        np.testing.assert_array_equal(got, ids[0])
    if "histories" in req:
        assert not {1, 2, 3} & set(ids[0][0].tolist())


# ---------------------------------------------------------------------------
# Serving from a checkpoint: arec's Orbax checkpoints handed over through the
# bridge into the port's own checkpoint, refresh, the refusal of an empty
# train_dir, and `python -m arec_torch.serve`
# ---------------------------------------------------------------------------

def _port_checkpoint_of(jrec, train_dir, sparse):
    """arec's latest Orbax checkpoint, read by arec's Checkpointer, bridged
    and written as the port's checkpoint under `train_dir`; returns the
    config that serves it."""
    from arec.train.checkpoint import Checkpointer as JCheckpointer
    from arec.train.checkpoint import abstract_like as jabstract_like
    from arec_torch import bridge
    from arec_torch.train.checkpoint import Checkpointer

    jstate, _, _ = JCheckpointer(jrec.cfg.train.train_dir).restore(
        jabstract_like(jrec._trainer.state))
    jstate = jax.tree.map(np.asarray, jstate)
    state = (bridge.sparse_train_state_from_arec(jstate) if sparse
             else bridge.train_state_from_arec(jstate))
    cfg = TConfig.from_json(jrec.cfg.to_json())
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, train_dir=str(train_dir)))
    Checkpointer(str(train_dir)).save(int(state.step), state,
                                      {"epoch": 0, "step_in_epoch": 0},
                                      cfg.to_json())
    return cfg


def test_mf_arec_checkpoint_served_from_the_ports(served_mf, tmp_path):
    jrec, trec, _, users, seen = served_mf
    cfg = _port_checkpoint_of(jrec, tmp_path / "t", sparse=True)
    rec = tserve.Recommender(cfg, serve_batch=SERVE_BATCH, device="cpu")
    assert rec._restored_step == jrec._restored_step
    got = rec.for_users(users, seen=seen)
    np.testing.assert_array_equal(got, trec.for_users(users, seen=seen))
    want = jrec.for_users(users, seen=seen)
    scores = _mf_scores(rec, users, seen)
    assert_ids_equal_up_to_ties(
        got, np.take_along_axis(scores, want.astype(np.int64), axis=1),
        want, scores)


def test_seq_arec_checkpoint_served_from_the_ports(served, tmp_path):
    jrec, trec, hists = served
    cfg = _port_checkpoint_of(jrec, tmp_path / "t", sparse=False)
    rec = tserve.Recommender(cfg, serve_batch=SERVE_BATCH, device="cpu")
    reqs, kw = _requests(hists, "long")
    got = rec.from_histories(reqs, **kw)
    np.testing.assert_array_equal(got, trec.from_histories(reqs, **kw))
    want = jrec.from_histories(reqs, **kw)
    q, seen, _ = _port_queries(rec, reqs, **kw)
    v, b = (x.float().numpy() for x in rec._vb)
    scores = ref_scores(q, v, b, seen)
    assert_ids_equal_up_to_ties(
        got, np.take_along_axis(scores, want.astype(np.int64), axis=1),
        want, scores)


def _mf_cfg(tmp_path, sparse, n_epoch=1):
    return TConfig.from_json(Config(
        data=DataConfig(dataset="synthetic", data_dir=str(tmp_path / "d"),
                        syn_users=300, syn_items=250, syn_interactions=8000),
        model=ModelConfig(model="mf", dim=16, use_attributes=True,
                          dense_vocab_threshold=16),
        train=TrainConfig(batch_size=64, num_sampled=32, n_epoch=n_epoch,
                          steps_per_checkpoint=500, compute_dtype="float32",
                          sparse_update=sparse,
                          train_dir=str(tmp_path / "t"))).to_json())


@pytest.mark.parametrize("sparse", [False, True])
def test_refresh_follows_training(tmp_path, sparse):
    """After arec's tests/test_serve.py:162: a standing Recommender picks up
    the newest checkpoint in place and then answers as a freshly built one
    (and as the trainer's in-memory state), keeping its step function; with
    no newer checkpoint refresh is a no-op returning False."""
    from arec_torch.train.loop import Trainer as TTrainer

    TTrainer(_mf_cfg(tmp_path, sparse), device="cpu").train()
    rec = tserve.Recommender(_mf_cfg(tmp_path, sparse), serve_batch=16,
                             device="cpu")
    users = np.arange(0, 40, 2, dtype=np.int32)
    seen = [[int(x) for x in row if x >= 0]
            for row in rec._ds.seen_items[users]]
    before = rec.for_users(users, seen=seen)
    assert rec.refresh() is False

    tr2 = TTrainer(_mf_cfg(tmp_path, sparse, n_epoch=2), device="cpu")
    tr2.train()
    final = int(tr2.state.step)
    step_fn = rec._step
    assert rec.refresh() is True
    assert rec._restored_step == final and rec._step is step_fn
    after = rec.for_users(users, seen=seen)
    assert not np.array_equal(after, before)
    fresh = tserve.Recommender(_mf_cfg(tmp_path, sparse), serve_batch=16,
                               device="cpu")
    np.testing.assert_array_equal(after, fresh.for_users(users, seen=seen))
    in_memory = tserve.Recommender(_mf_cfg(tmp_path, sparse),
                                   tr2._eval_params(), serve_batch=16,
                                   device="cpu")
    np.testing.assert_array_equal(after,
                                  in_memory.for_users(users, seen=seen))
    out = io.StringIO()
    tserve._serve_loop(rec, io.StringIO("!step\n!refresh\n"), out)
    assert out.getvalue().split("\n")[:2] == [
        f"!ok step {final}", f"!ok current step {final}"]


def test_refuses_an_empty_train_dir(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tserve.Recommender(_mf_cfg(tmp_path, True), device="cpu")
    assert not os.path.exists(tmp_path / "t")   # nothing written there


def test_serve_main_from_a_checkpoint(tmp_path):
    """`python -m arec_torch.serve` restores, prints its banner and answers
    the line protocol."""
    from arec_torch.cli.main import main as cli_main

    argv = ["--config", os.path.join(ROOT, "configs", "syn_mf.json")] + [
        a for k, v in {"data.data_dir": tmp_path / "d",
                       "data.syn_users": 200, "data.syn_items": 150,
                       "data.syn_interactions": 4000, "model.dim": 8,
                       "train.batch_size": 32, "train.num_sampled": 16,
                       "train.max_steps": 16,
                       "train.steps_per_checkpoint": 8,
                       "train.compute_dtype": "float32",
                       "train.train_dir": tmp_path / "t"}.items()
        for a in ("--set", f"{k}={v}")]
    assert cli_main(argv, device="cpu") == 0
    out = io.StringIO()
    assert tserve.main(argv, io.StringIO("3\n!step\nx\n!quit\n4\n"), out,
                       device="cpu") == 0
    lines = out.getvalue().strip().split("\n")
    assert lines[0] == (f"!ok serving {tmp_path / 't'} step 16 (user ids on "
                        f"stdin; !refresh / !step / !quit)")
    rec = tserve.Recommender(load_config(parse_args(argv)), device="cpu")
    assert lines[1] == "3\t" + ",".join(
        map(str, rec.for_users([3])[0].tolist()))
    assert lines[2] == "!ok step 16"
    assert lines[3].startswith("!err ValueError")
    assert len(lines) == 4


# ---------------------------------------------------------------------------
# The graph path's shapes: on one card a call replays the captured step of
# its key; these hold, on the CPU, the widths and keys it takes and when it
# engages (its replays are held to the eager path in
# tests/test_torch_serve_graph_cuda.py)
# ---------------------------------------------------------------------------

def _by_32(monkeypatch):
    """Seen slabs sized as before the buckets: the longest seen row
    rounded up to a multiple of 32."""
    def width(seen, floor):
        w = max((len(row) for row in seen or ()), default=0)
        return -(-max(w, 1) // 32) * 32
    monkeypatch.setattr(tserve, "_bucket_width", width)


def _seen_widths(rec, histories, **kw):
    return {b["seen"].shape[1] for b, _ in rec._history_batches(histories,
                                                                **kw)}


@pytest.mark.parametrize("segments", [1, 2])
def test_bucket_width_serves_todays_ids_seq(served, segments, monkeypatch):
    """The seen slab at its bucket width (n·L rounded up to 32) holds the
    same lists as at the longest row rounded up to 32: the extra −1 name
    no item. L = 40 so that the two widths differ: 1 segment of ≤ 32
    items → 64 against 32, 2 segments of 41–64 → 96 against 64."""
    _, trec, hists = served
    cfg = dataclasses.replace(trec.cfg, model=dataclasses.replace(
        trec.cfg.model, max_seq_len=40))
    rec = tserve.Recommender(cfg, trec._params, serve_batch=SERVE_BATCH,
                             device="cpu")
    assert rec._graphs is None                 # the CPU: eager
    lengths = (20, 32) if segments == 1 else (41, 64)
    reqs = [(h * 64)[:lengths[i % 2] - i % 3] for i, h in
            enumerate(hists[:24]) if h]
    got, got_w = rec.from_histories(reqs), _seen_widths(rec, reqs)
    _by_32(monkeypatch)
    want, want_w = rec.from_histories(reqs), _seen_widths(rec, reqs)
    assert want_w == {32 * segments} and got_w == {32 + 32 * segments}
    np.testing.assert_array_equal(got, want)


def test_bucket_width_serves_todays_ids_mf(served_mf, monkeypatch):
    """MF: seen lists of 65–70 ids take a slab of 128 (their bucket) in
    place of 96 (rounded up to 32); the lists are the same."""
    _, trec, _, users, seen = served_mf
    assert trec._graphs is None
    rng = np.random.default_rng(0)
    long_seen = [s + rng.integers(0, 250, 65 + i % 6 - len(s)).tolist()
                 for i, s in enumerate(seen)]
    assert tserve._bucket_width(long_seen, 32) == 128
    got = trec.for_users(users, seen=long_seen)
    _by_32(monkeypatch)
    assert tserve._bucket_width(long_seen, 32) == 96
    np.testing.assert_array_equal(trec.for_users(users, seen=long_seen),
                                  got)


@pytest.mark.parametrize("device, sharded, target, graphed", [
    ("cpu", False, 1.0, False),
    ("cuda", True, 1.0, False),       # a mesh: its gathers are collectives
    ("cuda", False, 0.95, False),     # the approximate top-k
    ("cuda", False, 1.0, True),
])
def test_graph_path_only_on_one_card_with_the_exact_topk(device, sharded,
                                                         target, graphed):
    assert tserve._graphed(torch.device(device), sharded, target) is graphed


@pytest.mark.parametrize("longest, floor, width", [
    (0, 32, 32), (1, 32, 32), (32, 32, 32), (33, 32, 64), (64, 32, 64),
    (65, 32, 128), (200, 32, 256), (50, 64, 64), (100, 128, 128),
    (129, 128, 256),
])
def test_seen_width_rounds_up_to_its_bucket(longest, floor, width):
    assert tserve._bucket_width([[1] * longest, [2]], floor) == width


def test_history_key_follows_its_segment_count(served):
    """A history batch's key is its segment count and its bucket width:
    one key for every call of n segments (L = 8, so n·L rounds up to 32),
    whatever the lengths inside."""
    _, trec, hists = served
    L = trec.spec.max_seq_len

    def keys(lengths):
        reqs = [(hists[0] * 64)[:n] for n in lengths]
        return {tserve._graph_key(b) for b, _ in trec._history_batches(reqs)}

    one, two = keys([1, L]), keys([L + 1, 2 * L])
    assert len(one) == len(two) == 1 and one != two
    assert keys([3]) == one and keys([2 * L - 1, 2]) == two
    (k1,), (k2,) = one, two
    shapes = {name: shape for name, shape, _ in k1}
    assert shapes["inputs"] == (8, L)         # 2 requests: row bucket 8
    assert shapes["seen"] == (8, 32)
    assert {name: shape for name, shape, _ in k2}["inputs"] == (8, 2 * L)
    # more requests, a larger bucket, another key
    assert keys([1] * 9) != one and keys([1] * 16) == keys([1] * 9)


@pytest.mark.parametrize("n_live, serve_batch, sharded, rows", [
    (1, 256, False, 8), (8, 256, False, 8), (9, 256, False, 32),
    (32, 256, False, 32), (33, 256, False, 128), (200, 256, False, 256),
    (256, 256, False, 256),
    (1, 4, False, 4), (4, 4, False, 4),       # the cap below the least
    (9, 64, False, 32), (33, 64, False, 64),  # the cap between buckets
    (1, 256, True, 256), (33, 64, True, 64),  # a mesh: serve_batch
])
def test_row_bucket(n_live, serve_batch, sharded, rows):
    assert tserve._bucket_rows(n_live, serve_batch, sharded) == rows
