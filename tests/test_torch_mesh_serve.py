"""Serving on a device mesh: arec_torch on gloo ranks
(tests/torch_mesh_worker.py) against arec on its 8 fake devices.

  * `make_sharded_topk` equals arec's on (2, 4) and (1, 4), exact and with
    recall_target 0.95 (where arec's CPU lowering is exact), and in the
    degenerate case of k above a shard's rows; `pad_item_shards`.
  * `Recommender` on syn_sharded.json's MF at 2 × 4 and on syn_lstm.json at
    2 × 2, from arec's trained weights (bridged into a port checkpoint, and
    handed in as a param tree): lists equal to arec's `Recommender` on the
    same mesh shape up to ties; a serve-only Trainer's `evaluate()` equal
    to arec's, its `recommend()` lists equal up to ties, written by the
    primary rank only.
  * A single-device checkpoint of the port (dense MF, sparse MF with its
    packed tables, the LSTM) restored onto 2 × 4 and 1 × 4, shuffled and
    contiguous, serves the lists it serves on one device.
  * `serve.main` on 2 ranks answers the primary rank's lines on both.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from arec.config import Config as JConfig
from arec.dist.mesh import make_mesh as jmake_mesh
from arec.retrieval.mips import (
    make_sharded_topk as jmake_topk, pad_item_shards as jpad,
)
from arec.serve import Recommender as JRecommender
from arec.train.loop import Trainer as JTrainer
from arec_torch import bridge, serve as tserve
from arec_torch.cli.main import load_config, parse_args
from arec_torch.data.io import load_or_prepare
from arec_torch.retrieval.mips import pad_item_shards
from arec_torch.serve import Recommender
from arec_torch.train.checkpoint import Checkpointer
from arec_torch.train.loop import Trainer
from torch_mesh_worker import run_ranks
from torch_topk_check import (
    assert_ids_equal_up_to_ties, assert_topk_equal_up_to_ties, ref_scores,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"data.syn_users": 200, "data.syn_items": 150,
         "data.syn_interactions": 3000, "model.dim": 8,
         "train.batch_size": 64, "train.num_sampled": 32,
         "train.eval_batch_size": 32, "train.max_steps": 16,
         "train.steps_per_checkpoint": 16}
FAMILIES = {
    "mf": ("syn_sharded.json", {}),
    "lstm": ("syn_lstm.json", {"model.max_seq_len": 6}),
}


def _cfg(family, tmp, train_dir, mesh=(1, 1), **sets):
    name, extra = FAMILIES[family]
    argv = ["--config", os.path.join(ROOT, "configs", name)]
    for k, v in {**SMALL, **extra, "data.data_dir": str(tmp / "data"),
                 "train.train_dir": str(tmp / train_dir),
                 "mesh.data": mesh[0], "mesh.model": mesh[1],
                 **sets}.items():
        argv += ["--set", f"{k}={v}"]
    return load_config(parse_args(argv))


def _jcfg(cfg, **sets):
    """arec's twin of a port config (the scan in plain jnp: arec's Pallas
    kernel does not partition over its mesh in interpret mode)."""
    j = JConfig.from_json(cfg.to_json())
    return j.override({"model.use_pallas_scan": "false", **sets})


def _port_ckpt(state, cfg, step):
    ck = Checkpointer(cfg.train.train_dir)
    ck.save(step, state, {"epoch": 0, "step_in_epoch": step,
                          "prev_loss": None, "window": [],
                          "best_recall": 0.0}, cfg.to_json())


# ---------------------------------------------------------------------------
# the sharded top-k
# ---------------------------------------------------------------------------

def _topk_cases():
    rng = np.random.default_rng(3)
    cases = []
    for mesh, v, k in (((2, 4), 37, 5), ((1, 4), 37, 5), ((2, 4), 10, 5),
                       ((1, 4), 10, 5)):
        for rt in (1.0, 0.95):
            q = rng.normal(size=(8, 16)).astype(np.float32)
            lat = rng.normal(size=(v, 16)).astype(np.float32)
            b = rng.normal(size=v).astype(np.float32) * 0.1
            seen = rng.integers(-1, v, (8, 4)).astype(np.int32)
            cases.append(dict(mesh=mesh, q=q, v=lat, b=b, seen=seen, k=k,
                              recall_target=rt))
    return cases


def _arec_topk(c):
    mesh = jmake_mesh(*c["mesh"])
    v, b = jpad(jax.numpy.asarray(c["v"]), jax.numpy.asarray(c["b"]),
                c["mesh"][1])
    fn = jax.jit(jmake_topk(mesh, k=c["k"], recall_target=c["recall_target"]))
    vals, ids = fn(c["q"], v, b, c["seen"])
    return np.asarray(vals), np.asarray(ids)


def _merge_slabs(results, world, data, key):
    """Rank results of [B/data, ...] slabs → the whole [B, ...] array (the
    model-axis ranks of a slab agree)."""
    per = world // data
    for r in range(world):
        np.testing.assert_array_equal(results[r][key],
                                      results[(r // per) * per][key])
    return np.concatenate([results[d * per][key] for d in range(data)])


# ---------------------------------------------------------------------------
# arec's side and the spawns, once per module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_serve")
    out = {"tmp": tmp}
    for family in FAMILIES:
        cfg = _cfg(family, tmp, f"{family}_arec")
        ds = load_or_prepare(cfg.data)
        jtr = JTrainer(_jcfg(cfg))
        jtr.train()
        jstate = jax.tree.map(np.asarray, jtr.state)
        port = _cfg(family, tmp, f"{family}_port")
        _port_ckpt(bridge.train_state_from_arec(jstate), port, 16)
        jcfg_mesh = _jcfg(_cfg(family, tmp, f"{family}_arec",
                               (2, 4) if family == "mf" else (2, 2)))
        if family == "mf":
            users = ds.valid_users[:24].astype(np.int32)
            seen = [ds.seen_items[u][ds.seen_items[u] >= 0].tolist()
                    for u in users]
            req = {"users": users, "seen": seen}
            want = JRecommender(jcfg_mesh, serve_batch=16).for_users(
                users, seen=seen)
        else:
            hists = [ds.hist_items[u][: ds.hist_lengths[u]].tolist()
                     for u in range(20)]
            req = {"histories": hists}
            want = JRecommender(jcfg_mesh, serve_batch=16).from_histories(
                hists)
        jmesh_tr = JTrainer(jcfg_mesh, serve_only=True)
        out[family] = dict(
            cfg=port, jstate=jstate, req=req, want=want,
            jrecall=jmesh_tr.evaluate(exact=True),
            jrows=jmesh_tr.recommend(),
            one=Recommender(port, serve_batch=16, device="cpu"))
    # the sparse MF step's packed checkpoint, written by the port's Trainer
    sp = _cfg("mf", tmp, "mf_sparse", **{"train.sparse_update": "true"})
    tr = Trainer(sp, device="cpu")
    tr.train()
    tr.close()
    out["mf_sparse"] = dict(cfg=sp, req=out["mf"]["req"],
                            one=Recommender(sp, serve_batch=16, device="cpu"))

    def case(family, mesh, params=None, eval=False, **sets):
        base = out[family]["cfg"]
        cfg = base.override({"mesh.data": mesh[0], "mesh.model": mesh[1],
                             **sets})
        c = {"config": cfg.to_json(), **out[family]["req"],
             "out_dir": str(tmp), "family": family, "mesh": mesh,
             "eval": eval}
        if params is not None:
            c["params"] = params
        return c

    mfp = out["mf"]["jstate"].params
    eight = [case("mf", (2, 4), eval=True),
             case("mf", (2, 4), params=mfp),
             case("mf", (2, 4), **{"mesh.row_shard": "contiguous"}),
             case("mf_sparse", (2, 4)),
             case("lstm", (2, 4), **{"mesh.row_shard": "contiguous"})]
    four = [case("lstm", (2, 2), eval=True),
            case("mf", (1, 4)),
            case("mf", (1, 4), **{"mesh.row_shard": "contiguous"}),
            case("mf_sparse", (1, 4)),
            case("lstm", (1, 4))]
    out["eight"] = (eight, run_ranks("recommend", 8, tmp, {"cases": eight}))
    out["four"] = (four, run_ranks("recommend", 4, tmp, {"cases": four}))
    topk = _topk_cases()
    out["topk"] = (topk, {w: run_ranks(
        "topk", w, tmp, {"cases": [c for c in topk
                                   if np.prod(c["mesh"]) == w]})
        for w in (4, 8)})
    return out


def _scores_of(rec_one, req):
    """float64 masked scores of a request set from a one-device port
    Recommender's queries (bf16-rounded operands, as the top-k's)."""
    v, b = (x.float().numpy() for x in rec_one._vb)
    if "users" in req:
        from arec_torch.models.mf import mf_user_latents
        with torch.no_grad():
            q = mf_user_latents(rec_one._params, rec_one.spec,
                                rec_one._user_dev,
                                torch.from_numpy(req["users"])).numpy()
        seen = tserve._pad_seen(req["seen"], len(req["users"]),
                                tserve._bucket_width(req["seen"], 32))
    else:
        from arec_torch.models.seq import seq_final_state_full
        qs, seens = [], []
        for batch, n in rec_one._history_batches(req["histories"]):
            with torch.no_grad():
                q = seq_final_state_full(
                    rec_one._params, rec_one.spec, rec_one._item_dev,
                    rec_one._user_dev,
                    {k: torch.from_numpy(x) for k, x in batch.items()
                     if k != "seen"}).numpy()
            qs.append(q[:n])
            seens.append(batch["seen"][:n])
        q, seen = np.concatenate(qs), np.concatenate(seens)
    return ref_scores(q, v, b, seen)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(8))
def test_sharded_topk_matches_arec(sides, i):
    cases, by_world = sides["topk"]
    c = cases[i]
    world = int(np.prod(c["mesh"]))
    j = sum(1 for x in cases[:i] if np.prod(x["mesh"]) == world)
    got_v = _merge_slabs([r[j] for r in by_world[world]], world,
                         c["mesh"][0], "vals")
    got_i = _merge_slabs([r[j] for r in by_world[world]], world,
                         c["mesh"][0], "ids")
    want_v, want_i = _arec_topk(c)
    vp = -(-c["v"].shape[0] // c["mesh"][1]) * c["mesh"][1]
    pad = vp - c["v"].shape[0]
    lat = np.concatenate([c["v"], np.zeros((pad, 16), np.float32)])
    bias = np.concatenate([c["b"], np.full(pad, -1e9, np.float32)])
    scores = ref_scores(c["q"], lat, bias, c["seen"])
    finite = np.isfinite(want_v)
    # the degenerate case: fewer candidates than k on the whole mesh
    np.testing.assert_array_equal(np.isfinite(got_v), finite)
    np.testing.assert_array_equal(got_i[~finite], want_i[~finite])
    if finite.all():
        assert_topk_equal_up_to_ties(got_v, got_i, want_v, want_i, scores)
    else:
        k = int(finite.sum(1).min())
        assert finite.sum(1).max() == k
        assert_topk_equal_up_to_ties(got_v[:, :k], got_i[:, :k],
                                     want_v[:, :k], want_i[:, :k], scores)


def test_pad_item_shards_matches_arec():
    v = np.arange(30, dtype=np.float32).reshape(10, 3)
    b = np.ones(10, np.float32)
    for t in (1, 3, 4):
        gv, gb = pad_item_shards(torch.from_numpy(v), torch.from_numpy(b), t)
        wv, wb = jpad(jax.numpy.asarray(v), jax.numpy.asarray(b), t)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))


def _case_result(sides, world, idx):
    cases, results = sides["eight" if world == 8 else "four"]
    c = cases[idx]
    for r in range(1, world):     # every rank returns the whole answer
        np.testing.assert_array_equal(results[r][idx]["ids"],
                                      results[0][idx]["ids"])
    return c, results


MESH_CASES = [(8, i) for i in range(5)] + [(4, i) for i in range(5)]


@pytest.mark.parametrize("world,idx", MESH_CASES)
def test_mesh_lists_equal_one_device(sides, world, idx):
    """Every mesh case (checkpoint restores onto 2 × 4 and 1 × 4, shuffle
    and contiguous, dense and sparse MF, the LSTM; weights handed in)
    serves the one-device Recommender's lists up to ties, and its item
    matrix, gathered, is the one-device matrix padded."""
    c, results = _case_result(sides, world, idx)
    one = sides[c["family"]]["one"]
    req = sides[c["family"]]["req"]
    if "users" in req:
        want = one.for_users(req["users"], seen=req["seen"])
    else:
        want = one.from_histories(req["histories"])
    scores = _scores_of(one, req)
    got = results[0][idx]["ids"]
    assert got.shape == want.shape
    assert_ids_equal_up_to_ties(got, np.take_along_axis(scores, want, 1),
                                want, scores)
    v1, b1 = (x.float().numpy() for x in one._vb)
    t = c["mesh"][1]
    lat = results[0][idx]["latents"].reshape(world, -1, v1.shape[1])
    bias = results[0][idx]["bias"].reshape(world, -1)
    vs = -(-v1.shape[0] // t)
    for r in range(world):
        m = r % t
        lo, hi = m * vs, min((m + 1) * vs, v1.shape[0])
        np.testing.assert_allclose(lat[r][:hi - lo], v1[lo:hi], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(bias[r][:hi - lo], b1[lo:hi], rtol=1e-6,
                                   atol=1e-6)
        assert not lat[r][hi - lo:].any()
        assert (bias[r][hi - lo:] == -1e9).all()


@pytest.mark.parametrize("family,world,idx", [("mf", 8, 0), ("mf", 8, 1),
                                              ("lstm", 4, 0)])
def test_recommender_matches_arec_on_its_mesh(sides, family, world, idx):
    c, results = _case_result(sides, world, idx)
    assert c["family"] == family
    want = sides[family]["want"]
    scores = _scores_of(sides[family]["one"], sides[family]["req"])
    assert_ids_equal_up_to_ties(results[0][idx]["ids"],
                                np.take_along_axis(scores, want, 1), want,
                                scores)


@pytest.mark.parametrize("family,world,idx", [("mf", 8, 0), ("lstm", 4, 0)])
def test_evaluate_and_recommend_match_arec_on_its_mesh(sides, family, world,
                                                       idx):
    c, results = _case_result(sides, world, idx)
    s = sides[family]
    for r in range(world):
        assert results[r][idx]["recall"] == s["jrecall"]
        assert results[r][idx]["rows"] == results[0][idx]["rows"]
        assert results[r][idx]["wrote"] == (r == 0)
    rows = results[0][idx]["rows"]
    assert [u for u, _ in rows] == [u for u, _ in s["jrows"]]
    lines = open(os.path.join(c["out_dir"], f"{family}.0.tsv")).read(
    ).splitlines()
    assert lines == [f"{u}\t{','.join(map(str, r))}" for u, r in rows]
    for r in range(1, world):
        assert not os.path.exists(os.path.join(c["out_dir"],
                                               f"{family}.{r}.tsv"))


def test_training_on_a_mesh_raises(sides, tmp_path):
    """Training on the mesh, refused until mesh training was ported, now
    runs from the checkpoint these tests serve (arec's trained state,
    written on one device): 2 more steps on 2 x 4 restore step 16 and
    match 2 steps of the one-device Trainer from it (the same negatives:
    the step's key is the same on every rank), each step's loss at rtol
    2e-4 and every parameter after them at rtol 2e-4, atol 2e-6; the
    mesh's checkpoint serves on one device."""
    import shutil
    src = sides["mf"]["cfg"].train.train_dir
    sets = {"train.max_steps": 18, "train.steps_per_checkpoint": 1,
            "train.steps_per_dispatch": 1,
            "train.compute_dtype": "float32"}
    runs = {}
    for name, mesh in (("one", (1, 1)), ("mesh", (2, 4))):
        d = str(tmp_path / name)
        shutil.copytree(src, d)
        runs[name] = sides["mf"]["cfg"].override({
            **sets, "train.train_dir": d, "mesh.data": mesh[0],
            "mesh.model": mesh[1]})
    Trainer(runs["one"], device="cpu").train()
    res = run_ranks("train", 8, tmp_path, {"cases": [{
        "config": runs["mesh"].to_json(),
        "train_dir": runs["mesh"].train.train_dir}]})
    assert "[ckpt] restored step 16" in res[0][0]["stdout"]
    losses = {}
    for name, cfg in runs.items():
        with open(os.path.join(cfg.train.train_dir, "metrics.jsonl")) as f:
            recs = [json.loads(ln) for ln in f]
        losses[name] = [r["loss"] for r in recs if "loss" in r]
    assert len(losses["one"]) == 2
    np.testing.assert_allclose(losses["mesh"], losses["one"], rtol=2e-4)
    want = Checkpointer(runs["one"].train.train_dir)
    got = Checkpointer(runs["mesh"].train.train_dir)
    assert want.latest_step() == got.latest_step() == 18
    load = lambda c: torch.load(os.path.join(c.path, "18", "state.pt"),
                                weights_only=True)["params"]
    for (k, a), (_, b) in zip(_named(load(got)), _named(load(want))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-6, err_msg=k)
    one = Recommender(runs["mesh"].override({"mesh.data": 1,
                                             "mesh.model": 1}),
                      serve_batch=16, device="cpu")
    assert one._restored_step == 18


def _named(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def test_entry_points_on_two_ranks(sides, tmp_path):
    """`cli.main --recommend --out` and `serve.main` on a 1 x 2 mesh: the
    summary equals a one-device serve-only Trainer's, the primary writes
    the file; serve.main answers the primary's lines on both ranks."""
    cfg = sides["mf"]["cfg"]
    users = sides["mf"]["req"]["users"][:3]
    argv = ["--config", str(tmp_path / "cfg.json"),
            "--set", "mesh.data=1", "--set", "mesh.model=2"]
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    lines = "".join(f"{u}\n" for u in users) + "x\n!step\n!quit\n"
    res = run_ranks("serve_main", 2, tmp_path,
                    {"argv": argv, "lines": lines,
                     "out": str(tmp_path / "top.tsv")})
    # --recommend: every rank prints the summary, the primary writes
    assert [r["rc_cli"] for r in res] == [0, 0]
    assert [r["wrote"] for r in res] == [True, False]
    summary = json.loads(res[0]["cli"].strip().splitlines()[-1])
    assert res[1]["cli"].strip().splitlines()[-1] == res[0]["cli"].strip(
    ).splitlines()[-1]
    one = Trainer(cfg, serve_only=True, device="cpu")
    assert summary == {"users": len(one.recommend()),
                       "recall@30": one.evaluate()}
    assert len((tmp_path / "top.tsv.0").read_text().splitlines()) == \
        summary["users"]
    for r in res:
        r.pop("cli"), r.pop("wrote")
    assert res[0] == res[1]
    assert res[0]["rc"] == 0
    got = res[0]["out"].strip().split("\n")
    assert got[0].startswith("!ok serving") and "step 16" in got[0]
    one = sides["mf"]["one"]
    scores = _scores_of(one, {"users": users, "seen": None} | {
        "seen": [[] for _ in users]})
    want = one.for_users(users)
    ids = np.array([[int(x) for x in ln.split("\t")[1].split(",")]
                    for ln in got[1:4]])
    assert [ln.split("\t")[0] for ln in got[1:4]] == [str(u) for u in users]
    assert_ids_equal_up_to_ties(ids, np.take_along_axis(scores, want, 1),
                                want, scores)
    assert got[4].startswith("!err ValueError")
    assert got[5] == "!ok step 16"
    assert len(got) == 6


def test_rank_without_a_card_raises(monkeypatch):
    from arec_torch import resolve_device
    monkeypatch.setenv("LOCAL_RANK", "3")
    with pytest.raises(RuntimeError, match="local rank 3 has no card"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_failed_bring_up_raises_with_its_coordinates(monkeypatch):
    """A rank that cannot reach its master raises with the coordinates and
    the timeout; it never falls back to a single process."""
    import socket

    import torch.distributed as dist
    from arec_torch.dist.mesh import multihost_init

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in {"WORLD_SIZE": "2", "RANK": "1", "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(port), "AREC_INIT_TIMEOUT_S": "2"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match=(
            rf"backend=gloo, master=localhost:{port}, rank=1/2, "
            rf"timeout=2s")):
        multihost_init("cpu")
    assert not dist.is_initialized()
