"""`serve.Recommender`'s graph path on the card: a call answered by CUDA
graph replays of the query encode and the fused top-k, against the eager
step on the same batches.

  * the replays' scores and ids equal the eager step's bit for bit, and a
    whole call equals an eager Recommender's, for MF and for LSTM and GRU
    histories of 1 and 2 segments, at two seen buckets each;
  * a second call of a key captures nothing; a key past MAX_GRAPHS runs
    the eager step;
  * `refresh()` drops the graphs, and the next call captures anew and
    matches the eager step on the new weights;
  * under a torch profiler the spans `serve.query` and `serve.topk` (with
    stream seconds) time the replays, and the counters
    `serve.graph_replays` and `serve.graph_captures` count calls and keys,
    nothing from inside a capture.

Marked `cuda`: they skip where no CUDA device is present. On a machine with
one (and no jax), run them without the jax-loading conftest:

    python -m pytest tests/test_torch_serve_graph_cuda.py --noconftest -q
"""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from arec_torch import bridge, obs, serve
from arec_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from arec_torch.data.io import load_or_prepare
from arec_torch.models.mf import MFSpec, init_mf
from arec_torch.models.seq import SeqSpec, init_seq

SERVE_BATCH = 64
L = 10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(root, model):
    kw = ({"use_attributes": True} if model == "mf" else
          {"model": "lstm", "cell": model, "max_seq_len": L,
           "use_pallas_scan": True})
    return Config(
        data=DataConfig(data_dir=os.path.join(root, "d"), syn_users=200,
                        syn_items=400, syn_interactions=4000),
        model=ModelConfig(**{"model": "mf", "dim": 32, **kw}),
        train=TrainConfig(compute_dtype="bfloat16"))


def _params(cfg, ds, seed):
    gen = torch.Generator().manual_seed(seed)
    if cfg.model.model == "mf":
        return init_mf(gen, MFSpec.from_config(cfg, ds.user_schema,
                                               ds.item_schema))
    return init_seq(gen, SeqSpec.from_config(cfg, ds.user_schema,
                                             ds.item_schema))


def _recommender(root, model, dev, seed=0):
    cfg = _cfg(root, model)
    params = bridge.to_numpy(_params(cfg, load_or_prepare(cfg.data), seed))
    rec = serve.Recommender(cfg, params, serve_batch=SERVE_BATCH, device=dev)
    assert rec._graphs == {}                  # one card, exact top-k
    return rec, cfg, params


def _eager(rec):
    """`rec` with every call served by the eager step."""
    rec._graph = lambda batch: None
    return rec


def _requests(rec, segments, seen, rng):
    """A call's requests: 100 users (two batches), or 100 histories of
    `segments` segments; with seen "long", seen lists of 33-64 ids (the
    64 bucket) in place of the short ones (the 32 bucket)."""
    n, V = 100, rec._vb[0].shape[0]
    lens = rng.integers(1 + (segments - 1) * L, segments * L + 1, n)
    short = [rng.integers(0, V, int(m)).tolist() for m in lens]
    long_ = [rng.integers(0, V, int(m)).tolist()
             for m in rng.integers(33, 65, n)] if seen == "long" else None
    if not rec.is_seq:
        users = rng.integers(0, rec._ds.num_users, n).astype(np.int32)
        return lambda r: r.for_users(users, seen=long_ or short)
    return lambda r: r.from_histories(short, seen=long_)


CASES = [("mf", 1, "short"), ("mf", 1, "long")] + [
    (cell, s, seen) for cell in ("lstm", "gru") for s in (1, 2)
    for seen in ("short", "long")]


@pytest.mark.cuda
@pytest.mark.parametrize("model, segments, seen", CASES)
def test_replays_equal_the_eager_step_bit_for_bit(dev, tmp_path, model,
                                                  segments, seen):
    rec, cfg, params = _recommender(str(tmp_path), model, dev)
    call = _requests(rec, segments, seen, np.random.default_rng(1))
    got = call(rec)
    assert len(rec._graphs) == 1
    (g,) = rec._graphs.values()
    width = {"short": 32, "long": 64}[seen]
    key = {name: shape for name, shape, _ in serve._graph_key(g.host_np)}
    assert key["seen"] == (SERVE_BATCH, width)
    if rec.is_seq:
        assert key["inputs"] == (SERVE_BATCH, segments * L)
    # the call against an eager Recommender of the same weights and widths
    eager = _eager(serve.Recommender(cfg, params, serve_batch=SERVE_BATCH,
                                     device=dev))
    np.testing.assert_array_equal(got, call(eager))
    # each batch's scores and ids against the eager step on that batch
    v, b = rec._vb
    with torch.inference_mode():
        for batch in _batches_of(rec, call):
            g(batch)
            tb = {n: torch.from_numpy(a).to(dev) for n, a in batch.items()}
            seen_t = tb.pop("seen")
            scores, ids = rec._step(rec._params, v, b, tb, seen_t)
            torch.testing.assert_close(g.scores, scores, rtol=0, atol=0)
            torch.testing.assert_close(g.ids, ids, rtol=0, atol=0)
    call(rec)
    assert len(rec._graphs) == 1 and next(iter(rec._graphs.values())) is g


def _batches_of(rec, call):
    """The numpy batches `call` hands to `rec._run`."""
    out = []

    def run(batches):
        out.extend(batch for batch, _ in batches)
        return np.zeros((0, rec.k), np.int32)

    rec._run = run
    try:
        call(rec)
    finally:
        del rec._run
    return out


@pytest.mark.cuda
def test_a_key_past_the_cap_runs_eagerly(dev, tmp_path, monkeypatch):
    rec, cfg, params = _recommender(str(tmp_path), "lstm", dev)
    monkeypatch.setattr(serve, "MAX_GRAPHS", 1)
    rng = np.random.default_rng(2)
    one, two = (_requests(rec, s, "short", rng) for s in (1, 2))
    one(rec)
    got = two(rec)
    assert len(rec._graphs) == 1
    eager = _eager(serve.Recommender(cfg, params, serve_batch=SERVE_BATCH,
                                     device=dev))
    np.testing.assert_array_equal(got, two(eager))


class _Checkpoints:
    """The part of a serve-only Trainer that `refresh()` reads, handing
    over `trees` one restore at a time."""

    def __init__(self, trees, dev):
        self.trees, self.dev = list(trees), dev
        self.ckpt = types.SimpleNamespace(drain=lambda: None)
        self.state = types.SimpleNamespace(step=0)

    def latest_step(self):
        return self.state.step + 1

    def _maybe_restore(self):
        self.params = bridge.to_torch(self.trees.pop(0), self.dev)
        self.state.step += 1

    def _eval_params(self):
        return self.params


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mf", "lstm"])
def test_refresh_drops_the_graphs(dev, tmp_path, model):
    rec, cfg, _ = _recommender(str(tmp_path), model, dev)
    new = bridge.to_numpy(_params(cfg, rec._ds, seed=7))
    rec._trainer = _Checkpoints([new], dev)
    rec._restored_step = 0
    call = _requests(rec, 2, "short", np.random.default_rng(3))
    before = call(rec)
    old = next(iter(rec._graphs.values()))
    assert rec.refresh()
    assert rec._graphs == {} and rec._pool is None
    got = call(rec)
    assert len(rec._graphs) == 1
    assert next(iter(rec._graphs.values())) is not old
    eager = _eager(serve.Recommender(cfg, new, serve_batch=SERVE_BATCH,
                                     device=dev))
    np.testing.assert_array_equal(got, call(eager))
    assert not np.array_equal(got, before)


def _reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mf", "lstm"])
def test_spans_and_counters_of_the_replays(dev, tmp_path, model):
    """Three calls of two batches under a profiler, the first capturing
    its key there: two replays a call, one capture, and no count from the
    warm-up or the capture."""
    rec, *_ = _recommender(str(tmp_path), model, dev)
    call = _requests(rec, 1, "short", np.random.default_rng(4))
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            call(rec)
        torch.cuda.synchronize()
    snap = obs.snapshot()
    obs.reset()
    assert snap["counts"] == {"serve.rows_live": 300,
                              "serve.rows": 6 * SERVE_BATCH,
                              "serve.graph_replays": 3,
                              "serve.graph_captures": 1}
    spans = snap["spans"]
    for name in ("serve.batch", "serve.h2d", "serve.query", "serve.topk",
                 "serve.d2h"):
        assert spans[name]["count"] == 6, name
    assert spans["serve.topk"]["stream_s"] > 0
    run = types.SimpleNamespace(counts={"calls": 3})
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            call(rec)
    assert _reader("graph_share.serve")(run) == pytest.approx(100.0)
    assert _reader("enqueue_ms.serve")(run) > 0
    assert _reader("topk_stream_ms.serve")(run) > 0
    assert "serve.graph_captures" not in obs.snapshot()["counts"]
    obs.reset()
