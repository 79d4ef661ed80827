"""`serve.Recommender`'s graph path on the card: a call answered by CUDA
graph replays of the query encode and the fused top-k, against the eager
step on the same batches.

  * the replays' scores and ids equal the eager step's bit for bit, and a
    whole call equals an eager Recommender's, for MF and for LSTM and GRU
    histories of 1 and 2 segments, at two seen buckets each, and at row
    buckets below serve_batch;
  * one history served alone (row bucket 8) and inside a full batch gets
    the same ids up to ties, and one-history calls of 1 and 2 segments
    (the standing server's traffic) capture exactly two keys;
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
from arec_torch.train.loop import _query_fn

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


def _requests(rec, segments, seen, rng, n=100):
    """A call's requests: n users (100: two batches of 64 rows), or n
    histories of `segments` segments; with seen "long", seen lists of
    33-64 ids (the 64 bucket) in place of the short ones (the 32
    bucket)."""
    V = rec._vb[0].shape[0]
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
    _replays_equal_eager(rec, cfg, params, call, SERVE_BATCH,
                         {"short": 32, "long": 64}[seen], segments)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mf", "lstm", "gru"])
@pytest.mark.parametrize("n, rows", [(5, 8), (20, 32)])
def test_a_row_bucket_below_serve_batch_replays_the_eager_step(
        dev, tmp_path, model, n, rows):
    rec, cfg, params = _recommender(str(tmp_path), model, dev)
    call = _requests(rec, 1, "short", np.random.default_rng(5), n=n)
    _replays_equal_eager(rec, cfg, params, call, rows, 32, 1)


def _replays_equal_eager(rec, cfg, params, call, rows, width, segments):
    """One call of one key (`rows` × the seen slab's `width`, `segments`
    segments a history) captures it; its result equals an eager
    Recommender's, each batch's replayed scores and ids equal the eager
    step's bit for bit, and a second call captures nothing."""
    got = call(rec)
    assert len(rec._graphs) == 1
    (g,) = rec._graphs.values()
    key = {name: shape for name, shape, _ in serve._graph_key(g.host_np)}
    assert key["seen"] == (rows, width)
    if rec.is_seq:
        assert key["inputs"] == (rows, segments * L)
    # the call against an eager Recommender of the same weights and widths
    eager = _eager(serve.Recommender(cfg, params, serve_batch=SERVE_BATCH,
                                     device=rec.device))
    np.testing.assert_array_equal(got, call(eager))
    # each batch's scores and ids against the eager step on that batch
    v, b = rec._vb
    with torch.inference_mode():
        for batch in _batches_of(rec, call):
            g(batch)
            tb = {n: torch.from_numpy(a).to(rec.device)
                  for n, a in batch.items()}
            seen_t = tb.pop("seen")
            scores, ids = rec._step(rec._params, v, b, tb, seen_t)
            torch.testing.assert_close(g.scores, scores, rtol=0, atol=0)
            torch.testing.assert_close(g.ids, ids, rtol=0, atol=0)
    call(rec)
    assert len(rec._graphs) == 1 and next(iter(rec._graphs.values())) is g


def _tie_scores(q, v, b, seen, ids):
    """float64 seen-masked scores of `ids` [B, k] from bf16-rounded query
    and item rows, as the fused top-k rounds its operands."""
    ids = torch.as_tensor(ids, device=q.device).long()
    s = torch.einsum("bkd,bd->bk", v[ids].to(torch.bfloat16).double(),
                     q.to(torch.bfloat16).double()) + b[ids].double()
    seen = torch.as_tensor(seen, device=q.device).long()
    return s - 1e9 * (ids[:, :, None] == seen[:, None, :]).sum(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["lstm", "gru"])
def test_one_history_alone_and_in_a_full_batch(dev, tmp_path, model):
    """A history served alone (row bucket 8) and as one row of a full
    batch (64 rows): query states within f32 rounding (the GEMMs may sum
    in another order at another row count), and the same ids up to ties,
    each list judged on its own call's query state."""
    rec, *_ = _recommender(str(tmp_path), model, dev)
    rng = np.random.default_rng(6)
    V = rec._vb[0].shape[0]
    hists = [rng.integers(0, V, int(m)).tolist()
             for m in rng.integers(1, 2 * L + 1, SERVE_BATCH)]
    hists[0] = hists[0] + [1] * (L + 1 - len(hists[0]))   # 2 segments
    full = rec.from_histories(hists)
    v, b = rec._vb
    (whole, _), = rec._history_batches(hists)
    assert whole["inputs"].shape == (SERVE_BATCH, 2 * L)
    q_full = _query_states(rec, whole)
    for i in (0, 1, 31, SERVE_BATCH - 1):
        alone = rec.from_histories([hists[i]])
        (one, _), = rec._history_batches([hists[i]])
        assert len(one["inputs"]) == 8
        q_one = _query_states(rec, one)[:1]
        if one["inputs"].shape[1] == whole["inputs"].shape[1]:
            torch.testing.assert_close(q_one, q_full[i:i + 1], rtol=1e-5,
                                       atol=1e-6)
        seen = one["seen"][:1]
        got = _tie_scores(q_one, v, b, seen, alone)
        want = _tie_scores(q_full[i:i + 1], v, b, whole["seen"][i:i + 1],
                           full[i:i + 1])
        assert len(set(alone[0].tolist())) == alone.shape[1]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _query_states(rec, batch):
    tb = {n: torch.from_numpy(a).to(rec.device) for n, a in batch.items()
          if n != "seen"}
    with torch.inference_mode():
        return _query_fn(rec.spec, rec._params, rec._item_dev,
                         rec._user_dev, tb)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["lstm", "gru"])
def test_one_history_calls_capture_two_keys(dev, tmp_path, model):
    """The standing server's traffic: one history a call, of 1 or 2
    segments, with seen lists of at most 2·L ids. Two keys (row bucket 8,
    1 and 2 segments) serve every call."""
    rec, *_ = _recommender(str(tmp_path), model, dev)
    rng = np.random.default_rng(7)
    V = rec._vb[0].shape[0]
    for m in rng.integers(1, 2 * L + 1, 40):
        rec.from_histories([rng.integers(0, V, int(m)).tolist()])
    assert len(rec._graphs) == 2
    shapes = sorted(dict((name, shape) for name, shape, _ in key)["inputs"]
                    for key in rec._graphs)
    assert shapes == [(8, L), (8, 2 * L)]


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
