"""arec_torch's spans and counters (`arec_torch/obs.py`) on the CPU: off
while no profiler records (one shared no-op span, nothing recorded); under
`torch.profiler.profile` nested spans' counts, totals, self times and
parents, counters, a second thread's spans, and the names among the
profiler's own events; and the spans at the program's layer boundaries:
`serve.Recommender` (MF and LSTM), `scan_multi`'s replays under the CPU
emulation of the card's side, and the prefetch worker."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from arec_torch import bridge, obs
from arec_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from arec_torch.data.io import load_or_prepare
from arec_torch.data.prefetch import copy_batch, prefetch
from arec_torch.models.mf import MFSpec, init_mf
from arec_torch.models.seq import SeqSpec, init_seq
from arec_torch.serve import Recommender

SERVE_SPANS = ("serve.batch", "serve.h2d", "serve.query", "serve.topk",
               "serve.d2h")


@pytest.fixture(autouse=True)
def fresh():
    obs.reset()
    yield
    obs.reset()


def traced():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing_and_shares_one_span():
    a, b = obs.span("a"), obs.span("b", stream="cpu")
    assert a is b
    with a:
        with b:
            pass
    obs.count("c", 3)
    assert list(obs.iterate("it", range(3))) == [0, 1, 2]
    assert obs.snapshot() == {"spans": {}, "counts": {}}


def test_suspended_records_nothing_on_its_thread():
    """Inside `suspended()` (a CUDA graph capture's block) this thread
    records no span and no count, nested or not, while another thread
    still records; on leaving it, recording resumes."""
    def other():
        obs.count("other", 1)

    with traced():
        with obs.span("kept"):
            with obs.suspended():
                with obs.span("dropped", stream="cpu"):
                    obs.count("dropped", 1)
                with obs.suspended():
                    obs.count("dropped", 1)
                obs.count("dropped", 1)
                t = threading.Thread(target=other)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
            obs.count("kept", 1)
    snap = obs.snapshot()
    assert set(snap["spans"]) == {"kept"}
    assert snap["counts"] == {"kept": 1, "other": 1}


def test_graph_share_reader():
    """`graph_share.serve` (benchmark/metrics): replays over the window's
    calls in %, None without the counter or the calls."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark", "metrics",
        "graph_share.serve.py")
    spec = importlib.util.spec_from_file_location("graph_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Run:
        counts = {"calls": 8}

    assert mod.read(Run()) is None               # no counter: the parent
    with traced():
        for _ in range(6):
            obs.count("serve.graph_replays", 1)
    assert mod.read(Run()) == pytest.approx(75.0)
    Run.counts = {}
    assert mod.read(Run()) is None


def test_nested_spans_counters_and_threads_under_a_profiler():
    done = threading.Event()

    def worker():
        with obs.span("worker"):
            time.sleep(0.01)
        done.set()

    with traced() as prof:
        assert obs.span("x") is not obs.span("x")     # on: a span each
        for _ in range(2):
            with obs.span("outer"):
                time.sleep(0.02)
                with obs.span("inner"):
                    time.sleep(0.01)
                with obs.span("inner"):
                    time.sleep(0.01)
        obs.count("n", 2)
        obs.count("n", 5)
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and done.is_set()
    assert obs.span("x") is obs.span("y")             # off again
    snap = obs.snapshot()
    outer, inner = snap["spans"]["outer"], snap["spans"]["inner"]
    assert (outer["count"], inner["count"]) == (2, 4)
    assert (outer["parent"], inner["parent"]) == (None, "outer")
    assert inner["total_s"] >= 0.04 and inner["self_s"] == inner["total_s"]
    assert outer["total_s"] >= 0.08
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - inner["total_s"], abs=1e-9)
    assert 0.04 <= outer["self_s"] < outer["total_s"]
    assert outer["stream_s"] is None
    assert snap["spans"]["worker"]["count"] == 1
    assert snap["spans"]["worker"]["total_s"] >= 0.01
    assert snap["counts"] == {"n": 7}
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"outer", "inner"} <= names
    obs.reset()
    assert obs.snapshot() == {"spans": {}, "counts": {}}


def test_iterate_records_each_item_not_the_end():
    with traced():
        assert list(obs.iterate("it", iter(range(4)))) == [0, 1, 2, 3]
        assert list(obs.iterate("empty", [])) == []
    spans = obs.snapshot()["spans"]
    assert spans["it"]["count"] == 4 and "empty" not in spans


def test_concurrent_spans_and_counts_lose_no_update():
    n_threads, n = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with obs.span("s"):
                    obs.count("c")

        with traced():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = obs.snapshot()
    assert snap["spans"]["s"]["count"] == n_threads * n
    assert snap["counts"]["c"] == n_threads * n


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------

def _cfg(tmp_path, model):
    kw = {"max_seq_len": 6, "use_pallas_scan": True} if model == "lstm" \
        else {"use_attributes": True}
    return Config(
        data=DataConfig(data_dir=str(tmp_path / "d"), syn_users=60,
                        syn_items=50, syn_interactions=600),
        model=ModelConfig(model=model, dim=8, **kw),
        train=TrainConfig(compute_dtype="float32"))


def _recommender(tmp_path, model, serve_batch):
    torch.set_num_threads(1)
    cfg = _cfg(tmp_path, model)
    ds = load_or_prepare(cfg.data)
    gen = torch.Generator().manual_seed(0)
    if model == "mf":
        spec = MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
        params = init_mf(gen, spec)
    else:
        spec = SeqSpec.from_config(cfg, ds.user_schema, ds.item_schema)
        params = init_seq(gen, spec)
    return Recommender(cfg, bridge.to_numpy(params), serve_batch=serve_batch,
                       device="cpu")


def _served(rec, n):
    if rec.is_seq:
        return rec.from_histories([[1, 2, 3]] * n)
    return rec.for_users(np.arange(n) % 50, seen=[[1, 2]] * n)


@pytest.mark.parametrize("model", ["mf", "lstm"])
def test_recommender_records_each_batch(tmp_path, model):
    rec = _recommender(tmp_path, model, serve_batch=4)
    n = 10                                    # 3 batches: 4 + 4 + 2 live
    _served(rec, n)                           # no profiler: not recorded
    assert obs.snapshot() == {"spans": {}, "counts": {}}
    with traced() as prof:
        ids = _served(rec, n)
    assert ids.shape == (n, rec.k)
    snap = obs.snapshot()
    assert {name: s["count"] for name, s in snap["spans"].items()} == (
        dict.fromkeys(SERVE_SPANS, 3))
    assert all(snap["spans"][name]["parent"] is None for name in SERVE_SPANS)
    assert snap["counts"] == {"serve.rows_live": n, "serve.rows": 12}
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert set(SERVE_SPANS) <= names


@pytest.mark.parametrize("model", ["mf", "lstm"])
def test_serve_rows_counts_the_row_buckets(tmp_path, model):
    """`serve.rows` counts the rows dispatched, each batch's row bucket:
    70 requests at serve_batch 64 are 64 + 6 live, dispatched as 64 + 8
    rows; `serve.rows_live` counts the requests."""
    rec = _recommender(tmp_path, model, serve_batch=64)
    with traced():
        ids = _served(rec, 70)
    assert ids.shape == (70, rec.k)
    assert obs.snapshot()["counts"] == {"serve.rows_live": 70,
                                        "serve.rows": 64 + 8}


def test_scan_multi_records_prepare_and_replay_per_replay():
    from test_torch_multi_step import K, Emulated, _dispatches, _port_mf
    state, core, batches = _port_mf()
    multi = Emulated(core, K)
    state, _ = _dispatches(multi, state, batches, 1)     # eager + capture
    with traced():
        _dispatches(multi, state, batches, 2)
    assert multi.replays == 2
    spans = obs.snapshot()["spans"]
    assert set(spans) == {"dispatch.prepare", "dispatch.replay"}
    assert spans["dispatch.prepare"]["count"] == 2
    assert spans["dispatch.replay"]["count"] == 2


def test_prefetch_records_each_build_and_stage():
    batches = [{"x": np.full(3, i, np.int32)} for i in range(5)]
    with traced():
        got = list(prefetch(iter(batches), depth=2,
                            transform=lambda b: copy_batch(b, "cpu")))
    assert [int(b["x"][0]) for b in got] == list(range(5))
    spans = obs.snapshot()["spans"]
    assert spans["input.build"]["count"] == 5
    assert spans["input.stage"]["count"] == 5
