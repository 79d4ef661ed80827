"""The per-layer metrics read from the program's own spans and counters
(`arec_torch.obs`): a traced tiny CPU run of each cell reports every one
that lists the cell, and every reader returns None where its span or the
program's tracing module is missing. On the card only: the top-k's
stream time (CUDA events) and the dispatch's two spans (a CUDA graph's
replay; on the CPU a dispatch is K eager steps)."""

import json
import os
import sys

import pytest

import run as run_py
from harness import bench

SPANS = ("input_build_ms.train", "input_stage_ms.train",
         "dispatch_prepare_ms.train", "replay_block_ms.train",
         "batch_build_ms.serve", "h2d_ms.serve", "enqueue_ms.serve",
         "d2h_wait_ms.serve", "topk_stream_ms.serve", "padding_share.serve")
CARD_ONLY = {"topk_stream_ms.serve", "dispatch_prepare_ms.train",
             "replay_block_ms.train"}
CELLS = [w["name"] for w in bench.benchmark()["workloads"]]


def _listed(cell):
    return {m["name"] for m in bench.benchmark()["per_layer"]
            if m["name"] in SPANS and cell in m["workloads"]}


def test_every_metric_is_in_the_benchmark_with_its_cells():
    per_layer = {m["name"]: m for m in bench.benchmark()["per_layer"]}
    for name in SPANS:
        assert per_layer[name]["workloads"], name
        assert os.path.exists(os.path.join(bench.HERE, "metrics",
                                           name + ".py"))


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_program_spans(tiny_cells, capsys, cell):
    from arec_torch import obs
    obs.reset()                   # the runs of this process share it
    rc = run_py.main(["--workload", cell, "--seed", str(2**31 + 5),
                      "--seconds", "1", "--trace", "1"], device="cpu")
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    want = _listed(cell)
    assert want
    got = {k for k, v in line["metrics"].items() if v["value"] is not None}
    assert want - CARD_ONLY <= got
    assert not want & CARD_ONLY & got
    assert all(line["metrics"][k]["value"] >= 0 for k in want - CARD_ONLY)
    if cell == "c4-serve-online":            # one live row of 256
        assert line["metrics"]["padding_share.serve"]["value"] == (
            pytest.approx(100 * (1 - 1 / 256)))
    names = {n for n, _ in line["breakdown"]["device_ops"]}
    assert not names & {"serve.topk", "serve.query", "dispatch.replay"}


class _Run:
    counts = {"steps": 8, "calls": 2}


@pytest.mark.parametrize("metric", SPANS)
def test_a_reader_finds_nothing_without_its_span(metric, monkeypatch):
    import arec_torch
    from arec_torch import obs
    obs.reset()
    assert bench.reader(metric)(_Run()) is None
    monkeypatch.delattr(arec_torch, "obs")        # a program without it
    monkeypatch.setitem(sys.modules, "arec_torch.obs", None)
    assert bench.reader(metric)(_Run()) is None


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["c4-serve-online", "c4-train"])
def test_the_card_only_metrics_on_the_card(card, cell):
    import subprocess
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        cell, "--seed", str(2**32 + 13), "--seconds", "2",
                        "--trace", "1"], cwd=bench.REPO, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    for name in _listed(cell) & CARD_ONLY:
        assert line["metrics"][name]["value"] > 0, name
