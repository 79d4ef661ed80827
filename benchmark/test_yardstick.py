"""The yardstick's own arithmetic and its lookups by name: the frozen
FLOP and byte counts at small shapes against hand-worked numbers, the
busy time of a trace whose two streams overlap, BENCHMARK.json against
the contract's shape, and a new configuration, mix, cell and metric
found by name."""

import json
import os
import re
import shutil

import pytest

import run as run_py
from harness import bench
from harness.trace import Trace, union_s
from roofline import counts as rc


def test_scan_bytes_and_bounds_by_hand():
    # L 2, B 3, H 4, LSTM, bf16 Wh: G = 16;
    # 4·(xw 96 + mask 6 + h0,c0 24 + h_all 24 + cT 12) + 2·Wh 64
    assert rc.scan_fwd_bytes(2, 3, 4) == 776
    assert rc.scan_fwd_s(2, 3, 4, 5) == pytest.approx(
        max(776 / 3.35e12, 2 * 16 * 4 * 5 / 989e12))
    # the training launch adds hp, cp: 2·4·L·B·H = 192 bytes
    assert rc.scan_fwd_resid_s(2, 3, 4, 5) == pytest.approx(968 / 3.35e12)
    # backward: 4·(2·96 + 6 + 3·24 + 3·12 + 64) + 2·64 = 1608 bytes;
    # 3·2·16·4·valid FLOPs
    assert rc.scan_bwd_s(2, 3, 4, 10**6) == pytest.approx(
        max(1608 / 3.35e12, 3 * 2 * 16 * 4 * 10**6 / 989e12))


def test_ce_scatter_and_step_flops_by_hand():
    # N 2, S 3, D 4, Dt 5: inputs 8 + 10 + 12 + 3 + 6 + 3 = 42 floats
    assert rc.ce_s(2, 3, 4, 5, False) == pytest.approx(
        max(4 * 48 / 3.35e12, 2 * 2 * 3 * 4 / 989e12))
    assert rc.ce_s(2, 3, 4, 5, True) == pytest.approx(
        max(4 * (42 + 3 + 8 + 10 + 12 + 3 + 2) / 3.35e12,
            6 * 2 * 3 * 4 / 989e12))
    assert rc.scatter_s(10, 4, 8) == pytest.approx((40 + 256) / 3.35e12)
    # fusions 2·2·16 = 64 (user) and 96 (item): 3·(2·64 + 5·96) + 3·16
    # + 6·24
    assert rc.mf_train_step_flops(2, 3, 4, 2, 3) == 2016
    assert rc.mf_serve_flops(2, 5, 4, 2) == 2 * (64 + 40)


def test_busy_time_is_the_union_of_two_overlapping_streams():
    compute = [("k1", 0.0, 1.0), ("k2", 2.0, 3.0)]
    copies = [("memcpy", 0.5, 2.5)]
    t = Trace(device=compute + copies)
    assert t.busy_s() == pytest.approx(3.0)
    assert sum(e - s for _, s, e in t.device) == pytest.approx(4.0)
    assert union_s([(0, 1), (1, 2), (5, 6)]) == pytest.approx(3.0)


def test_idle_gaps_are_named_by_the_innermost_host_event():
    t = Trace(device=[("a", 0.0, 1.0), ("b", 1.5, 2.0), ("a", 2.1, 2.2)],
              host=[("bench.dispatch", 0.9, 1.6, 1),
                    ("aten::copy_", 1.1, 1.3, 1)])
    b = t.breakdown()
    assert b["device_ops"][0] == ["a", pytest.approx(1.1)]
    assert b["idle_gaps"][0] == ["aten::copy_", pytest.approx(0.5)]
    assert b["idle_gaps"][1] == ["host: no event open", pytest.approx(0.1)]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keeps_the_contract_shape():
    spec = bench.benchmark()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in spec["configs"]]
             + [w["name"] for w in spec["workloads"]]
             + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]])
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(
        names)
    e2e = {m["name"] for m in spec["end_to_end"]}
    for w in spec["workloads"]:
        assert len(w["why"]) <= 200
        mine = {m["name"] for m in bench.metrics_of(w["name"], spec, False)}
        assert "setup_s" in mine and len(mine) >= 2
        assert bench.metrics_of(w["name"], spec, True)
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in
                                  bench.metrics_of(w, spec, False)}
        bench.reader(m["name"])
    for c in spec["configs"]:
        with open(os.path.join(bench.REPO, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]


def test_a_new_cell_mix_and_metric_are_found_by_name(tmp_path, tiny_cells,
                                                     monkeypatch, capsys):
    repo = tmp_path / "repo"
    shutil.copytree(bench.HERE, repo / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    spec = bench.benchmark()
    (repo / "benchmark" / "traffic" / "serve-half.json").write_text(
        json.dumps({"kind": "serve", "requests_per_call": 128,
                    "pool_calls": 64, "check_requests": 64}))
    (repo / "benchmark" / "limits" / "xing-mf-serve-half.json").write_text(
        json.dumps({"score_gap": 0.05}))
    (repo / "benchmark" / "metrics" / "calls.serve.py").write_text(
        "def read(run):\n    return run.counts.get('calls')\n")
    conf = json.loads((repo / "benchmark" / "configs" / "xing-mf.json")
                      .read_text())
    conf["config"]["train"]["eval_topk"] = 20
    (repo / "benchmark" / "configs" / "xing-mf-top20.json").write_text(
        json.dumps(conf))
    spec["configs"].append({"name": "xing-mf-top20", "source": "test",
                            "file": "benchmark/configs/xing-mf-top20.json",
                            "reduced": conf["reduced"], "why": "top 20"})
    spec["workloads"].append({"name": "xing-mf-serve-half",
                              "config": "xing-mf-top20",
                              "traffic": "serve-half", "chips": 1,
                              "why": "half batches, top 20"})
    spec["per_layer"].append({"name": "calls.serve", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "serve", "moves":
                              "serve_requests_per_s",
                              "workloads": ["xing-mf-serve-half"]})
    (repo / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(bench, "HERE", str(repo / "benchmark"))
    monkeypatch.setattr(bench, "REPO", str(repo))
    assert run_py.main(["--workload", "xing-mf-serve-half", "--seed", "5",
                        "--seconds", "1", "--trace", "1"], device="cpu") == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["calls.serve"]["value"] > 0
    assert bench.Cell.find("xing-mf-serve-half").config["config"][
        "train"]["eval_topk"] == 20
