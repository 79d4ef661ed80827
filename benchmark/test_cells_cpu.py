"""Each cell of BENCHMARK.json run end to end at a tiny size on the CPU:
set-up, the window, the check, and the contract's last line."""

import json

import pytest

import run as run_py
from harness import bench

CELLS = [w["name"] for w in bench.benchmark()["workloads"]]


def last_line(capsys):
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_cpu(tiny_cells, capsys, cell, trace):
    rc = run_py.main(["--workload", cell, "--seed", str(2**31 + 7),
                      "--seconds", "1", "--trace", str(trace)],
                     device="cpu")
    assert rc == 0
    line, err = last_line(capsys)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    spec = bench.benchmark()
    want = {m["name"] for m in bench.metrics_of(cell, spec, bool(trace))}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        assert "breakdown" in line and "busy_s" in line["device"]
    names = list(line["checks"])
    tail = err.strip().splitlines()[-len(names):]
    assert [t.split(":")[0] for t in tail] == [f"check {n}" for n in names]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell):
    import subprocess
    import sys
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        cell, "--seed", str(2**32 + 11), "--seconds", "2",
                        "--trace", "0"], cwd=bench.REPO, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
