"""The checks fail what they must: the control (the reference in float8
in the program's place) fails a limit of every cell, and each fault a
cell can have, planted under the timed path (in a step, or in the K-step
dispatch that the window replays), makes a whole run report `correct`
false. At a tiny size on the CPU; the readings that set the
limits were taken on the card at the cells' own sizes."""

import json

import pytest
import torch

import control
import run as run_py
from harness import bench

TRAIN = ["xing-mf-train", "c4-train"]
SERVE = ["xing-mf-serve-batch", "c4-serve-online"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_the_control_fails_a_limit(tiny_cells, cell):
    c = bench.Cell.find(cell)
    read = (control.train_readings if cell in TRAIN
            else control.serve_readings)
    got = read(c, 11, "control", torch.device("cpu"))
    assert any(v > c.limits[k] for k, v in got.items()), got


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_fails_a_limit(tiny_cells, cell):
    c = bench.Cell.find(cell)
    got = control.train_readings(c, 12, "half", torch.device("cpu"))
    assert any(v > c.limits[k] for k, v in got.items()), got


def _unchanged(core):
    from arec_torch.train.step import _leaves

    def step(state, batch, gen):
        saved = [t.clone() for t in _leaves(state)]
        state, m = core(state, batch, gen)
        with torch.no_grad():
            for t, s in zip(_leaves(state), saved):
                t.copy_(s)
        return state, m
    return step


def _half_batch(core):
    def step(state, batch, gen):
        n = next(iter(batch.values())).shape[0] // 2
        return core(state, {k: v[:n] for k, v in batch.items()}, gen)
    return step


def _plant(monkeypatch, fault):
    """Wrap every step core the Trainer builds (dense and sparse)."""
    from arec_torch.train import sparse, step
    for mod, name in ((sparse, "make_sparse_step_core"),
                      (step, "make_step_core")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, **k:
                            fault(_r(*a, **k)))


def _run(capsys, cell):
    assert run_py.main(["--workload", cell, "--seed", "21", "--seconds",
                        "1", "--trace", "0"], device="cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
@pytest.mark.parametrize("cell", TRAIN)
def test_a_broken_step_is_not_correct(tiny_cells, monkeypatch, capsys,
                                      cell, fault):
    _plant(monkeypatch, fault)
    assert _run(capsys, cell)["correct"] is False


def _stale_inputs(multi):
    """Every dispatch after the first runs on the first one's batches, as
    a replay would that read stale static inputs."""
    def call(self, state, batches, gens):
        first = self.__dict__.setdefault(
            "_stale", [{k: v.clone() for k, v in b.items()}
                       for b in batches])
        return multi(self, state, first, gens)
    return call


def _first_keys(multi):
    """Every dispatch after the first draws the first one's negatives."""
    def call(self, state, batches, gens):
        seeds = self.__dict__.setdefault(
            "_keys", [g.initial_seed() for g in gens])
        return multi(self, state, batches,
                     [torch.Generator(g.device).manual_seed(s)
                      for g, s in zip(gens, seeds)])
    return call


@pytest.mark.parametrize("fault", [_stale_inputs, _first_keys])
@pytest.mark.parametrize("cell", TRAIN)
def test_a_broken_dispatch_is_not_correct(tiny_cells, monkeypatch, capsys,
                                          cell, fault):
    from arec_torch.train import graph
    monkeypatch.setattr(graph.scan_multi, "__call__",
                        fault(graph.scan_multi.__call__))
    assert _run(capsys, cell)["correct"] is False


@pytest.mark.parametrize("cell", SERVE)
def test_an_altered_answer_is_not_correct(tiny_cells, monkeypatch, capsys,
                                          cell):
    from arec_torch import serve
    real = serve.Recommender._run

    def altered(self, batches):
        ids = real(self, batches)
        ids[0, 0] = (ids[0, 0] + self._vb[0].shape[0] // 2) % (
            self._vb[0].shape[0])
        return ids
    monkeypatch.setattr(serve.Recommender, "_run", altered)
    assert _run(capsys, cell)["correct"] is False
