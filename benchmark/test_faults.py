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
from conftest import tiny_case
from harness import bench

TRAIN = ["xing-mf-train", "c4-train"]
SERVE = ["xing-mf-serve-batch", "c4-serve-online"]
# c4's cells with `model.cell` gru: the configuration a GRU cell brings
GRU_TRAIN, GRU_SERVE = ["c4-train@gru"], ["c4-serve-online@gru"]


@pytest.mark.parametrize("cell", TRAIN + SERVE + GRU_TRAIN + GRU_SERVE)
def test_the_control_fails_a_limit(monkeypatch, cache_dir, cell):
    name = tiny_case(monkeypatch, cache_dir, cell)
    c = bench.Cell.find(name)
    read = (control.train_readings if c.traffic["kind"] == "train"
            else control.serve_readings)
    got = read(c, 11, "control", torch.device("cpu"))
    assert any(v > c.limits[k] for k, v in got.items()), got


@pytest.mark.parametrize("cell", TRAIN + GRU_TRAIN)
def test_half_the_batch_fails_a_limit(monkeypatch, cache_dir, cell):
    name = tiny_case(monkeypatch, cache_dir, cell)
    c = bench.Cell.find(name)
    got = control.train_readings(c, 12, "half", torch.device("cpu"))
    assert any(v > c.limits[k] for k, v in got.items()), got


def _lstm_over_gru_weights(P, m, inputs, mask, dt):
    """The LSTM's recurrence over a GRU's weights: the r | u | n blocks
    read as i | f | g, the output gate's block zero."""
    from reference import model
    w, b = P["rnn_w"], P["rnn_b"]
    d = w.shape[1] // 3
    return model.lstm_hidden({**P, "rnn_w": torch.cat(
        [w, w.new_zeros(w.shape[0], d)], 1), "rnn_b": torch.cat(
        [b, b.new_zeros(d)])}, m, inputs, mask, dt)


def _cudnn_gru(P, m, inputs, mask, dt):
    """cuDNN's GRU: the reset gate scales h·U_n, not h."""
    from reference import model
    x, _ = model.encode(P["item_in"], m["item"], m["item_slots"], inputs)
    D = x.shape[-1]
    w = P["rnn_w"]
    xw = model.mm(x, w[:D], dt) + P["rnn_b"]
    h, out = torch.zeros(x.shape[0], D, device=x.device), []
    for t in range(inputs.shape[1]):
        hw = model.mm(h, w[D:], dt)
        r = torch.sigmoid(xw[:, t, :D] + hw[:, :D])
        u = torch.sigmoid(xw[:, t, D:2 * D] + hw[:, D:2 * D])
        n = torch.tanh(xw[:, t, 2 * D:] + r * hw[:, 2 * D:])
        keep = mask[:, t:t + 1]
        h = keep * (u * h + (1.0 - u) * n) + (1.0 - keep) * h
        out.append(h)
    return torch.stack(out, 1)


@pytest.mark.parametrize("other", [_lstm_over_gru_weights, _cudnn_gru])
@pytest.mark.parametrize("cell", GRU_TRAIN + GRU_SERVE)
def test_a_gru_held_to_another_recurrence_is_not_correct(
        monkeypatch, cache_dir, capsys, cell, other):
    """The program's GRU against a reference that is not TF1's GRUCell:
    the cell chooses the recurrence, and the check tells them apart."""
    from reference import model
    cell = tiny_case(monkeypatch, cache_dir, cell)
    monkeypatch.setitem(model.HIDDEN, "gru", other)
    assert _run(capsys, cell)["correct"] is False


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
        # every row of the call, so that whichever answers the check
        # samples hold an altered one
        ids = real(self, batches)
        ids[:, 0] = (ids[:, 0] + self._vb[0].shape[0] // 2) % (
            self._vb[0].shape[0])
        return ids
    monkeypatch.setattr(serve.Recommender, "_run", altered)
    assert _run(capsys, cell)["correct"] is False
