"""CPU tests of the benchmark harness: each cell's driver runs end to end
at a tiny size on the CPU (the kernels' plain versions), with the look for
a card skipped."""

import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

# sizes a CPU test run can hold; widths are the tests' own
TINY = {"data": {"syn_items": 3000, "syn_users": 2000,
                 "syn_interactions": 40000, "syn_tag_vocab": 64},
        "train": {"batch_size": 256, "num_sampled": 64},
        "model": {"dim": 16}}
TINY_SEQ = {"train": {"batch_size": 32}, "model": {"max_seq_len": 10}}
# the tiny size's own limits: its rounding is not the cells' (the CPU's
# plain CE and scan, 16-wide products), so the cells' limits, set from
# chip readings at their own sizes, do not carry over
TINY_LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 1e-3,
               "score_gap": 1e-2}


def tiny(cell, rnn_cell: str | None = None):
    """The cell with its configuration cut to TINY; a sequence cell's
    `model.cell` set to `rnn_cell` where one is given."""
    cfg = copy.deepcopy(cell.config)
    seq = cfg["config"]["model"]["model"] == "lstm"
    for part in (TINY, TINY_SEQ if seq else {}):
        for sec, kv in part.items():
            cfg["config"][sec].update(kv)
    if seq and rnn_cell:
        cfg["config"]["model"]["cell"] = rnn_cell
    cell.config = cfg
    cell.limits = {k: TINY_LIMITS[k] for k in cell.limits}
    return cell


@pytest.fixture(scope="session")
def cache_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache"))


def use_tiny_cells(monkeypatch, cache_dir, rnn_cell=None):
    """Cell.find gives tiny cells (each sequence configuration's
    `model.cell` set to `rnn_cell` where one is given), their data cached
    in `cache_dir`; returns harness.bench."""
    import torch
    from harness import bench
    torch.set_num_threads(2)
    find = bench.Cell.find
    monkeypatch.setattr(bench.Cell, "find",
                        staticmethod(lambda name, spec=None:
                                     tiny(find(name, spec), rnn_cell)))
    monkeypatch.setattr(bench, "CACHE", cache_dir)
    return bench


def tiny_case(monkeypatch, cache_dir, case: str) -> str:
    """A test case "<workload>" or "<workload>@<cell>" (the workload's
    sequence configuration switched to that recurrent cell) made tiny;
    returns the workload's name."""
    name, _, rnn_cell = case.partition("@")
    use_tiny_cells(monkeypatch, cache_dir, rnn_cell or None)
    return name


@pytest.fixture
def tiny_cells(monkeypatch, cache_dir):
    """Cell.find gives tiny cells, their data cached in pytest's
    temporary directory."""
    return use_tiny_cells(monkeypatch, cache_dir)
