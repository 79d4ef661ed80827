"""arec_torch's MetricLogger against arec's: the same calls give the same
JSONL records (but for the wall-clock `t`) and the same stdout lines."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from arec.train.metrics import MetricLogger as JMetricLogger
from arec_torch.train.metrics import MetricLogger

torch.set_num_threads(1)


def _calls(logger):
    logger.log(10, loss=torch.tensor(2.5), recall_at_k=0.125, lr=np.float32(
        0.1), examples_per_s=1234.5678, note="text", flag=True)
    logger.log(np.int64(20), loss=1.75, count=7)
    logger.log(20, final_recall_at_k=0.25, final_eval_approximate=0.0)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_records_and_stdout_equal_arecs(tmp_path, capsys):
    _calls(JMetricLogger(str(tmp_path / "jax")))
    want_out = capsys.readouterr().out
    log = MetricLogger(str(tmp_path / "torch"))
    _calls(log)
    log.close()
    got_out = capsys.readouterr().out
    assert got_out == want_out and got_out.count("[metrics]") == 3
    want = _records(tmp_path / "jax" / "metrics.jsonl")
    got = _records(tmp_path / "torch" / "metrics.jsonl")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        assert g.pop("t") >= 0 and w.pop("t") >= 0
        assert g == w


def test_disabled_logger_writes_nothing(tmp_path, capsys):
    log = MetricLogger(str(tmp_path / "off"), tensorboard=True,
                       enabled=False)
    log.log(1, loss=1.0)
    log.close()
    log.log(2, loss=1.0)                      # no-op even after close
    assert not os.path.exists(tmp_path / "off")
    assert capsys.readouterr().out == ""


def test_log_after_close_raises(tmp_path):
    log = MetricLogger(str(tmp_path))
    log.log(1, loss=1.0)
    log.close()
    with pytest.raises(ValueError, match="after close"):
        log.log(2, loss=1.0)


def test_tensorboard_stream(tmp_path):
    pytest.importorskip("tensorboard")
    log = MetricLogger(str(tmp_path), tensorboard=True)
    log.log(3, loss=0.5, note="text")
    log.close()
    events = os.listdir(tmp_path / "tb")
    assert any(name.startswith("events.out.tfevents") for name in events)
    with pytest.raises(ValueError, match="after close"):
        log.log(4, loss=0.5)


def test_tensorboard_without_the_package_raises(tmp_path, monkeypatch):
    """tensorboard=true never degrades to a silent no-op: a missing
    package raises at construction."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError):
        MetricLogger(str(tmp_path / "m"), tensorboard=True)
    assert not os.path.exists(tmp_path / "m" / "metrics.jsonl")
