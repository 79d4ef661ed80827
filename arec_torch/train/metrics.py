"""Structured metrics (port of `arec/train/metrics.py`).

Every scalar goes to (a) stdout in a compact line and (b) a JSONL stream
in train_dir, with the same record keys and the same stdout line as arec.
With `train.tensorboard=true` the same scalars also stream to a
TensorBoard event file under train_dir/tb through torch's SummaryWriter;
the writer is made at construction, so a missing `tensorboard` package
raises there instead of silently dropping the stream.
"""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, train_dir: str, filename: str = "metrics.jsonl",
                 tensorboard: bool = False, enabled: bool = True):
        """enabled=False → every call is a no-op (a serve-only Trainer
        shares train_dir with the run that trains and must not write)."""
        self.enabled = enabled
        self._t0 = time.time()
        self._tb = None
        self._closed = False
        self._f = None
        if not enabled:
            return
        if tensorboard:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=os.path.join(train_dir, "tb"))
        os.makedirs(train_dir, exist_ok=True)
        self._f = open(os.path.join(train_dir, filename), "a", buffering=1)

    def log(self, step: int, **scalars) -> None:
        if not self.enabled:
            return
        if self._closed:
            raise ValueError("MetricLogger.log() after close()")
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "t") and isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, global_step=rec["step"])
        parts = " ".join(
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in rec.items() if k not in ("t",))
        print(f"[metrics] {parts}", flush=True)

    def close(self) -> None:
        self._closed = True
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()
            self._tb = None
