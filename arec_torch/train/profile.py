"""Profiling hooks (port of `arec/train/profile.py`) on `torch.profiler`.

Set AREC_PROFILE_DIR=/path and the Trainer captures a trace of steps
[AREC_PROFILE_START, AREC_PROFILE_START + AREC_PROFILE_STEPS) (defaults
10 and 5, arec's), written as a Chrome trace JSON into that directory
(viewable in Perfetto). On a CUDA device the trace holds the kernels, a
CUDA graph replay's too. A K-step dispatch is one call of `on_step` for
its K steps: the trace opens at the first dispatch that holds a step of
the window and closes at the first dispatch past it, so it holds whole
dispatches and is named after the first step it holds.
"""

from __future__ import annotations

import os

import torch
from torch.profiler import ProfilerActivity, profile


class StepProfiler:
    def __init__(self, device="cpu"):
        self.dir = os.environ.get("AREC_PROFILE_DIR", "")
        self.start = int(os.environ.get("AREC_PROFILE_START", "10"))
        self.steps = int(os.environ.get("AREC_PROFILE_STEPS", "5"))
        self._cuda = torch.device(device).type == "cuda"
        self._prof = None
        self._first = None

    def on_step(self, step: int, n: int = 1) -> None:
        """Before the steps [step, step + n) of one dispatch."""
        if not self.dir:
            return
        end = self.start + self.steps
        if self._prof is None and step < end and self.start < step + n:
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self._cuda else [])
            self._prof = profile(activities=acts)
            self._prof.start()
            self._first = step
        elif self._prof is not None and step >= end:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        self._prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self._prof.export_chrome_trace(
            os.path.join(self.dir, f"trace_steps_{self._first}.json"))
        self._prof = None
