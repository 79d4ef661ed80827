"""The traced run: torch.profiler over the measured window, reduced to the
device's busy time (the union of its activity intervals, so work that
overlaps on two streams counts once), kernel time by symbol, and the
breakdown of device operations and idle gaps."""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field


@dataclass
class Trace:
    """What a traced window left: device intervals (name, start_s, end_s)
    and host events (name, start_s, end_s, thread), times in seconds from
    the trace's start."""
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    kinds: dict = field(default_factory=dict)   # activity type: events

    def busy_s(self) -> float:
        return union_s([(s, e) for _, s, e in self.device])

    def kernel_s(self, pattern: str) -> tuple[float, int]:
        """(summed device seconds, launches) of the device events whose
        name matches `pattern`."""
        rx = re.compile(pattern)
        hits = [(e - s) for name, s, e in self.device if rx.search(name)]
        return sum(hits), len(hits)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each gap named by the innermost host event open at its
        middle (the harness's `bench.*` spans among them)."""
        by_name: dict[str, float] = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = idle_gaps(sorted((s, e) for _, s, e in self.device))
        gaps = sorted(gaps, key=lambda g: -(g[1] - g[0]))[:top]
        named = []
        for s, e in gaps:
            mid = (s + e) / 2
            open_ = [(he - hs, name) for name, hs, he, _ in self.host
                     if hs <= mid <= he]
            label = min(open_)[1] if open_ else "host: no event open"
            named.append([label[:120], e - s])
        return {"device_ops": [[n[:120], t] for n, t in ops],
                "idle_gaps": named}


def union_s(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_gaps(sorted_intervals) -> list[tuple[float, float]]:
    """The gaps between the union's pieces, in order."""
    gaps, end = [], None
    for s, e in sorted_intervals:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def _kind(e) -> str:
    """"user_annotation" for a record_function's span (which also shows on
    the device's timeline and is not device work), else "device"."""
    if e.is_user_annotation() or e.name().startswith("bench."):
        return "user_annotation"
    return "device"


@contextlib.contextmanager
def traced(enabled: bool, out: Trace):
    """Profile the block (host and device) when `enabled`, filling `out`
    once it ends; otherwise run it as it is."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.cuda.is_available()
    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if on_card else []))
    prof.__enter__()
    try:
        yield
    finally:
        if on_card:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    for e in results.events():
        s, d = (e.start_ns() - t0) / 1e9, e.duration_ns() / 1e9
        kind = _kind(e)
        out.kinds[kind] = out.kinds.get(kind, 0) + 1
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if kind == "device":
                out.device.append((e.name(), s, s + d))
        else:
            out.host.append((e.name(), s, s + d, e.start_thread_id()))
