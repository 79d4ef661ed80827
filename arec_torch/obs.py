"""The program's spans and counters: one tracing system, on exactly while a
torch profiler records in this process.

Any `torch.profiler.profile` turns it on: the one `Trainer.train()` opens
under AREC_PROFILE_DIR (`train/profile.py`), a benchmark's traced window,
an operator's own. There is no switch of its own. The flag read is the
process-wide one the profiler sets on start and clears on stop
(`torch.autograd.profiler._is_profiler_enabled`), so a worker thread sees
it too.

Off, `span(name)` returns one shared no-op context manager (one flag read,
no allocation) and `count` returns at once. On, a span

  * opens `torch.profiler.record_function(name)`, so a span of the main
    thread lands in the profiler's trace, on the clock of the device's
    kernels (the profiler records no range of a thread it was not started
    on: the prefetch worker's spans are read from `snapshot()` alone);
  * adds its host seconds to an aggregate by name: count, total, self
    (total less its child spans on the same thread) and its parent span's
    name;
  * with `stream=` a CUDA device, records a pair of timing events on that
    device's current stream around the span, from a pool; the oldest pair
    is resolved once more than MAX_PENDING wait, and all at a snapshot.
    Each pair adds "stream seconds": from the end of the stream's earlier
    work to the end of the span's work.

Counters add host integers, never a device value, so no synchronisation.
`snapshot()` resolves the pending events and returns
{"spans": {name: {count, total_s, self_s, stream_s, parent}}, "counts":
{name: n}}; `reset()` clears both. Aggregation is thread-safe.

The spans, each at the layer boundary where its work happens:

  serve.batch     building one padded numpy batch (`serve.Recommender`)
  serve.h2d       its pageable copies to the device
  serve.query     the query encode (`train/loop._serve_step`)
  serve.topk      the seen-masked top-k, with stream seconds
  serve.d2h       the host's wait for the ids and their copy back
  dispatch.prepare  a replay's checks, static-input stacks and generator
                  re-seeding (`train/graph.scan_multi`)
  dispatch.replay   `graph.replay()` alone
  input.build     the prefetch worker's `next` of the batch iterator
  input.stage     its staging of the batch (`data/prefetch`)

and the counters serve.rows_live, serve.rows: the live and padded rows of
every served batch.
"""

from __future__ import annotations

import collections
import threading
import time

import torch
from torch.autograd import profiler as _profiler

MAX_PENDING = 256     # event pairs in flight before the oldest is waited on


class _Off:
    """The span of a process no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def cancel(self) -> None:
        pass


_OFF = _Off()


class _Recorder:
    """The aggregates, the pending event pairs and the events' pool."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.spans: dict[str, list] = {}  # name: [n, total, self, stream, parent]
        self.counts: dict[str, int] = {}
        self.pending: collections.deque = collections.deque()
        self.free: list = []

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def add(self, name: str, total: float, self_s: float, parent) -> None:
        with self.lock:
            agg = self.spans.get(name)
            if agg is None:
                agg = self.spans[name] = [0, 0.0, 0.0, None, parent]
            agg[0] += 1
            agg[1] += total
            agg[2] += self_s
            agg[4] = parent

    def event(self):
        with self.lock:
            if self.free:
                return self.free.pop()
        return torch.cuda.Event(enable_timing=True)

    def pend(self, name: str, start, end) -> None:
        """Queue a span's event pair; past MAX_PENDING, resolve the oldest
        (waiting for it, if it has not completed)."""
        with self.lock:
            self.pending.append((name, start, end))
            if len(self.pending) > MAX_PENDING:
                self._resolve(*self.pending.popleft())

    def _resolve(self, name: str, start, end) -> None:
        end.synchronize()
        agg = self.spans[name]
        agg[3] = (agg[3] or 0.0) + start.elapsed_time(end) / 1e3
        self.free += [start, end]

    def snapshot(self) -> dict:
        with self.lock:
            while self.pending:
                self._resolve(*self.pending.popleft())
            spans = {name: {"count": n, "total_s": total, "self_s": self_s,
                            "stream_s": stream, "parent": parent}
                     for name, (n, total, self_s, stream, parent)
                     in self.spans.items()}
            return {"spans": spans, "counts": dict(self.counts)}

    def reset(self) -> None:
        with self.lock:
            while self.pending:
                _, start, end = self.pending.popleft()
                end.synchronize()
                self.free += [start, end]
            self.spans.clear()
            self.counts.clear()


_REC = _Recorder()


class _Span:
    """One recorded span; see the module docstring."""

    __slots__ = ("name", "device", "parent", "child_s", "t0", "range",
                 "start")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device
        self.child_s = 0.0
        self.start = None

    def __enter__(self):
        stack = _REC.stack()
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.range = _profiler.record_function(self.name)
        self.range.__enter__()
        if self.device is not None:
            self.start = _REC.event()
            self.start.record(torch.cuda.current_stream(self.device))
        self.t0 = time.perf_counter()
        return self

    def _close(self) -> float:
        dt = time.perf_counter() - self.t0
        self.range.__exit__(None, None, None)
        stack = _REC.stack()
        stack.pop()
        if stack:
            stack[-1].child_s += dt
        return dt

    def __exit__(self, *exc):
        end = None
        if self.start is not None:
            end = _REC.event()
            end.record(torch.cuda.current_stream(self.device))
        dt = self._close()
        _REC.add(self.name, dt, dt - self.child_s, self.parent)
        if end is not None:
            _REC.pend(self.name, self.start, end)
        return False

    def cancel(self) -> None:
        """Close the span without recording it."""
        self._close()


def span(name: str, stream=None):
    """A context manager timing its block as span `name`. stream: a device
    whose current stream's time is also taken, when it is a CUDA one."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    dev = None
    if stream is not None:
        dev = torch.device(stream)
        if dev.type != "cuda":
            dev = None
    return _Span(name, dev)


def count(name: str, n: int = 1) -> None:
    """Add host integer `n` to counter `name`."""
    if not _profiler._is_profiler_enabled:
        return
    with _REC.lock:
        _REC.counts[name] = _REC.counts.get(name, 0) + n


def iterate(name: str, iterable):
    """The items of `iterable`, each `next` under span `name`; the `next`
    that finds it exhausted is not recorded."""
    it = iter(iterable)
    while True:
        s = span(name)
        s.__enter__()
        try:
            item = next(it)
        except StopIteration:
            s.cancel()
            return
        except BaseException:
            s.__exit__(None, None, None)
            raise
        s.__exit__(None, None, None)
        yield item


def snapshot() -> dict:
    """The aggregates so far, every pending event pair resolved first
    (stream_s is None for a span that took no stream time)."""
    return _REC.snapshot()


def reset() -> None:
    """Forget every span and counter recorded so far."""
    _REC.reset()
