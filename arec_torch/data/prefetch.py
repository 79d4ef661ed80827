"""Background batch prefetcher (port of `arec/data/prefetch.py`).

Batch assembly (host numpy, the C++ packer of `arec_torch.native`) runs on
a worker thread a fixed depth ahead of the steps. With `to_device` on a
CUDA device the worker also stages each batch, and the host-to-device
transfer of the next batch overlaps the current step's compute, as arec's
`jax.device_put` does:

- the worker copies the batch's arrays into pinned host buffers, taken
  from a ring whose slots are reused only after the event of the copy that
  read them has completed, and issues non-blocking copies on a copy stream
  of its own, then records one event for the batch;
- before the consumer receives the batch, its current stream waits for
  that event (on the device; the host does not block), and each device
  tensor is marked with `record_stream` so that the caching allocator does
  not hand its memory to a later batch while a step may still read it.

A plain `.to(device)` from pageable memory would instead wait for every
step already queued on the stream before it copies. On the CPU the batch
becomes tensors with `torch.from_numpy`. A K-step dispatch (arec's
`_stage_stacked`) takes K of these staged batches and stacks them into
its CUDA graph's static inputs with a device copy on the consumer's
stream (`train.graph.scan_multi`), so no pageable copy enters it.

Unlike arec's, the worker's error is raised in the consumer (arec ends the
epoch early and silently), and closing the generator stops the worker.
"""

from __future__ import annotations

import functools
import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from arec_torch import obs


class Staged:
    """A batch whose copies to `device` are queued on a copy stream, with
    the event recorded after them."""

    def __init__(self, tensors: dict, event: torch.cuda.Event, device):
        self.tensors = tensors
        self.event = event
        self.device = device

    def wait(self) -> dict:
        """Order the calling thread's current stream after the copies and
        hand the batch to it. Call once, on the thread that consumes it."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        for t in self.tensors.values():
            t.record_stream(stream)
        return self.tensors


class PinnedStager:
    """Stages numpy batch dicts on a CUDA device through a ring of pinned
    host buffers and a copy stream of its own. One thread calls it at a
    time (the prefetch worker); the consumer calls `Staged.wait`."""

    def __init__(self, device, slots: int):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.ring = [({}, None) for _ in range(slots)]   # (buffers, event)
        self.next = 0

    def __call__(self, batch: dict) -> Staged:
        buffers, event = self.ring[self.next]
        if event is not None:
            event.synchronize()       # the copy that read this slot is done
        out = {}
        with torch.cuda.stream(self.stream):
            for k, v in batch.items():
                src = torch.from_numpy(np.ascontiguousarray(v))
                buf = buffers.get(k)
                if buf is None or buf.shape != src.shape or (
                        buf.dtype != src.dtype):
                    buf = buffers[k] = torch.empty(
                        src.shape, dtype=src.dtype, pin_memory=True)
                buf.copy_(src)
                out[k] = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.ring[self.next] = (buffers, event)
        self.next = (self.next + 1) % len(self.ring)
        return Staged(out, event, self.device)


def copy_batch(batch: dict, device) -> dict:
    """numpy batch dict → tensors on `device`, synchronously (on CUDA, a
    pageable copy on the current stream)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def to_device(device, depth: int = 2) -> Callable:
    """Standard transform for `prefetch(..., depth)`: on CUDA a
    `PinnedStager` with depth + 2 slots (the queue's batches, the one the
    consumer holds and the one being staged), elsewhere `copy_batch`."""
    device = torch.device(device)
    if device.type == "cuda":
        return PinnedStager(device, depth + 2)
    return functools.partial(copy_batch, device=device)


def prefetch(it: Iterable, depth: int = 2,
             transform: Callable | None = None) -> Iterator:
    """Wrap any batch iterator; `transform` runs on the worker thread. A
    `Staged` batch is handed over with `Staged.wait` in the consumer. The
    worker's `next` of the iterator and its `transform` of each batch are
    the spans `input.build` and `input.stage` (`arec_torch.obs`)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in obs.iterate("input.build", it):
                if transform is not None:
                    with obs.span("input.stage"):
                        item = transform(item)
                if not put((True, item)):
                    return
        except BaseException as e:  # handed to the consumer, raised there
            put((False, e))
            return
        put((False, None))

    t = threading.Thread(target=worker, name="arec-prefetch", daemon=True)
    t.start()
    try:
        while True:
            ok, item = q.get()
            if not ok:
                if item is not None:
                    raise item
                return
            yield item.wait() if isinstance(item, Staged) else item
    finally:
        stop.set()
        t.join()
