"""Background batch prefetcher (port of `arec/data/prefetch.py`).

Batch assembly (host numpy, `arec_torch.native`) runs on a worker thread
a fixed depth ahead of the steps, and with `to_device` the worker also
moves each batch to the device. The copies are plain synchronous
`.to(device)` from pageable memory: a non-blocking copy from pinned
memory would need its own stream ordering against the steps (ROADMAP
A6.4).

Unlike arec's, the worker's error is raised in the consumer (arec ends
the epoch early and silently), and closing the generator stops the
worker.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch


def prefetch(it: Iterable, depth: int = 2,
             transform: Callable | None = None) -> Iterator:
    """Wrap any batch iterator; `transform` runs on the worker thread."""
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
            for item in it:
                if transform is not None:
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
            yield item
    finally:
        stop.set()
        t.join()


def to_device(device) -> Callable:
    """Standard transform: numpy batch dict → tensors on `device`."""
    def tf(batch):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in batch.items()}
    return tf
