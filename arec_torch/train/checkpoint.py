"""Checkpoint / resume (port of `arec/train/checkpoint.py`), torch-native.

Layout: one directory per step, `train_dir/ckpt/<step>/`, holding

  state.pt   the TrainState as a dict of tensors (params, opt_state,
             lr_scale, step), written by `torch.save` and read by
             `torch.load(weights_only=True)`;
  meta.json  {"data_pos": ..., "config": <the config JSON>}.

Writes are atomic: the step is written into a temporary sibling directory
(`.tmp-<step>-...`), every file and the directory are fsynced, and one
`os.replace` publishes it. A directory with a step number for its name is
therefore always complete, and `latest_step()` ignores everything else.
Only the newest `keep` steps are kept; older ones are pruned after a
successful publish (renamed out of the step namespace first, then
deleted), so a crash mid-prune never leaves a half step behind.

`async_save` (train.async_ckpt): the train steps update the state's
tensors in place, so `save()` copies every leaf to host memory before it
returns; only the file write runs on a background thread, which `drain()`
joins (and whose error it raises). One write is in flight at a time.

Restore reads into any target whose leaves give shapes and dtypes alone
(`abstract_like`: tensors on the `meta` device), so a serve-only restore
allocates no random tables or optimizer state; the saved tensors load
straight onto the requested device. A table whose row count differs from
the target's is sliced or zero-padded on axis 0 (arec's `_adapt_leaf`
rule); any other mismatch raises.

On a mesh (`rows=`) each rank restores its own shard: the file is
memory-mapped on the host, each row-sharded leaf gathers the natural
rows behind this rank's stored rows (its model-axis block, through the
table's RowPerm under row_shard = "shuffle"; a row past the saved ones
is zero, as `_adapt` pads), and only that block is copied to the device.
The layout on disk stays natural, so a checkpoint written on one device
restores onto any mesh shape and either placement.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from arec_torch.train.step import TrainState

STATE_FILE = "state.pt"
META_FILE = "meta.json"


def _to(tree, device, copy: bool = False):
    """The tree with every tensor on `device` (copied, with copy=True)."""
    if isinstance(tree, dict):
        return {k: _to(v, device, copy) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device, copy) for v in tree)
    return tree.detach().to(device, copy=copy)


def _adapt(saved, target, path: str, rows=None):
    """`saved` laid onto `target`'s structure: the same keys and lengths,
    each tensor of the target's dtype and shape, a differing row count
    sliced or zero-padded on axis 0. rows(keys) → the saved row behind
    each of the target's rows (int64 numpy; ≥ the saved count: a zero
    row), or None to keep that rule, for a rank's shard of a table."""
    if isinstance(target, dict):
        if not isinstance(saved, dict) or set(saved) != set(target):
            raise ValueError(
                f"checkpoint/model structure mismatch at {path or '/'}: "
                f"saved {sorted(saved) if isinstance(saved, dict) else type(saved).__name__} "
                f"vs target {sorted(target)}")
        return {k: _adapt(saved[k], target[k], f"{path}/{k}", rows)
                for k in target}
    if isinstance(target, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(target):
            raise ValueError(f"checkpoint/model structure mismatch at {path}")
        return type(target)(_adapt(s, t, f"{path}/{i}", rows)
                            for i, (s, t) in enumerate(zip(saved, target)))
    if saved.dtype != target.dtype:
        raise ValueError(f"checkpoint/model dtype mismatch at {path}: "
                         f"saved {saved.dtype} vs target {target.dtype}")
    idx = None if rows is None else rows(tuple(path.strip("/").split("/")))
    if idx is not None:
        if len(idx) != target.shape[0] or (
                saved.shape[1:] != target.shape[1:]):
            raise ValueError(
                f"checkpoint/model shape mismatch beyond row padding at "
                f"{path}: saved {tuple(saved.shape)} vs a shard of "
                f"{tuple(target.shape)}")
        n = saved.shape[0]
        out = saved[torch.from_numpy(np.minimum(idx, n - 1))]
        out[torch.from_numpy(idx >= n)] = 0
        return out
    if saved.shape == target.shape:
        return saved
    if saved.dim() != target.dim() or saved.dim() == 0 or (
            saved.shape[1:] != target.shape[1:]):
        raise ValueError(
            f"checkpoint/model shape mismatch beyond row padding at {path}: "
            f"saved {tuple(saved.shape)} vs target {tuple(target.shape)}")
    rows = target.shape[0]
    if saved.shape[0] >= rows:
        return saved[:rows].clone()
    pad = saved.new_zeros((rows - saved.shape[0],) + tuple(saved.shape[1:]))
    return torch.cat([saved, pad], dim=0)


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Checkpointer:
    def __init__(self, train_dir: str, keep: int = 3,
                 async_save: bool = False):
        self.path = os.path.abspath(os.path.join(train_dir, "ckpt"))
        self.keep = keep
        self.async_save = async_save
        self._pool: ThreadPoolExecutor | None = None
        self._pending: Future | None = None

    # ---- the step namespace ---------------------------------------------
    def _steps(self) -> list[int]:
        if not os.path.isdir(self.path):
            return []
        return sorted(int(n) for n in os.listdir(self.path) if n.isdigit()
                      and os.path.isdir(os.path.join(self.path, n)))

    def latest_step(self):
        """The newest complete step, or None."""
        steps = self._steps()
        return steps[-1] if steps else None

    # ---- save -------------------------------------------------------------
    def save(self, step: int, state: TrainState, data_pos: dict,
             config_json: str) -> None:
        """Snapshot `state` to host memory, then write it (in the
        background with async_save). Returns once the snapshot is taken:
        the caller may update the state's tensors in place right after."""
        t0 = time.perf_counter()
        self.drain()
        if os.path.exists(os.path.join(self.path, str(step))):
            raise FileExistsError(f"checkpoint step {step} already exists "
                                  f"under {self.path}")
        host = _to(state._asdict(), "cpu", copy=True)
        meta = {"data_pos": data_pos, "config": config_json}
        if not self.async_save:
            self._write(step, host, meta, t0)
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(1, "arec-ckpt")
        self._pending = self._pool.submit(self._write, step, host, meta, t0,
                                          time.perf_counter() - t0)

    def _write(self, step: int, host: dict, meta: dict, t0: float,
               blocked_s: float | None = None) -> None:
        os.makedirs(self.path, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self.path)
        try:
            t1 = time.perf_counter()
            torch.save(host, os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, META_FILE), "w") as f:
                json.dump(meta, f)
            nbytes = 0
            for name in (STATE_FILE, META_FILE):
                _fsync(os.path.join(tmp, name))
                nbytes += os.path.getsize(os.path.join(tmp, name))
            _fsync(tmp)
            os.replace(tmp, os.path.join(self.path, str(step)))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _fsync(self.path)
        write_s = time.perf_counter() - t1
        if blocked_s is None:
            blocked_s = time.perf_counter() - t0
        print(f"[ckpt] saved step {step}: {nbytes} bytes; save() blocked "
              f"{blocked_s:.3f} s, write {write_s:.3f} s "
              f"({'async' if self.async_save else 'sync'})", flush=True)
        self._prune()

    def _prune(self) -> None:
        for step in (self._steps()[:-self.keep] if self.keep else []):
            doomed = tempfile.mkdtemp(prefix=f".tmp-prune-{step}-",
                                      dir=self.path)
            os.rmdir(doomed)
            os.replace(os.path.join(self.path, str(step)), doomed)
            shutil.rmtree(doomed)

    def drain(self) -> None:
        """Block until an in-flight async write is published (and raise
        its error, if it failed)."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    # ---- restore ----------------------------------------------------------
    def restore(self, target: TrainState, device="cpu", rows=None,
                step=None):
        """Load `step` (default the latest) into `target`'s structure on
        `device`; `rows`: a rank's shard (see `_adapt`), read from the
        memory-mapped file on the host. Returns (state, data_pos,
        config_json), or None without a step."""
        self.drain()                 # an in-flight async save must win
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        d = os.path.join(self.path, str(step))
        saved = torch.load(os.path.join(d, STATE_FILE),
                           map_location="cpu" if rows else device,
                           weights_only=True, mmap=True)
        with open(os.path.join(d, META_FILE)) as f:
            meta = json.load(f)
        tree = _adapt(saved, target._asdict(), "", rows)
        if rows:
            tree = _to(tree, device)
        return TrainState(**tree), meta["data_pos"], meta["config"]


def abstract_like(state: TrainState) -> TrainState:
    """The state's shapes and dtypes without its storage: a restore target
    of tensors on the `meta` device."""
    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(meta(v) for v in tree)
        return torch.empty_like(tree, device="meta")
    return TrainState(*(meta(x) for x in state))
