"""Rank ↔ whole-array bridge (port of `arec/dist/global_io.py`).

arec builds GLOBAL jax.Arrays from what each process holds, and reads
them back whole. In the port a rank holds plain tensors of its own shard,
so the bridge is three moves:

  * `shard_from_hosts(batch, mesh, device)`: a batch every rank holds
    whole → this rank's "data" slab, on its device.
  * `put_replicated_global(full, mesh, device, row_sharded)`: an array
    every rank holds whole (a checkpoint, weights handed in) → this
    rank's row block (row-sharded leaves) or the whole array
    (replicated ones), on its device.
  * `all_hosts_concat(x, group)`: every rank's tensor, concatenated on
    the leading axis in rank order over `group`, as numpy on every rank.

Without a process group each degrades to the single-device move.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from arec_torch.dist.specs import batch_slab, shard_rows


def _to(x, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(
        x, np.ndarray) else x
    return t.to(device)


def shard_from_hosts(batch: dict, mesh, device) -> dict:
    """This rank's "data" slab of each leaf (numpy or torch), on
    `device`; mesh None: the whole batch."""
    if mesh is not None:
        batch = batch_slab(batch, mesh)
    return {k: _to(x, device) for k, x in batch.items()}


def put_replicated_global(full, mesh, device, row_sharded: bool):
    """A whole array → this rank's part on `device`: its row block when
    `row_sharded` (see `shard_rows`), else all of it."""
    if row_sharded and mesh is not None:
        full = shard_rows(full, mesh)
    return _to(full, device)


def all_hosts_concat(x: torch.Tensor, group=None) -> np.ndarray:
    """Every rank's `x` (equal shapes), concatenated on axis 0 in the
    group's rank order, as numpy on every rank."""
    if not dist.is_initialized():
        return x.cpu().numpy()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts).cpu().numpy()
