"""Row-sharded embedding lookups over the mesh's "model" group (port of
`arec/tables/sharded.py`).

Each rank holds one contiguous block of a table's STORED rows (owner =
stored_row // rows_per_shard); with MeshConfig.row_shard = "shuffle" the
stored rows are a `RowPerm` of the natural ones, and request ids are
remapped arithmetically before anything else. Two lookups, both with the
signature of `engine.dense_lookup` (table_shard, ids) → rows, so every
model runs unchanged on a mesh:

  * `make_sharded_lookup`: arec's all-to-all exchange (DLRM-style), the
    training-side lookup. The request list, the same on every rank of the
    "model" group, is split T ways; rank m exchanges slice m only:
      1. (dedup) its ids are uniqued: one sort + a cumsum compaction;
      2. each id is bucketed by owner into [T, C] slots (stable sort +
         rank in group);
      3. the [T·C] local-row ids go out with `all_to_all_single`;
      4. each rank gathers the rows it was asked for;
      5. the [T·C, D] rows come back with a second `all_to_all_single`
         and are scattered to request order;
      6. the T slices are `all_gather`ed back into the whole list (arec's
         out_spec P(("data", "model")) and XLA's reshard do this step).
    Splits are equal (C slots per peer), so no size exchange and no host
    sync happens.
    Capacity: C = ceil(n · capacity_factor / T) slots per destination;
    only capacity_factor = 0 (C = n, the default) is overflow-proof.
    Every overflowed request is counted into `EXCHANGE_DROPS` (a device
    tensor; read, with one host sync, only when capacity_factor > 0).
    The lookup is differentiable in the table shard, as `jax.grad` makes
    arec's: the rows' all-to-all runs in reverse (`dist.collectives`),
    the row gather's backward adds each slot's cotangent into its table
    row, the dedup's inverse gather sums duplicate ids' cotangents BEFORE
    the reverse exchange, and the closing all_gather's backward sums the
    cotangents over "model" and keeps this rank's slice. The shard's
    gradient is this rank's partial: the train step sums it over "data"
    (arec's shard_map does that psum because the shard enters it
    replicated over "data").
  * `make_masked_lookup`: the serving-side lookup, the counterpart of
    arec's `make_perm_dense_lookup` and `make_gspmd_lookup` (a plain gather
    on row-sharded operands, whose collectives XLA chooses). Each rank
    gathers the requested rows it owns, zeroes the rest, and one
    `all_reduce(SUM)` over "model" completes every row: exact, since a
    row receives one nonzero addend. It needs the same ids on every rank
    of the group, and moves T times the exchange's row bytes.

The item-latent encode, which reads nearly every row of the item table,
takes the table whole instead (`gather_rows`, then arec's
`make_perm_dense_lookup`).

Both lookups take a `.head(table, n)` method: the first n rows (the
engine's dense small-vocab prefix, which it reads as a static slice on
one device).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from arec_torch.dist.collectives import all_gather_cat, all_to_all, gather_cat
from arec_torch.dist.specs import TABLE_AXIS
from arec_torch.tables.engine import dense_lookup
from arec_torch.tables.layout import RowPerm


class _DropCounter:
    """Overflowed exchange requests, accumulated on the device (no host
    sync per lookup); `read_and_reset` reads them with one sync, and warns
    on the first nonzero read."""

    def __init__(self):
        self._pending = None
        self._warned = False

    def add(self, n: torch.Tensor) -> None:
        n = n.detach().to(torch.int64)
        self._pending = n if self._pending is None else self._pending + n

    def read_and_reset(self) -> int:
        n = 0 if self._pending is None else int(self._pending)
        self._pending = None
        if n and not self._warned:
            self._warned = True
            print(f"[exchange] WARNING: {n} lookup request(s) overflowed "
                  f"their all-to-all capacity bucket and returned ZERO rows. "
                  f"Raise mesh.capacity_factor (0 = overflow-proof). Total "
                  f"is tracked in step metrics as 'exchange_dropped'.",
                  flush=True)
        return n


EXCHANGE_DROPS = _DropCounter()


def round_up_rows(rows: int, model_size: int) -> int:
    """Tables are padded to a model-axis multiple so every rank holds an
    equal row block (pad rows are never addressed: ids < rows)."""
    return -(-rows // model_size) * model_size


def pad_table_rows(table: torch.Tensor, model_size: int) -> torch.Tensor:
    pad = round_up_rows(table.shape[0], model_size) - table.shape[0]
    if pad:
        table = torch.cat([table, table.new_zeros((pad, table.shape[1]))])
    return table


def shard_row_index(rows: int, model_size: int, shard: int,
                    perm: RowPerm | None = None):
    """The natural row behind each stored row of rank `shard`'s block of a
    `rows`-row table (padded to a model-axis multiple), as int64 numpy:
    stored row j holds natural row pi^{-1}(j) under `perm` (rows past the
    permuted region stay in place). An index ≥ rows is a pad row."""
    per = round_up_rows(rows, model_size) // model_size
    idx = np.arange(shard * per, (shard + 1) * per, dtype=np.int64)
    if perm is not None:
        n = perm.prefix + perm.r
        inv = perm.inv_index()
        head = idx < n
        idx[head] = inv[idx[head]]
    return idx


def _bucket_by_owner(ids: torch.Tensor, valid: torch.Tensor | None,
                     num_shards: int, rows_per: int, capacity: int):
    """ids [n] → (send_local [T, C], send_valid [T, C], send_pos [T, C],
    dropped [n] bool: True where a VALID request found no bucket slot).
    Invalid requests and overflow are written to a spill slot past the
    [T·C] buffer, which is cut off (arec's scatter mode="drop")."""
    n = ids.shape[0]
    dev = ids.device
    owner = torch.div(ids, rows_per, rounding_mode="floor")
    if valid is not None:
        owner = torch.where(valid, owner, num_shards)   # invalid → OOB
    local = ids % rows_per
    order = torch.sort(owner, stable=True).indices
    so = owner[order]
    # rank within each owner group (so is sorted)
    rank = torch.arange(n, device=dev) - torch.searchsorted(so, so,
                                                            side="left")
    keep = (so < num_shards) & (rank < capacity)
    spill = num_shards * capacity
    slot = torch.where(keep, so * capacity + rank, spill)

    def scatter(values, dtype):
        out = torch.zeros(spill + 1, dtype=dtype, device=dev)
        out[slot] = values.to(dtype)
        return out[:spill].view(num_shards, capacity)

    send_local = scatter(local[order], torch.int32)
    send_valid = scatter(torch.ones_like(keep), torch.bool)
    send_pos = scatter(order, torch.int32)
    overflow = (so < num_shards) & (rank >= capacity)
    dropped = torch.zeros(n, dtype=torch.bool, device=dev)
    dropped[order] = overflow
    return send_local, send_valid, send_pos, dropped


def _dedup_ids(ids: torch.Tensor):
    """Static-shape unique: (uniq [n], valid [n], inv [n]) with
    ids == uniq[inv]; trailing uniq slots are value-0 with valid=False.
    One sort + a cumsum compaction (duplicate occurrences write the SAME
    value to the same slot, so the scatter is order-independent)."""
    n = ids.shape[0]
    s, order = torch.sort(ids)
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = s[1:] != s[:-1]
    slot = torch.cumsum(first, 0) - 1
    uniq = torch.zeros_like(ids)
    uniq[slot] = s
    valid = torch.arange(n, device=ids.device) < slot[-1] + 1
    inv = torch.zeros(n, dtype=torch.int32, device=ids.device)
    inv[order] = slot.to(torch.int32)
    return uniq, valid, inv


def _exchange_lookup(table_shard: torch.Tensor, ids: torch.Tensor,
                     capacity_factor: float, dedup: bool, group,
                     num_shards: int) -> torch.Tensor:
    """Rows [n, D] for this rank's own stored-row ids [n]; every rank of
    `group` calls it at the same n."""
    T = num_shards
    n = ids.shape[0]
    rows_per = table_shard.shape[0]
    cap = n if capacity_factor <= 0 else max(
        1, -(-int(n * capacity_factor) // T))
    valid = inv = None
    if dedup:
        ids, valid, inv = _dedup_ids(ids)
    send_local, send_valid, send_pos, dropped = _bucket_by_owner(
        ids, valid, T, rows_per, cap)
    if capacity_factor > 0:
        # in REQUEST units: a dropped unique id drops every duplicate
        EXCHANGE_DROPS.add(dropped[inv].sum() if dedup else dropped.sum())
    recv_local = all_to_all(send_local.reshape(-1), group)
    # recv_local is a local row or 0 for pad slots: always in range. Both
    # row gathers here are `embedding`, whose backward sums a row's
    # repeats by a sort and segments: the pad slots all read row 0 and a
    # hot id repeats thousands of times, and an indexing backward over
    # them took 180 ms and 36 ms of a dense step at syn_xing_full's width
    # (one H100, a one-rank NCCL group) against 25 ms for the whole step on
    # one card
    rows = torch.nn.functional.embedding(recv_local.long(), table_shard)
    back = all_to_all(rows, group)
    flat_rows = back * send_valid.reshape(-1, 1)
    # send_pos is a permutation of request slots; invalid slots carry
    # zero rows and add them to position 0
    out = flat_rows.new_zeros((n, table_shard.shape[1])).index_add(
        0, send_pos.reshape(-1).long(), flat_rows)
    if dedup:
        # back to request order; the backward of this gather sums the
        # duplicate ids' cotangents before the reverse exchange
        out = torch.nn.functional.embedding(inv.long(), out)
    return out


def _with_head(lookup):
    lookup.head = lambda table, n: lookup(
        table, torch.arange(n, dtype=torch.int32, device=table.device))
    return lookup


def _model_group(mesh):
    return (mesh.get_group(TABLE_AXIS), mesh.size(1),
            mesh.get_local_rank(TABLE_AXIS))


def make_sharded_lookup(mesh, capacity_factor: float = 0.0,
                        dedup: bool = True, perm: RowPerm | None = None):
    """LookupFn (table_shard, ids) → rows [*ids.shape, D] through the
    all-to-all exchange over "model". ids (any shape) must be the same on
    every rank of the group, as the data slab of a batch is. `perm`: the
    table is stored in RowPerm layout (row_shard = "shuffle").

    arec pads the batch's whole flat id list to a multiple of data·model
    and splits it over both axes; here each rank pads its data slab's list
    to a multiple of model. The rows are the same; the per-rank slices,
    and so the dedup and the capacity buckets, are arec's exactly when
    the batch's id count divides by data·model. A list every data rank
    holds whole (the sampled negatives) arec splits over data·model and
    the port over model, so at capacity_factor > 0 its drops differ.

    `.head(table, n)` (the engine's dense prefix, which arec reads as a
    plain slice of the sharded table) runs the exchange at capacity 0,
    so no prefix row is ever dropped."""
    group, t, me = _model_group(mesh)

    def run(table_shard, ids, cf):
        flat = ids.reshape(-1)
        if perm is not None:
            flat = perm.apply_ids(flat)
        n = flat.shape[0]
        chunk = -(-n // t)
        flat = torch.nn.functional.pad(flat, (0, chunk * t - n))
        mine = _exchange_lookup(table_shard, flat[me * chunk:(me + 1) * chunk],
                                cf, dedup, group, t)
        return all_gather_cat(mine, group)[:n].reshape(
            *ids.shape, table_shard.shape[1])

    def lookup(table_shard, ids):
        return run(table_shard, ids, capacity_factor)

    lookup.head = lambda table, n: run(
        table, torch.arange(n, dtype=torch.int32, device=table.device), 0.0)
    return lookup


def make_perm_dense_lookup(perm: RowPerm):
    """Single-pass gather through a RowPerm on a WHOLE table stored in
    shuffle layout (arec's eval-path counterpart of dense_lookup): the
    lookup of the item-latent encode, over the table `gather_rows`
    assembles."""
    def lookup(table, ids):
        return dense_lookup(table, perm.apply_ids(ids))
    return lookup


def gather_rows(table_shard: torch.Tensor, mesh) -> torch.Tensor:
    """The whole stored table on every rank: the "model" ranks' row blocks
    all-gathered in shard order. The item-latent encode reads nearly every
    row of the item table (each item's id row and its attribute rows), so
    one gather of the table moves the least: each rank receives (T-1)/T of
    it, where the exchange would move T slots per requested row."""
    return gather_cat(table_shard, _model_group(mesh)[0])


def make_masked_lookup(mesh, perm: RowPerm | None = None):
    """LookupFn (table_shard, ids) → rows: owned rows gathered, the rest
    zero, summed over "model" by one all_reduce. ids must be the same on
    every rank of the group; they clip into the padded table's rows, as
    jnp.take's mode="clip" does."""
    group, t, me = _model_group(mesh)

    def lookup(table_shard, ids):
        rows_per = table_shard.shape[0]
        pid = perm.apply_ids(ids) if perm is not None else ids
        local = pid.long().clamp(0, rows_per * t - 1) - me * rows_per
        mine = (local >= 0) & (local < rows_per)
        rows = table_shard[local.clamp(0, rows_per - 1)]
        rows = torch.where(mine[..., None], rows, 0.0)
        dist.all_reduce(rows, group=group)
        return rows

    return _with_head(lookup)
