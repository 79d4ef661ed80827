"""Sparse (touched-rows) table updates on the mesh (port of
`arec/train/sparse_mesh.py`).

The dense mesh step (`train.step.make_mesh_step_core`) differentiates the
loss w.r.t. each rank's table shard and all-reduces that [Vp/T, W]
gradient over "data" every step: at XING's width ~166 MB per table per
step, mostly zeros, plus an optimizer pass over every row. This step
costs O(touched rows · W) per table in compute and in traffic:

  1. The negatives are drawn first, from the step's key, alike on every
     rank, so each rank knows every table row its "data" slab touches.
  2. The touched ids are made unique per slab with a static shape
     (`engine.unique_rows`, cut at its provable bound), then mapped to
     STORED ids (`_stored_ids`), and the subset [dense prefix ++ touched]
     is fetched through the exchange: the list split T ways over "model",
     each rank's part through `tables.sharded._exchange_lookup`, the rows
     all_gathered back (`_subset_exchange_gather`).
  3. The loss is the single-device loss over the subset tables
     (`engine.make_subset_lookup`), so the fused CE kernels (B5 / B6) run
     on the rank's slab; its gradient is w.r.t. the subset only.
  4. The subset gradient goes back to the owners (`_scatter_rows_update`):
     each model rank sends its 1/T of (stored id, gradient row), bucketed
     by owner, through one all-to-all over "model"; the owners all_gather
     what they received over "data" (every data replica of a shard then
     applies the same update), sum colliding rows BEFORE the optimizer
     (Adagrad accumulates the square of the row's total gradient), and
     update exactly those rows: the packed [param ++ accumulator] rows are
     written back by `scatter_rows_set`, the B7 kernel on the card, with
     the pad slots out of range and dropped.

Every shape is static (the touched sets at their bounds, the buckets at
the list length), so every rank issues the same collectives at the same
shapes whatever its data. The slab's loss is a weighted mean, so the
global loss is Σ_d w_d·loss_d / Σ_d w_d and each rank's gradients carry
w_d / W (not 1 / n_data: the shards of a sequence batch carry different
pad counts). The other parameters' gradients are summed over "data"
after that scaling and go through the port's optimizer.

Semantics equal the dense mesh step at keep_prob = 1. With dropout the
masks are drawn per data slab (the key folded with the data index), as
arec's are: equal in distribution to the dense step's, not bit for bit.
The dense mesh step remains the oracle behind train.sparse_update=False.
arec's `make_sparse_mesh_multi_step` (K steps in one `lax.scan`) is not
ported: the Trainer runs `steps_per_dispatch` as K single steps.
"""

from __future__ import annotations

from typing import Callable

import torch

from arec_torch.dist.collectives import all_sum, all_to_all, gather_cat
from arec_torch.dist.specs import DATA_AXIS, TABLE_AXIS, mesh_coords
from arec_torch.kernels.row_scatter import scatter_rows_set
from arec_torch.losses.losses import mesh_gather_cands
from arec_torch.rng import fold_in
from arec_torch.tables.layout import RowPerm
from arec_torch.tables.sharded import (
    _bucket_by_owner, _dedup_ids, _exchange_lookup,
)
from arec_torch.train.sparse import (
    _adagrad_rows, check_sparse_loss, get_path, set_path,
    subset_loss_and_grads, table_paths, touched_rows,
)
from arec_torch.train.step import Optimizer, TrainState, _next, check_tf32


def _stored_ids(uids_nat, total_rows: int, vp: int, perm: RowPerm | None):
    """Natural unique row ids (sentinel = total_rows) → STORED row ids with
    sentinel = vp (rows_per · T), out of range for the exchange's owner
    bucketing, so sentinel slots are dropped. A sentinel never passes
    through the RowPerm, which would map it onto a real row."""
    real = uids_nat < total_rows
    stored = uids_nat if perm is None else perm.apply_ids(uids_nat)
    return torch.where(real, stored, vp)


def _pad_split(x, t: int, me: int, fill):
    """x [n, ...] padded with `fill` to a multiple of t, and rank me's
    1/t block of it."""
    n = x.shape[0]
    chunk = -(-n // t)
    pad = chunk * t - n
    if pad:
        x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])
    return x[me * chunk:(me + 1) * chunk]


def _subset_exchange_gather(table_shard, stored_ids, mesh):
    """[n] stored row ids (the same on every rank of the data row) → their
    [n, W] rows through the owner exchange: model rank m exchanges the
    m-th of T slices of the padded list, and the slices are all_gathered
    back over "model". Sentinel ids (≥ vp) give zero rows."""
    group = mesh.get_group(TABLE_AXIS)
    _, _, me, t = mesh_coords(mesh)
    n = stored_ids.shape[0]
    if n == 0:
        return table_shard.new_zeros((0, table_shard.shape[1]))
    vp = table_shard.shape[0] * t
    mine = _pad_split(stored_ids, t, me, vp)
    rows = _exchange_lookup(table_shard, mine, 0.0, False, group, t)
    return gather_cat(rows, group)[:n]


@torch.no_grad()
def _scatter_rows_update(table_shard, stored_ids, g_rows, lr,
                         optimizer: str, mesh):
    """The touched-rows update of ONE table shard, in place.

    stored_ids [n] / g_rows [n, W] are the data slab's whole touched set
    (the same on each model rank of the data row), already scaled to the
    global loss. Each model rank sends its 1/T through the reverse
    exchange; the owners all_gather over "data", sum colliding rows and
    update exactly those rows. Traffic per rank: O(touched·W/T) over
    "model" and O(touched·W) over "data"."""
    _, _, me, t = mesh_coords(mesh)
    rows_per = table_shard.shape[0]
    w = g_rows.shape[1]
    if stored_ids.shape[0] == 0:
        return table_shard
    my_ids = _pad_split(stored_ids, t, me, rows_per * t)
    my_g = _pad_split(g_rows, t, me, 0.0)
    # each owner's slots hold its requests in order (capacity n: none
    # overflows); sentinel ids fall outside every owner and are dropped,
    # and an empty slot carries local id rows_per (out of range on the
    # receiver) and a zero row
    send_local, send_valid, send_pos, _ = _bucket_by_owner(
        my_ids, None, t, rows_per, my_ids.shape[0])
    send_local = torch.where(send_valid, send_local, rows_per)
    send_g = my_g[send_pos.long()] * send_valid[..., None]
    model_group = mesh.get_group(TABLE_AXIS)
    loc = all_to_all(send_local.reshape(-1), model_group)
    g_r = all_to_all(send_g.reshape(-1, w), model_group)

    # every data replica of this shard must apply the SAME update: gather
    # every data slab's contributions (touched rows only: this replaces
    # the dense step's [Vp/T, W] all-reduce over "data")
    data_group = mesh.get_group(DATA_AXIS)
    flat_ids = gather_cat(loc, data_group)
    flat_g = gather_cat(g_r, data_group)

    # sum colliding rows BEFORE the optimizer
    uloc, valid, inv = _dedup_ids(flat_ids)
    uloc = torch.where(valid, uloc, rows_per)     # pad slots: out of range
    gsum = flat_g.new_zeros(flat_g.shape).index_add(0, inv.long(), flat_g)
    ok = uloc < rows_per
    if optimizer == "adagrad":
        d = table_shard.shape[1] // 2
        rows = torch.where(ok[:, None],
                           table_shard[uloc.long().clamp(max=rows_per - 1)],
                           0.0)
        p_new, a_new = _adagrad_rows(rows[:, :d], rows[:, d:], gsum, lr)
        scatter_rows_set(table_shard, uloc, torch.cat([p_new, a_new], 1),
                         use_kernel=True)
        return table_shard
    table_shard.index_add_(0, uloc.long().clamp(max=rows_per - 1),
                           torch.where(ok[:, None], -lr * gsum, 0.0))
    return table_shard


def make_sparse_mesh_step_core(mesh, is_seq: bool, spec, user_dev, item_dev,
                               rest_opt: Optimizer, base_lr: float,
                               optimizer: str, pop=None,
                               perms: dict[str, RowPerm] | None = None
                               ) -> Callable:
    """step(state, batch_slab, gen) -> (state, metrics) on this rank: the
    single-device sparse step with the subset gather and the row update
    replaced by the exchanges above. The state holds this rank's row
    block of each (packed) table, in its RowPerm order under perms[role],
    and the replicated rest; it is updated in place. The metrics' loss is
    the global one, alike on every rank."""
    if optimizer not in ("adagrad", "sgd"):
        raise ValueError(
            f"sparse_update supports adagrad/sgd, not {optimizer!r}")
    needs_neg = check_sparse_loss(is_seq, spec)
    perms = perms or {}
    paths = table_paths(is_seq, spec)
    packed = optimizer == "adagrad"
    data_group = mesh.get_group(DATA_AXIS)
    d_index, n_data, _, t = mesh_coords(mesh)
    gather_cands = None if needs_neg else mesh_gather_cands(mesh)

    def step(state: TrainState, batch, gen: torch.Generator):
        params = state.params
        check_tf32(get_path(params, paths[0]))
        lr = base_lr * state.lr_scale
        # 1–2. the negatives from the unfolded key (the same on every
        # rank), the touched rows of this data slab
        sampled, specs, uids = touched_rows(is_seq, spec, user_dev,
                                            item_dev, batch, gen, pop)

        # 3. the subset rows through the exchange ([prefix ++ touched])
        sub_full, req_stored = {}, {}
        for s, _, total, _ in specs:
            table = get_path(params, s.path)
            stored = _stored_ids(uids[s.role], total, table.shape[0] * t,
                                 perms.get(s.role))
            if s.prefix:
                stored = torch.cat([torch.arange(
                    s.prefix, dtype=stored.dtype, device=stored.device),
                    stored])
            req_stored[s.role] = stored
            sub_full[s.role] = _subset_exchange_gather(table, stored, mesh)

        # 4. the slab's loss; dropout decorrelated per data slab (the
        # negatives were drawn from the unfolded key); mw / bbpr score
        # against the global batch's positives
        loss, g_subs, g_rest, rest, rest_leaves = subset_loss_and_grads(
            is_seq, spec, params, specs, uids, sub_full, packed, user_dev,
            item_dev, batch, fold_in(gen, d_index), sampled, pop,
            gather_cands)
        w = (batch["mask"].float().sum() if is_seq else torch.tensor(
            float(batch["user"].shape[0]), device=loss.device))

        # the global loss Σ w_d·loss_d / W: each slab's gradients carry
        # w_d / W; the model ranks of a data row hold the same values
        with torch.no_grad():
            scale = w / all_sum(w, data_group)
            flat = torch.cat([(loss.detach() * scale).reshape(1)] + [
                (g * scale).reshape(-1) for g in g_rest])
            if n_data > 1:
                torch.distributed.all_reduce(flat, group=data_group)
            loss_sum, rest_flat = flat[0], flat[1:]
            g_rest = [part.view_as(g) for g, part in zip(
                g_rest, rest_flat.split([g.numel() for g in g_rest]))]

        # 5a. the other parameters: the port's optimizer
        rest_state = state.opt_state["rest"]
        rest_opt.update(g_rest, rest_state, rest_leaves, lr)

        # 5b. the tables: reverse exchange and the touched-rows update
        new_params = rest
        for s, *_ in specs:
            table = _scatter_rows_update(
                get_path(params, s.path), req_stored[s.role],
                g_subs[s.role] * scale, lr, optimizer, mesh)
            new_params = set_path(new_params, s.path, table)

        return (_next(TrainState(params=new_params,
                                 opt_state={"rest": rest_state},
                                 lr_scale=state.lr_scale, step=state.step)),
                {"loss": loss_sum, "lr": lr})

    return step

