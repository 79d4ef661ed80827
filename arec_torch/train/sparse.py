"""Sparse (touched-rows-only) embedding updates (port of
`arec/train/sparse.py`).

The dense step (`arec_torch.train.step`) forms full-table gradients and
runs Adagrad over every table row each step: O(vocab·D) bytes a step,
about 1.4 GB of tables at the XING twin's width. This step costs
O(touched rows·D):

  1. The negatives are drawn first (every sampled loss takes pre-drawn
     `sampled`), so every table row the step touches is known up front.
  2. Per fused table, the touched gather-row ids are sorted and made
     unique with a static shape (`engine.unique_rows`); the dense
     small-vocab prefix is always touched and handled with them.
  3. The loss is differentiated w.r.t. SUBSET tables [prefix ++
     table[uids]] (`engine.build_subset`); encode reads them through
     `engine.make_subset_lookup`, so no full-table gradient exists.
  4. Adagrad or SGD is applied to exactly those rows; every other parameter
     goes through the port's `make_optimizer`.
  5. For Adagrad each table is stored PACKED as [V, 2D] (param rows in
     [:, :D], accumulator rows in [:, D:]), so one row gather brings both
     halves in and one row scatter writes both back: the write-back is
     `kernels.row_scatter.scatter_rows_set`, the hand-written CUDA kernel
     on the card. Eval and serving read through `unpack_params`.

Semantics match the dense step (same negatives, Adagrad with optax's
initial accumulator 0.1 and eps 1e-7), except that the touched-rows
Adagrad divides by √a + eps where the dense path multiplies by
rsqrt(a + eps) — each path keeps arec's own formula.

As in the dense port, every leaf of the state (tables, the other
parameters, their optimizer state, `step`) is updated in place: the state
passed to a step is consumed by it. `make_sparse_multi_step` runs K steps
per dispatch, one CUDA graph replay on the card (`train/graph.py`); the
step's shapes are static (`unique_rows`' sentinel padding, the row
scatter dropping ids >= V on the card), so nothing in it reads the card
from the host. The mesh variant is `train/sparse_mesh.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from arec_torch.kernels.row_scatter import scatter_rows_set
from arec_torch.losses.sampling import draw
from arec_torch.models import mf as mf_mod
from arec_torch.models import seq as seq_mod
from arec_torch.rng import split
from arec_torch.tables.engine import (
    FUSED, build_subset, gather_row_ids, gather_unique_bound,
    make_subset_lookup, subset_pos_map, unique_rows,
)
from arec_torch.train.step import (
    Optimizer, TrainState, _leaves, _next, _rebuild, check_tf32,
)

ADAGRAD_INIT_ACCUM = 0.1   # optax.adagrad defaults, as the dense path
ADAGRAD_EPS = 1e-7

# MF losses whose touched rows include pre-drawn negatives; mw/bbpr use
# the in-batch positives as negatives and draw nothing
MF_SAMPLED_LOSSES = ("ce", "warp", "bpr")
MF_BATCH_LOSSES = ("mw", "bbpr")


# ---------------------------------------------------------------------------
# Nested-dict path helpers (params are plain dict trees)
# ---------------------------------------------------------------------------

def get_path(tree: dict, path: tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def set_path(tree: dict, path: tuple[str, ...], value):
    """Copy-on-write set: a new tree sharing the untouched subtrees."""
    if len(path) == 1:
        return {**tree, path[0]: value}
    return {**tree, path[0]: set_path(tree[path[0]], path[1:], value)}


@dataclass(frozen=True)
class SparseTableSpec:
    """One sparsely-updated table: where it lives and its dense prefix."""
    role: str                  # lookup_fns key: {"user", "item", "out"}
    path: tuple[str, ...]      # into the params tree
    prefix: int                # dense-region rows (0 for plain tables)


# ---------------------------------------------------------------------------
# Per-row optimizers (optax's scale_by_rss / sgd, written out)
# ---------------------------------------------------------------------------

def _adagrad_rows(p_rows, a_rows, g_rows, lr):
    a_new = a_rows + g_rows * g_rows
    inv = torch.where(a_new > 0, 1.0 / (torch.sqrt(a_new) + ADAGRAD_EPS),
                      0.0)
    return p_rows - lr * g_rows * inv, a_new


def _row_indices(uids, prefix: int):
    """[prefix ids ++ uids], int32 — still sorted and unique (the fused
    layout puts the dense prefix first, so every gather uid is >= prefix)."""
    if not prefix:
        return uids
    return torch.cat([torch.arange(prefix, dtype=torch.int32,
                                   device=uids.device), uids])


def _apply_packed_adagrad(packed, sub_packed, g_sub, uids, prefix, lr):
    """Update the touched PACKED rows in place: the new (param, accumulator)
    halves come from the already-gathered subset rows, so the write-back is
    one row scatter per table. The dense prefix rides the same scatter."""
    d = packed.shape[1] // 2
    p_new, a_new = _adagrad_rows(sub_packed[:, :d], sub_packed[:, d:],
                                 g_sub, lr)
    new_rows = torch.cat([p_new, a_new], dim=1)
    idx = _row_indices(uids, prefix)
    if idx.shape[0]:
        scatter_rows_set(packed, idx, new_rows, use_kernel=True)
    return packed


@torch.no_grad()
def _apply_sgd(table, g_sub, uids, prefix, lr):
    """table[idx] -= lr·g in place, out-of-range idx dropped: they add an
    exact 0 to the last row, so no boolean mask syncs with the host."""
    idx = _row_indices(uids, prefix)
    if idx.shape[0]:
        ok = idx < table.shape[0]
        table.index_add_(0, idx.long().clamp(max=table.shape[0] - 1),
                         torch.where(ok[:, None], -lr * g_sub, 0.0))
    return table


# ---------------------------------------------------------------------------
# Family-specific touched-row collection
# ---------------------------------------------------------------------------

def _mf_tables(spec, user_dev, item_dev, batch, neg_ids):
    """Per role (spec, touched gather-row ids, total rows, unique bound)."""
    cand = torch.cat([batch["pos_item"].to(torch.int32),
                      neg_ids.to(torch.int32)])
    nb = batch["user"].shape[0]
    return [
        (SparseTableSpec("user", ("user", "tables", FUSED),
                         spec.user.dense_region_rows),
         gather_row_ids(spec.user, user_dev, batch["user"]),
         spec.user.total_rows,
         gather_unique_bound(spec.user, nb)),
        (SparseTableSpec("item", ("item", "tables", FUSED),
                         spec.item.dense_region_rows),
         gather_row_ids(spec.item, item_dev, cand),
         spec.item.total_rows,
         gather_unique_bound(spec.item, cand.shape[0])),
    ]


def _seq_tables(spec, user_dev, item_dev, batch, neg_ids):
    """The sequence family's counterpart of _mf_tables."""
    in_ids = batch["inputs"].reshape(-1).to(torch.int32)
    tgt = batch["targets"].reshape(-1).to(torch.int32)
    neg_ids = neg_ids.to(torch.int32)
    if spec.tie_output:
        in_ids = torch.cat([in_ids, tgt, neg_ids])
    out = [
        (SparseTableSpec("item", ("item_in", "tables", FUSED),
                         spec.item_in.dense_region_rows),
         gather_row_ids(spec.item_in, item_dev, in_ids),
         spec.item_in.total_rows,
         gather_unique_bound(spec.item_in, in_ids.shape[0])),
    ]
    if spec.user is not None:
        out.append((SparseTableSpec("user", ("user", "tables", FUSED),
                                    spec.user.dense_region_rows),
                    gather_row_ids(spec.user, user_dev, batch["user"]),
                    spec.user.total_rows,
                    gather_unique_bound(spec.user, batch["user"].shape[0])))
    if not spec.tie_output:
        n_out = tgt.shape[0] + neg_ids.shape[0]
        out.append((SparseTableSpec("out", ("item_out",), 0),
                    torch.cat([tgt, neg_ids]),
                    spec.vocab + 1,
                    min(n_out, spec.vocab + 1)))
    return out


# ---------------------------------------------------------------------------
# State + step factory
# ---------------------------------------------------------------------------

def table_paths(is_seq: bool, spec) -> list[tuple[str, ...]]:
    if not is_seq:
        return [("user", "tables", FUSED), ("item", "tables", FUSED)]
    paths = [("item_in", "tables", FUSED)]
    if spec.user is not None:
        paths.append(("user", "tables", FUSED))
    if not spec.tie_output:
        paths.append(("item_out",))
    return paths


def init_sparse_state(params, paths: list[tuple[str, ...]],
                      rest_opt: Optimizer, optimizer: str) -> TrainState:
    """Adagrad tables are packed [V, 2D] (see the module docstring);
    opt_state holds only the state of the other parameters, under
    "rest"."""
    rest = _strip_tables(params, paths)
    if optimizer == "adagrad":
        params = pack_tables(params, paths)
    dev = _leaves(params)[0].device
    return TrainState(
        params=params,
        opt_state={"rest": rest_opt.init(rest)},
        lr_scale=torch.ones((), dtype=torch.float32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _strip_tables(params, paths):
    """The tree with each table replaced by a (1, 1) zero placeholder, so
    the rest-optimizer carries no table state (arec's shape: orbax refuses
    zero-size arrays)."""
    out = params
    for p in paths:
        dev = get_path(params, p).device
        out = set_path(out, p, torch.zeros((1, 1), device=dev))
    return out


def pack_tables(params, paths):
    """[V, D] param tables → [V, 2D] packed (param ++ Adagrad accumulator)."""
    out = params
    for p in paths:
        t = get_path(params, p)
        out = set_path(out, p, torch.cat(
            [t, torch.full_like(t, ADAGRAD_INIT_ACCUM)], dim=1))
    return out


def unpack_params(params, paths):
    """Packed sparse-mode params → a plain param tree (views of the param
    halves) for eval, serving and cross-mode comparisons."""
    out = params
    for p in paths:
        t = get_path(params, p)
        out = set_path(out, p, t[:, : t.shape[1] // 2])
    return out


def check_sparse_loss(is_seq: bool, spec) -> bool:
    """Validate spec.loss for the sparse step at factory time; returns
    whether the loss consumes sampled negatives."""
    if is_seq:
        return True          # SeqSpec already refuses losses other than ce
    if spec.loss in MF_SAMPLED_LOSSES:
        return True
    if spec.loss in MF_BATCH_LOSSES:
        return False
    raise ValueError(
        f"sparse_update supports mf losses "
        f"{MF_SAMPLED_LOSSES + MF_BATCH_LOSSES}, not {spec.loss!r}")


def touched_rows(is_seq: bool, spec, user_dev, item_dev, batch,
                 gen: torch.Generator, pop=None):
    """Steps 1–2 of a sparse step: (sampled, specs, uids). The negatives
    are pre-drawn from the loss's own stream (the loss splits gen into
    (dropout, negatives) itself, and with `sampled` handed in its own
    draw is not made, so the negatives are the dense step's; mw / bbpr
    draw nothing); then each table's touched rows, sorted and unique at
    a static bound (sentinel-padded)."""
    dev = batch["user"].device
    if check_sparse_loss(is_seq, spec):
        vocab = spec.vocab if is_seq else spec.item.schema.num_entities
        _, g_neg = split(gen, dev)
        sampled = draw(g_neg, spec.num_sampled, vocab, spec.sampler, pop)
        neg_ids = sampled[0]
    else:
        sampled = None
        neg_ids = torch.zeros(0, dtype=torch.int32, device=dev)
    specs = (_seq_tables if is_seq else _mf_tables)(
        spec, user_dev, item_dev, batch, neg_ids)
    uids = {s.role: unique_rows(ids, total, cap=bound)
            for s, ids, total, bound in specs}
    return sampled, specs, uids


def subset_loss_and_grads(is_seq: bool, spec, params, specs, uids,
                          sub_full: dict, packed: bool, user_dev, item_dev,
                          batch, gen: torch.Generator, sampled, pop=None,
                          gather_cands=None):
    """Steps 3–4 of a sparse step: the loss over the subset tables
    `sub_full` (per role, [prefix ++ touched] rows; with packed Adagrad
    the loss sees their param half) and every other parameter, and its
    gradients. Returns (loss, {role: subset gradient}, the other
    parameters' gradients, that tree with (1, 1) table placeholders, its
    leaves)."""
    subs = {role: (f[:, : f.shape[1] // 2] if packed else f)
            .detach().clone().requires_grad_()
            for role, f in sub_full.items()}
    lookup_fns = {
        s.role: make_subset_lookup(
            subset_pos_map(uids[s.role], total, s.prefix), s.prefix)
        for s, _, total, _ in specs if uids[s.role].shape[0]}
    rest = _strip_tables(params, table_paths(is_seq, spec))
    rest_leaves = _leaves(rest)
    live = [t.detach().requires_grad_(t.is_floating_point())
            for t in rest_leaves]
    p = _rebuild(rest, iter(live))
    for s, *_ in specs:
        p = set_path(p, s.path, subs[s.role])
    if is_seq:
        loss = seq_mod.seq_loss(p, spec, item_dev, user_dev, batch, gen,
                                lookup_fns=lookup_fns, sampled=sampled,
                                time_major=True, pop=pop)
    else:
        loss = mf_mod.mf_loss(p, spec, user_dev, item_dev, batch, gen,
                              lookup_fns=lookup_fns, sampled=sampled,
                              pop=pop, gather_cands=gather_cands)
    roles = list(subs)
    wrt = [subs[r] for r in roles] + [t for t in live if t.requires_grad]
    grads = iter(torch.autograd.grad(loss, wrt, allow_unused=True,
                                     materialize_grads=True))
    g_subs = {r: next(grads) for r in roles}
    g_rest = [next(grads) if t.requires_grad else torch.zeros_like(t)
              for t in live]
    return loss, g_subs, g_rest, rest, rest_leaves


def make_sparse_step_core(is_seq: bool, spec, user_dev, item_dev,
                          rest_opt: Optimizer, base_lr: float,
                          optimizer: str, pop=None) -> Callable:
    """step(state, batch, gen) -> (state, metrics), equal to the dense
    `make_step_core` step on `mf_loss` / `seq_loss` but with O(touched·D)
    table updates. One device. The state is updated in place."""
    if optimizer not in ("adagrad", "sgd"):
        raise ValueError(
            f"sparse_update supports adagrad/sgd, not {optimizer!r}")
    check_sparse_loss(is_seq, spec)
    paths = table_paths(is_seq, spec)
    packed = optimizer == "adagrad"

    def step(state: TrainState, batch, gen: torch.Generator):
        params = state.params
        check_tf32(get_path(params, paths[0]))
        lr = base_lr * state.lr_scale
        sampled, specs, uids = touched_rows(is_seq, spec, user_dev,
                                            item_dev, batch, gen, pop)
        # 3. with packed Adagrad one gather brings both halves in
        sub_full = {s.role: build_subset(get_path(params, s.path),
                                         uids[s.role], s.prefix)
                    for s, *_ in specs}
        loss, g_subs, g_rest, rest, rest_leaves = subset_loss_and_grads(
            is_seq, spec, params, specs, uids, sub_full, packed, user_dev,
            item_dev, batch, gen, sampled, pop)

        # 4a. the other parameters: the port's optimizer, lr set per step
        rest_state = state.opt_state["rest"]
        rest_opt.update(g_rest, rest_state, rest_leaves, lr)

        # 4b. the tables: the touched rows, one scatter per table
        new_params = rest
        with torch.no_grad():
            for s, *_ in specs:
                table = get_path(params, s.path)
                if packed:
                    table = _apply_packed_adagrad(
                        table, sub_full[s.role], g_subs[s.role],
                        uids[s.role], s.prefix, lr)
                else:
                    table = _apply_sgd(table, g_subs[s.role], uids[s.role],
                                       s.prefix, lr)
                new_params = set_path(new_params, s.path, table)

        new_state = _next(TrainState(params=new_params,
                                     opt_state={"rest": rest_state},
                                     lr_scale=state.lr_scale,
                                     step=state.step))
        return new_state, {"loss": loss.detach(), "lr": lr}

    return step


def make_sparse_train_step(*args, **kwargs) -> Callable:
    """The single sparse step (see make_sparse_step_core); it consumes the
    state it is given (in-place updates, as arec donates it)."""
    return make_sparse_step_core(*args, **kwargs)


def make_sparse_multi_step(*args, k: int, **kwargs) -> Callable:
    """K sparse steps per dispatch (arec's `make_sparse_multi_step`): the
    sparse core under `train.graph.scan_multi`, step for step identical to
    K single sparse steps (same keys, same touched-row updates)."""
    from arec_torch.train.graph import scan_multi
    return scan_multi(make_sparse_step_core(*args, **kwargs), k)
