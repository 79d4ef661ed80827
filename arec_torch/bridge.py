"""Weight bridge: arec param pytrees (numpy) ↔ port tensors, same layout.

The layout is arec's, key for key and shape for shape:

  sequence family  {"item_in": {"tables": {"__fused__"}, ["fusion": {"w1",
                    "b1", ...}]}, ["user": {...}], "rnn": [{"w", "b"}, ...],
                    ["item_out"]}
  MF family        {"user": {...}, "item": {...}} (encoder params each)

`w` stays the fused [D_in + H, G·H] matrix with gate order i|f|g|o (LSTM)
or r|u|n (GRU); it is never split into nn.LSTM's or nn.GRU's parameters. numpy arrays are copied, so the two
sides never share memory; torch leaves are moved to `device` (no copy when
they are already there).

`shard_params` hands the same canonical tree to one rank of a mesh: each
table padded to a model-axis multiple, laid out in its RowPerm order
(row_shard = "shuffle") and cut to this rank's row block; the other
leaves whole.

`train_state_from_arec` carries a whole arec `TrainState` across (params,
optimizer state, lr scale, step), so a run can continue mid-training on
either side from the same state; `sparse_train_state_from_arec` does the
same for the sparse touched-rows step's state (packed tables, the other
parameters' optimizer state under "rest"). `shard_state` hands either
to one rank of a mesh: arec's mesh train state in its natural layout
(`Trainer._canonical_state`: tables and, dense, their Adagrad
accumulators row-padded; `sparse_mesh_state_pspecs`' packed tables) cut
to the rank's row blocks.
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(tree, device="cpu"):
    """numpy (or torch) leaves → torch tensors on `device`, same nesting."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    arr = np.asarray(tree)
    if arr.dtype not in (np.float32, np.int32, np.int64, np.bool_):
        raise TypeError(f"bridge takes float32/int/bool arrays, got "
                        f"{arr.dtype}")
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def to_numpy(tree):
    """torch tensors → numpy arrays (on the host), same nesting."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy().copy()


def shard_params(params, mesh, perms: dict, device="cpu"):
    """arec's canonical (natural-row) param tree, numpy or torch → this
    rank's tree on `device`: every table (`dist.specs.table_role`) padded,
    permuted by perms[role] when there is one, and cut to this rank's
    "model" row block; every other leaf replicated."""
    from arec_torch.dist.global_io import put_replicated_global
    from arec_torch.dist.specs import table_role, tree_map_with_keys

    def put(keys, leaf):
        full = to_torch(leaf)
        role = table_role(keys)
        if role is not None and role in perms:
            full = perms[role].permute_table(full)
        return put_replicated_global(full, mesh, device,
                                     row_sharded=role is not None)
    return tree_map_with_keys(put, params)


def _opt_state_from_optax(opt, device):
    """optax's `inject_hyperparams` state → the port's optimizer state:
    `count`, `hyperparams["learning_rate"]` and `inner_state`, whose first
    entry is `ScaleByRssState(sum_of_squares)` (adagrad),
    `ScaleByAdamState(count, mu, nu)` (adam) or empty (sgd). Read by field
    name: optax itself is not imported here."""
    inner = opt.inner_state[0]
    out = {"count": to_torch(opt.count, device),
           "learning_rate": to_torch(opt.hyperparams["learning_rate"],
                                     device)}
    if hasattr(inner, "sum_of_squares"):
        out["sum_of_squares"] = to_torch(inner.sum_of_squares, device)
    elif hasattr(inner, "mu"):
        out.update(mu=to_torch(inner.mu, device),
                   nu=to_torch(inner.nu, device),
                   adam_count=to_torch(inner.count, device))
    return out


def train_state_from_arec(state, device="cpu"):
    """arec's TrainState, as numpy (`jax.tree.map(np.asarray, state)`) →
    the port's `arec_torch.train.step.TrainState` on `device`; opt_state is
    optax's `inject_hyperparams` state (see _opt_state_from_optax)."""
    from arec_torch.train.step import TrainState

    return TrainState(params=to_torch(state.params, device),
                      opt_state=_opt_state_from_optax(state.opt_state,
                                                      device),
                      lr_scale=to_torch(state.lr_scale, device),
                      step=to_torch(state.step, device))


def sparse_train_state_from_arec(state, device="cpu"):
    """arec's sparse-step TrainState (`arec.train.sparse.init_sparse_state`),
    as numpy → the port's, for `arec_torch.train.sparse`: the params keep
    their packed [V, 2D] Adagrad tables (param ++ accumulator) and the
    (1, 1) placeholders stay in the "rest" optimizer state, which is
    optax's `inject_hyperparams` state under `opt_state["rest"]`."""
    from arec_torch.train.step import TrainState

    return TrainState(params=to_torch(state.params, device),
                      opt_state={"rest": _opt_state_from_optax(
                          state.opt_state["rest"], device)},
                      lr_scale=to_torch(state.lr_scale, device),
                      step=to_torch(state.step, device))



def shard_state(state, sh, sparse: bool, device="cpu"):
    """A whole train state in the natural layout (a `TrainState` or its
    dict, numpy or torch: e.g. `train_state_from_arec` of arec's mesh
    state, whose tables are row-padded) → this rank's `TrainState` on
    `device`: each row-sharded leaf (the tables; dense, their optimizer
    state too) permuted into its stored order, padded and cut to the
    rank's row block by `sh` (the Trainer's `_MeshServing`); the rest
    whole."""
    from arec_torch.dist.specs import tree_map_with_keys
    from arec_torch.train.step import TrainState

    tree = state if isinstance(state, dict) else state._asdict()
    return TrainState(**tree_map_with_keys(
        lambda keys, leaf: sh.shard(keys, to_torch(leaf, device), sparse),
        tree))
