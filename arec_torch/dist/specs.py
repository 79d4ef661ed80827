"""Sharding rules (port of `arec/dist/specs.py`).

One place decides how every parameter and batch tensor is laid out on the
("data", "model") mesh:

  * Embedding tables (any leaf under a "tables" subtree, and the LSTM
    "item_out" output table) are row-sharded over "model": each rank holds
    one contiguous block of the table's rows, padded to a model-axis
    multiple (`arec_torch.tables.sharded.round_up_rows`), and the block is
    replicated over "data".
  * Everything else (fusion MLP, RNN weights, biases) is replicated.
  * Batch tensors are split over "data" on their leading axis: each rank
    takes its slab.

arec states these rules as PartitionSpec pytrees (`param_pspecs`,
`batch_pspec`, `stacked_pspec`, `shardings`) and XLA moves the data; its
`DEVS_KEY` carries the attribute maps into jitted steps as arguments. Both
are XLA plumbing and have no counterpart here: a rank slices its own
shard with `shard_rows` / `batch_slab`, and the attribute maps are plain
tensors every rank holds.
"""

from __future__ import annotations

import numpy as np
import torch

DATA_AXIS = "data"
TABLE_AXIS = "model"


def table_role(keys) -> str | None:
    """The lookup role ("user", "item", "out") of the table leaf at the key
    path `keys`, "" for a table of no role, None for a replicated leaf.
    arec's `_is_table_path` (a "tables" subtree or "item_out") decides
    what is a table; `Trainer._perm_for_path` the role."""
    keys = list(keys)
    if "item_out" in keys:
        return "out"
    if "tables" not in keys:
        return None
    if "user" in keys:
        return "user"
    if "item" in keys or "item_in" in keys:
        return "item"
    return ""


def tree_leaves_with_keys(tree, keys=()):
    """(key path, leaf) of every leaf of a dict / list tree; list indices
    are keys as strings, as in a checkpoint's paths."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_keys(v, keys + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_keys(v, keys + (str(i),))
    else:
        yield keys, tree


def tree_map_with_keys(fn, tree, keys=()):
    """The tree with each leaf replaced by fn(key path, leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_keys(fn, v, keys + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_keys(fn, v, keys + (str(i),))
                          for i, v in enumerate(tree))
    return fn(keys, tree)


def mesh_coords(mesh) -> tuple[int, int, int, int]:
    """(data index, data size, model index, model size) of this rank."""
    return (mesh.get_local_rank(DATA_AXIS), mesh.size(0),
            mesh.get_local_rank(TABLE_AXIS), mesh.size(1))


def shard_rows(full, mesh):
    """This rank's contiguous row block of a whole table (numpy or torch):
    the rows are zero-padded to a model-axis multiple first, so every
    rank's block has the same length."""
    _, _, m, t = mesh_coords(mesh)
    rows = -(-full.shape[0] // t)
    block = full[m * rows:(m + 1) * rows]
    short = rows - block.shape[0]
    if not short:
        return block
    if isinstance(block, torch.Tensor):
        return torch.cat([block, block.new_zeros((short,) + tuple(
            block.shape[1:]))])
    return np.concatenate([block, np.zeros((short,) + block.shape[1:],
                                           block.dtype)])


def batch_slab(batch: dict, mesh) -> dict:
    """This rank's "data" slab of every leaf of a batch (leading axis).
    The batch must divide evenly: every rank of a group must issue the
    same collectives at the same shapes."""
    d, nd, _, _ = mesh_coords(mesh)
    out = {}
    for k, x in batch.items():
        b = x.shape[0]
        if b % nd:
            raise ValueError(f"batch leaf {k!r} of {b} rows does not split "
                             f"over {nd} data ranks")
        s = b // nd
        out[k] = x[d * s:(d + 1) * s]
    return out
