"""Weight bridge: arec param pytrees (numpy) ↔ port tensors, same layout.

The layout is arec's, key for key and shape for shape:

  sequence family  {"item_in": {"tables": {"__fused__"}, ["fusion": {"w1",
                    "b1", ...}]}, ["user": {...}], "rnn": [{"w", "b"}, ...],
                    ["item_out"]}
  MF family        {"user": {...}, "item": {...}} (encoder params each)

`w` stays the fused [D_in + H, G·H] matrix with gate order i|f|g|o; it is
never split into nn.LSTM's parameters. numpy arrays are copied, so the two
sides never share memory; torch leaves are moved to `device` (no copy when
they are already there).
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
