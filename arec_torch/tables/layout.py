"""Row → shard placement for row-sharded tables (port of
`arec/tables/layout.py`).

With contiguous ownership (owner = row // rows_per_shard) and
frequency-ranked ids, every hot row of a table lands on shard 0. The
"shuffle" placement (MeshConfig.row_shard) is a fixed multiplicative
permutation of the gather-region rows:

    pi(j) = prefix + (j - prefix) * a  mod R     for j in [prefix, prefix+R)
    pi(j) = j                                     for j <  prefix

with a ≈ golden_ratio · R, odd and coprime to R. (a, R) depend only on
the table's static layout, so the permutation is the same on any mesh
shape, and checkpoints stay in the NATURAL row order: a checkpoint moves
freely between mesh shapes, one device and both placements.

arec evaluates the id remap inside XLA with an unrolled uint32
double-and-add, because a 32-bit product would overflow for R > ~46k. In
torch the product is taken in int64, which is exact for R < 2^31, so
`apply_ids` is one multiply and one remainder, equal to arec's bit for
bit (the sentinel id prefix + R included: both map it to prefix).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

_GOLDEN = 0.6180339887498949


def _pick_multiplier(r: int) -> int:
    """Odd multiplier near golden_ratio * r, coprime to r."""
    a = max(1, int(r * _GOLDEN)) | 1
    while math.gcd(a, r) != 1:
        a += 2
    return a % r if r > 1 else 0


@dataclass(frozen=True)
class RowPerm:
    """One table's row permutation: `prefix` identity rows (the engine's
    dense small-vocab prefix), then `r` permuted rows, multiplier `a`."""

    prefix: int
    r: int
    a: int

    @staticmethod
    def for_rows(total_rows: int, prefix_rows: int = 0) -> "RowPerm | None":
        r = total_rows - prefix_rows
        if r <= 2:
            return None
        return RowPerm(prefix_rows, r, _pick_multiplier(r))

    def apply_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """Natural row ids → stored row ids, in ids' dtype. An id in
        [prefix, prefix + 2R) maps as arec's does (one conditional
        subtraction of R, then the exact product mod R)."""
        tail = (ids.long() - self.prefix) % self.r
        out = (self.prefix + tail * self.a % self.r).to(ids.dtype)
        return torch.where(ids < self.prefix, ids, out)

    def perm_index(self) -> np.ndarray:
        """pi as an int64 index array over [0, prefix + r)."""
        j = np.arange(self.r, dtype=np.int64)
        tail = self.prefix + (j * self.a) % self.r
        return np.concatenate([np.arange(self.prefix, dtype=np.int64), tail])

    def inv_index(self) -> np.ndarray:
        p = self.perm_index()
        inv = np.empty_like(p)
        inv[p] = np.arange(p.shape[0], dtype=np.int64)
        return inv

    def permute_table(self, table, inverse: bool = False):
        """Rearrange table rows natural → stored layout (or back), numpy or
        torch. Rows beyond prefix + r (mesh padding) stay in place."""
        n = self.prefix + self.r
        # new[pi(i)] = old[i]  <=>  new = old[pi^{-1}]
        idx = self.perm_index() if inverse else self.inv_index()
        if isinstance(table, np.ndarray):
            return np.concatenate([table[:n][idx], table[n:]], axis=0)
        head = table[:n][torch.from_numpy(idx).to(table.device)]
        return torch.cat([head, table[n:]], dim=0)
