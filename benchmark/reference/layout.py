"""The fused-table layout of one entity encoder, worked out from the
entity's fields alone (the plain reference's own copy of arec's rule:
one table per entity, the small-vocabulary fields first, each field's
rows `vocab + 1` with the last one its pad row, the entity-id field's row
`id + offset`, the bias of a candidate entity in column `dim`).

Plain PyTorch and NumPy; imports nothing of the program."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Field:
    name: str
    kind: str
    vocab: int
    degree: int = 1


@dataclass(frozen=True)
class Entity:
    """One encoder: its fields in schema order, entity count and width.
    A field is dense (a prefix row block) when its vocabulary is at most
    `dense_threshold` and its one-hot map would take at most `map_cap`
    bytes."""
    fields: tuple
    num: int
    dim: int
    with_bias: bool = False
    dense_threshold: int = 512
    map_cap: int = 256 << 20

    def dense(self, f: Field) -> bool:
        return (f.vocab <= self.dense_threshold
                and 4 * (self.num + 1) * f.vocab <= self.map_cap)

    def offsets(self) -> dict:
        order = ([f for f in self.fields if self.dense(f)]
                 + [f for f in self.fields if not self.dense(f)])
        out, off = {}, 0
        for f in order:
            out[f.name] = off
            off += f.vocab + 1
        return out

    @property
    def rows(self) -> int:
        return sum(f.vocab + 1 for f in self.fields)

    @property
    def width(self) -> int:
        return self.dim + (1 if self.with_bias else 0)

    def pad_rows(self) -> list[int]:
        off = self.offsets()
        return [off[f.name] + f.vocab for f in self.fields]

    def slots(self, values: dict, device) -> torch.Tensor:
        """[num + 1, Σ degree] int64: each entity's fused row per value
        slot, -1 for an empty slot; the extra last entity (the pad id
        `num`) has every slot empty."""
        off = self.offsets()
        cols = []
        for f in self.fields:
            v = np.asarray(values[f.name]).astype(np.int64)
            v = v.reshape(self.num, f.degree)
            v = np.where(v >= 0, v + off[f.name], -1)
            cols.append(np.concatenate([v, np.full((1, f.degree), -1)]))
        return torch.from_numpy(np.concatenate(cols, axis=1)).to(device)


def entity_of(fields: tuple, dim: int, with_bias: bool,
              dense_threshold: int = 512) -> Entity:
    """An Entity of `fields` (the first the entity-id field, whose
    vocabulary is the entity count)."""
    return Entity(tuple(fields), fields[0].vocab, dim, with_bias,
                  dense_threshold)
