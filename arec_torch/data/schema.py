"""Attribute schema + per-entity attribute value storage.

Rebuild of the reference's `Attributes` metadata container (SURVEY.md §2.1
"Attribute metadata container": cat vs mulhot features, vocab sizes, CSR-style
flattened value arrays, OOV handling after frequency thresholding).

TPU-first departure from the reference: the reference stores mulhot values as
CSR (flat values + starts/lengths), which implies ragged gathers. Ragged
anything defeats XLA tiling, so values are stored **padded-dense** at prep
time: `[num_entities, max_degree] int32` plus a `[num_entities]` length vector.
The device path is then a dense gather + mask — no dynamic shapes anywhere
(SURVEY.md §7 "Ragged mulhot pooling on TPU").

Conventions:
  * Every attribute vocabulary reserves index `vocab_size` as the PAD row, so
    embedding tables have `vocab_size + 1` rows. PAD contributions are masked
    to exactly zero in pooling, so the PAD row's contents never matter.
  * Attribute 0 of each entity is the entity's own ID ("hybrid": IDs and
    attributes are jointly embedded — SURVEY.md §2.1 "Hybrid MF model").
  * Out-of-vocabulary / below-threshold values map to a dedicated OOV id
    (`vocab_size - 1` by prep convention), NOT to PAD.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

import numpy as np

# Value used in padded mulhot slots past `lengths[i]`. Any non-negative int
# would do (slots are masked); PAD_SENTINEL rows index the PAD embedding row.
PAD_SENTINEL = -1

CAT = "cat"
MULHOT = "mulhot"


@dataclass(frozen=True)
class AttrField:
    """One attribute of an entity type.

    kind="cat":    exactly one value per entity (e.g. ML-1M user gender).
    kind="mulhot": a set of values per entity (e.g. ML-1M movie genres,
                   XING item tags), padded to `max_degree`.
    """

    name: str
    kind: str                  # CAT | MULHOT
    vocab_size: int            # real values in [0, vocab_size); PAD = vocab_size
    max_degree: int = 1        # mulhot only: padded width

    def __post_init__(self):
        if self.kind not in (CAT, MULHOT):
            raise ValueError(f"bad kind {self.kind!r}")
        if self.kind == CAT and self.max_degree != 1:
            raise ValueError("cat fields have max_degree 1")
        if self.vocab_size <= 0:
            raise ValueError(f"{self.name}: vocab_size must be positive")

    @property
    def pad_index(self) -> int:
        return self.vocab_size

    @property
    def table_rows(self) -> int:
        return self.vocab_size + 1


@dataclass(frozen=True)
class EntitySchema:
    """All attributes of one entity type (user or item)."""

    entity: str                         # "user" | "item"
    num_entities: int
    fields: tuple[AttrField, ...]

    def __post_init__(self):
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate field names in {self.entity}: {names}")
        if not self.fields:
            raise ValueError("entity needs at least one field (its own id)")

    def field_named(self, name: str) -> AttrField:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def id_only(self) -> "EntitySchema":
        """Schema restricted to the entity-ID field (configs 1 & 3 of
        BASELINE.json:7,9 use ID-only embeddings)."""
        return EntitySchema(self.entity, self.num_entities, (self.fields[0],))

    @staticmethod
    def id_field(entity: str, num_entities: int) -> AttrField:
        return AttrField(name=f"{entity}_id", kind=CAT, vocab_size=num_entities)


@dataclass
class AttributeData:
    """Per-entity attribute values, padded-dense, host-side numpy.

    values[name]:  cat    → int32 [N]           (value id per entity)
                   mulhot → int32 [N, max_deg]  (PAD_SENTINEL-padded)
    lengths[name]: mulhot → int32 [N]           (valid prefix length)
    """

    schema: EntitySchema
    values: dict[str, np.ndarray] = field(default_factory=dict)
    lengths: dict[str, np.ndarray] = field(default_factory=dict)

    def validate(self) -> None:
        n = self.schema.num_entities
        for f in self.schema.fields:
            v = self.values[f.name]
            if f.kind == CAT:
                assert v.shape == (n,), (f.name, v.shape)
                assert v.min() >= 0 and v.max() < f.vocab_size, f.name
            else:
                assert v.shape == (n, f.max_degree), (f.name, v.shape)
                ln = self.lengths[f.name]
                assert ln.shape == (n,)
                assert (ln >= 0).all() and (ln <= f.max_degree).all()
                # valid prefix in range, padded suffix is sentinel
                cols = np.arange(f.max_degree)[None, :]
                valid = cols < ln[:, None]
                assert ((v >= 0) & (v < f.vocab_size))[valid].all(), f.name
                assert (v[~valid] == PAD_SENTINEL).all(), f.name

    def restrict(self, schema: EntitySchema) -> "AttributeData":
        """Project onto a sub-schema (e.g. id_only())."""
        return AttributeData(
            schema=schema,
            values={f.name: self.values[f.name] for f in schema.fields},
            lengths={f.name: self.lengths[f.name]
                     for f in schema.fields if f.kind == MULHOT},
        )

    @staticmethod
    def id_identity(schema: EntitySchema) -> dict[str, np.ndarray]:
        """values entry for the entity-ID field: the identity map."""
        return {schema.fields[0].name:
                np.arange(schema.num_entities, dtype=np.int32)}


def pad_mulhot(lists: list[list[int]], max_degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack ragged per-entity value lists into padded-dense form, truncating
    to max_degree. Returns (values [N, max_degree], lengths [N])."""
    n = len(lists)
    out = np.full((n, max_degree), PAD_SENTINEL, dtype=np.int32)
    lengths = np.zeros((n,), dtype=np.int32)
    for i, vals in enumerate(lists):
        vals = vals[:max_degree]
        out[i, : len(vals)] = vals
        lengths[i] = len(vals)
    return out, lengths


def build_vocab(
    raw_values: list, min_count: int = 1, max_size: int = 0
) -> tuple[dict, int]:
    """Frequency-threshold vocabulary build (ref: --vocab_min_thresh,
    --item_vocab_size; SURVEY.md §2.1 "OOV handling after frequency
    thresholding").

    Ids are assigned in DESCENDING frequency order (ties broken by first
    appearance), so id 0 is the most frequent value. This ordering is
    load-bearing: the log-uniform negative sampler (arec.losses) assumes a
    frequency-sorted vocabulary, matching TF1 sampled_softmax behavior
    (SURVEY.md §7 "Sampled-softmax parity").

    Values below min_count (or beyond max_size-1) map to a shared OOV id,
    which is the LAST real id. Returns (value→id mapping, vocab_size
    including the OOV slot).
    """
    counts: dict = {}
    order: dict = {}
    for i, v in enumerate(raw_values):
        counts[v] = counts.get(v, 0) + 1
        if v not in order:
            order[v] = i
    kept = [v for v, c in counts.items() if c >= min_count]
    kept.sort(key=lambda v: (-counts[v], order[v]))
    if max_size and len(kept) > max_size - 1:
        kept = kept[: max_size - 1]
    mapping = {v: i for i, v in enumerate(kept)}
    oov = len(kept)
    vocab_size = oov + 1
    return ({**mapping, "__OOV__": oov}, vocab_size)


def apply_vocab(mapping: Mapping, raw_values: list) -> np.ndarray:
    oov = mapping["__OOV__"]
    return np.asarray([mapping.get(v, oov) for v in raw_values], dtype=np.int32)
