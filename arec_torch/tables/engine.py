"""Embedding-table engine (port of `arec/tables/engine.py`): one fused,
row-concatenated table per entity, lookup, mulhot pooling, entity encode.

The layout is arec's, unchanged, so the bridge hands tables over as they
are: dense (small-vocab) fields form a prefix of the fused table and are
served by a constant one-hot / normalised-multihot map times the
sub-table; the entity-ID field's rows are `id + offset`; large-vocab cat
fields go through an indirection gather; large-vocab mulhot fields are one
gather plus a masked mean. Pad entities encode to exactly zero.

Index semantics follow JAX's, since a CUDA index out of range fires a
device-side assert that would kill a standing server: `dense_lookup`
clamps (jnp.take mode="clip"), and the attribute-map gathers wrap negative
ids once and then clamp (jnp `x[idx]`).

The row gather is pluggable (`lookup_fn`), as in arec: `dense_lookup`
gathers from a whole table and gives it a dense gradient (arec's dense
train step); the sparse touched-rows step (`arec_torch.train.sparse`)
passes `make_subset_lookup`, which reads a subset table [dense prefix ++
the step's unique gather rows] through a dense id→position map, so the
gradient is O(touched rows). The subset helpers keep arec's static shapes:
no step of them reads a data-dependent size back to the host.

arec's `make_compact_lookup` (`train.compact_table_grads`) has no twin:
its sort and unique exist to hand XLA's table-gradient scatter sorted,
collision-free ids, and `embedding`'s CUDA backward already groups
duplicate ids and writes each touched row once (see `dense_lookup`), so
the dense step serves that knob with `dense_lookup`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from arec_torch.data.schema import CAT, MULHOT, AttributeData, EntitySchema
from arec_torch.fusion.fuse import apply_fusion, init_fusion

Params = dict

FUSED = "__fused__"


@dataclass(frozen=True)
class EncoderSpec:
    """Static configuration of one entity encoder (user-side or item-side)."""

    schema: EntitySchema
    dim: int
    fusion: str = "concat"      # {concat, sum}
    nonlinear: bool = False
    with_bias: bool = False     # per-entity bias scalar in COLUMN `dim` of
                                # the fused table (entity-ID field rows)
    dense_mulhot_threshold: int = 512   # vocab ≤ this → multihot-matmul pooling
    # cap on the dense map (4·(N+1)·vocab_f bytes per field), so huge entity
    # counts never trade a gather for GBs
    dense_map_max_bytes: int = 256 << 20

    @property
    def needs_proj(self) -> bool:
        # single-attribute concat without nonlinearity is the identity
        return self.fusion == "concat" and (
            len(self.schema.fields) > 1 or self.nonlinear
        )

    # ---- fused-table layout (static): dense prefix first, gather tail ----
    @property
    def layout_fields(self):
        """Schema fields in fused-table layout order (dense prefix first)."""
        return self.dense_fields + [
            f for f in self.schema.fields if not self._is_dense(f)]

    @property
    def dense_region_rows(self) -> int:
        """Rows of the dense prefix (0 when no field is dense)."""
        return sum(f.table_rows for f in self.dense_fields)

    def field_offsets(self) -> dict[str, int]:
        """Row offset of each field's sub-table inside the fused table."""
        off, out = 0, {}
        for f in self.layout_fields:
            out[f.name] = off
            off += f.table_rows
        return out

    @property
    def total_rows(self) -> int:
        return sum(f.table_rows for f in self.schema.fields)

    @property
    def width(self) -> int:
        """Fused-table row width: dim (+1 bias column when with_bias)."""
        return self.dim + (1 if self.with_bias else 0)

    @property
    def cat_fields(self):
        return [f for f in self.schema.fields if f.kind == CAT]

    @property
    def mulhot_fields(self):
        return [f for f in self.schema.fields if f.kind == MULHOT]

    def _is_dense(self, f) -> bool:
        map_bytes = 4 * (self.schema.num_entities + 1) * f.vocab_size
        return (f.vocab_size <= self.dense_mulhot_threshold
                and map_bytes <= self.dense_map_max_bytes)

    @property
    def dense_fields(self):
        """Small-vocab fields (any kind) served by the dense map."""
        return [f for f in self.schema.fields if self._is_dense(f)]

    @property
    def gather_cat_fields(self):
        return [f for f in self.cat_fields if not self._is_dense(f)]

    def is_identity(self, f) -> bool:
        """True for the entity-ID field: its fused row id is `id + offset`
        (attrs_to_device checks the data really is the identity)."""
        return (f is self.schema.fields[0] and f.kind == CAT
                and f.vocab_size == self.schema.num_entities)

    @property
    def identity_cat_fields(self):
        return [f for f in self.gather_cat_fields if self.is_identity(f)]

    @property
    def gathered_cat_fields(self):
        """Large-vocab cat fields that still need the indirection gather
        (columns of attr_dev["cat"], in this order)."""
        return [f for f in self.gather_cat_fields if not self.is_identity(f)]

    @property
    def gather_mulhot_fields(self):
        return [f for f in self.mulhot_fields if not self._is_dense(f)]


def init_encoder(gen: torch.Generator, spec: EncoderSpec,
                 device=None) -> Params:
    """One fused table ~ N(0, 1/sqrt(dim)) with every PAD row zeroed (and
    the bias column, when present, zero), on `device` (default
    `gen.device`)."""
    dev = gen.device if device is None else device
    t = torch.randn(spec.total_rows, spec.width, generator=gen,
                    device=dev) / math.sqrt(spec.dim)
    if spec.with_bias:
        t[:, spec.dim] = 0.0
    offsets = spec.field_offsets()
    pad_rows = [offsets[f.name] + f.pad_index for f in spec.schema.fields]
    t[pad_rows] = 0.0
    params: Params = {"tables": {FUSED: t}}
    if spec.needs_proj:
        params["fusion"] = init_fusion(
            gen, len(spec.schema.fields), spec.dim, spec.nonlinear, dev)
    return params


def attrs_to_device(attrs: AttributeData, spec: EncoderSpec,
                    device="cpu") -> dict[str, torch.Tensor]:
    """Attribute value maps in the fused-table id space, on `device`, with
    ONE EXTRA pad entity row (entity id == num_entities) that maps every
    attribute to its zeroed PAD row / an all-invalid mulhot row.

    Returns {"cat":   int32 [N+1, n_big_cat]     (large-vocab cat fields),
             "mul":   int32 [N+1, total_deg]     (large-vocab mulhot fields),
             "dense": float32 [N+1, Σ vocab_f]}  (ALL small-vocab fields).
    Keys are present only when their field group is non-empty.
    """
    offsets = spec.field_offsets()
    n = attrs.schema.num_entities
    out: dict[str, np.ndarray] = {}

    for f in spec.identity_cat_fields:
        if not np.array_equal(attrs.values[f.name],
                              np.arange(n, dtype=np.int32)):
            raise ValueError(
                f"{f.name}: schema position 0 with vocab == num_entities "
                f"must be the identity map (schema.py id_identity contract)")
    if spec.gathered_cat_fields:
        cat_cols = []
        for f in spec.gathered_cat_fields:
            v = attrs.values[f.name].astype(np.int64) + offsets[f.name]
            v = np.concatenate([v, [offsets[f.name] + f.pad_index]])
            cat_cols.append(v)
        out["cat"] = np.stack(cat_cols, axis=1).astype(np.int32)

    if spec.gather_mulhot_fields:
        mul_cols = []
        for f in spec.gather_mulhot_fields:
            v = attrs.values[f.name].astype(np.int64)
            v = np.where(v >= 0, v + offsets[f.name], -1)
            pad_row = np.full((1, f.max_degree), -1, np.int64)
            mul_cols.append(np.concatenate([v, pad_row], axis=0))
        out["mul"] = np.concatenate(mul_cols, axis=1).astype(np.int32)

    if spec.dense_fields:
        blocks = []
        for f in spec.dense_fields:
            m = np.zeros((n + 1, f.vocab_size), np.float32)
            if f.kind == CAT:
                m[np.arange(n), attrs.values[f.name]] = 1.0
                # pad-entity row (index n) stays all-zero → zero embedding
            else:
                v = attrs.values[f.name]
                rows = np.repeat(np.arange(n), f.max_degree).reshape(
                    n, f.max_degree)
                valid = v >= 0
                np.add.at(m, (rows[valid], v[valid]), 1.0)
                denom = np.maximum(m.sum(axis=1, keepdims=True), 1.0)
                m = m / denom
            blocks.append(m)
        out["dense"] = np.concatenate(blocks, axis=1)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def dense_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Single-device row gather of a [rows, width] table; ids clamp into
    range like jnp.take's mode="clip" (pad ids address a real zeroed pad
    row). Its gradient is the dense table-sized scatter-add of arec's dense
    step, through `embedding`'s backward, which on CUDA groups duplicate
    ids and sums each id's cotangents into its row once, without atomics
    (the compaction that arec's `make_compact_lookup` builds by hand for
    XLA): `table[ids]`'s
    index_put backward sums each run of repeated ids (pad ids, the row-0
    stand-in of empty tag slots) serially and took 52 ms of an 80 ms c4
    train step on the H100."""
    return torch.nn.functional.embedding(
        ids.clamp(0, table.shape[0] - 1), table)


def _take_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`arr[idx]` with jnp's gather semantics: a negative index wraps once,
    then every index clamps into [0, len)."""
    n = arr.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    return arr[idx.clamp(0, n - 1)]


def rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to `dtype` and held in f32: an operand of a product whose
    sums run in f32 (jax's preferred_element_type=f32)."""
    return x.to(dtype).float()


def mm_f32(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a·b with both operands rounded to `dtype` and an f32 product: the
    torch twin of jax's dot(a.astype(dtype), b.astype(dtype),
    preferred_element_type=f32). A bf16 torch matmul would round the
    OUTPUT to bf16; here only the operands are rounded (their products are
    exact in f32, and the sums run in f32)."""
    return rounded(a, dtype) @ rounded(b, dtype)


def encode(params: Params, spec: EncoderSpec, attr_dev: dict, ids,
           lookup_fn=dense_lookup, act_dtype=None, dropout_gen=None,
           keep_prob: float = 1.0) -> torch.Tensor:
    """ids int [...] (values in [0, num_entities]; num_entities = pad) →
    entity latents float32 [..., dim]. Pad ids encode to exactly zero.
    lookup_fn(table, row_ids): the row gather (see the module docstring).
    act_dtype: arec's train-path activation dtype (None = float32).
    dropout_gen/keep_prob: training dropout on the fused latents."""
    latent, _ = _encode_impl(params, spec, attr_dev, ids, lookup_fn,
                             act_dtype, dropout_gen, keep_prob)
    return latent


def encode_with_bias(params: Params, spec: EncoderSpec, attr_dev: dict, ids,
                     lookup_fn=dense_lookup, act_dtype=None,
                     dropout_gen=None, keep_prob: float = 1.0):
    """(latents [..., dim], bias [...]) — candidate-side encode; the bias is
    column `dim` of the entity-ID field's row."""
    if not spec.with_bias:
        raise ValueError("encode_with_bias needs EncoderSpec.with_bias")
    return _encode_impl(params, spec, attr_dev, ids, lookup_fn, act_dtype,
                        dropout_gen, keep_prob)


def _encode_impl(params: Params, spec: EncoderSpec, attr_dev: dict, ids,
                 lookup_fn=dense_lookup, act_dtype=None, dropout_gen=None,
                 keep_prob: float = 1.0):
    batch_shape = ids.shape
    flat = ids.reshape(-1).long()
    table = params["tables"][FUSED]
    d = spec.width
    acast = (lambda a: a.to(act_dtype)) if act_dtype is not None else (
        lambda a: a)

    # one gather for every large-vocab cat attribute; entity-ID fields skip
    # the indirection map (row id = flat + offset)
    cat_rows = None
    if spec.gather_cat_fields:
        offsets = spec.field_offsets()
        gathered = (_take_rows(attr_dev["cat"], flat).long()
                    if spec.gathered_cat_fields else None)
        cols, gi = [], 0
        for f in spec.gather_cat_fields:
            if spec.is_identity(f):
                off = offsets[f.name]
                cols.append(torch.where(flat < f.vocab_size, flat + off,
                                        off + f.pad_index))
            else:
                cols.append(gathered[:, gi])
                gi += 1
        cat_ids = torch.stack(cols, dim=1)                   # [N, n_cat]
        cat_rows = acast(lookup_fn(table, cat_ids.reshape(-1)))
        cat_rows = cat_rows.reshape(*cat_ids.shape, d)       # [N, n_cat, D]

    # large-vocab mulhot: one gather + per-field mask-mean
    pooled: dict[str, torch.Tensor] = {}
    if spec.gather_mulhot_fields:
        mul_ids = _take_rows(attr_dev["mul"], flat).long()   # [N, total_deg]
        safe = torch.where(mul_ids >= 0, mul_ids, 0)
        rows = acast(lookup_fn(table, safe.reshape(-1)))
        rows = rows.reshape(*mul_ids.shape, d)               # [N, deg, D]
        mask = (mul_ids >= 0).to(rows.dtype)[..., None]
        rows = rows * mask
        col = 0
        for f in spec.gather_mulhot_fields:
            sl_rows = rows[:, col:col + f.max_degree]
            sl_mask = mask[:, col:col + f.max_degree]
            denom = sl_mask.sum(dim=-2).clamp_min(1.0)
            pooled[f.name] = acast(sl_rows.sum(dim=-2) / denom)
            col += f.max_degree

    # small-vocab fields: one-hot / multihot rows × sub-table
    if spec.dense_fields:
        offsets = spec.field_offsets()
        mrow = _take_rows(attr_dev["dense"], flat)           # [N, Σ vocab_f]
        mm_dtype = act_dtype if act_dtype is not None else torch.float32
        # the dense prefix: a static slice on one device; a row-sharded
        # table's lookup fetches it (`tables.sharded`'s `.head`)
        head = getattr(lookup_fn, "head", None)
        prefix = (table if head is None
                  else head(table, spec.dense_region_rows))
        col = 0
        for f in spec.dense_fields:
            m = mrow[:, col:col + f.vocab_size]
            sub = prefix[offsets[f.name]:offsets[f.name] + f.vocab_size]
            pooled[f.name] = acast(mm_f32(m, sub, mm_dtype))
            col += f.vocab_size

    # per-attribute embeddings in schema field order (fusion contract); the
    # bias column (field 0) is sliced off before fusion
    per_attr: list[torch.Tensor] = []
    bias = None
    ci = 0
    for fi, f in enumerate(spec.schema.fields):
        row = pooled[f.name] if f.name in pooled else cat_rows[:, ci]
        if f.name not in pooled:
            ci += 1
        if spec.with_bias:
            if fi == 0:
                bias = row[:, spec.dim]
            row = row[:, : spec.dim]
        per_attr.append(row)

    latent = apply_fusion(params.get("fusion"), per_attr, kind=spec.fusion,
                          nonlinear=spec.nonlinear, act_dtype=act_dtype,
                          dropout_gen=dropout_gen, keep_prob=keep_prob)
    # pad entities (id == num_entities) encode to zero
    valid = (flat < spec.schema.num_entities).to(latent.dtype)[:, None]
    latent = (latent * valid).reshape(*batch_shape, spec.dim)
    if bias is not None:
        bias = (bias.float() * valid[:, 0].float()).reshape(batch_shape)
    return latent, bias


def encode_all_items(params: Params, spec: EncoderSpec, attr_dev: dict,
                     block: int = 8192, lookup_fn=dense_lookup):
    """All-item latent matrix [num_items, dim] for full-softmax eval and
    retrieval, encoded in blocks of `block` ids to bound peak memory."""
    n = spec.schema.num_entities
    device = params["tables"][FUSED].device
    return torch.cat([
        encode(params, spec, attr_dev,
               torch.arange(s, min(s + block, n), device=device), lookup_fn)
        for s in range(0, n, block)])


def encode_all_items_with_bias(params: Params, spec: EncoderSpec,
                               attr_dev: dict, block: int = 8192,
                               lookup_fn=dense_lookup, ids=None):
    """(V [num_items, dim], bias [num_items]) — with_bias counterpart of
    `encode_all_items`; `ids` (1-D) encodes those entities instead of
    all."""
    device = params["tables"][FUSED].device
    if ids is None:
        ids = torch.arange(spec.schema.num_entities, device=device)
    vs, bs = [], []
    for s in range(0, ids.shape[0], block):
        v, b = encode_with_bias(params, spec, attr_dev, ids[s:s + block],
                                lookup_fn)
        vs.append(v)
        bs.append(b)
    return torch.cat(vs), torch.cat(bs)


# ---------------------------------------------------------------------------
# Sparse-update support (arec_torch/train/sparse.py): the loss reads a SUBSET
# table [dense prefix ++ the step's unique gather rows], so gradients and
# optimizer traffic are O(touched rows), not O(vocab). The fused layout puts
# the dense fields in a prefix, so encode's dense path (static slices) works
# on the subset unchanged.
# ---------------------------------------------------------------------------

def gather_row_ids(spec: EncoderSpec, attr_dev: dict,
                   ids: torch.Tensor) -> torch.Tensor:
    """Every fused-table row id (int32) the GATHER path touches for entity
    `ids`. Invalid mulhot slots map to the out-of-range sentinel
    `total_rows`, not to the row 0 that encode's masked gather reads: their
    gradient is zero, so they are not touched rows (row 0 may be a prefix
    row, whose update a zero-gradient slot would overwrite)."""
    flat = ids.reshape(-1).long()
    parts = []
    if spec.gather_cat_fields:
        offsets = spec.field_offsets()
        for f in spec.identity_cat_fields:
            off = offsets[f.name]
            parts.append(torch.where(flat < f.vocab_size, flat + off,
                                     off + f.pad_index))
        if spec.gathered_cat_fields:
            parts.append(_take_rows(attr_dev["cat"], flat).reshape(-1))
    if spec.gather_mulhot_fields:
        m = _take_rows(attr_dev["mul"], flat).reshape(-1)
        parts.append(torch.where(m >= 0, m, spec.total_rows))
    if not parts:
        return torch.zeros(0, dtype=torch.int32, device=ids.device)
    return torch.cat([p.to(torch.int32) for p in parts])


def unique_rows(ids: torch.Tensor, sentinel: int,
                cap: int | None = None) -> torch.Tensor:
    """Sorted-unique with a static shape: trailing slots hold `sentinel`
    (pass total_rows: out of range, so scatters drop them and subset
    gathers zero-fill them). One sort and a cumsum compaction, whose output
    size does not depend on the data (torch.unique's does, and reading it
    would sync with the host); every duplicate writes the same value to the
    same slot. cap: a provable bound on the unique count
    (`gather_unique_bound`); the output is cut to [cap]."""
    if ids.shape[0] == 0:
        return ids
    s = torch.sort(ids).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    slot = torch.cumsum(first, 0) - 1              # unique-group index
    out = torch.full_like(s, sentinel)
    out.scatter_(0, slot, s)
    if cap is not None and cap < out.shape[0]:
        # slot < unique count <= cap: no live value lands beyond out[:cap]
        out = out[:cap]
    return out


def gather_unique_bound(spec: EncoderSpec, n_ids: int) -> int:
    """Static upper bound on the number of UNIQUE fused-table rows the
    gather path can touch for `n_ids` entity ids: per field, at most
    min(#ids drawn for it, its table rows)."""
    b = 0
    for f in spec.identity_cat_fields:
        b += min(n_ids, f.table_rows)
    for f in spec.gathered_cat_fields:
        b += min(n_ids, f.table_rows)
    for f in spec.gather_mulhot_fields:
        b += min(n_ids * f.max_degree, f.table_rows)
    return b


def build_subset(table: torch.Tensor, uids: torch.Tensor,
                 prefix_rows: int) -> torch.Tensor:
    """[table[:prefix_rows] ++ table[uids]], a new tensor. Sentinel uids
    (>= rows) give zero rows, as jnp's mode="fill" gather: their index is
    clamped for the gather and the row is then replaced by zeros, so no
    sentinel slot carries another row's values."""
    if uids.shape[0] == 0:
        return table[:prefix_rows].clone()
    n = table.shape[0]
    ok = (uids < n)[:, None]
    tail = torch.where(ok, table[uids.long().clamp(max=n - 1)], 0.0)
    if prefix_rows == 0:
        return tail
    return torch.cat([table[:prefix_rows], tail], dim=0)


def subset_pos_map(uids: torch.Tensor, total_rows: int,
                   prefix_rows: int) -> torch.Tensor:
    """Dense id→subset-position map [total_rows] int32: a prefix row maps
    to itself, uid k to prefix_rows + k, every other row to 0. Sentinel
    uids are dropped before the index write (a CUDA index out of range
    kills the context): they are sent to one extra slot past the end,
    which the returned view leaves out."""
    dev = uids.device
    base = torch.arange(total_rows + 1, dtype=torch.int32, device=dev)
    pos = torch.where(base < prefix_rows, base, 0)
    slots = prefix_rows + torch.arange(uids.shape[0], dtype=torch.int32,
                                       device=dev)
    pos[uids.long().clamp(max=total_rows)] = slots
    return pos[:total_rows]


def make_subset_lookup(pos_map: torch.Tensor, prefix_rows: int):
    """lookup_fn over the subset table through the dense position map. The
    row gather is `embedding`, as in `dense_lookup`, so its backward sums
    repeated rows without an index_put."""
    def lookup(sub: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        pos = _take_rows(pos_map, ids.reshape(-1).long())
        return torch.nn.functional.embedding(pos, sub).reshape(
            *ids.shape, sub.shape[1])
    return lookup
