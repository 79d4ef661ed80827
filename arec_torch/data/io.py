"""Prepared-dataset artifacts: save/load + prep dispatch.

The reference's prep scripts emit index files consumed by both model
families (SURVEY.md §3.4); here a PreparedDataset round-trips through one
.npz (arrays) + embedded JSON (schemas), cached under DataConfig.data_dir
and keyed by a config fingerprint, so prep runs once (deterministic,
golden-hashable — SURVEY.md §7 build order step 1).

The port's copy of `arec/data/io.py`: the same fingerprint, the same npz
layout and the same prep dispatch (the synthetic generator, ML-1M and
XING from their raw files), so a cache prepared by either package loads in
the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

from arec_torch.config import DataConfig
from arec_torch.data.dataset import PreparedDataset
from arec_torch.data.schema import AttrField, AttributeData, EntitySchema

_ARRAYS = (
    "train_users", "train_items", "valid_users", "valid_items",
    "seen_items", "seen_lengths", "item_freq", "hist_items", "hist_lengths",
)


def _schema_to_json(s: EntitySchema) -> dict:
    return {
        "entity": s.entity,
        "num_entities": s.num_entities,
        "fields": [dataclasses.asdict(f) for f in s.fields],
    }


def _schema_from_json(d: dict) -> EntitySchema:
    return EntitySchema(
        d["entity"], d["num_entities"],
        tuple(AttrField(**f) for f in d["fields"]),
    )


def save_prepared(ds: PreparedDataset, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = {
        "name": ds.name,
        "user_schema": _schema_to_json(ds.user_schema),
        "item_schema": _schema_to_json(ds.item_schema),
    }
    arrays = {k: getattr(ds, k) for k in _ARRAYS}
    for side, attrs in (("user", ds.user_attrs), ("item", ds.item_attrs)):
        for name, v in attrs.values.items():
            arrays[f"attr_{side}_v_{name}"] = v
        for name, v in attrs.lengths.items():
            arrays[f"attr_{side}_l_{name}"] = v
    # atomic publish: concurrent processes sharing a data_dir may prepare
    # the same uncached config simultaneously (observed: a reader hit a
    # half-written zip and died with BadZipFile). Each writer streams to
    # its own temp file and os.replace()-renames into place — readers see
    # either no file (and prepare themselves) or a complete one; prep is
    # deterministic, so last-rename-wins is harmless.
    tmp = f"{path}.{os.getpid()}.tmp.npz"   # keep the .npz suffix:
    # np.savez appends one to any other extension, orphaning the temp
    try:
        np.savez_compressed(tmp, __meta__=json.dumps(meta), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_prepared(path: str) -> PreparedDataset:
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["__meta__"]))
    user_schema = _schema_from_json(meta["user_schema"])
    item_schema = _schema_from_json(meta["item_schema"])

    def attrs_for(side, schema):
        values = {f.name: z[f"attr_{side}_v_{f.name}"] for f in schema.fields}
        lengths = {f.name: z[f"attr_{side}_l_{f.name}"]
                   for f in schema.fields if f.kind == "mulhot"}
        return AttributeData(schema, values, lengths)

    ds = PreparedDataset(
        name=meta["name"],
        user_schema=user_schema,
        item_schema=item_schema,
        user_attrs=attrs_for("user", user_schema),
        item_attrs=attrs_for("item", item_schema),
        **{k: z[k] for k in _ARRAYS},
    )
    ds.validate()
    return ds


def fingerprint(cfg: DataConfig) -> str:
    return hashlib.sha256(
        json.dumps(dataclasses.asdict(cfg), sort_keys=True).encode()
    ).hexdigest()[:16]


def load_or_prepare(cfg: DataConfig) -> PreparedDataset:
    """Cache-aware prep dispatch (ref: --data_dir holding prepared index
    files, SURVEY.md §2.1 "Shared data loading glue")."""
    cache = os.path.join(cfg.data_dir, f"{cfg.dataset}-{fingerprint(cfg)}.npz")
    if os.path.exists(cache):
        return load_prepared(cache)

    if cfg.dataset == "synthetic":
        from arec_torch.data.synthetic import generate
        ds = generate(cfg)
    elif cfg.dataset == "ml1m":
        from arec_torch.data.movielens import prepare_ml1m
        ds = prepare_ml1m(cfg)
    elif cfg.dataset == "xing":
        from arec_torch.data.xing import prepare_xing
        ds = prepare_xing(cfg)
    else:
        raise ValueError(f"unknown dataset {cfg.dataset!r}")

    save_prepared(ds, cache)
    return ds
