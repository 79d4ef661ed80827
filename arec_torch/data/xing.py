"""XING RecSys Challenge 2017 dataset preparation (port of
`arec/data/xing.py`, kept field for field equal: the same arrays, schemas
and vocabularies from the same raw files).

Rebuild of the reference's XING prep (SURVEY.md §2.1 "Dataset prep: XING
RecSys'17"): parse interactions/users/items CSVs; filter interaction types
(keep positive click/bookmark/reply types 1-3, drop impressions type 0 and
delete type 4); dedupe; temporal split; many cat + mulhot attributes on both
sides (career level, discipline, industry, region, ... ; jobroles/tags/title
as mulhot); large vocabularies with min-count thresholding.

Raw files expected under DataConfig.raw_dir as tab-separated
`interactions.csv`, `users.csv`, `items.csv` in the challenge layout
(header row; multi-valued fields comma-separated). Column positions are
resolved by header name, so minor layout drift is tolerated.
"""

from __future__ import annotations

import os

import numpy as np

from arec_torch.config import DataConfig
from arec_torch.data.dataset import PreparedDataset, build_prepared
from arec_torch.data.schema import (
    CAT, MULHOT, AttrField, AttributeData, EntitySchema, apply_vocab,
    build_vocab, pad_mulhot,
)

POSITIVE_TYPES = {1, 2, 3}   # click, bookmark, reply
MAX_MULHOT_DEG = 12


def _read_csv(path: str) -> tuple[list[str], list[list[str]]]:
    with open(path, encoding="utf-8") as f:
        rows = [line.rstrip("\n").split("\t") for line in f if line.strip()]
    return rows[0], rows[1:]


def _col(header: list[str], *names: str) -> int:
    for n in names:
        if n in header:
            return header.index(n)
    raise KeyError(f"none of {names} in header {header}")


def _cat_attr(raw: list[str], min_count: int) -> tuple[np.ndarray, int]:
    vocab, size = build_vocab(raw, min_count=min_count)
    return apply_vocab(vocab, raw), size


def _mulhot_attr(raw_lists: list[list[str]], min_count: int):
    flat = [v for lst in raw_lists for v in lst]
    vocab, size = build_vocab(flat, min_count=min_count)
    ids = [sorted({int(x) for x in apply_vocab(vocab, lst)})
           for lst in raw_lists]
    deg = max(1, min(MAX_MULHOT_DEG, max((len(l) for l in ids), default=1)))
    vals, lens = pad_mulhot(ids, deg)
    return vals, lens, size, deg


def prepare_xing(cfg: DataConfig) -> PreparedDataset:
    d = cfg.raw_dir
    for name in ("interactions.csv", "users.csv", "items.csv"):
        if not os.path.exists(os.path.join(d, name)):
            raise FileNotFoundError(
                f"XING raw file {name} not found under {d!r}; set "
                f"DataConfig.raw_dir to the RecSys'17 dump directory")

    ih, irows = _read_csv(os.path.join(d, "interactions.csv"))
    ci_u = _col(ih, "user_id", "user")
    ci_i = _col(ih, "item_id", "item")
    ci_t = _col(ih, "interaction_type", "type")
    ci_ts = _col(ih, "created_at", "timestamp", "time")

    raw_u, raw_i, ts = [], [], []
    for r in irows:
        if int(r[ci_t]) in POSITIVE_TYPES:
            raw_u.append(int(r[ci_u]))
            raw_i.append(int(r[ci_i]))
            ts.append(int(r[ci_ts]))
    raw_u = np.asarray(raw_u)
    raw_i = np.asarray(raw_i)
    ts = np.asarray(ts, np.int64)

    if cfg.min_timestamp:   # ref --after40-style temporal filter
        keep = ts >= cfg.min_timestamp
        raw_u, raw_i, ts = raw_u[keep], raw_i[keep], ts[keep]

    # dedupe (user, item) keeping the FIRST occurrence in time
    order = np.lexsort((ts, raw_i, raw_u))
    raw_u, raw_i, ts = raw_u[order], raw_i[order], ts[order]
    first = np.ones(len(raw_u), bool)
    first[1:] = (raw_u[1:] != raw_u[:-1]) | (raw_i[1:] != raw_i[:-1])
    raw_u, raw_i, ts = raw_u[first], raw_i[first], ts[first]

    # user subsampling (ref: --user_sample — XING is large)
    if cfg.user_sample < 1.0:
        rng = np.random.default_rng(cfg.syn_seed)
        uniq = np.unique(raw_u)
        kept = set(uniq[rng.random(len(uniq)) < cfg.user_sample].tolist())
        m = np.array([u in kept for u in raw_u])
        raw_u, raw_i, ts = raw_u[m], raw_i[m], ts[m]

    # item id = frequency rank, with optional vocab truncation
    vals, counts = np.unique(raw_i, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    ranked = vals[order]
    if cfg.item_vocab_size:
        ranked = ranked[: cfg.item_vocab_size]
    item_map = {int(v): i for i, v in enumerate(ranked)}
    keep = np.array([int(i) in item_map for i in raw_i])
    raw_u, raw_i, ts = raw_u[keep], raw_i[keep], ts[keep]
    items = np.array([item_map[int(i)] for i in raw_i], np.int32)

    uniq_users = np.unique(raw_u)
    user_map = {int(u): i for i, u in enumerate(uniq_users)}
    users = np.array([user_map[int(u)] for u in raw_u], np.int32)
    n_users, n_items = len(user_map), len(item_map)
    mc = cfg.vocab_min_thresh

    # ---- user attributes -------------------------------------------------
    uh, urows = _read_csv(os.path.join(d, "users.csv"))
    uid_c = _col(uh, "user_id", "id")
    def ucol(*names, default="0"):
        try:
            c = _col(uh, *names)
        except KeyError:
            return [default] * n_users
        out = [default] * n_users
        for r in urows:
            u = int(r[uid_c])
            if u in user_map and c < len(r):
                out[user_map[u]] = r[c] or default
        return out

    def ucol_multi(*names):
        try:
            c = _col(uh, *names)
        except KeyError:
            return [[] for _ in range(n_users)]
        out: list[list[str]] = [[] for _ in range(n_users)]
        for r in urows:
            u = int(r[uid_c])
            if u in user_map and c < len(r) and r[c]:
                out[user_map[u]] = r[c].split(",")
        return out

    u_fields, u_values, u_lengths = [EntitySchema.id_field("user", n_users)], \
        {"user_id": np.arange(n_users, dtype=np.int32)}, {}
    for fname, cols in (
        ("career_level", ("career_level",)),
        ("discipline", ("discipline_id", "discipline")),
        ("industry", ("industry_id", "industry")),
        ("country", ("country",)),
        ("region", ("region",)),
        ("experience_years", ("experience_years_experience",
                              "experience_years")),
        ("edu_degree", ("edu_degree",)),
    ):
        ids, size = _cat_attr(ucol(*cols), mc)
        u_fields.append(AttrField(fname, CAT, size))
        u_values[fname] = ids
    jr_vals, jr_lens, jr_size, jr_deg = _mulhot_attr(
        ucol_multi("jobroles", "jobrole_list"), mc)
    u_fields.append(AttrField("jobroles", MULHOT, jr_size, max_degree=jr_deg))
    u_values["jobroles"] = jr_vals
    u_lengths["jobroles"] = jr_lens

    user_schema = EntitySchema("user", n_users, tuple(u_fields))
    user_attrs = AttributeData(user_schema, u_values, u_lengths)

    # ---- item attributes -------------------------------------------------
    ith, itrows = _read_csv(os.path.join(d, "items.csv"))
    iid_c = _col(ith, "item_id", "id")
    def icol(*names, default="0"):
        try:
            c = _col(ith, *names)
        except KeyError:
            return [default] * n_items
        out = [default] * n_items
        for r in itrows:
            i = int(r[iid_c])
            if i in item_map and c < len(r):
                out[item_map[i]] = r[c] or default
        return out

    def icol_multi(*names):
        try:
            c = _col(ith, *names)
        except KeyError:
            return [[] for _ in range(n_items)]
        out: list[list[str]] = [[] for _ in range(n_items)]
        for r in itrows:
            i = int(r[iid_c])
            if i in item_map and c < len(r) and r[c]:
                out[item_map[i]] = r[c].split(",")
        return out

    i_fields, i_values, i_lengths = [EntitySchema.id_field("item", n_items)], \
        {"item_id": np.arange(n_items, dtype=np.int32)}, {}
    for fname, cols in (
        ("career_level", ("career_level",)),
        ("discipline", ("discipline_id", "discipline")),
        ("industry", ("industry_id", "industry")),
        ("country", ("country",)),
        ("region", ("region",)),
        ("employment", ("employment",)),
        ("is_payed", ("is_payed", "is_paid")),
    ):
        ids, size = _cat_attr(icol(*cols), mc)
        i_fields.append(AttrField(fname, CAT, size))
        i_values[fname] = ids
    for fname, cols in (("title", ("title",)), ("tags", ("tags",))):
        vals2, lens2, size2, deg2 = _mulhot_attr(icol_multi(*cols), mc)
        i_fields.append(AttrField(fname, MULHOT, size2, max_degree=deg2))
        i_values[fname] = vals2
        i_lengths[fname] = lens2

    item_schema = EntitySchema("item", n_items, tuple(i_fields))
    item_attrs = AttributeData(item_schema, i_values, i_lengths)

    ds = build_prepared("xing", user_schema, item_schema, user_attrs,
                        item_attrs, users, items, ts)
    ds.validate()
    return ds
