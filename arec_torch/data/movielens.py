"""MovieLens-1M dataset preparation (port of `arec/data/movielens.py`, kept
field for field equal: the same arrays, schemas and vocabularies from the
same raw files).

Rebuild of the reference's ML-1M prep (SURVEY.md §2.1 "Dataset prep:
MovieLens-1M"): parse ratings.dat / users.dat / movies.dat; implicit-ize
ratings; time-sort per user; temporal leave-one-out split; user attrs
(gender/age/occupation/zip-prefix → cat) and item attrs (genres → mulhot,
decade → cat); vocabularies with min-count thresholding and OOV.

Raw files expected under DataConfig.raw_dir in the standard GroupLens
"::"-separated layout. Item ids are frequency ranks (sampler contract,
arec/data/schema.py). User/item ids are dense re-maps of the raw ids.
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


def _read_dat(path: str) -> list[list[str]]:
    with open(path, encoding="latin-1") as f:
        return [line.rstrip("\n").split("::") for line in f if line.strip()]


def prepare_ml1m(cfg: DataConfig) -> PreparedDataset:
    d = cfg.raw_dir
    for name in ("ratings.dat", "users.dat", "movies.dat"):
        if not os.path.exists(os.path.join(d, name)):
            raise FileNotFoundError(
                f"ML-1M raw file {name} not found under {d!r}; set "
                f"DataConfig.raw_dir to the extracted ml-1m directory")

    ratings = _read_dat(os.path.join(d, "ratings.dat"))
    users_raw = _read_dat(os.path.join(d, "users.dat"))
    movies_raw = _read_dat(os.path.join(d, "movies.dat"))

    r_user = np.array([int(r[0]) for r in ratings])
    r_item = np.array([int(r[1]) for r in ratings])
    r_time = np.array([int(r[3]) for r in ratings], np.int64)
    # implicit feedback: every rating event is a positive (SURVEY.md §2.1)

    if cfg.min_timestamp:   # ref --after40-style temporal filter
        keep = r_time >= cfg.min_timestamp
        r_user, r_item, r_time = r_user[keep], r_item[keep], r_time[keep]

    # optional user subsampling (ref: --user_sample)
    uniq_users = np.unique(r_user)
    if cfg.user_sample < 1.0:
        rng = np.random.default_rng(cfg.syn_seed)
        keep = rng.random(len(uniq_users)) < cfg.user_sample
        kept = set(uniq_users[keep].tolist())
        m = np.array([u in kept for u in r_user])
        r_user, r_item, r_time = r_user[m], r_item[m], r_time[m]
        uniq_users = np.unique(r_user)

    # ---- item id = frequency rank (ref: --item_vocab_size truncation) ----
    vals, counts = np.unique(r_item, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    ranked = vals[order]
    if cfg.item_vocab_size:
        ranked = ranked[: cfg.item_vocab_size]
    item_map = {int(v): i for i, v in enumerate(ranked)}
    keep_mask = np.array([int(i) in item_map for i in r_item])
    r_user, r_item, r_time = r_user[keep_mask], r_item[keep_mask], r_time[keep_mask]
    items = np.array([item_map[int(i)] for i in r_item], np.int32)

    uniq_users = np.unique(r_user)
    user_map = {int(u): i for i, u in enumerate(uniq_users)}
    users = np.array([user_map[int(u)] for u in r_user], np.int32)
    n_users, n_items = len(user_map), len(item_map)

    # ---- user attributes: gender, age, occupation, zip prefix -----------
    gender = np.zeros(n_users, np.int32)
    age = np.zeros(n_users, np.int32)
    occ = np.zeros(n_users, np.int32)
    zips = ["" for _ in range(n_users)]
    age_bands = {1: 0, 18: 1, 25: 2, 35: 3, 45: 4, 50: 5, 56: 6}
    for row in users_raw:
        uid = int(row[0])
        if uid not in user_map:
            continue
        i = user_map[uid]
        gender[i] = 1 if row[1] == "M" else 0
        age[i] = age_bands.get(int(row[2]), 0)
        occ[i] = int(row[3])
        zips[i] = row[4][:3]
    zip_vocab, zip_size = build_vocab(zips, min_count=cfg.vocab_min_thresh)
    zip_ids = apply_vocab(zip_vocab, zips)

    user_schema = EntitySchema(
        "user", n_users,
        (
            EntitySchema.id_field("user", n_users),
            AttrField("gender", CAT, 2),
            AttrField("age", CAT, 7),
            AttrField("occupation", CAT, 21),
            AttrField("zip3", CAT, zip_size),
        ),
    )
    user_attrs = AttributeData(
        user_schema,
        {"user_id": np.arange(n_users, dtype=np.int32), "gender": gender,
         "age": age, "occupation": occ, "zip3": zip_ids},
    )

    # ---- item attributes: genres (mulhot), decade (cat) ------------------
    all_genres: list[str] = []
    item_genres: dict[int, list[str]] = {}
    item_year: dict[int, int] = {}
    for row in movies_raw:
        mid = int(row[0])
        if mid not in item_map:
            continue
        gs = row[2].split("|") if len(row) > 2 and row[2] else []
        item_genres[item_map[mid]] = gs
        all_genres.extend(gs)
        title = row[1]
        year = 0
        if title.endswith(")") and "(" in title:
            try:
                year = int(title[title.rfind("(") + 1 : -1])
            except ValueError:
                year = 0
        item_year[item_map[mid]] = year

    genre_vocab, genre_size = build_vocab(all_genres, min_count=1)
    genre_lists = [
        apply_vocab(genre_vocab, item_genres.get(i, [])).tolist()
        for i in range(n_items)
    ]
    max_deg = max(1, max(len(g) for g in genre_lists))
    g_vals, g_len = pad_mulhot(genre_lists, max_deg)

    decades = np.zeros(n_items, np.int32)
    for i in range(n_items):
        y = item_year.get(i, 0)
        decades[i] = 0 if y < 1920 else min((y - 1920) // 10 + 1, 10)

    item_schema = EntitySchema(
        "item", n_items,
        (
            EntitySchema.id_field("item", n_items),
            AttrField("genres", MULHOT, genre_size, max_degree=max_deg),
            AttrField("decade", CAT, 11),
        ),
    )
    item_attrs = AttributeData(
        item_schema,
        {"item_id": np.arange(n_items, dtype=np.int32),
         "genres": g_vals, "decade": decades},
        {"genres": g_len},
    )

    ds = build_prepared("ml1m", user_schema, item_schema, user_attrs,
                        item_attrs, users, items, r_time)
    ds.validate()
    return ds
