"""Deterministic synthetic dataset generator.

No counterpart in the reference (it ships only ML-1M / XING prep —
SURVEY.md §2.1). Built because this environment has neither network access
nor raw dataset dumps; every test and bench needs a dataset with the same
*shape* as the real ones: cat + mulhot attributes on both entity sides,
Zipf-ish item popularity, per-user temporal structure, and enough latent
signal that Recall@30 visibly improves over random when training works.

Generative model (all from one seeded PRNG — fully reproducible):
  * K latent clusters; each user and item gets a cluster.
  * Item base popularity ~ Zipf(1.1).
  * A user's interactions are drawn from a mixture: with prob `affinity`
    an item from the user's cluster (popularity-weighted within cluster),
    else a global popularity draw. Timestamps are per-user sequential.
  * Cat attributes correlate with the cluster (so attribute-aware configs
    have signal to exploit); mulhot attributes are cluster-flavored tag sets.
  * Item ids are then remapped to frequency rank (sampler contract,
    arec/data/schema.py build_vocab docstring).
"""

from __future__ import annotations

import numpy as np

from arec_torch.config import DataConfig
from arec_torch.data.schema import (
    CAT, MULHOT, AttrField, AttributeData, EntitySchema, pad_mulhot,
)
from arec_torch.data.dataset import PreparedDataset, build_prepared


def generate(cfg: DataConfig) -> PreparedDataset:
    if cfg.syn_mulhot_degree > 0:
        return _generate_big(cfg)
    rng = np.random.default_rng(cfg.syn_seed)
    n_users, n_items, n_inter = cfg.syn_users, cfg.syn_items, cfg.syn_interactions
    n_clusters = 8
    affinity = 0.75

    user_cluster = rng.integers(0, n_clusters, n_users)
    item_cluster = rng.integers(0, n_clusters, n_items)

    # Zipf-ish base popularity
    base_pop = 1.0 / np.power(np.arange(1, n_items + 1), 1.1)
    base_pop = rng.permutation(base_pop)
    base_pop /= base_pop.sum()

    # per-cluster popularity distributions
    cluster_pop = np.zeros((n_clusters, n_items))
    for c in range(n_clusters):
        in_c = item_cluster == c
        p = np.where(in_c, base_pop, 0.0)
        cluster_pop[c] = p / max(p.sum(), 1e-12)

    # interactions: users drawn proportional to a light activity skew
    user_act = rng.gamma(2.0, 1.0, n_users)
    user_act /= user_act.sum()
    users = rng.choice(n_users, size=n_inter, p=user_act).astype(np.int32)
    use_cluster = rng.random(n_inter) < affinity
    items = np.empty(n_inter, np.int32)
    glob = rng.choice(n_items, size=n_inter, p=base_pop)
    for c in range(n_clusters):
        m = use_cluster & (user_cluster[users] == c)
        items[m] = rng.choice(n_items, size=int(m.sum()), p=cluster_pop[c])
    items[~use_cluster] = glob[~use_cluster]

    # timestamps: global order index (per-user order follows from lexsort)
    times = np.arange(n_inter, dtype=np.int64)

    # ---- frequency-rank remap of item ids --------------------------------
    freq = np.bincount(items, minlength=n_items)
    rank_of = np.argsort(np.argsort(-freq, kind="stable"), kind="stable")
    items = rank_of[items].astype(np.int32)
    item_cluster = item_cluster[np.argsort(rank_of, kind="stable")]

    # ---- attributes ------------------------------------------------------
    # user: id + cat(group≈cluster, noisy) + cat(age-band) + mulhot(tags)
    n_groups = n_clusters
    noisy_group = np.where(
        rng.random(n_users) < 0.9, user_cluster, rng.integers(0, n_groups, n_users)
    ).astype(np.int32)
    age = rng.integers(0, 7, n_users).astype(np.int32)
    n_user_tags = 24
    user_tag_lists = [
        sorted(set(rng.choice(n_user_tags, size=rng.integers(1, 5)).tolist()
                   + [int(user_cluster[u]) * 3 % n_user_tags]))
        for u in range(n_users)
    ]
    ut_vals, ut_len = pad_mulhot(user_tag_lists, 6)

    user_schema = EntitySchema(
        "user", n_users,
        (
            EntitySchema.id_field("user", n_users),
            AttrField("group", CAT, n_groups),
            AttrField("age", CAT, 7),
            AttrField("user_tags", MULHOT, n_user_tags, max_degree=6),
        ),
    )
    user_attrs = AttributeData(
        schema=user_schema,
        values={
            "user_id": np.arange(n_users, dtype=np.int32),
            "group": noisy_group,
            "age": age,
            "user_tags": ut_vals,
        },
        lengths={"user_tags": ut_len},
    )

    # item: id + cat(category≈cluster) + cat(year) + mulhot(genres)
    year = rng.integers(0, 10, n_items).astype(np.int32)
    n_genres = 18
    genre_lists = [
        sorted(set(rng.choice(n_genres, size=rng.integers(1, 4)).tolist()
                   + [int(item_cluster[i]) * 2 % n_genres]))
        for i in range(n_items)
    ]
    g_vals, g_len = pad_mulhot(genre_lists, 5)

    item_schema = EntitySchema(
        "item", n_items,
        (
            EntitySchema.id_field("item", n_items),
            AttrField("category", CAT, n_clusters),
            AttrField("year", CAT, 10),
            AttrField("genres", MULHOT, n_genres, max_degree=5),
        ),
    )
    item_attrs = AttributeData(
        schema=item_schema,
        values={
            "item_id": np.arange(n_items, dtype=np.int32),
            "category": item_cluster.astype(np.int32),
            "year": year,
            "genres": g_vals,
        },
        lengths={"genres": g_len},
    )

    ds = build_prepared(
        name="synthetic",
        user_schema=user_schema,
        item_schema=item_schema,
        user_attrs=user_attrs,
        item_attrs=item_attrs,
        users=users,
        items=items,
        times=times,
    )
    ds.validate()
    return ds


def _tag_matrix(rng, n: int, vocab: int, max_deg: int, cluster,
                n_clusters: int):
    """Vectorized per-entity tag sets: [n, max_deg] int32 (PAD -1) +
    lengths. Row degree ~ Uniform(max_deg//2 .. max_deg); slot 0 carries a
    cluster-flavored tag (attribute signal); rows are sorted-unique like
    the legacy generator's `sorted(set(...))` lists."""
    tags = rng.integers(0, vocab, (n, max_deg), dtype=np.int64)
    tags[:, 0] = (cluster.astype(np.int64)
                  * max(1, vocab // n_clusters)) % vocab
    deg = rng.integers(max(1, max_deg // 2), max_deg + 1, n)
    # slots beyond the row degree duplicate slot 0 → removed by the dedupe
    tags = np.where(np.arange(max_deg)[None, :] < deg[:, None],
                    tags, tags[:, :1])
    s = np.sort(tags, axis=1)
    keep = np.concatenate(
        [np.ones((n, 1), bool), s[:, 1:] != s[:, :-1]], axis=1)
    pos = np.cumsum(keep, axis=1) - 1
    vals = np.full((n, max_deg), -1, np.int32)
    rr, cc = np.nonzero(keep)
    vals[rr, pos[rr, cc]] = s[rr, cc].astype(np.int32)
    return vals, keep.sum(axis=1).astype(np.int32)


def _generate_big(cfg: DataConfig) -> PreparedDataset:
    """XING-cardinality synthetic twin (DataConfig.syn_mulhot_degree > 0):
    same interaction model as the small generator, but every per-entity
    construction is vectorized (U=1.5M in seconds, not minutes) and both
    entity sides carry a ~deg-12 mulhot tag field over a vocab LARGER than
    the dense-lookup threshold, so the rehearsal exercises the gather /
    exchange path exactly like real XING tags/jobroles (SURVEY.md §2.1
    "much larger vocabularies")."""
    rng = np.random.default_rng(cfg.syn_seed)
    n_users, n_items = cfg.syn_users, cfg.syn_items
    n_inter = cfg.syn_interactions
    max_deg = cfg.syn_mulhot_degree
    tag_vocab = cfg.syn_tag_vocab or 4096
    n_clusters = 16
    affinity = 0.75

    user_cluster = rng.integers(0, n_clusters, n_users)
    item_cluster = rng.integers(0, n_clusters, n_items)

    base_pop = 1.0 / np.power(np.arange(1, n_items + 1), 1.1)
    base_pop = rng.permutation(base_pop)
    base_pop /= base_pop.sum()

    user_act = rng.gamma(2.0, 1.0, n_users)
    user_act /= user_act.sum()
    users = rng.choice(n_users, size=n_inter, p=user_act).astype(np.int32)
    use_cluster = rng.random(n_inter) < affinity
    items = np.empty(n_inter, np.int32)
    items[~use_cluster] = rng.choice(n_items, size=int((~use_cluster).sum()),
                                     p=base_pop)
    for c in range(n_clusters):
        m = use_cluster & (user_cluster[users] == c)
        p = np.where(item_cluster == c, base_pop, 0.0)
        p /= max(p.sum(), 1e-12)
        items[m] = rng.choice(n_items, size=int(m.sum()), p=p)
    times = np.arange(n_inter, dtype=np.int64)

    freq = np.bincount(items, minlength=n_items)
    rank_of = np.argsort(np.argsort(-freq, kind="stable"), kind="stable")
    items = rank_of[items].astype(np.int32)
    item_cluster = item_cluster[np.argsort(rank_of, kind="stable")]

    noisy_group = np.where(
        rng.random(n_users) < 0.9, user_cluster,
        rng.integers(0, n_clusters, n_users)).astype(np.int32)
    age = rng.integers(0, 7, n_users).astype(np.int32)
    ut_vals, ut_len = _tag_matrix(rng, n_users, tag_vocab, max_deg,
                                  user_cluster, n_clusters)
    user_schema = EntitySchema(
        "user", n_users,
        (EntitySchema.id_field("user", n_users),
         AttrField("group", CAT, n_clusters),
         AttrField("age", CAT, 7),
         AttrField("user_tags", MULHOT, tag_vocab, max_degree=max_deg)))
    user_attrs = AttributeData(
        schema=user_schema,
        values={"user_id": np.arange(n_users, dtype=np.int32),
                "group": noisy_group, "age": age, "user_tags": ut_vals},
        lengths={"user_tags": ut_len})

    year = rng.integers(0, 10, n_items).astype(np.int32)
    g_vals, g_len = _tag_matrix(rng, n_items, tag_vocab, max_deg,
                                item_cluster, n_clusters)
    item_schema = EntitySchema(
        "item", n_items,
        (EntitySchema.id_field("item", n_items),
         AttrField("category", CAT, n_clusters),
         AttrField("year", CAT, 10),
         AttrField("tags", MULHOT, tag_vocab, max_degree=max_deg)))
    item_attrs = AttributeData(
        schema=item_schema,
        values={"item_id": np.arange(n_items, dtype=np.int32),
                "category": item_cluster.astype(np.int32), "year": year,
                "tags": g_vals},
        lengths={"tags": g_len})

    ds = build_prepared(
        name="synthetic",
        user_schema=user_schema,
        item_schema=item_schema,
        user_attrs=user_attrs,
        item_attrs=item_attrs,
        users=users,
        items=items,
        times=times,
    )
    ds.validate()
    return ds
