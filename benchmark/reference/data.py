"""The benchmark's own copy of the synthetic XING-cardinality twin: the
schema, the data, the split, the seen lists and histories, and the
training batches, worked out from a configuration's `data` section and
the training seed alone. The checks take their inputs from here (the
batches the reference trains on, the attribute maps, the seen lists and
histories a served request carries), so a fault in the program's own
preparation or batching shows as a gap instead of reaching both sides.

A frozen copy of the twin's published definition (one seeded numpy
generator: 16 clusters, Zipf(1.1) item popularity, 3 in 4 interactions
from the user's cluster, items renumbered by frequency rank, a deg-12
tag field on each side; the last interaction of each user with two or
more held out; batches in a (seed, epoch) permutation). It is kept
here, unchanged by the program's later edits, as the yardstick.

Plain NumPy; imports nothing of the program."""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass

import numpy as np

from reference.layout import Field, entity_of

N_CLUSTERS = 16
AFFINITY = 0.75
MAX_HIST = 256


def fields(data: dict) -> dict:
    """{entity: (Field, ...)} of the twin, from the configuration alone."""
    deg, tags = data["syn_mulhot_degree"], data["syn_tag_vocab"] or 4096
    return {
        "user": (Field("user_id", "cat", data["syn_users"]),
                 Field("group", "cat", N_CLUSTERS),
                 Field("age", "cat", 7),
                 Field("user_tags", "mulhot", tags, deg)),
        "item": (Field("item_id", "cat", data["syn_items"]),
                 Field("category", "cat", N_CLUSTERS),
                 Field("year", "cat", 10),
                 Field("tags", "mulhot", tags, deg)),
    }


@dataclass
class Data:
    """The twin's arrays: train interactions (user-sorted, time order
    within a user), per-user seen lists (first occurrence order) and
    histories (newest last), PAD -1, and each entity's attribute values."""
    train_users: np.ndarray
    train_items: np.ndarray
    seen_items: np.ndarray
    seen_lengths: np.ndarray
    hist_items: np.ndarray
    hist_lengths: np.ndarray
    user_attrs: dict
    item_attrs: dict

    @property
    def num_items(self) -> int:
        return len(self.item_attrs["item_id"])


def load(data: dict, cache_dir: str) -> Data:
    """The twin of `data`, from the cache file of this configuration, or
    made and written there."""
    key = hashlib.sha256(json.dumps(
        {k: data[k] for k in ("syn_users", "syn_items", "syn_interactions",
                              "syn_seed", "syn_mulhot_degree",
                              "syn_tag_vocab")},
        sort_keys=True).encode()).hexdigest()[:16]
    path = os.path.join(cache_dir, "reference", f"twin-{key}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return _unpack(dict(z))
    d = make(data)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".part.npz"
    np.savez(tmp, **_pack(d))
    os.replace(tmp, path)
    return d


def _pack(d: Data) -> dict:
    out = {k: getattr(d, k) for k in ("train_users", "train_items",
                                      "seen_items", "seen_lengths",
                                      "hist_items", "hist_lengths")}
    out.update({f"user.{k}": v for k, v in d.user_attrs.items()})
    out.update({f"item.{k}": v for k, v in d.item_attrs.items()})
    return out


def _unpack(z: dict) -> Data:
    attrs = {e: {k.split(".", 1)[1]: v for k, v in z.items()
                 if k.startswith(e + ".")} for e in ("user", "item")}
    return Data(*(z[k] for k in ("train_users", "train_items", "seen_items",
                                 "seen_lengths", "hist_items",
                                 "hist_lengths")),
                attrs["user"], attrs["item"])


def _tags(rng, n: int, vocab: int, max_deg: int, cluster):
    """[n, max_deg] sorted unique tags a row (PAD -1): slot 0 the
    cluster's tag, the degree uniform in max_deg//2 .. max_deg."""
    tags = rng.integers(0, vocab, (n, max_deg), dtype=np.int64)
    tags[:, 0] = (cluster.astype(np.int64)
                  * max(1, vocab // N_CLUSTERS)) % vocab
    deg = rng.integers(max(1, max_deg // 2), max_deg + 1, n)
    tags = np.where(np.arange(max_deg)[None, :] < deg[:, None], tags,
                    tags[:, :1])
    s = np.sort(tags, axis=1)
    keep = np.concatenate([np.ones((n, 1), bool), s[:, 1:] != s[:, :-1]],
                          axis=1)
    pos = np.cumsum(keep, axis=1) - 1
    vals = np.full((n, max_deg), -1, np.int32)
    rr, cc = np.nonzero(keep)
    vals[rr, pos[rr, cc]] = s[rr, cc].astype(np.int32)
    return vals


def make(data: dict) -> Data:
    rng = np.random.default_rng(data["syn_seed"])
    n_users, n_items = data["syn_users"], data["syn_items"]
    n_inter, max_deg = data["syn_interactions"], data["syn_mulhot_degree"]
    tag_vocab = data["syn_tag_vocab"] or 4096

    user_cluster = rng.integers(0, N_CLUSTERS, n_users)
    item_cluster = rng.integers(0, N_CLUSTERS, n_items)
    pop = 1.0 / np.power(np.arange(1, n_items + 1), 1.1)
    pop = rng.permutation(pop)
    pop /= pop.sum()
    act = rng.gamma(2.0, 1.0, n_users)
    act /= act.sum()
    users = rng.choice(n_users, size=n_inter, p=act).astype(np.int32)
    own = rng.random(n_inter) < AFFINITY
    items = np.empty(n_inter, np.int32)
    items[~own] = rng.choice(n_items, size=int((~own).sum()), p=pop)
    for c in range(N_CLUSTERS):
        m = own & (user_cluster[users] == c)
        p = np.where(item_cluster == c, pop, 0.0)
        p /= max(p.sum(), 1e-12)
        items[m] = rng.choice(n_items, size=int(m.sum()), p=p)

    freq = np.bincount(items, minlength=n_items)
    rank = np.argsort(np.argsort(-freq, kind="stable"), kind="stable")
    items = rank[items].astype(np.int32)
    item_cluster = item_cluster[np.argsort(rank, kind="stable")]

    group = np.where(rng.random(n_users) < 0.9, user_cluster,
                     rng.integers(0, N_CLUSTERS, n_users)).astype(np.int32)
    age = rng.integers(0, 7, n_users).astype(np.int32)
    user_tags = _tags(rng, n_users, tag_vocab, max_deg, user_cluster)
    year = rng.integers(0, 10, n_items).astype(np.int32)
    item_tags = _tags(rng, n_items, tag_vocab, max_deg, item_cluster)

    # time order is the draw order; each user's last interaction (of two
    # or more) is held out
    order = np.lexsort((np.arange(n_inter), users))
    users, items = users[order], items[order]
    last = np.ones(n_inter, bool)
    last[:-1] = users[:-1] != users[1:]
    held = last & (np.bincount(users, minlength=n_users)[users] >= 2)
    tu, ti = users[~held], items[~held]

    _, first = np.unique(tu.astype(np.int64) * n_items + ti,
                         return_index=True)
    first.sort()
    seen, seen_n = _rows(tu[first], ti[first], n_users)
    n_of = np.bincount(tu, minlength=n_users)
    pos = np.arange(len(tu)) - np.concatenate([[0], np.cumsum(n_of)[:-1]])[tu]
    keep = pos >= n_of[tu] - MAX_HIST
    hist, hist_n = _rows(tu[keep], ti[keep], n_users)
    return Data(tu, ti, seen, seen_n, hist, hist_n,
                {"user_id": np.arange(n_users, dtype=np.int32),
                 "group": group, "age": age, "user_tags": user_tags},
                {"item_id": np.arange(n_items, dtype=np.int32),
                 "category": item_cluster.astype(np.int32), "year": year,
                 "tags": item_tags})


def _rows(users, items, n_users: int):
    """User-sorted (users, items) as [n_users, longest] rows, PAD -1, in
    the given order, and the lengths."""
    n = np.bincount(users, minlength=n_users).astype(np.int32)
    out = np.full((n_users, max(1, int(n.max()) if len(users) else 0)), -1,
                  np.int32)
    pos = np.arange(len(users)) - np.concatenate([[0], np.cumsum(n)[:-1]])[
        users]
    out[users, pos] = items
    return out, n


# ---- training batches ----------------------------------------------------

def _perm(n: int, seed: int, epoch: int) -> np.ndarray:
    return np.random.default_rng(
        np.random.SeedSequence([seed, epoch])).permutation(n)


def mf_batches(d: Data, batch: int, seed: int, epoch: int):
    """(user, positive item) pairs of the epoch's permutation of the train
    interactions; the last partial batch is dropped."""
    perm = _perm(len(d.train_users), seed, epoch)
    for s in range(0, len(perm) // batch * batch, batch):
        idx = perm[s:s + batch]
        yield {"user": d.train_users[idx], "pos_item": d.train_items[idx]}


def seq_batches(d: Data, batch: int, L: int, seed: int, epoch: int):
    """Users with two or more train items in the epoch's permutation, each
    its last L + 1 items as inputs [:-1] and targets [1:], left-padded
    with the pad id (the item count); a last partial batch is filled from
    the start of the permutation."""
    users = np.flatnonzero(d.hist_lengths >= 2)
    perm = users[_perm(len(users), seed, epoch)]
    n = len(perm) // batch * batch
    for s in range(0, max(n, batch if len(perm) else 0), batch):
        idx = perm[s:s + batch]
        if len(idx) < batch:
            idx = np.concatenate([idx, perm[:batch - len(idx)]])
        yield {"user": idx.astype(np.int32),
               **pack(d, idx, L, d.num_items)}


def pack(d: Data, users, L: int, pad: int) -> dict:
    """inputs, targets int32 [B, L] and mask float32 [B, L] of `users`."""
    n = np.minimum(d.hist_lengths[users], L + 1)
    t = np.maximum(n - 1, 0)                       # valid positions
    col = np.arange(L)[None, :]
    live = col >= (L - t)[:, None]
    # position j of the row holds history item (len - n) + (j - (L - t))
    base = (d.hist_lengths[users] - n - (L - t))[:, None]
    src = np.clip(base + col, 0, d.hist_items.shape[1] - 1)
    rows = d.hist_items[np.asarray(users)[:, None], src]
    nxt = d.hist_items[np.asarray(users)[:, None],
                       np.clip(src + 1, 0, d.hist_items.shape[1] - 1)]
    return {"inputs": np.where(live, rows, pad).astype(np.int32),
            "targets": np.where(live, nxt, pad).astype(np.int32),
            "mask": live.astype(np.float32)}


def batches(d: Data, cfg: dict, seed: int):
    """Every training batch of configuration `cfg` (its `model` and
    `train` sections), epoch after epoch."""
    B = cfg["train"]["batch_size"]
    lstm = cfg["model"]["model"] == "lstm"
    L = cfg["model"].get("max_seq_len", 0) * cfg["model"].get(
        "train_segments", 1)
    epoch = 0
    while True:
        yield from (seq_batches(d, B, L, seed, epoch) if lstm
                    else mf_batches(d, B, seed, epoch))
        epoch += 1


# ---- the reference model's layout and static inputs ----------------------

def entities(cfg: dict) -> dict:
    """The layout of each encoder of configuration `cfg` (its sections as
    the file states them): the item encoder (with its bias column where
    MF scores it, or the LSTM ties its output), and MF's user encoder."""
    f, model = fields(cfg["data"]), cfg["model"]
    dim, thr = model["dim"], model.get("dense_vocab_threshold", 512)
    mf = model["model"] == "mf"
    ents = {"item": entity_of(f["item"], dim,
                              mf or model.get("tie_output", False), thr)}
    if mf:
        ents["user"] = entity_of(f["user"], dim, False, thr)
    return ents


def static_parts(ents: dict, d: Data, device) -> dict:
    """The reference model's static inputs: each entity's layout and its
    value-slot map."""
    m = {"item": ents["item"],
         "item_slots": ents["item"].slots(d.item_attrs, device)}
    if "user" in ents:
        m["user"] = ents["user"]
        m["user_slots"] = ents["user"].slots(d.user_attrs, device)
    return m
