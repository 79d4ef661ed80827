"""Prepared-dataset container and batch iterators: the port's copy of
`arec/data/dataset.py` (`PreparedDataset`, `build_prepared`, `mf_batches`,
`seq_batches`, `eval_batches`). The iterators yield the same numpy arrays
as arec's for the same (seed, epoch, host).

Split protocol (SURVEY.md §3.4): interactions are time-sorted per user; the
LAST interaction of each user (by time, ties by original order) is held out
as the validation positive; everything earlier is train. Users with < 2
interactions contribute no validation positive.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from arec_torch import native
from arec_torch.data.schema import AttributeData, EntitySchema


@dataclass
class PreparedDataset:
    """Everything both model families consume, host-side numpy."""

    name: str
    user_schema: EntitySchema
    item_schema: EntitySchema
    user_attrs: AttributeData
    item_attrs: AttributeData

    # train interactions, time-sorted per user then concatenated by user
    train_users: np.ndarray    # int32 [Ntr]
    train_items: np.ndarray    # int32 [Ntr]

    # held-out validation positives (≤ 1 per user)
    valid_users: np.ndarray    # int32 [Nv]
    valid_items: np.ndarray    # int32 [Nv]

    # eval-time seen-item masking (SURVEY.md §3.3): padded per-user seen lists
    seen_items: np.ndarray     # int32 [num_users, max_seen], PAD = -1
    seen_lengths: np.ndarray   # int32 [num_users]

    # item popularity (train counts), aligned with the freq-sorted item ids
    item_freq: np.ndarray      # int64 [num_items]

    # per-user train history in time order, padded-dense (newest last)
    hist_items: np.ndarray = field(default=None)   # int32 [num_users, max_hist]
    hist_lengths: np.ndarray = field(default=None) # int32 [num_users]

    @property
    def num_users(self) -> int:
        return self.user_schema.num_entities

    @property
    def num_items(self) -> int:
        return self.item_schema.num_entities

    def validate(self) -> None:
        self.user_attrs.validate()
        self.item_attrs.validate()
        assert self.train_users.shape == self.train_items.shape
        assert self.valid_users.shape == self.valid_items.shape
        assert self.item_freq.shape == (self.num_items,)
        # item ids must be frequency-sorted (sampler contract, schema.py)
        assert (np.diff(self.item_freq) <= 0).all(), "item ids not freq-sorted"


def build_prepared(
    name: str,
    user_schema: EntitySchema,
    item_schema: EntitySchema,
    user_attrs: AttributeData,
    item_attrs: AttributeData,
    users: np.ndarray,
    items: np.ndarray,
    times: np.ndarray,
    max_hist: int = 256,
) -> PreparedDataset:
    """Shared tail of every dataset prep: time-sort per user, temporal
    leave-one-out split, seen lists, histories. `items` must already be
    frequency-rank ids."""
    users = np.asarray(users, np.int32)
    items = np.asarray(items, np.int32)
    times = np.asarray(times, np.int64)
    n = len(users)
    assert len(items) == n and len(times) == n

    order = np.lexsort((np.arange(n), times, users))  # by user, time, orig idx
    users, items, times = users[order], items[order], times[order]

    num_users = user_schema.num_entities
    num_items = item_schema.num_entities

    # last index per user = validation positive
    is_last = np.ones(n, bool)
    is_last[:-1] = users[:-1] != users[1:]
    counts = np.bincount(users, minlength=num_users)
    has_valid = counts[users] >= 2
    valid_mask = is_last & has_valid
    train_mask = ~valid_mask

    train_users, train_items = users[train_mask], items[train_mask]
    valid_users, valid_items = users[valid_mask], items[valid_mask]

    # seen lists over TRAIN interactions only (eval must not mask the target)
    # + per-user history, newest last, truncated to max_hist most-recent.
    # Vectorized (identical output to the per-interaction loop it replaced,
    # incl. first-occurrence order — tests/test_prep.py::
    # test_vectorized_seen_hist_match_loop_reference): the XING-true-scale
    # rehearsal preps tens of millions of interactions, where a Python loop
    # per interaction costs minutes.
    seen_items, seen_lengths = _padded_seen(train_users, train_items,
                                            num_users, num_items)
    hist_items, hist_lengths = _padded_hist(train_users, train_items,
                                            num_users, max_hist)

    # full-data counts: item ids are frequency ranks over ALL interactions
    # (assigned at vocab-build time, before the split), so the stored freq
    # must use the same population to stay monotone.
    item_freq = np.bincount(items, minlength=num_items).astype(np.int64)

    ds = PreparedDataset(
        name=name,
        user_schema=user_schema,
        item_schema=item_schema,
        user_attrs=user_attrs,
        item_attrs=item_attrs,
        train_users=train_users,
        train_items=train_items,
        valid_users=valid_users,
        valid_items=valid_items,
        seen_items=seen_items,
        seen_lengths=seen_lengths,
        item_freq=item_freq,
        hist_items=hist_items,
        hist_lengths=hist_lengths,
    )
    return ds


def _pad_rows(users: np.ndarray, items: np.ndarray, num_users: int,
              width_floor: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """(user-sorted users, items) → padded-dense [num_users, max_len] int32
    (PAD = -1) + lengths, preserving the given per-user order."""
    lengths = np.bincount(users, minlength=num_users).astype(np.int32)
    max_len = max(width_floor, int(lengths.max()) if len(users) else 0)
    out = np.full((num_users, max_len), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    pos = np.arange(len(users)) - starts[users]
    out[users, pos] = items
    return out, lengths


def _padded_seen(train_users, train_items, num_users: int, num_items: int):
    """Per-user deduped seen items in FIRST-OCCURRENCE order (the arrays
    arrive user-sorted then time-sorted, so first occurrence == earliest)."""
    n = len(train_users)
    key = train_users.astype(np.int64) * num_items + train_items
    _, first = np.unique(key, return_index=True)
    first.sort()                       # back to (user, time) order
    return _pad_rows(train_users[first], train_items[first], num_users)


def _padded_hist(train_users, train_items, num_users: int, max_hist: int):
    """Per-user full history (newest last), truncated to the max_hist
    most-recent interactions."""
    lengths = np.bincount(train_users, minlength=num_users)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    pos = np.arange(len(train_users)) - starts[train_users]
    keep = pos >= (lengths[train_users] - max_hist)
    return _pad_rows(train_users[keep], train_items[keep], num_users)


# --------------------------------------------------------------------------
# Batch iterators
# --------------------------------------------------------------------------

def _epoch_perm(n: int, seed: int, epoch: int) -> np.ndarray:
    return np.random.default_rng(
        np.random.SeedSequence([seed, epoch])).permutation(n)


def mf_batches(ds: PreparedDataset, batch_size: int, seed: int, epoch: int,
               host_id: int = 0, num_hosts: int = 1,
               drop_remainder: bool = True
               ) -> Iterator[dict[str, np.ndarray]]:
    """MF training batches: (user, positive item) pairs in a deterministic
    per-(seed, epoch) order of the train interactions; a last partial batch
    (drop_remainder=False) is filled from the start of the order. The
    negatives are drawn by the loss, not here."""
    perm = _epoch_perm(len(ds.train_users), seed, epoch)[host_id::num_hosts]
    n = (len(perm) // batch_size) * batch_size if drop_remainder else len(perm)
    for s in range(0, n, batch_size):
        idx = perm[s : s + batch_size]
        if len(idx) < batch_size:
            idx = np.concatenate([idx, perm[: batch_size - len(idx)]])
        yield {"user": ds.train_users[idx], "pos_item": ds.train_items[idx]}


def seq_batches(ds: PreparedDataset, batch_size: int, max_seq_len: int,
                seed: int, epoch: int, host_id: int = 0,
                num_hosts: int = 1) -> Iterator[dict[str, np.ndarray]]:
    """Sequence training batches: for each user with ≥2 train interactions
    (in a deterministic per-(seed, epoch) order), inputs are items[:-1] and
    targets items[1:] (next-item prediction), truncated to the most recent
    `max_seq_len` steps and left-padded. Fixed shapes: inputs/targets int32
    [B, L] with pad id = num_items, mask float32 [B, L], user int32 [B]."""
    users = np.flatnonzero(ds.hist_lengths >= 2)
    perm = users[_epoch_perm(len(users), seed, epoch)][host_id::num_hosts]
    pad = ds.num_items
    n = (len(perm) // batch_size) * batch_size
    for s in range(0, max(n, batch_size if len(perm) else 0), batch_size):
        idx = perm[s : s + batch_size]
        if len(idx) == 0:
            return
        if len(idx) < batch_size:
            idx = np.concatenate([idx, perm[: batch_size - len(idx)]])
        idx = idx.astype(np.int32)
        inputs, targets, mask = native.pack_train_sequences(
            ds.hist_items, ds.hist_lengths, idx, max_seq_len, pad)
        yield {"user": idx, "inputs": inputs,
               "targets": targets, "mask": mask}


def eval_batches(ds: PreparedDataset, batch_size: int, max_seq_len: int = 0,
                 host_id: int = 0, num_hosts: int = 1
                 ) -> Iterator[dict[str, np.ndarray]]:
    """Validation batches: one row per held-out (user, positive), fixed
    shapes; the trailing partial batch is padded with repeats and flagged by
    `valid`. With max_seq_len > 0 also the user's train history packed to L
    (inputs, mask). Host h takes the rows h::num_hosts, and every host
    yields the same number of batches."""
    nv = len(ds.valid_users)
    pad_item = ds.num_items
    rows = np.arange(nv)[host_id::num_hosts]
    per_host = -(-nv // num_hosts)
    n_batches = max(1, -(-per_host // batch_size)) if nv else 0
    for b in range(n_batches):
        idx = rows[b * batch_size : (b + 1) * batch_size]
        valid = np.ones(batch_size, np.float32)
        if len(idx) < batch_size:
            valid[len(idx):] = 0.0
            idx = np.concatenate([idx, np.zeros(batch_size - len(idx),
                                                np.int64)])
        batch = {
            "user": ds.valid_users[idx],
            "pos_item": ds.valid_items[idx],
            "valid": valid,
        }
        if max_seq_len:
            inputs, mask = native.pack_eval_sequences(
                ds.hist_items, ds.hist_lengths,
                batch["user"].astype(np.int32), max_seq_len, pad_item)
            batch["inputs"] = inputs
            batch["mask"] = mask
        yield batch
