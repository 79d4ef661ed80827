"""The batch packer of `arec/native/__init__.py`, numpy twins only.

arec packs sequence batches with a C++ packer (`packer.cpp`, loaded with
ctypes) and keeps these numpy versions as its fallback and test oracle. The
port exposes the numpy versions under the names `data/dataset.py` calls;
the C++ packer is host code and waits for the host input path (ROADMAP
A6.4).
"""

from __future__ import annotations

import numpy as np


def pack_train_sequences(hist, hist_len, users, L, pad_item):
    """→ (inputs [B,L] i32, targets [B,L] i32, mask [B,L] f32): per user the
    last L+1 history items, inputs = items[:-1], targets = items[1:],
    left-padded with `pad_item`."""
    b = len(users)
    inputs = np.full((b, L), pad_item, np.int32)
    targets = np.full((b, L), pad_item, np.int32)
    mask = np.zeros((b, L), np.float32)
    for r, u in enumerate(users):
        h = hist[u, : hist_len[u]]
        h = h[-(L + 1):]
        t = max(len(h) - 1, 0)
        if t:
            inputs[r, L - t:] = h[:-1]
            targets[r, L - t:] = h[1:]
            mask[r, L - t:] = 1.0
    return inputs, targets, mask


def pack_eval_sequences(hist, hist_len, users, L, pad_item):
    """→ (inputs [B,L] i32, mask [B,L] f32): per user the last L history
    items, left-padded."""
    b = len(users)
    inputs = np.full((b, L), pad_item, np.int32)
    mask = np.zeros((b, L), np.float32)
    for r, u in enumerate(users):
        h = hist[u, : hist_len[u]][-L:]
        if len(h):
            inputs[r, L - len(h):] = h
            mask[r, L - len(h):] = 1.0
    return inputs, mask
