"""The native batch packer: ctypes bindings for `packer.cpp` (port of
`arec/native/__init__.py`, the same C ABI and argtypes).

`pack_train_sequences` and `pack_eval_sequences` call the C++ library,
which `build.py` compiles with g++ at first use; `data/dataset.py` packs
every sequence batch through them. `pack_train_sequences_np` and
`pack_eval_sequences_np` are arec's numpy versions, kept as the tests'
oracle.

Why the port raises where arec falls back: arec's loader swallows a failed
build or load and packs with numpy instead, so a broken toolchain turns
into a silent slowdown of every step. Here a failed build raises with
g++'s output, and a library that loads must report ABI version 1.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)

_lib = None
_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    """The packer library, built and bound on first use."""
    global _lib
    with _lock:
        if _lib is None:
            from arec_torch.native.build import build
            lib = ctypes.CDLL(str(build()))
            i64, i32 = ctypes.c_int64, ctypes.c_int32
            lib.arec_pack_train_sequences.argtypes = [
                _I32P, _I32P, i64, _I32P, i64, i64, i32, _I32P, _I32P, _F32P]
            lib.arec_pack_train_sequences.restype = None
            lib.arec_pack_eval_sequences.argtypes = [
                _I32P, _I32P, i64, _I32P, i64, i64, i32, _I32P, _F32P]
            lib.arec_pack_eval_sequences.restype = None
            lib.arec_gather_rows_i32.argtypes = [_I32P, i64, _I64P, i64,
                                                 _I32P]
            lib.arec_gather_rows_i32.restype = None
            lib.arec_abi_version.argtypes = []
            lib.arec_abi_version.restype = i32
            version = lib.arec_abi_version()
            if version != 1:
                raise RuntimeError(f"packer ABI version {version}, want 1")
            _lib = lib
        return _lib


def _p(a, t):
    return a.ctypes.data_as(t)


def _operands(hist, hist_len, users, L):
    """C-contiguous int32 operands, checked so that the C loops stay
    inside their arrays: user ids index `hist_len`, and every selected
    history length lies in [0, max_hist]."""
    hist = np.ascontiguousarray(hist, np.int32)
    hist_len = np.ascontiguousarray(hist_len, np.int32)
    users = np.ascontiguousarray(users, np.int32)
    if hist.ndim != 2 or hist_len.shape != (hist.shape[0],) or L < 0:
        raise ValueError(f"hist {hist.shape}, hist_len {hist_len.shape}, "
                         f"L {L}")
    if len(users):
        if users.min() < 0 or users.max() >= len(hist_len):
            raise ValueError("user id out of range")
        lens = hist_len[users]
        if lens.min() < 0 or lens.max() > hist.shape[1]:
            raise ValueError("history length out of [0, max_hist]")
    return hist, hist_len, users


def pack_train_sequences(hist, hist_len, users, L, pad_item):
    """→ (inputs [B,L] i32, targets [B,L] i32, mask [B,L] f32): per user the
    last L+1 history items, inputs = items[:-1], targets = items[1:],
    left-padded with `pad_item`."""
    hist, hist_len, users = _operands(hist, hist_len, users, L)
    b = len(users)
    inputs = np.empty((b, L), np.int32)
    targets = np.empty((b, L), np.int32)
    mask = np.empty((b, L), np.float32)
    _load().arec_pack_train_sequences(
        _p(hist, _I32P), _p(hist_len, _I32P), hist.shape[1],
        _p(users, _I32P), b, int(L), int(pad_item),
        _p(inputs, _I32P), _p(targets, _I32P), _p(mask, _F32P))
    return inputs, targets, mask


def pack_train_sequences_np(hist, hist_len, users, L, pad_item):
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
    hist, hist_len, users = _operands(hist, hist_len, users, L)
    b = len(users)
    inputs = np.empty((b, L), np.int32)
    mask = np.empty((b, L), np.float32)
    _load().arec_pack_eval_sequences(
        _p(hist, _I32P), _p(hist_len, _I32P), hist.shape[1],
        _p(users, _I32P), b, int(L), int(pad_item),
        _p(inputs, _I32P), _p(mask, _F32P))
    return inputs, mask


def pack_eval_sequences_np(hist, hist_len, users, L, pad_item):
    b = len(users)
    inputs = np.full((b, L), pad_item, np.int32)
    mask = np.zeros((b, L), np.float32)
    for r, u in enumerate(users):
        h = hist[u, : hist_len[u]][-L:]
        if len(h):
            inputs[r, L - len(h):] = h
            mask[r, L - len(h):] = 1.0
    return inputs, mask
