"""Standing serving layer (port of `arec/serve.py`): hold the model's
weights and the item latent matrix on the device and answer batched top-K
requests — raw item histories (sequence family, `from_histories`) or user
ids (MF family, `for_users`).

The path is arec's: `Recommender.__init__` → item latents (pre-cast to
the compute dtype) → per batch `_query_fn` → the sequence family's
`seq_final_state_full` (the carried-state segmented scan, through the CUDA
LSTM or GRU kernel with `use_pallas_scan`) or MF's `mf_user_latents` →
seen-masked exact top-k. Requests are padded to a fixed batch of
`serve_batch`.

Weights enter as an arec-layout param tree (numpy or torch; see
`arec_torch.bridge`) — what a checkpoint restore would hand over. An MF
tree may be the sparse step's packed one (tables [V, 2D]); it is read
through `unpack_params`, as arec's `Trainer._eval_params` does. Not ported
yet: checkpoint restore (`refresh`, `main`) and the approximate top-k
mode.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from arec_torch import bridge, resolve_device
from arec_torch.config import Config
from arec_torch.data.io import load_or_prepare
from arec_torch.models import mf as mf_mod
from arec_torch.models import seq as seq_mod
from arec_torch.tables.engine import attrs_to_device
from arec_torch.train.evalu import topk_with_mask
from arec_torch.train.sparse import get_path, table_paths, unpack_params


def _item_latents(cfg: Config, spec, params, item_dev):
    """All-item latent matrix + bias; serve_latents_dtype="compute" pre-casts
    the matrix to the compute dtype once (scores are unchanged: top-k casts
    its operands anyway)."""
    if isinstance(spec, mf_mod.MFSpec):
        v, b = mf_mod.mf_item_latents(params, spec, item_dev)
    else:
        v, b = seq_mod.seq_item_latents(params, spec, item_dev)
    if cfg.train.serve_latents_dtype == "compute":
        v = v.to(spec.dtype)
    return v, b


def _query_fn(spec, params, item_dev, user_dev, batch):
    """Serving query encode: MF's user latents, or the final recurrent
    state after each history."""
    if isinstance(spec, mf_mod.MFSpec):
        return mf_mod.mf_user_latents(params, spec, user_dev, batch["user"])
    return seq_mod.seq_final_state_full(params, spec, item_dev, user_dev,
                                        batch)


def _mf_params(spec, params):
    """A plain MF param tree: the sparse step's packed tables ([V, 2D])
    are read through unpack_params; any other width raises."""
    paths = table_paths(False, spec)
    widths = [get_path(params, p).shape[1] for p in paths]
    want = [spec.user.width, spec.item.width]
    if widths == [2 * w for w in want]:
        return unpack_params(params, paths)
    if widths != want:
        raise ValueError(f"MF tables of width {widths}: neither plain "
                         f"{want} nor packed {[2 * w for w in want]}")
    return params


def _serve_step(cfg: Config, spec, item_dev, user_dev, k: int):
    """Per-batch serving step: queries → seen-masked exact top-k. Like
    arec's single-device step it passes no compute dtype to the top-k, so
    the scores take bf16 operands even when the model computes in f32."""
    target = cfg.train.serve_recall_target
    mem = cfg.train.serve_score_mem_mb
    if target < 1.0:
        raise NotImplementedError(
            "train.serve_recall_target < 1 (approximate top-k) is not "
            "ported; serve with 1.0")

    def step(params, v, b, batch, seen):
        q = _query_fn(spec, params, item_dev, user_dev, batch)
        return topk_with_mask(q, v, b, seen, k=k, recall_target=target,
                              score_mem_mb=mem)
    return step


def _pad_seen(seen, n: int, width: int) -> np.ndarray:
    """[n, width] int32, PAD = -1. Rows longer than `width` keep their LAST
    (most recent) ids."""
    out = np.full((n, max(width, 1)), -1, np.int32)
    if seen is not None:
        for i, row in enumerate(seen):
            row = list(row)[-out.shape[1]:]
            out[i, : len(row)] = row
    return out


def _auto_width(seen, fallback: int = 1) -> int:
    """Slab width for one call: the longest seen row, rounded up to a
    multiple of 32."""
    w = max((len(row) for row in seen), default=0) if seen is not None else 0
    w = max(w, fallback, 1)
    return -(-w // 32) * 32


class Recommender:
    """Serve a sequence or MF model from weights handed over as a param
    tree.

    Args:
      cfg: the model's Config (the same JSON arec trains from).
      params: arec-layout param tree, numpy arrays or torch tensors
        (`arec_torch.bridge`), e.g. `jax.tree.map(np.asarray, params)`.
      k: list length per request (default cfg.train.eval_topk).
      serve_batch: requests are padded to this batch size per dispatch.
      seen_width: width of the per-request seen-id slab; None sizes it per
        call to the longest seen list, so no exclusion list is truncated.
      device: where to serve; None = `cuda` (raises if there is none).
    """

    def __init__(self, cfg: Config, params, k: int | None = None,
                 serve_batch: int = 256, seen_width: int | None = None,
                 device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and (
                torch.backends.cuda.matmul.allow_tf32):
            raise RuntimeError(
                "TF32 matmuls change the scores and the scan's products; "
                "set torch.backends.cuda.matmul.allow_tf32 = False")
        self.cfg = cfg
        self.k = k or cfg.train.eval_topk
        self.serve_batch = serve_batch
        self.seen_width = None if seen_width is None else max(seen_width, 1)
        self._restored_step = None       # weights were handed in, not restored
        ds = self._ds = load_or_prepare(cfg.data)
        self.is_seq = cfg.model.model != "mf"
        family = seq_mod.SeqSpec if self.is_seq else mf_mod.MFSpec
        spec = self.spec = family.from_config(cfg, ds.user_schema,
                                              ds.item_schema)
        item_enc = spec.item_in if self.is_seq else spec.item
        self._item_dev = attrs_to_device(
            ds.item_attrs.restrict(item_enc.schema), item_enc, self.device)
        self._user_dev = (attrs_to_device(
            ds.user_attrs.restrict(spec.user.schema), spec.user, self.device)
            if spec.user is not None else None)
        self._params = bridge.to_torch(params, self.device)
        if not self.is_seq:
            self._params = _mf_params(spec, self._params)
        with torch.inference_mode():
            self._vb = _item_latents(cfg, spec, self._params, self._item_dev)
        self._step = _serve_step(cfg, spec, self._item_dev, self._user_dev,
                                 self.k)

    def refresh(self) -> bool:
        raise NotImplementedError(
            "refresh needs checkpoint restore, which is not ported yet: "
            "later slice")

    def for_users(self, user_ids, seen=None) -> np.ndarray:
        """Top-k item ids for known user ids (MF family). `seen`: optional
        per-request iterable of item ids to exclude."""
        if self.is_seq:
            raise ValueError("for_users serves the MF family; use "
                             "from_histories for sequence models")
        user_ids = np.asarray(user_ids, np.int32)
        sb = self.serve_batch
        pad_user = self._ds.num_users            # encodes to zero
        width = self.seen_width or _auto_width(seen)

        def batches():
            for s in range(0, len(user_ids), sb):
                chunk = user_ids[s:s + sb]
                users = np.full(sb, pad_user, np.int32)
                users[:len(chunk)] = chunk
                sl = None if seen is None else seen[s:s + sb]
                yield {"user": users,
                       "seen": _pad_seen(sl, sb, width)}, len(chunk)
        return self._run(batches())

    # ------------------------------------------------------------------
    def _run(self, batches) -> np.ndarray:
        """batches: iterable of (numpy batch dict, n_valid) → [N, k] ids."""
        ids_out = []
        v, b = self._vb
        with torch.inference_mode():
            for batch, n_valid in batches:
                tb = {kk: torch.from_numpy(x).to(self.device)
                      for kk, x in batch.items() if kk != "seen"}
                seen = torch.from_numpy(batch["seen"]).to(self.device)
                _, ids = self._step(self._params, v, b, tb, seen)
                ids_out.append(ids[:n_valid].cpu().numpy().astype(np.int32))
        if not ids_out:                      # empty request list
            return np.zeros((0, self.k), np.int32)
        return np.concatenate(ids_out, axis=0)

    def _history_batches(self, histories, seen_from_history=True, seen=None,
                         user_ids=None):
        """Fixed-shape numpy batches (and their live row counts) for
        `from_histories`: histories left-padded / truncated to whole
        max_seq_len segments."""
        spec = self.spec
        L = spec.max_seq_len
        sb = self.serve_batch
        pad_id = spec.vocab                      # encodes to zero
        max_hist = max((len(h) for h in histories), default=1)
        total = max(L, L * math.ceil(max_hist / L))
        if seen_from_history and seen is None:
            seen = (histories if self.seen_width is None
                    else [list(h)[-self.seen_width:] for h in histories])
        width = self.seen_width or _auto_width(seen)
        for s in range(0, len(histories), sb):
            chunk = histories[s:s + sb]
            n = len(chunk)
            inputs = np.full((sb, total), pad_id, np.int32)
            mask = np.zeros((sb, total), np.float32)
            for i, h in enumerate(chunk):
                h = list(h)[-total:]
                if h:
                    inputs[i, total - len(h):] = h
                    mask[i, total - len(h):] = 1.0
            batch = {"inputs": inputs, "mask": mask,
                     "seen": _pad_seen(
                         None if seen is None else seen[s:s + sb], sb, width)}
            if spec.user is not None:
                # anonymous requests take the pad user, which encodes to 0
                u = np.full(sb, spec.user.schema.num_entities, np.int32)
                if user_ids is not None:
                    u[:n] = np.asarray(user_ids[s:s + sb], np.int32)
                batch["user"] = u
            yield batch, n

    def from_histories(self, histories, seen_from_history: bool = True,
                       seen=None, user_ids=None) -> np.ndarray:
        """Top-k next items for raw per-request item histories of any
        length (the carried-state segmented scan runs one segment per
        max_seq_len items). By default a request's own history is also its
        seen-exclusion list."""
        if not self.is_seq:
            raise ValueError("from_histories serves the sequence family")
        return self._run(self._history_batches(histories, seen_from_history,
                                               seen, user_ids))


# ---------------------------------------------------------------------------
# Line-oriented request loop (arec's `python -m arec.serve` protocol):
#
#   MF family:        <user_id>[\t<seen_id,seen_id,...>]
#   sequence family:  <hist_id,hist_id,...>   (history = exclusion list)
#   commands:         !step, !quit; !refresh answers !err until the
#                     checkpoint slice is ported
#
# Responses: `<first_field>\t<id,id,...>`; unparseable lines answer
# `!err <reason>` and the loop continues.
# ---------------------------------------------------------------------------


def _serve_loop(rec: Recommender, inp, out) -> int:
    for line in inp:
        line = line.strip()
        if not line:
            continue
        try:
            if line == "!quit":
                return 0
            if line == "!step":
                print(f"!ok step {rec._restored_step}", file=out, flush=True)
            elif line == "!refresh":
                changed = rec.refresh()
                print(f"!ok {'refreshed' if changed else 'current'} "
                      f"step {rec._restored_step}", file=out, flush=True)
            elif rec.is_seq:
                first = line.split("\t")[0]
                hist = [int(x) for x in first.split(",") if x]
                ids = rec.from_histories([hist])
                print(f"{first}\t{','.join(map(str, ids[0].tolist()))}",
                      file=out, flush=True)
            else:
                parts = line.split("\t")
                uid = int(parts[0])
                seen = ([[int(x) for x in parts[1].split(",") if x]]
                        if len(parts) > 1 and parts[1] else None)
                ids = rec.for_users([uid], seen=seen)
                print(f"{uid}\t{','.join(map(str, ids[0].tolist()))}",
                      file=out, flush=True)
        except Exception as e:  # keep serving after a bad request
            print(f"!err {type(e).__name__}: {e}", file=out, flush=True)
    return 0
