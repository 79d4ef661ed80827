"""Standing serving layer (port of `arec/serve.py`, sequence family): hold
the model's weights and the item latent matrix on the device and answer
batched top-K requests from raw item histories.

The path is arec's: `Recommender.__init__` → item latents (pre-cast to
the compute dtype) → per batch `_query_fn` → `seq_final_state_full` (the
carried-state segmented scan, through the CUDA LSTM or GRU kernel with
`use_pallas_scan`) → seen-masked exact top-k. Requests are padded to a
fixed batch of `serve_batch`.

Weights enter as an arec-layout param tree (numpy or torch; see
`arec_torch.bridge`) — what a checkpoint restore would hand over. Not
ported yet: checkpoint restore (`refresh`, `main`), MF serving
(`for_users`) and the approximate top-k mode.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from arec_torch import bridge, resolve_device
from arec_torch.config import Config
from arec_torch.data.io import load_or_prepare
from arec_torch.models import seq as seq_mod
from arec_torch.tables.engine import attrs_to_device
from arec_torch.train.evalu import topk_with_mask


def _item_latents(cfg: Config, spec, params, item_dev):
    """All-item latent matrix + bias; serve_latents_dtype="compute" pre-casts
    the matrix to the compute dtype once (scores are unchanged: top-k casts
    its operands anyway)."""
    v, b = seq_mod.seq_item_latents(params, spec, item_dev)
    if cfg.train.serve_latents_dtype == "compute":
        v = v.to(spec.dtype)
    return v, b


def _query_fn(spec, params, item_dev, user_dev, batch):
    """Serving query encode: the final recurrent state after each
    history."""
    return seq_mod.seq_final_state_full(params, spec, item_dev, user_dev,
                                        batch)


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
    """Serve a sequence model from weights handed over as a param tree.

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
        if cfg.model.model != "lstm":
            raise NotImplementedError(
                "MF serving (for_users) is not ported yet: later slice")
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
        ds = load_or_prepare(cfg.data)
        spec = self.spec = seq_mod.SeqSpec.from_config(
            cfg, ds.user_schema, ds.item_schema)
        self._item_dev = attrs_to_device(
            ds.item_attrs.restrict(spec.item_in.schema), spec.item_in,
            self.device)
        self._user_dev = (attrs_to_device(
            ds.user_attrs.restrict(spec.user.schema), spec.user, self.device)
            if spec.user is not None else None)
        self._params = bridge.to_torch(params, self.device)
        with torch.inference_mode():
            self._vb = _item_latents(cfg, spec, self._params, self._item_dev)
        self._step = _serve_step(cfg, spec, self._item_dev, self._user_dev,
                                 self.k)

    def refresh(self) -> bool:
        raise NotImplementedError(
            "refresh needs checkpoint restore, which is not ported yet: "
            "later slice")

    def for_users(self, user_ids, seen=None) -> np.ndarray:
        raise NotImplementedError(
            "for_users serves the MF family, which is not ported yet: "
            "later slice")

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
        return self._run(self._history_batches(histories, seen_from_history,
                                               seen, user_ids))


# ---------------------------------------------------------------------------
# Line-oriented request loop (arec's `python -m arec.serve` protocol):
#
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
            else:
                first = line.split("\t")[0]
                hist = [int(x) for x in first.split(",") if x]
                ids = rec.from_histories([hist])
                print(f"{first}\t{','.join(map(str, ids[0].tolist()))}",
                      file=out, flush=True)
        except Exception as e:  # keep serving after a bad request
            print(f"!err {type(e).__name__}: {e}", file=out, flush=True)
    return 0
