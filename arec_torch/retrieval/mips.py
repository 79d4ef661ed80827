"""Serving-time candidate retrieval: exact top-k MIPS over the item table
(port of the single-device exact mode of `arec/retrieval/mips.py`).

Query-blocked: each chunk of queries scores the full vocab, masks its seen
items and selects top-k, so peak score memory stays within `score_mem_mb`
at any V (at V ≈ 1.3M a [256, V] f32 score matrix would be 1.3 GB).

Not ported: `recall_target < 1` (arec builds it on `lax.approx_max_k`,
which has no torch twin) raises; the sharded top-k comes with the
multi-GPU slice.
"""

from __future__ import annotations

import torch


def blocked_topk_mips(query, item_latents, item_bias, seen, k: int = 30,
                      qblock: int = 0, compute_dtype=torch.bfloat16,
                      recall_target: float = 1.0, score_mem_mb: int = 512):
    """(scores [B, k], ids [B, k]), identical to `_topk_full`. The operands
    are rounded to `compute_dtype` once, outside the chunk loop, and every
    chunk's product sums in f32. A seen id clamps into [0, V) before its
    −1e9 penalty is added (arec's clip; PAD = -1 adds nothing)."""
    if recall_target < 1.0:
        raise NotImplementedError(
            "approximate top-k (recall_target < 1) has no torch counterpart "
            "of lax.approx_max_k yet; serve with recall_target=1.0")
    b = query.shape[0]
    v = item_latents.shape[0]
    if not qblock:
        # budget → chunk count first, then even chunks
        qblock = max(1, min(b, (score_mem_mb << 20) // max(4 * v, 1)))
        nb = -(-b // qblock)
        qblock = -(-b // nb)
    qs = query.to(compute_dtype).float()
    vt = item_latents.to(compute_dtype).float().T
    vals, ids = [], []
    for s in range(0, b, qblock):
        sn = seen[s:s + qblock]
        scores = qs[s:s + qblock] @ vt + item_bias[None, :]
        rows = torch.arange(sn.shape[0], device=sn.device)[:, None].expand(
            sn.shape)
        penalty = torch.where(sn >= 0, -1e9, 0.0).to(scores.dtype)
        scores.index_put_((rows, sn.clamp(0, v - 1).long()), penalty,
                          accumulate=True)
        tv, ti = torch.topk(scores, k, dim=1)
        vals.append(tv)
        ids.append(ti)
    return torch.cat(vals), torch.cat(ids)
