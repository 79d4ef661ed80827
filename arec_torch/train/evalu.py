"""Evaluation: seen-masked top-k and Recall@K hit counts (port of
`arec/train/evalu.py`).

scores = query · V_allᵀ + b over ALL items, already-interacted items pushed
down by a −1e9 penalty, top-k. The scoring product takes its operands in
`compute_dtype` (bf16 by default, whatever the model's compute dtype, as
in arec's serving step) and sums in f32. The penalty is a scatter-ADD, so
a duplicated seen id is penalised twice, as in arec.
"""

from __future__ import annotations

import torch

from arec_torch.tables.engine import mm_f32

BLOCKED_EVAL_MIN_V = 131072  # above this, stream query blocks


def topk_with_mask(query, item_latents, item_bias, seen, k: int = 30,
                   compute_dtype=torch.bfloat16, recall_target: float = 1.0,
                   score_mem_mb: int = 512):
    """Dispatch by vocabulary size: small V materialises [B, V] scores;
    production V goes through the query-blocked
    `arec_torch.retrieval.mips.blocked_topk_mips`, whose peak score memory
    is bounded by `score_mem_mb`. The two are exactly equal.
    recall_target < 1 (arec's approx_max_k mode) always takes the blocked
    path, which then selects approximately (`mips.approx_max_k`)."""
    if recall_target < 1.0 or item_latents.shape[0] > BLOCKED_EVAL_MIN_V:
        from arec_torch.retrieval.mips import blocked_topk_mips
        return blocked_topk_mips(query, item_latents, item_bias, seen, k=k,
                                 compute_dtype=compute_dtype,
                                 recall_target=recall_target,
                                 score_mem_mb=score_mem_mb)
    return _topk_full(query, item_latents, item_bias, seen, k=k,
                      compute_dtype=compute_dtype)


def _topk_full(query, item_latents, item_bias, seen, k: int = 30,
               compute_dtype=torch.bfloat16):
    """query [B, D], item_latents [V, D], item_bias [V], seen int [B, S]
    (PAD = -1) → (topk_scores [B, k], topk_ids [B, k])."""
    scores = mm_f32(query, item_latents.T, compute_dtype) + item_bias[None, :]
    v = scores.shape[1]
    # scatter-add with jax's default scatter mode: an id outside [0, V)
    # is dropped (it penalises nothing)
    ok = (seen >= 0) & (seen < v)
    rows = torch.arange(seen.shape[0], device=seen.device)[:, None].expand(
        seen.shape)
    safe = torch.where(ok, seen, 0).long()
    penalty = torch.where(ok, -1e9, 0.0).to(scores.dtype)
    scores.index_put_((rows, safe), penalty, accumulate=True)
    return torch.topk(scores, k, dim=1)


def recall_hits(query, item_latents, item_bias, seen, pos_item, valid,
                k: int = 30, recall_target: float = 1.0):
    """Per-batch (hits, count) for Recall@K, honouring the eval-padding
    mask `valid`."""
    _, ids = topk_with_mask(query, item_latents, item_bias, seen, k=k,
                            recall_target=recall_target)
    hit = (ids == pos_item[:, None]).any(dim=1).float()
    return (hit * valid).sum(), valid.sum()
