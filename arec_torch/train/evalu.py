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

from arec_torch import obs
from arec_torch.tables.engine import mm_f32

BLOCKED_EVAL_MIN_V = 131072  # above this, stream query blocks


def topk_with_mask(query, item_latents, item_bias, seen, k: int = 30,
                   compute_dtype=torch.bfloat16, recall_target: float = 1.0,
                   score_mem_mb: int = 512):
    """The exact top-k (recall_target 1) of CUDA tensors is the fused
    kernels of `arec_torch.kernels.mips_topk` at every V; on the CPU it is
    their plain version, `mips_topk_plain`: `_topk_full` up to
    BLOCKED_EVAL_MIN_V items, the query-blocked
    `arec_torch.retrieval.mips.blocked_topk_mips` (peak score memory
    bounded by `score_mem_mb`) above it. The two are exactly equal, but for
    a seen id ≥ V, which the first drops and the second clamps to V − 1;
    the kernels keep the rule of the branch at that V.
    recall_target < 1 (arec's approx_max_k mode) takes the blocked path,
    which then selects approximately (`mips.approx_max_k`)."""
    if recall_target >= 1.0:
        from arec_torch.kernels import mips_topk as mk
        if query.device.type == "cuda":
            obs.count("serve.topk_kernel", 1)
            return mk.mips_topk(query.float().contiguous(), item_latents,
                                item_bias, seen.to(torch.int32), k=k,
                                compute_dtype=compute_dtype)
        return mk.mips_topk_plain(query, item_latents, item_bias, seen, k=k,
                                  compute_dtype=compute_dtype,
                                  score_mem_mb=score_mem_mb)
    from arec_torch.retrieval.mips import blocked_topk_mips
    return blocked_topk_mips(query, item_latents, item_bias, seen, k=k,
                             compute_dtype=compute_dtype,
                             recall_target=recall_target,
                             score_mem_mb=score_mem_mb)


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
