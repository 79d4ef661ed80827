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

from arec_torch.kernels import mips_topk as mk
from arec_torch.retrieval import mips


def topk_with_mask(query, item_latents, item_bias, seen, k: int = 30,
                   compute_dtype=torch.bfloat16, recall_target: float = 1.0,
                   score_mem_mb: int = 512):
    """The one-device top-k. The exact one (recall_target 1) of CUDA
    tensors is the fused kernels of `arec_torch.kernels.mips_topk` at
    every V; on the CPU it is their plain version, `mips_topk_plain`, the
    query-blocked loop of `retrieval.mips` (peak score memory bounded by
    `score_mem_mb`) over the seen slab as `retrieval.mips.seen_rule` reads
    it. recall_target < 1 (arec's approx_max_k mode) takes
    `retrieval.mips.blocked_topk_mips`, which then selects approximately
    (`mips.approx_max_k`)."""
    if recall_target < 1.0:
        return mips.blocked_topk_mips(query, item_latents, item_bias, seen,
                                      k=k, compute_dtype=compute_dtype,
                                      recall_target=recall_target,
                                      score_mem_mb=score_mem_mb)
    if query.device.type == "cuda":
        return mk.mips_topk(query.float().contiguous(), item_latents,
                            item_bias, seen.to(torch.int32), k=k,
                            compute_dtype=compute_dtype)
    return mk.mips_topk_plain(query, item_latents, item_bias, seen, k=k,
                              compute_dtype=compute_dtype,
                              score_mem_mb=score_mem_mb)


def recall_hits(query, item_latents, item_bias, seen, pos_item, valid,
                k: int = 30, recall_target: float = 1.0):
    """Per-batch (hits, count) for Recall@K, honouring the eval-padding
    mask `valid`."""
    _, ids = topk_with_mask(query, item_latents, item_bias, seen, k=k,
                            recall_target=recall_target)
    hit = (ids == pos_item[:, None]).any(dim=1).float()
    return (hit * valid).sum(), valid.sum()
