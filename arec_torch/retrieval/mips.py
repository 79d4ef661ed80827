"""Serving-time candidate retrieval: top-k MIPS over the (sharded) item
table (port of `arec/retrieval/mips.py`).

Query-blocked: each chunk of queries scores the full vocab, masks its seen
items and selects top-k, so peak score memory stays within `score_mem_mb`
at any V (at V ≈ 1.3M a [256, V] f32 score matrix would be 1.3 GB).
recall_target = 1 is exact; recall_target < 1 selects with `approx_max_k`,
the port's counterpart of `lax.approx_max_k`, over top-(k+S) candidates
and masks the seen ids among them, as arec does.

On a mesh (`make_sharded_topk`) each rank holds a contiguous block of the
item matrix (rows padded to a model-axis multiple, pad bias −1e9:
`pad_item_shards`) and its "data" slab of the queries; it scores its
block query-blocked, masks the seen ids that fall in its block (seen ids
are global), takes a local top-min(k, Vs), and the candidates are
all-gathered over "model" in shard order for an exact merge. The top-k of
a union of per-shard top-ks is the global top-k, so the merge loses
nothing; ties may be ordered differently from arec's `lax.top_k`.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

TILING = 128   # XLA's tile of the reduced (minor-most) dimension


def approx_reduction_size(v: int, k: int,
                          recall_target: float) -> tuple[int, int]:
    """(R, l): how many bins `approx_max_k` reduces a row of `v` scores to
    (R) and log2 of the elements a bin holds (l), by the port's copy of
    XLA's rule (`ApproxTopKReductionOutputSize` for aggregate_to_topk=False
    and a rank-2 operand reduced along its last dimension). A row of at
    most 128 is not reduced; k = 1 reduces to one tile of 128, where a bin
    max loses nothing. Otherwise a bin count m keeps the expected recall
    (1 − 1/m)^(k−1) ≈ exp((1 − k)/m) at the target; l = floor(log2(v / m)),
    at most ceil(log2(ceil(v / 128))); l = 0 means no reduction (R = v)."""
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target {recall_target} outside (0, 1]")
    if v <= TILING:
        return v, 0
    tiles = -(-v // TILING)
    ceil_log2 = (tiles - 1).bit_length()
    if k == 1:
        return TILING, ceil_log2
    if recall_target == 1.0:
        return v, 0
    m = min(max(int((1.0 - k) / math.log(recall_target)), TILING), v)
    l = min((v // m).bit_length() - 1, ceil_log2)
    if l <= 0:
        return v, 0
    return -(-tiles // (1 << l)) * TILING, l


def approx_max_k(scores, k: int, recall_target: float):
    """(values [B, k], ids [B, k]): an approximate top-k of each row of
    `scores` [B, V], the port's counterpart of `lax.approx_max_k`.

    With (R, l) from `approx_reduction_size`, the row is read as if padded
    with −inf to R·2^l and viewed as [2^l, R]: element i falls into bin
    i mod R. Each bin keeps its max and that max's index; the result is the
    exact top-k of the R bin maxima. Two of the true top-k that share a bin
    cost one of them, which the bin count keeps near the recall target.
    This layout is the port's choice: it cannot be held against the TPU's,
    since arec's CPU lowering of `approx_max_k` is exact.

    Where XLA's rule gives no reduction (l = 0: a row of at most 128,
    recall_target 1, or V under twice the bin count the target needs), the
    result is the exact top-k, as XLA's is."""
    b, v = scores.shape
    r, l = approx_reduction_size(v, k, recall_target)
    if l == 0:
        return torch.topk(scores, k, dim=1)
    full = v // r                     # bins filled in every row of the view
    vals, rows = scores[:, :full * r].view(b, full, r).max(dim=1)
    tail = v - full * r               # the ragged row: bins [0, tail)
    if tail:
        last = scores[:, full * r:]
        better = last > vals[:, :tail]
        vals[:, :tail] = torch.where(better, last, vals[:, :tail])
        rows[:, :tail] = torch.where(better, full, rows[:, :tail])
    tv, tb = torch.topk(vals, k, dim=1)
    return tv, rows.gather(1, tb) * r + tb


def blocked_topk_mips(query, item_latents, item_bias, seen, k: int = 30,
                      qblock: int = 0, compute_dtype=torch.bfloat16,
                      recall_target: float = 1.0, score_mem_mb: int = 512):
    """(scores [B, k], ids [B, k]). The operands are rounded to
    `compute_dtype` once, outside the chunk loop, and every chunk's product
    sums in f32.

    recall_target = 1: identical to `_topk_full`; a seen id clamps into
    [0, V) before its −1e9 penalty is added (arec's clip; PAD = -1 adds
    nothing).
    recall_target < 1: `approx_max_k` takes kb = min(k + S, V) candidates
    per row; a row's seen ids (sorted, PAD → V + 1) can hold at most S of
    them, and a candidate found among them by a sorted search is set to
    −inf with id −1; the result is the exact top-k of the candidates (so
    where fewer than k unseen candidates remain, −inf / −1 fill the tail,
    as in arec)."""
    b = query.shape[0]
    v = item_latents.shape[0]
    s_width = seen.shape[1]
    if not qblock:
        # budget → chunk count first, then even chunks
        qblock = max(1, min(b, (score_mem_mb << 20) // max(4 * v, 1)))
        nb = -(-b // qblock)
        qblock = -(-b // nb)
    exact = recall_target >= 1.0
    if not exact:
        seen = torch.sort(torch.where(seen >= 0, seen, v + 1).long(),
                          dim=1).values
        kb = min(k + s_width, v)
    qs = query.to(compute_dtype).float()
    vt = item_latents.to(compute_dtype).float().T
    vals, ids = [], []
    for s in range(0, b, qblock):
        sn = seen[s:s + qblock]
        scores = qs[s:s + qblock] @ vt + item_bias[None, :]
        if exact:
            rows = torch.arange(sn.shape[0], device=sn.device)[:, None]
            penalty = torch.where(sn >= 0, -1e9, 0.0).to(scores.dtype)
            scores.index_put_((rows.expand(sn.shape),
                               sn.clamp(0, v - 1).long()), penalty,
                              accumulate=True)
            tv, ti = torch.topk(scores, k, dim=1)
        else:
            cv, ci = approx_max_k(scores, kb, recall_target)
            if s_width > 0:   # width-0 seen: nothing to mask
                pos = torch.searchsorted(sn, ci).clamp_max(s_width - 1)
                hit = sn.gather(1, pos) == ci
                cv = cv.masked_fill(hit, -math.inf)
                ci = ci.masked_fill(hit, -1)
            tv, tp = torch.topk(cv, k, dim=1)
            ti = ci.gather(1, tp)
        vals.append(tv)
        ids.append(ti)
    return torch.cat(vals), torch.cat(ids)


def _local_score_topk(q, v_shard, b_shard, seen, k, compute_dtype, offset,
                      score_mem_mb=512, recall_target=1.0, qblock=0):
    """One rank's part of the sharded top-k: score the item block
    v_shard [Vs, D] (global ids offset .. offset + Vs) query-blocked under
    `score_mem_mb`, mask the seen ids in this block, and return the local
    top-min(k, Vs) (values, GLOBAL ids). recall_target < 1 selects each
    chunk with `approx_max_k` over top-(k+S) candidates and masks the
    seen ids among them (sentinel id −1), as `blocked_topk_mips` does."""
    vs = v_shard.shape[0]
    kl = min(k, vs)
    bl = q.shape[0]
    s_width = seen.shape[1]
    if not qblock:
        qblock = max(1, min(bl, (score_mem_mb << 20) // max(4 * vs, 1)))
        nb = -(-bl // qblock)
        qblock = -(-bl // nb)
    exact = recall_target >= 1.0
    if not exact:
        # sorted GLOBAL ids (pad → int32 max) for candidate-set membership
        seen = torch.sort(torch.where(seen >= 0, seen, 2**31 - 1).long(),
                          dim=1).values
        kb = min(k + s_width, vs)
    qs = q.to(compute_dtype).float()
    vt = v_shard.to(compute_dtype).float().T
    vals, ids = [], []
    for s in range(0, bl, qblock):
        sn = seen[s:s + qblock]
        scores = qs[s:s + qblock] @ vt + b_shard[None, :]
        if exact:
            local = sn.long() - offset
            mine = (local >= 0) & (local < vs) & (sn >= 0)
            rows = torch.arange(sn.shape[0], device=sn.device)[:, None]
            scores.index_put_((rows.expand(sn.shape), local.clamp(0, vs - 1)),
                              torch.where(mine, -1e9, 0.0).to(scores.dtype),
                              accumulate=True)
            tv, ti = torch.topk(scores, kl, dim=1)
            gi = ti + offset
        else:
            cv, ci = approx_max_k(scores, kb, recall_target)
            ci = ci + offset
            if s_width > 0:
                pos = torch.searchsorted(sn, ci).clamp_max(s_width - 1)
                hit = sn.gather(1, pos) == ci
                cv = cv.masked_fill(hit, -math.inf)
                ci = ci.masked_fill(hit, -1)
            tv, tp = torch.topk(cv, kl, dim=1)
            gi = ci.gather(1, tp)
        vals.append(tv)
        ids.append(gi)
    return torch.cat(vals), torch.cat(ids)


def _gather_model(x, group, t):
    """[Bl, kl] per rank → [Bl, T·kl], the model ranks' blocks side by
    side in shard order."""
    parts = [torch.empty_like(x) for _ in range(t)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def make_sharded_topk(mesh, k: int = 30, compute_dtype=torch.bfloat16,
                      score_mem_mb: int = 512, recall_target: float = 1.0,
                      qblock: int = 0):
    """topk(query, item_shard, bias_shard, seen) → (scores, ids) [Bl, k]:
    the global top-k of this rank's "data" slab of queries (query [Bl, D],
    seen [Bl, S] global ids, PAD = −1) over the item matrix row-sharded
    over "model" (item_shard [Vs, D], bias_shard [Vs]: this rank's block,
    see `pad_item_shards`). Exact by default; recall_target < 1 selects
    approximately per shard, and the merge stays exact. Where the
    candidates are fewer than k (the whole vocabulary is), the tail is
    −inf / −1, as in arec."""
    from arec_torch.dist.specs import TABLE_AXIS
    group, t = mesh.get_group(TABLE_AXIS), mesh.size(1)
    me = mesh.get_local_rank(TABLE_AXIS)

    def topk(query, item_shard, bias_shard, seen):
        vals, ids = _local_score_topk(
            query, item_shard, bias_shard, seen, k, compute_dtype,
            me * item_shard.shape[0], score_mem_mb, recall_target, qblock)
        all_vals = _gather_model(vals, group, t)
        all_ids = _gather_model(ids, group, t)
        km = min(k, all_vals.shape[1])
        m_vals, m_pos = torch.topk(all_vals, km, dim=1)
        m_ids = all_ids.gather(1, m_pos)
        if km < k:
            m_vals = torch.nn.functional.pad(m_vals, (0, k - km),
                                             value=-math.inf)
            m_ids = torch.nn.functional.pad(m_ids, (0, k - km), value=-1)
        return m_vals, m_ids

    return topk


def sharded_topk(mesh, query, item_shard, bias_shard, seen, k: int = 30,
                 compute_dtype=torch.bfloat16, score_mem_mb: int = 512,
                 recall_target: float = 1.0):
    """One-shot `make_sharded_topk`."""
    return make_sharded_topk(mesh, k=k, compute_dtype=compute_dtype,
                             score_mem_mb=score_mem_mb,
                             recall_target=recall_target)(
        query, item_shard, bias_shard, seen)


def pad_item_shards(item_latents, item_bias, model_size: int):
    """Pad V up to a model-axis multiple: zero latents, bias −1e9, so pad
    rows never enter a top-k."""
    v = item_latents.shape[0]
    pad = -(-v // model_size) * model_size - v
    if pad:
        item_latents = torch.cat([item_latents, item_latents.new_zeros(
            (pad, item_latents.shape[1]))])
        item_bias = torch.cat([item_bias, item_bias.new_full((pad,), -1e9)])
    return item_latents, item_bias
