"""The seen-masked top-k MIPS over the (sharded) item table in plain
PyTorch (port of `arec/retrieval/mips.py`), and the seen-id rule.

`score_and_select` is the one score-and-select loop: query-blocked, so
that each chunk of queries scores the full block of items, masks its seen
items and selects top-k, and peak score memory stays within
`score_mem_mb` at any V (at V ≈ 1.3M a [256, V] f32 score matrix would
be 1.3 GB). recall_target = 1 is exact; recall_target < 1 selects with
`approx_max_k`, the port's counterpart of `lax.approx_max_k`, over
top-(k+S) candidates and masks the seen ids among them, as arec does.

The loop reads a seen slab already mapped to its block's ids (−1 for
nothing). Each caller maps it once, by the rule of the arec path it
stands for: the one-device exact top-k by `seen_rule` (an id ≥ V dropped
up to BLOCKED_EVAL_MIN_V items, as arec's `_topk_full`; clamped to V − 1
above it, as arec's `blocked_topk_mips`); `blocked_topk_mips` clamps
where exact, as arec's does; the approximate selection drops an id ≥ V.

On a mesh (`make_sharded_topk`) each rank holds a contiguous block of the
item matrix (rows padded to a model-axis multiple, pad bias −1e9:
`pad_item_shards`) and its "data" slab of the queries; it runs the loop
over its block with the seen ids that fall in it (seen ids are global),
takes a local top-min(k, Vs), and the candidates are all-gathered over
"model" in shard order for an exact merge. The top-k of a union of
per-shard top-ks is the global top-k, so the merge loses nothing; ties
may be ordered differently from arec's `lax.top_k`.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from arec_torch.dist.specs import TABLE_AXIS
from arec_torch.tables.engine import rounded

TILING = 128   # XLA's tile of the reduced (minor-most) dimension
BLOCKED_EVAL_MIN_V = 131072  # above this, arec takes the blocked path


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


def clamps(v: int) -> bool:
    """Whether the one-device exact top-k at V = v clamps a seen id ≥ v to
    v − 1, as arec's `blocked_topk_mips` does (its dispatch's path above
    BLOCKED_EVAL_MIN_V), rather than dropping it, as arec's `_topk_full`
    does (the path up to it)."""
    return v > BLOCKED_EVAL_MIN_V


def _local_ids(seen, v: int, clamp: bool) -> torch.Tensor:
    """The seen slab as ids of a block of `v` items: an id below 0 becomes
    −1 (nothing); an id ≥ v becomes −1 too, or v − 1 where `clamp`.
    int32, the shape of `seen`."""
    high = v - 1 if clamp else -1
    return torch.where(seen < 0, -1, torch.where(seen >= v, high, seen)).to(
        torch.int32)


def seen_rule(seen: torch.Tensor, v: int) -> torch.Tensor:
    """The seen slab as the one-device exact top-k at V = v reads it, and as
    the fused kernels read each id: −1 or an id in [0, v), an id ≥ v
    dropped or, where `clamps(v)`, clamped to v − 1."""
    return _local_ids(seen, v, clamps(v))


def score_and_select(query, items, bias, seen, k: int,
                     compute_dtype=torch.bfloat16, recall_target: float = 1.0,
                     score_mem_mb: int = 512, qblock: int = 0,
                     offset: int = 0):
    """(scores [B, k], ids [B, k]), best first: the seen-masked top-k of
    query [B, D] over items [V, D] + bias [V], query-blocked so that a
    chunk's [qblock, V] f32 scores stay within `score_mem_mb` (floored at
    one query row). seen [B, S] holds ids of this block, in [0, V), or
    below 0 for nothing: the caller maps its slab first. The returned ids
    are the block's plus `offset`.

    recall_target = 1: −1e9 is scatter-added at each seen id (a duplicate
    is penalised twice, as in arec), then `torch.topk`.
    recall_target < 1: `approx_max_k` takes kb = min(k + S, V) candidates
    a row; a row's seen ids, sorted, can hold at most S of them, and a
    candidate found among them by a sorted search is set to −inf with id
    −1; the result is the exact top-k of the candidates (so where fewer
    than k unseen candidates remain, −inf / −1 fill the tail, as in
    arec)."""
    b = query.shape[0]
    v = items.shape[0]
    s_width = seen.shape[1]
    if not qblock:
        # budget → chunk count first, then even chunks
        qblock = max(1, min(b, (score_mem_mb << 20) // max(4 * v, 1)))
        nb = -(-b // qblock)
        qblock = -(-b // nb)
    exact = recall_target >= 1.0
    if exact:
        seen = seen.long()
    else:
        seen = torch.sort(torch.where(seen >= 0, seen, v).long(),
                          dim=1).values
        kb = min(k + s_width, v)
    qs = rounded(query, compute_dtype)
    vt = rounded(items, compute_dtype).T
    vals, ids = [], []
    for s in range(0, b, qblock):
        sn = seen[s:s + qblock]
        scores = qs[s:s + qblock] @ vt + bias[None, :]
        if exact:
            rows = torch.arange(sn.shape[0], device=sn.device)[:, None]
            penalty = torch.where(sn >= 0, -1e9, 0.0).to(scores.dtype)
            scores.index_put_((rows.expand(sn.shape), sn.clamp_min(0)),
                              penalty, accumulate=True)
            tv, ti = torch.topk(scores, k, dim=1)
        else:
            cv, ti = approx_max_k(scores, kb, recall_target)
            if s_width > 0:   # width-0 seen: nothing to mask
                pos = torch.searchsorted(sn, ti).clamp_max(s_width - 1)
                hit = sn.gather(1, pos) == ti
                cv = cv.masked_fill(hit, -math.inf)
                ti = ti.masked_fill(hit, -1)
            tv, tp = torch.topk(cv, k, dim=1)
            ti = ti.gather(1, tp)
        vals.append(tv)
        ids.append(torch.where(ti >= 0, ti + offset, -1) if offset else ti)
    return torch.cat(vals), torch.cat(ids)


def blocked_topk_mips(query, item_latents, item_bias, seen, k: int = 30,
                      qblock: int = 0, compute_dtype=torch.bfloat16,
                      recall_target: float = 1.0, score_mem_mb: int = 512):
    """arec's function of this name: `score_and_select` over the slab with
    an id ≥ V clamped to V − 1 (arec's clip) where the selection is exact,
    and dropped where it is approximate (such an id is no candidate)."""
    v = item_latents.shape[0]
    return score_and_select(
        query, item_latents, item_bias,
        _local_ids(seen, v, clamp=recall_target >= 1.0), k, compute_dtype,
        recall_target, score_mem_mb, qblock)


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
    group, t = mesh.get_group(TABLE_AXIS), mesh.size(1)
    me = mesh.get_local_rank(TABLE_AXIS)

    def topk(query, item_shard, bias_shard, seen):
        vs = item_shard.shape[0]
        offset = me * vs
        vals, ids = score_and_select(
            query, item_shard, bias_shard,
            _local_ids(seen - offset, vs, clamp=False), min(k, vs),
            compute_dtype, recall_target, score_mem_mb, qblock, offset)
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
