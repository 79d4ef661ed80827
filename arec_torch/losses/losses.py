"""The loss family (port of `arec/losses/losses.py`): the sampled softmax
CE and its oracle, the full softmax CE; the MF pairwise-ranking losses
(WARP, BPR) over sampled negatives; and the batch-ranking losses (`mw`,
`bbpr`) that reuse the in-batch positives as shared negatives, with the
optional Horvitz–Thompson correction (`_ht_weights`).

Every sampled loss takes pre-drawn `sampled=(ids, p)`, so the sparse train
step's touched rows and the loss's candidates are one draw.

On a mesh (the dense mesh step, `train.step.make_mesh_step_core`) a rank
computes on its "data" slab and every loss returns the GLOBAL loss, each
rank's backward giving its partial gradients (`dist.collectives`): the
CE through the sharded fused CE (`mesh=`), a loss that is a mean over
the slab through `mesh_mean`. `gather_cands` lifts the in-batch
candidates of `mw` / `bbpr` to the global batch (`mesh_gather_cands`, an
all_gather over "data"), as the dense step's global [B, B] score matrix
and arec's sparse-mesh step have them.

Candidate-side encoding is one `embed(ids) -> (v [n, D], bias [n])`
callable, so the per-candidate bias arrives in the same row gather as the
embedding; `embed_raw(ids)` optionally gives the raw [n, D+1] rows (bias in
lane D) for the fused kernel's aug mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from arec_torch.dist.collectives import (
    all_gather_cat, all_sum, gather_cat, sum_partials,
)
from arec_torch.dist.specs import DATA_AXIS, mesh_coords
from arec_torch.losses.sampling import draw, log_uniform_prob, pop_prob
from arec_torch.tables.engine import mm_f32

_NEG_INF = -1e9


def _rowdot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (q.float() * v.float()).sum(dim=-1)


def _mean(ce, weights):
    if weights is None:
        return ce.mean()
    return (ce * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def mesh_mean(loss, weight, mesh):
    """The global loss Σ_d w_d·loss_d / Σ_d w_d from each "data" slab's
    mean loss_d of weight w_d (its row count, or its mask's sum), which
    the model ranks of the slab compute alike. Each rank adds the share
    loss_d·w_d / (W·T) (T model ranks) into one all_reduce, so its
    backward is that share's partial: summed over the ranks, the
    gradients are the global loss's. (arec's sparse-mesh step scales by
    w_d / W, `arec/train/sparse_mesh.py:306-318`: the shards of a
    sequence batch carry different pad counts.)"""
    _, _, _, t = mesh_coords(mesh)
    weight = torch.as_tensor(weight, dtype=torch.float32,
                             device=loss.device)
    total = all_sum(weight, mesh.get_group(DATA_AXIS))
    return sum_partials(loss * (weight / (total * t)))


def mesh_gather_cands(mesh):
    """gather_cands for mw / bbpr on a mesh: the slab's positive ids,
    latents and biases all_gathered over "data" (the global in-batch
    candidates, data-major), and the slab's row offset into them. The
    gather's backward sums each slab's cross-batch cotangents back to
    the slab that encoded them. Slabs are equal-sized."""
    group = mesh.get_group(DATA_AXIS)
    d = mesh_coords(mesh)[0]

    def gather(ids, v, b):
        return (gather_cat(ids, group), all_gather_cat(v, group),
                all_gather_cat(b, group), d * ids.shape[0])
    return gather


def sampled_softmax_loss(query, true_ids, embed, gen, num_sampled: int,
                         vocab: int, dist: str = "log_uniform",
                         remove_accidental_hits: bool = True, weights=None,
                         compute_dtype=torch.bfloat16, sampled=None,
                         use_kernel: bool | None = None, mesh=None, pop=None,
                         embed_raw=None):
    """TF1 `tf.nn.sampled_softmax_loss` semantics: S shared negatives per
    step drawn from `gen` (or pre-drawn `sampled=(ids, p)`), −log(S·P)
    logit correction, accidental-hit masking, CE with the true class as
    class 0, (weighted) mean over rows.

    use_kernel: True takes the fused CE (`fused_sampled_ce_sums`: the CUDA
    kernels for CUDA tensors, their plain versions for CPU tensors), False
    the pure path that materialises the [N, S] logits. None means True
    whenever remove_accidental_hits (the kernel has no unmasked mode); arec's
    TPU row-count crossover is not inherited.

    mesh: query is this rank's slab; the loss returned is the global one
    (the fused CE through `fused_sampled_ce_sums_sharded`, the pure path
    through `mesh_mean`)."""
    sampled_ids, p = sampled if sampled is not None else draw(
        gen, num_sampled, vocab, dist, pop)
    v_samp, b_samp = embed(sampled_ids)                    # [S, D], [S]
    if use_kernel is None:
        use_kernel = remove_accidental_hits
    if use_kernel and remove_accidental_hits:
        from arec_torch.kernels.sampled_softmax import fused_sampled_ce_sums
        c_samp = b_samp - torch.log(num_sampled * p)
        corr = torch.log(num_sampled * _p_of(true_ids, vocab, dist, pop))
        if embed_raw is not None:
            v_true = embed_raw(true_ids)                   # [N, D+1], aug
            tl_base = -corr
        else:
            v_true, b_true = embed(true_ids)               # [N, D], [N]
            tl_base = b_true - corr
        if mesh is not None:
            from arec_torch.kernels.sampled_softmax import (
                fused_sampled_ce_sums_sharded,
            )
            num, den = fused_sampled_ce_sums_sharded(
                mesh, query, v_true, v_samp.float(), c_samp, tl_base,
                true_ids, sampled_ids, weights, compute_dtype)
            return num / torch.clamp(den, min=1.0)
        num, den = fused_sampled_ce_sums(
            query, v_true, v_samp.float(), c_samp, tl_base, true_ids,
            sampled_ids, weights, compute_dtype)
        if weights is None:
            return num / query.shape[0]
        return num / torch.clamp(den, min=1.0)
    v_true, b_true = embed(true_ids)                       # [N, D], [N]
    true_logit = _rowdot(query, v_true) + b_true
    true_logit = true_logit - torch.log(
        num_sampled * _p_of(true_ids, vocab, dist, pop))
    samp_logits = mm_f32(query, v_samp.T, compute_dtype) + b_samp[None, :]
    samp_logits = samp_logits - torch.log(num_sampled * p)[None, :]
    if remove_accidental_hits:
        hit = sampled_ids[None, :] == true_ids[:, None]
        samp_logits = torch.where(hit, _NEG_INF, samp_logits)
    logits = torch.cat([true_logit[:, None], samp_logits], dim=1)
    ce = torch.logsumexp(logits, dim=1) - logits[:, 0]
    if mesh is not None:
        w = (query.shape[0] if weights is None
             else torch.clamp(weights.float().sum(), min=1.0))
        return mesh_mean(_mean(ce, weights), w, mesh)
    return _mean(ce, weights)


def _p_of(ids, vocab: int, dist: str, pop=None):
    """Proposal probability of arbitrary ids under the chosen sampler."""
    if dist == "log_uniform":
        return log_uniform_prob(ids, vocab)
    if dist == "pop":
        return pop_prob(ids, pop)
    return torch.full(ids.shape, 1.0 / vocab, device=ids.device)


def full_softmax_loss(query, true_ids, all_items, all_bias, weights=None,
                      compute_dtype=torch.bfloat16):
    """Exact CE over the full vocabulary (eval / parity oracle for the
    sampled loss)."""
    logits = mm_f32(query, all_items.T, compute_dtype) + all_bias[None, :]
    ce = torch.logsumexp(logits, dim=1) - logits.gather(
        1, true_ids.long()[:, None])[:, 0]
    return _mean(ce, weights)


# --------------------------------------------------------------------------
# Pairwise-ranking family (sampled negatives)
# --------------------------------------------------------------------------

def warp_loss(query, true_ids, embed, gen, num_sampled: int, vocab: int,
              dist: str = "uniform", margin: float = 1.0,
              compute_dtype=torch.bfloat16, pop=None, sampled=None):
    """WARP with parallel sampled rank estimation: margin violations among
    S draws estimate the positive's rank, loss = Φ(rank)·mean hinge with
    Φ(r) = log(1 + r). Under the uniform proposal the rank is the classic
    (V−1)·m/S; under any other, each draw j is weighted by the vocabulary
    mass it stands for, 1/(S·P(j)) (arec's full Horvitz–Thompson form)."""
    sampled_ids, p = sampled if sampled is not None else draw(
        gen, num_sampled, vocab, dist, pop)
    v_true, b_true = embed(true_ids)
    v_samp, b_samp = embed(sampled_ids)
    pos = _rowdot(query, v_true) + b_true                          # [N]
    neg = mm_f32(query, v_samp.T, compute_dtype) + b_samp[None, :]
    hit = sampled_ids[None, :] == true_ids[:, None]
    hinge = torch.clamp(margin + neg - pos[:, None], min=0.0)
    hinge = torch.where(hit, 0.0, hinge)
    violations = (hinge > 0).float()
    m = violations.sum(dim=1)                                      # [N]
    if dist == "uniform":
        rank = (vocab - 1) * m / num_sampled
        mean_hinge = hinge.sum(dim=1) / torch.clamp(m, min=1.0)
    else:
        inv = (1.0 / (num_sampled * p))[None, :]                   # [1, S]
        wm = (violations * inv).sum(dim=1)                         # ~rank
        rank = torch.clamp(wm, max=vocab - 1.0)
        mean_hinge = (hinge * inv).sum(dim=1) / torch.clamp(wm, min=1e-6)
    return (torch.log1p(rank) * mean_hinge).mean()


def bpr_loss(query, true_ids, embed, gen, num_sampled: int, vocab: int,
             dist: str = "uniform", compute_dtype=torch.bfloat16, pop=None,
             sampled=None):
    """BPR (Rendle 2009): −log σ(pos − neg) over the sampled negatives
    that are not the row's positive."""
    sampled_ids, _ = sampled if sampled is not None else draw(
        gen, num_sampled, vocab, dist, pop)
    v_true, b_true = embed(true_ids)
    v_samp, b_samp = embed(sampled_ids)
    pos = _rowdot(query, v_true) + b_true
    neg = mm_f32(query, v_samp.T, compute_dtype) + b_samp[None, :]
    hit = sampled_ids[None, :] == true_ids[:, None]
    ll = torch.where(hit, 0.0, F.logsigmoid(pos[:, None] - neg))
    denom = torch.clamp((~hit).sum(dim=1).float(), min=1.0)
    return -(ll.sum(dim=1) / denom).mean()


# --------------------------------------------------------------------------
# Batch-ranking family (AAAI'18: in-batch positives as shared negatives).
# pop_probs (optional [V], the empirical item distribution) turns on the
# Horvitz–Thompson correction for that popularity-skewed proposal: draw j
# of row i is weighted by (1 − q_t)/(n_eff·q_j) (_ht_weights); None keeps
# the paper's estimator.
# --------------------------------------------------------------------------

def _ht_weights(cand_ids, same, true_ids, pop_probs):
    """[b, B] HT weights: the vocabulary mass each usable draw stands for,
    conditioned on cand != true (the `same` mask)."""
    q = torch.clamp(pop_probs[cand_ids.long()], min=1e-12)          # [B]
    q_t = pop_probs[true_ids.long()][:, None]                       # [b, 1]
    n_eff = torch.clamp((~same).sum(dim=1, keepdim=True), min=1)    # [b, 1]
    return torch.where(same, 0.0, (1.0 - q_t) / (n_eff * q[None, :]))


def _batch_scores(query, true_ids, embed, compute_dtype, gather_cands):
    """(scores [b, B], own-positive scores [b], duplicate-positive mask
    [b, B], candidate ids [B]). gather_cands(ids, v, b) → (cand ids, v,
    b, diag offset) lifts the b local positives to the B candidates
    (`mesh_gather_cands`); row i's own positive is column offset + i."""
    v, b_bias = embed(true_ids)                                    # [b, D]
    cand_ids, off = true_ids, 0
    if gather_cands is not None:
        cand_ids, v, b_bias, off = gather_cands(true_ids, v, b_bias)
    scores = mm_f32(query, v.T, compute_dtype) + b_bias[None, :]
    n = query.shape[0]
    pos = scores[torch.arange(n, device=scores.device),
                 off + torch.arange(n, device=scores.device)]
    same = cand_ids[None, :] == true_ids[:, None]                  # dup-pos
    return scores, pos, same, cand_ids


def batch_mw_loss(query, true_ids, embed, vocab: int, margin: float = 1.0,
                  compute_dtype=torch.bfloat16, gather_cands=None,
                  pop_probs=None):
    """`mw`: margin + rank-weighted hinge over the in-batch score matrix;
    positives on the diagonal, every other column a negative."""
    scores, pos, same, cand_ids = _batch_scores(
        query, true_ids, embed, compute_dtype, gather_cands)
    hinge = torch.clamp(margin + scores - pos[:, None], min=0.0)
    hinge = torch.where(same, 0.0, hinge)
    if pop_probs is None:
        m = (hinge > 0).sum(dim=1).float()
        rank = (vocab - 1) * m / max(cand_ids.shape[0] - 1, 1)
        mean_hinge = hinge.sum(dim=1) / torch.clamp(m, min=1.0)
    else:
        w = _ht_weights(cand_ids, same, true_ids, pop_probs)
        wm = (w * (hinge > 0)).sum(dim=1)                          # ~rank
        rank = torch.clamp(wm, max=vocab - 1.0)
        mean_hinge = (w * hinge).sum(dim=1) / torch.clamp(wm, min=1e-6)
    return (torch.log1p(rank) * mean_hinge).mean()


def batch_bpr_loss(query, true_ids, embed, compute_dtype=torch.bfloat16,
                   gather_cands=None, pop_probs=None):
    """`bbpr`: BPR over the in-batch score matrix (self-normalised HT
    weights with pop_probs). On one card in bf16 (CUDA tensors, no
    gather_cands) the fused kernels of `kernels.batch_rank`, which never
    write the [b, B] scores; elsewhere the library ops below."""
    if (gather_cands is None and query.is_cuda
            and compute_dtype == torch.bfloat16):
        from arec_torch.kernels.batch_rank import batch_bpr_rows
        v, b_bias = embed(true_ids)
        return batch_bpr_rows(query, v, b_bias, true_ids, pop_probs).mean()
    scores, pos, same, cand_ids = _batch_scores(
        query, true_ids, embed, compute_dtype, gather_cands)
    ll = torch.where(same, 0.0, F.logsigmoid(pos[:, None] - scores))
    if pop_probs is None:
        denom = torch.clamp((~same).sum(dim=1).float(), min=1.0)
        return -(ll.sum(dim=1) / denom).mean()
    w = _ht_weights(cand_ids, same, true_ids, pop_probs)
    return -((w * ll).sum(dim=1)
             / torch.clamp(w.sum(dim=1), min=1e-12)).mean()
