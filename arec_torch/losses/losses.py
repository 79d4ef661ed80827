"""Softmax-family losses of the sequence path (port of the seq half of
`arec/losses/losses.py`): the sampled softmax CE and its oracle, the full
softmax CE. The MF pairwise and batch losses come with the MF slice.

Candidate-side encoding is one `embed(ids) -> (v [n, D], bias [n])`
callable, so the per-candidate bias arrives in the same row gather as the
embedding; `embed_raw(ids)` optionally gives the raw [n, D+1] rows (bias in
lane D) for the fused kernel's aug mode.
"""

from __future__ import annotations

import torch

from arec_torch.losses.sampling import draw, log_uniform_prob, pop_prob
from arec_torch.tables.engine import mm_f32

_NEG_INF = -1e9


def _rowdot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (q.float() * v.float()).sum(dim=-1)


def _mean(ce, weights):
    if weights is None:
        return ce.mean()
    return (ce * weights).sum() / torch.clamp(weights.sum(), min=1.0)


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
    TPU row-count crossover is not inherited."""
    if mesh is not None:
        raise NotImplementedError(
            "sampled_softmax_loss over a device mesh waits for the "
            "multi-GPU port (ROADMAP A7)")
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
