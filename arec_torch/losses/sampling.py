"""Candidate sampling for sampled-softmax training (port of
`arec/losses/sampling.py`).

Log-uniform (Zipf) distribution over ids k ∈ [0, V):
    P(k) = log((k+2)/(k+1)) / log(V+1)
    CDF(k) = log(k+2) / log(V+1)
Inverse-CDF sampling: k = floor(exp(u · log(V+1))) − 1, u ~ U[0,1).

Item ids are frequency ranks, so this samples negatives in proportion to a
Zipf fit of popularity. Sampling is WITH replacement (independent draws):
the expected count of candidate k in S draws is S·P(k), and the
sampled-softmax correction is −log(S·P(k)).

Where arec takes a key, the draws here take a `torch.Generator` and land
on its device; the formulas are arec's, the random numbers are torch's.
"""

from __future__ import annotations

import math

import torch


def log_uniform_prob(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    k = ids.to(torch.float32)
    return torch.log((k + 2.0) / (k + 1.0)) / math.log(vocab + 1.0)


def log_uniform_sample(gen: torch.Generator, num_sampled: int, vocab: int):
    """Returns (ids int32 [S], P(ids) float32 [S])."""
    u = torch.rand(num_sampled, generator=gen, device=gen.device)
    k = torch.floor(torch.exp(u * math.log(vocab + 1.0))) - 1.0
    ids = k.to(torch.int32).clamp(0, vocab - 1)
    return ids, log_uniform_prob(ids, vocab)


def uniform_sample(gen: torch.Generator, num_sampled: int, vocab: int):
    ids = torch.randint(0, vocab, (num_sampled,), generator=gen,
                        device=gen.device, dtype=torch.int32)
    return ids, torch.full((num_sampled,), 1.0 / vocab, device=gen.device)


def make_pop(item_freq, power: float = 1.0, device="cpu"):
    """Empirical popularity^α proposal → (cdf [V], probs [V]) on `device`.
    Zero-count ids are clamped to count 1 so a true id outside the train
    split keeps a finite −log(S·P) correction."""
    f = torch.as_tensor(item_freq, dtype=torch.float32,
                        device=device).clamp_min(1.0) ** power
    probs = f / f.sum()
    return torch.cumsum(probs, 0), probs


def pop_sample(gen: torch.Generator, num_sampled: int, pop):
    """Inverse-CDF draw from the empirical popularity^α distribution."""
    cdf, probs = pop
    u = torch.rand(num_sampled, generator=gen, device=gen.device)
    ids = torch.searchsorted(cdf, u.to(cdf.device), right=True)
    ids = ids.clamp(0, probs.shape[0] - 1).to(torch.int32)
    return ids, probs[ids]


def pop_prob(ids, pop):
    return pop[1][ids]


def draw(gen: torch.Generator, num_sampled: int, vocab: int, dist: str,
         pop=None):
    if dist == "log_uniform":
        return log_uniform_sample(gen, num_sampled, vocab)
    if dist == "uniform":
        return uniform_sample(gen, num_sampled, vocab)
    if dist == "pop":
        if pop is None:
            raise ValueError(
                "sampler='pop' needs (cdf, probs) from make_pop(item_freq)")
        return pop_sample(gen, num_sampled, pop)
    raise ValueError(f"unknown sampler {dist!r}")
