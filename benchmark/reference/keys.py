"""The random keys of a training run, worked out from its seed: a step's
key is a pure function of (seed + 777, step), split into a dropout and a
negatives stream, and the negatives are S log-uniform draws from the
negatives stream (inverse CDF: k = floor(exp(u·log(V+1))) - 1). The
reference draws them itself from the seed, with the same generator on the
same device, so both sides score the same negatives.

Plain PyTorch and NumPy; imports nothing of the program."""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.model import log_uniform_prob


def mix(seed: int, data: int) -> int:
    """A 63-bit seed that is a pure function of (seed, data)."""
    state = np.random.SeedSequence([seed % (1 << 64), data % (1 << 64)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def negatives(seed: int, step: int, num: int, vocab: int, device):
    """(ids int32 [num], P(ids) float32 [num]) of global step `step`."""
    key = mix(seed + 777, step)
    gen = torch.Generator(device=device).manual_seed(mix(key, 1))
    u = torch.rand(num, generator=gen, device=device)
    k = torch.floor(torch.exp(u * math.log(vocab + 1.0))) - 1.0
    ids = k.to(torch.int32).clamp(0, vocab - 1)
    return ids, log_uniform_prob(ids, vocab)
