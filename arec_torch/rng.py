"""Random streams as keys: the port's counterpart of `jax.random` keys.

arec threads immutable keys (`split`, `fold_in`) so that a draw is a pure
function of (seed, position). A `torch.Generator` is stateful, so the port
treats a generator's *seed* as the key: `fold_in` and `split` derive new
generators from `gen.initial_seed()` alone, never drawing from `gen`, and a
value is drawn only from a generator made for that one use. Recomputation
(`torch.utils.checkpoint`) that rebuilds its generators from the same seeds
then redraws the same values. The numbers differ from JAX's threefry
streams; parity tests hand numpy-made inputs to both sides instead.
"""

from __future__ import annotations

import numpy as np
import torch


def mix(seed: int, data: int) -> int:
    """A 63-bit seed that is a pure function of (seed, data)."""
    state = np.random.SeedSequence([seed % (1 << 64), data % (1 << 64)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def fold_in(gen: torch.Generator, data: int, device=None) -> torch.Generator:
    """jax.random.fold_in: a new generator on `device` (default gen's)
    seeded by a pure function of (gen's seed, data)."""
    return generator(mix(gen.initial_seed(), data),
                     gen.device if device is None else device)


def split(gen: torch.Generator, device=None):
    """jax.random.split into two: fold_in(gen, 0), fold_in(gen, 1)."""
    return fold_in(gen, 0, device), fold_in(gen, 1, device)
