"""Random streams as keys: the port's counterpart of `jax.random` keys.

arec threads immutable keys (`split`, `fold_in`) so that a draw is a pure
function of (seed, position). A `torch.Generator` is stateful, so the port
treats a generator's *seed* as the key: `fold_in` and `split` derive new
generators from `gen.initial_seed()` alone, never drawing from `gen`, and a
value is drawn only from a generator made for that one use. Recomputation
(`torch.utils.checkpoint`) that rebuilds its generators from the same seeds
then redraws the same values. The numbers differ from JAX's threefry
streams; parity tests hand numpy-made inputs to both sides instead.

Keys inside a CUDA graph (`arec_torch.train.graph`). A captured graph
replays kernels, not the Python that seeded their generators, so while a
`KeyTrace` is active every CUDA generator a step makes is accounted for by
its derivation from the step's root key: the path (slot, data, data, ...)
of `fold_in`s from root key `slot` of the dispatch. In "record" mode (the
eager warm-up) `generator` makes fresh generators as usual and logs each
one's path; in "capture" mode it hands out, in the same order, generators
made before the capture and registered with the graph, each already
seeded with the value its path gives. Before a replay the runner re-seeds
each of them from the new root keys (`derive`), and `manual_seed` resets
the Philox offset, so the replay draws what fresh generators would. A CUDA
generator whose seed does not derive from a root key would be baked into
the graph with one seed for every replay; it raises instead.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

_TRACE = None   # the active KeyTrace, or None


def mix(seed: int, data: int) -> int:
    """A 63-bit seed that is a pure function of (seed, data)."""
    state = np.random.SeedSequence([seed % (1 << 64), data % (1 << 64)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device="cpu") -> torch.Generator:
    trace = _TRACE
    if trace is not None and torch.device(device).type == trace.device_type:
        return trace.take(seed, device)
    return torch.Generator(device=device).manual_seed(seed)


def fold_in(gen: torch.Generator, data: int, device=None) -> torch.Generator:
    """jax.random.fold_in: a new generator on `device` (default gen's)
    seeded by a pure function of (gen's seed, data)."""
    parent = gen.initial_seed()
    seed = mix(parent, data)
    if _TRACE is not None:
        _TRACE.derived(parent, data, seed)
    return generator(seed, gen.device if device is None else device)


def split(gen: torch.Generator, device=None):
    """jax.random.split into two: fold_in(gen, 0), fold_in(gen, 1)."""
    return fold_in(gen, 0, device), fold_in(gen, 1, device)


def derive(roots: list[int], paths: list[tuple], memo=None) -> list[int]:
    """The seed each path gives from `roots` (one per slot): root
    paths[i][0] folded with paths[i][1:] in turn."""
    memo = {} if memo is None else memo

    def seed(path):
        if path not in memo:
            memo[path] = (roots[path[0]] if len(path) == 1
                          else mix(seed(path[:-1]), path[-1]))
        return memo[path]
    return [seed(p) for p in paths]


class KeyTrace:
    """The derivations of one dispatch's CUDA generators from its root
    keys (see the module docstring). mode "record" logs `paths`; mode
    "capture" hands out `pool` in order, checking each path against the
    recorded one. device_type: the generators it accounts for ("cuda";
    a CPU test of the runner's host side takes "cpu")."""

    def __init__(self, roots: list[int], mode: str, paths=None, pool=None,
                 device_type: str = "cuda"):
        if len(set(roots)) != len(roots):
            raise ValueError("a dispatch's root keys must differ")
        self.known = {r: (i,) for i, r in enumerate(roots)}
        self.mode = mode
        self.device_type = device_type
        self.paths = [] if paths is None else paths
        self.pool = pool
        self.taken = 0

    def derived(self, parent: int, data: int, seed: int) -> None:
        path = self.known.get(parent)
        if path is not None:
            self.known.setdefault(seed, path + (data,))

    def take(self, seed: int, device) -> torch.Generator:
        path = self.known.get(seed)
        if path is None:
            raise RuntimeError(
                "a CUDA generator whose seed does not derive from the step's "
                "key would replay one seed in every graph replay")
        if self.mode == "record":
            self.paths.append(path)
            return torch.Generator(device=device).manual_seed(seed)
        if self.taken >= len(self.pool) or self.paths[self.taken] != path:
            raise RuntimeError(
                "the captured steps made other CUDA generators than their "
                "eager warm-up")
        gen = self.pool[self.taken]
        self.taken += 1
        if gen.initial_seed() != seed:
            raise RuntimeError(f"a graph generator holds seed "
                               f"{gen.initial_seed()}, its path gives {seed}")
        return gen


@contextlib.contextmanager
def key_trace(trace: KeyTrace):
    """Make `trace` the active one for the block (one at a time: the
    autograd engine's thread, which runs a recompute's generators, sees
    it too)."""
    global _TRACE
    if _TRACE is not None:
        raise RuntimeError("a KeyTrace is already active")
    _TRACE = trace
    try:
        yield trace
    finally:
        _TRACE = None
