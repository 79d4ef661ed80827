"""K optimizer steps per dispatch: the port of arec's `scan_multi`
(`arec/train/step.py:106`), one CUDA graph for K steps.

arec runs K steps as one `lax.scan`: one XLA program and one host dispatch
for K steps, step for step equal to K single steps (same key per global
step, same update order). The port's counterpart of one program is one
CUDA graph (`torch.cuda.CUDAGraph`) holding the K steps' kernels, so the
host issues one replay instead of the ~200–400 launches a step.

`scan_multi(core, k)` wraps any step core (state, batch, gen) -> (state,
metrics) into multi(state, batches, gens): `batches` is K batch dicts (or
one dict of [K, ...] tensors), `gens` the K steps' keys (`step_generator`
of each global step), and the metrics come back as [K] tensors. It is a
class under arec's function name (lower-case, as `torch.no_grad` is).

On the CPU the K steps are K calls of the core: the plain version. On
CUDA:

  * the first dispatch runs its K steps eagerly on a side stream (torch's
    advice before a capture), which also builds the kernels and loads
    their libraries, while `rng.KeyTrace` records how each CUDA generator
    the steps make derives from the step's key; then it captures K steps
    into one graph in a memory pool of its own. The capture runs nothing.
  * every later dispatch copies its K batches into the graph's static
    inputs on the current stream (ordered after the previous replay, so a
    queued replay never sees the next dispatch's inputs), re-seeds the
    graph's generators from the new keys (`rng.derive`), replays, and
    hands out clones of the [K] metric outputs. All that precedes the
    replay is the span `dispatch.prepare`, the replay `dispatch.replay`
    (`arec_torch.obs`: recorded while a torch profiler records).

The state lives at fixed addresses: every step core updates its params,
optimizer state, `step` and `lr_scale` in place, and the capture raises if
the core returned another tensor for any leaf. A later dispatch whose
state leaves (a restore, a `decay_lr` that made a new tensor) or batch
shapes differ from the captured ones raises and names the leaf or batch
key: a replay never runs on stale addresses. A capture that fails raises:
there is no fallback to eager steps.

The kernels' launch counters (`launches` of each wrapper) count in Python
as the core runs: at the eager warm-up, and at the capture, which records
each launch into the graph. A replay runs no Python and counts nothing;
what it launches on the card is read from a profiler trace of it.

The capture's mode is "thread_local": the prefetch worker stages batches
on its own copy stream while the main thread captures.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch

from arec_torch import obs
from arec_torch.rng import KeyTrace, derive, key_trace


def _slots(batches, k: int) -> list[dict]:
    """The K batch dicts of `batches` (a list of them, or one dict of
    [K, ...] tensors)."""
    if isinstance(batches, dict):
        if {v.shape[0] for v in batches.values()} != {k}:
            raise ValueError(f"stacked batches must have a leading axis of "
                             f"{k}")
        return [{key: v[i] for key, v in batches.items()} for i in range(k)]
    if len(batches) != k:
        raise ValueError(f"a dispatch takes {k} batches, got {len(batches)}")
    return list(batches)


def _stack(metrics: list[dict]) -> dict:
    return {key: torch.stack([m[key] for m in metrics]) for key in metrics[0]}


def _named(tree, path: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) of a dict/list/tuple tree, in `train.step._leaves`
    order."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree)
                for x in _named(tree[key], f"{path}/{key}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _named(v, f"{path}/{i}")]
    return [(path, tree)]


def _state_leaves(state) -> list[torch.Tensor]:
    return [t for _, t in _named(state._asdict())]


def _signature(state, slots) -> list[tuple]:
    """What a replay relies on, each entry named: every state leaf's
    address, shape, strides and dtype, and each batch tensor's shape and
    dtype."""
    return ([(f"state leaf {name}", t.data_ptr(), tuple(t.shape), t.stride(),
              t.dtype) for name, t in _named(state._asdict())]
            + [(f"batch {i} {key!r}", tuple(v.shape), v.dtype)
               for i, b in enumerate(slots) for key, v in sorted(b.items())])


class scan_multi:
    """multi(state, batches, gens) -> (state, {metric: [K]}); see the module
    docstring. `captures` and `replays` count what the runner did.

    The card's side is in the hooks `_on_card`, `_warm_up_stream`,
    `_new_graph`, `_captured` and `_launch` (a CPU test of the host side
    stands an emulation in for them); everything else is host code."""

    trace_device = "cuda"    # the generators a KeyTrace accounts for

    def __init__(self, core: Callable, k: int):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.core, self.k = core, k
        self.captures = self.replays = 0
        self._graph = None

    def __call__(self, state, batches, gens):
        if self._graph is not None:
            return state, self._replay(state, batches, gens)
        slots = self._args(batches, gens)
        leaf = _state_leaves(state)[0]
        if not self._on_card(leaf):
            return self._steps(state, slots, gens)
        roots = [g.initial_seed() for g in gens]
        trace = KeyTrace(roots, "record", device_type=self.trace_device)
        with self._warm_up_stream(leaf.device):
            state, metrics = self._steps(state, slots, gens, trace)
        self._paths = trace.paths
        self._capture(state, slots, gens, roots)
        return state, metrics

    def _args(self, batches, gens) -> list[dict]:
        """The K batch dicts, once `batches` and `gens` hold K each."""
        slots = _slots(batches, self.k)
        if len(gens) != self.k:
            raise ValueError(f"a dispatch takes {self.k} keys, "
                             f"got {len(gens)}")
        return slots

    def _steps(self, state, slots, gens, trace=None):
        """K calls of the core, under `trace` when one is given."""
        metrics = []
        with (key_trace(trace) if trace is not None
              else contextlib.nullcontext()):
            for batch, gen in zip(slots, gens):
                state, m = self.core(state, batch, gen)
                metrics.append(m)
            return state, _stack(metrics)

    # ---- the card's side ---------------------------------------------
    def _on_card(self, leaf: torch.Tensor) -> bool:
        return leaf.device.type == "cuda"

    @contextlib.contextmanager
    def _warm_up_stream(self, dev):
        """Run the block on a side stream ordered after the current one,
        and order the current one after it."""
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            yield
        main.wait_stream(side)

    def _new_graph(self, pool: list):
        graph = torch.cuda.CUDAGraph()
        for gen in pool:
            graph.register_generator_state(gen)
        return graph

    def _captured(self, graph, state):
        """The capture of the block into `graph`, in a memory pool of its
        own."""
        return torch.cuda.graph(graph, capture_error_mode="thread_local")

    def _launch(self, graph, roots) -> None:
        graph.replay()

    # ---- host side -------------------------------------------------------
    def _check(self, state, slots) -> None:
        """Raise, naming the first difference, unless the state and batches
        match what the graph captured."""
        sig = _signature(state, slots)
        for want, got in zip(self._sig, sig):
            if want != got:
                raise ValueError(
                    f"{got[0]} is not what the CUDA graph captured "
                    f"(captured {want[1:]}, got {got[1:]}): the state must "
                    f"be updated in place and the batch shapes kept")
        if len(sig) != len(self._sig):
            raise ValueError(f"the state or batches hold {len(sig)} tensors, "
                             f"the CUDA graph captured {len(self._sig)}")

    def _capture(self, state, slots, gens, roots) -> None:
        """Capture K steps of `state` into a new graph (nothing runs);
        `capture_s` is its host wall."""
        t0 = time.perf_counter()
        dev = _state_leaves(state)[0].device
        self._inputs = {key: torch.empty((self.k,) + tuple(v.shape),
                                         dtype=v.dtype, device=dev)
                        for key, v in slots[0].items()}
        self._stage(slots)
        self._views = [{key: buf[i] for key, buf in self._inputs.items()}
                       for i in range(self.k)]
        pool = [torch.Generator(device=dev).manual_seed(s)
                for s in derive(roots, self._paths)]
        graph = self._new_graph(pool)
        leaves = _state_leaves(state)
        trace = KeyTrace(roots, "capture", self._paths, pool,
                         self.trace_device)
        with self._captured(graph, state):
            out, stacked = self._steps(state, self._views, gens, trace)
        if trace.taken != len(pool):
            raise RuntimeError("the captured steps made fewer CUDA "
                               "generators than their eager warm-up")
        got = _state_leaves(out)
        if len(got) != len(leaves) or any(
                a.data_ptr() != b.data_ptr() for a, b in zip(got, leaves)):
            raise RuntimeError(
                "the step core returned a state leaf at a new address: a "
                "CUDA graph needs every leaf updated in place")
        self._graph, self._out, self._pool = graph, stacked, pool
        self._sig = _signature(state, slots)
        self.captures += 1
        self.capture_s = time.perf_counter() - t0

    def _stage(self, slots) -> None:
        """The dispatch's batches into the static inputs, on the current
        stream."""
        for key, buf in self._inputs.items():
            torch.stack([b[key] for b in slots], out=buf)

    def _replay(self, state, batches, gens) -> dict:
        """A later dispatch: check, stage and re-seed (the span
        `dispatch.prepare`), then replay (`dispatch.replay`)."""
        with obs.span("dispatch.prepare"):
            slots = self._args(batches, gens)
            self._check(state, slots)
            self._stage(slots)
            roots = [g.initial_seed() for g in gens]
            for gen, seed in zip(self._pool, derive(roots, self._paths)):
                gen.manual_seed(seed)
        with obs.span("dispatch.replay"):
            self._launch(self._graph, roots)
        self.replays += 1
        return {key: v.clone() for key, v in self._out.items()}
