"""Train step and optimizers (port of `arec/train/step.py`).

One step is: value and gradient of the loss over every parameter leaf, the
optimizer update, and the metrics (loss, lr, grad_norm). Gradients of the
embedding tables are dense, as in arec's dense path, so Adagrad touches
every row each step (a zero-gradient row is left as it is).

The optimizers are written out with optax 0.2.6 semantics, as arec builds
them with `optax.inject_hyperparams` (the learning rate is a hyperparameter
in the optimizer state, set each step to base_lr · lr_scale):

  adagrad  acc ← acc + g² (acc starts at 0.1);
           update = −lr · g · where(acc > 0, rsqrt(acc + 1e-7), 0)
           (`torch.optim.Adagrad` starts at 0 and divides by √acc + 1e-10:
           it differs from the first step, so it is not used)
  sgd      update = −lr · g
  adam     m ← 0.9m + 0.1g; v ← 0.999v + 0.001g²; t ← t + 1;
           update = −lr · (m / (1 − 0.9ᵗ)) / (√(v / (1 − 0.999ᵗ)) + 1e-8)

Where arec donates the state to its jitted step, the port updates every
leaf of the state in place (the parameters, the optimizer state with its
learning rate, `step` and, in `decay_lr`, `lr_scale`): the state passed to
a step is consumed by it, and its tensors keep their addresses, which a
CUDA graph of K steps relies on. arec's `steps_per_dispatch` (K steps in
one `lax.scan`, step for step identical to K single steps) is
`make_multi_step`: one CUDA graph replay for K steps on the card
(`arec_torch.train.graph`), K single steps on the CPU.

A step's `gen` is its key (see arec_torch.rng): callers make it a pure
function of (seed + 777, global step) with `step_generator`, as arec's
Trainer folds the step into its key, so a resumed run draws the same
negatives. On CUDA the step refuses to run with TF32 matmuls on, as
`Recommender` does.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from arec_torch.rng import generator, mix


class TrainState(NamedTuple):
    params: Any
    opt_state: dict
    lr_scale: torch.Tensor   # 0-d f32, multiplied into the base lr
    step: torch.Tensor       # 0-d int32


def _leaves(tree) -> list[torch.Tensor]:
    """Tensor leaves of a dict/list/tuple tree, in a fixed order (dict keys
    sorted, as jax's tree flattening orders them)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """`tree` with its leaves replaced, in `_leaves` order, from the
    iterator `leaves`."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def tree_map(fn, tree):
    return _rebuild(tree, iter([fn(x) for x in _leaves(tree)]))


class Optimizer(NamedTuple):
    """init(params) → opt_state; update(grads, opt_state, params, lr)
    applies one step to the param leaves and the state, in place."""
    init: Callable
    update: Callable


def make_optimizer(name: str, learning_rate: float) -> Optimizer:
    if name not in ("adagrad", "sgd", "adam"):
        raise ValueError(f"unknown optimizer {name!r}")

    def init(params) -> dict:
        first = _leaves(params)[0]
        state = {"count": torch.zeros((), dtype=torch.int32,
                                      device=first.device),
                 "learning_rate": torch.tensor(learning_rate,
                                               dtype=torch.float32,
                                               device=first.device)}
        if name == "adagrad":
            state["sum_of_squares"] = tree_map(
                lambda p: torch.full_like(p, 0.1), params)
        elif name == "adam":
            state["mu"] = tree_map(torch.zeros_like, params)
            state["nu"] = tree_map(torch.zeros_like, params)
            state["adam_count"] = torch.zeros((), dtype=torch.int32,
                                              device=first.device)
        return state

    @torch.no_grad()
    def update(grads: list, state: dict, params: list, lr: torch.Tensor):
        state["learning_rate"].copy_(lr)
        state["count"] += 1
        if name == "adam":
            state["adam_count"] += 1
            t = state["adam_count"].to(torch.float32)
            c1, c2 = 1.0 - 0.9 ** t, 1.0 - 0.999 ** t
            for p, g, m, v in zip(params, grads, _leaves(state["mu"]),
                                  _leaves(state["nu"])):
                m.mul_(0.9).add_(0.1 * g)
                v.mul_(0.999).add_(0.001 * g * g)
                p.add_(-lr * ((m / c1) / (torch.sqrt(v / c2) + 1e-8)))
        elif name == "adagrad":
            for p, g, acc in zip(params, grads,
                                 _leaves(state["sum_of_squares"])):
                acc.add_(g * g)
                inv = torch.where(acc > 0, torch.rsqrt(acc + 1e-7), 0.0)
                p.add_(-lr * (inv * g))
        else:
            for p, g in zip(params, grads):
                p.add_(-lr * g)

    return Optimizer(init, update)


def init_state(params, opt: Optimizer) -> TrainState:
    dev = _leaves(params)[0].device
    return TrainState(
        params=params,
        opt_state=opt.init(params),
        lr_scale=torch.ones((), dtype=torch.float32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def check_tf32(leaf: torch.Tensor) -> None:
    """Raise when `leaf` is on the card and TF32 matmuls are on."""
    if leaf.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "TF32 matmuls change the loss and its gradients; set "
            "torch.backends.cuda.matmul.allow_tf32 = False")


def _loss_and_grads(loss_fn: Callable, state: TrainState, batch, gen):
    """(loss, the param leaves, their gradients): the value and gradient
    of loss_fn over every floating-point leaf (zeros for the others)."""
    leaves = _leaves(state.params)
    check_tf32(leaves[0])
    live = [p.detach().requires_grad_(p.is_floating_point())
            for p in leaves]
    loss = loss_fn(_rebuild(state.params, iter(live)), batch, gen)
    wrt = [p for p in live if p.requires_grad]
    grads = iter(torch.autograd.grad(loss, wrt, allow_unused=True,
                                     materialize_grads=True))
    return loss, leaves, [next(grads) if p.requires_grad
                          else torch.zeros_like(p) for p in live]


@torch.no_grad()
def _next(state: TrainState) -> TrainState:
    """The state after a step: its `step` counted up in place."""
    state.step.add_(1)
    return state


def make_step_core(loss_fn: Callable, opt: Optimizer,
                   base_lr: float) -> Callable:
    """loss_fn(params, batch, gen) -> 0-d loss; returns
    step(state, batch, gen) -> (state, metrics), the metrics being loss, lr
    and grad_norm (the global norm over every gradient). arec's
    with_grad_norm=False, its mesh step's, is `make_mesh_step_core`."""

    def step(state: TrainState, batch, gen):
        loss, leaves, grads = _loss_and_grads(loss_fn, state, batch, gen)
        lr = base_lr * state.lr_scale
        opt.update(grads, state.opt_state, leaves, lr)
        metrics = {"loss": loss.detach(), "lr": lr,
                   "grad_norm": torch.sqrt(sum((g.float() * g.float()).sum()
                                               for g in grads))}
        return _next(state), metrics

    return step


def make_mesh_step_core(loss_fn: Callable, opt: Optimizer, base_lr: float,
                        mesh) -> Callable:
    """The dense step on a ("data", "model") mesh: arec's GSPMD step
    (`make_step_core(with_grad_norm=False)` jitted with the state's
    shardings, `arec/train/loop.py:441-452`) with its collectives named.

    loss_fn(params, batch_slab, gen) must return the GLOBAL loss with each
    rank's backward giving its partial gradients (`mf_loss` / `seq_loss`
    with mesh=, their lookups the exchange: `losses.mesh_mean`). Then:

      * the replicated leaves' partials are summed over every rank (one
        all_reduce of them packed into one buffer);
      * each table shard's partial (already summed over "model" by the
        exchange's backward) is summed over "data": the dense [Vp/T, W]
        all-reduce per table that the sparse mesh step exists to avoid;
      * the optimizer runs on each rank's leaves: its table state is
        row-sharded like the tables, and every rank applies the same
        summed gradient to the replicated leaves.

    A table shard is a leaf that `dist.specs.table_role` names. No
    grad_norm, as arec's mesh step: it would add a reduction over the
    shards for observability alone. The state is updated in place."""
    from arec_torch.dist.specs import (
        DATA_AXIS, table_role, tree_map_with_keys,
    )

    data_group = mesh.get_group(DATA_AXIS)
    n_data = mesh.size(0)

    def step(state: TrainState, batch, gen):
        loss, leaves, grads = _loss_and_grads(loss_fn, state, batch, gen)
        sharded = _leaves(tree_map_with_keys(
            lambda keys, _: table_role(keys) is not None, state.params))
        with torch.no_grad():
            rep = [i for i, s in enumerate(sharded)
                   if not s and grads[i].is_floating_point()]
            if rep:
                flat = torch.cat([grads[i].reshape(-1) for i in rep])
                torch.distributed.all_reduce(flat)
                for i, part in zip(rep, flat.split(
                        [grads[i].numel() for i in rep])):
                    grads[i] = part.view_as(grads[i])
            if n_data > 1:
                for i, s in enumerate(sharded):
                    if s:
                        grads[i] = grads[i].contiguous()
                        torch.distributed.all_reduce(grads[i],
                                                     group=data_group)
        lr = base_lr * state.lr_scale
        opt.update(grads, state.opt_state, leaves, lr)
        return _next(state), {"loss": loss.detach(), "lr": lr}

    return step


def make_train_step(loss_fn: Callable, opt: Optimizer,
                    base_lr: float) -> Callable:
    """The single train step step(state, batch, gen) -> (state, metrics);
    it consumes `state` (in-place updates, as arec donates it)."""
    return make_step_core(loss_fn, opt, base_lr)


def make_multi_step(loss_fn: Callable, opt: Optimizer, base_lr: float,
                    k: int) -> Callable:
    """K optimizer steps per dispatch (arec's `make_multi_step`):
    multi(state, batches, gens) over K batches and the K steps' keys,
    metrics as [K] tensors; step for step identical to K calls of
    `make_train_step` (same key per global step, same update order). One
    CUDA graph replay on the card (`arec_torch.train.graph`); K single
    steps on the CPU."""
    from arec_torch.train.graph import scan_multi
    return scan_multi(make_step_core(loss_fn, opt, base_lr), k)


@torch.no_grad()
def decay_lr(state: TrainState, factor: float) -> TrainState:
    """lr_scale *= factor, in place (a captured K-step graph reads the
    same tensor); returns the state."""
    state.lr_scale.mul_(factor)
    return state


def step_generator(seed: int, step: int) -> torch.Generator:
    """The key of global step `step` of a run seeded `seed`: a pure function
    of (seed + 777, step), as arec's fold_in(key(seed + 777), step)."""
    return generator(mix(seed + 777, step))
