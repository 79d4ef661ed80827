"""Collectives with autograd, for training on the mesh.

`torch.distributed` collectives carry no autograd, so each one the
training paths differentiate through is one `torch.autograd.Function`
here. They follow one convention, the counterpart of what `jax.grad`
derives from arec's shard_maps: a rank's backward produces its own
PARTIAL contribution to each gradient, and a gradient of an input that
several ranks hold (a replicated weight, a table shard replicated over
"data") is the sum of those partials over the ranks that hold it.

  * `all_to_all`       equal-split all_to_all_single on the leading axis;
                       its backward is the same all-to-all of the
                       cotangent (an equal-split all-to-all is its own
                       transpose).
  * `all_gather_cat`   each rank's [n, ...] concatenated in group order;
                       its backward sums the cotangents over the group and
                       keeps this rank's slice: an all_reduce and a slice
                       (gloo has no reduce-scatter; NCCL's would move half
                       the bytes, unmeasured across cards: ROADMAP B15).
  * `sum_partials`     all_reduce(SUM) of per-rank partial sums (the
                       sharded CE's (num, den), a loss's weighted shares);
                       its backward is the identity: the value is used once
                       per rank, and each rank's partial gets the cotangent
                       of the total, so the partial gradients summed over
                       ranks are the total's.

Every rank of a group must differentiate through the same collectives at
the same shapes: autograd runs the backward in the reverse of the order
the forward built it, so the same program on every rank issues the same
backward collectives in the same order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Equal-split all_to_all_single on the leading axis (its length must
    divide by the group size), differentiable in x."""
    return _AllToAll.apply(x, group)


def gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x (equal shapes) concatenated on axis 0 in group
    order; no autograd."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_cat(x, group)

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        g = g.contiguous().clone()
        dist.all_reduce(g, group=group)
        n, me = dist.get_world_size(group), dist.get_rank(group)
        return g.chunk(n)[me].contiguous(), None


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """`gather_cat`, differentiable in x: the backward sums each rank's
    cotangent over the group and returns this rank's slice."""
    return _AllGatherCat.apply(x, group)


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_partials(x: torch.Tensor, group=None) -> torch.Tensor:
    """all_reduce(SUM) of per-rank partials over `group` (None: every
    rank), with the identity backward (see the module docstring)."""
    return _SumPartials.apply(x, group)


def all_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """all_reduce(SUM) of a tensor without autograd, out of place."""
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x
