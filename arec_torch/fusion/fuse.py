"""Attribute-to-embedding fusion (port of `arec/fusion/fuse.py`).

Two modes:
  concat: concat per-attribute embeddings [B, n*D] → linear proj → [B, D];
          with nonlinear=True a tanh hidden layer is inserted (the ref's
          --nonlinear). Single-attribute + linear is the identity and takes
          no parameters (see EncoderSpec.needs_proj).
  sum:    elementwise sum of per-attribute embeddings (all dim D).

Dropout belongs to training and comes with the training slice.
"""

from __future__ import annotations

import math

import torch


def init_fusion(gen: torch.Generator, n_attrs: int, dim: int,
                nonlinear: bool) -> dict:
    """Same shapes and scales as arec's init; the draws come from `gen` and
    land on `gen.device` (torch and jax give different numbers from one
    seed, so parity runs hand arec's weights over through the bridge)."""
    d_in = n_attrs * dim
    dev = gen.device
    if nonlinear:
        return {
            "w1": torch.randn(d_in, dim, generator=gen, device=dev)
                  * math.sqrt(2.0 / d_in),
            "b1": torch.zeros(dim, device=dev),
            "w2": torch.randn(dim, dim, generator=gen, device=dev)
                  * math.sqrt(2.0 / dim),
            "b2": torch.zeros(dim, device=dev),
        }
    return {
        "w1": torch.randn(d_in, dim, generator=gen, device=dev)
              * math.sqrt(1.0 / d_in),
        "b1": torch.zeros(dim, device=dev),
    }


def apply_fusion(params: dict | None, per_attr: list[torch.Tensor], kind: str,
                 nonlinear: bool, act_dtype=None) -> torch.Tensor:
    """act_dtype: arec's train-path activation dtype; when set, the
    projection weights are cast to it so the matmul runs in that dtype."""
    cast = (lambda a: a.to(act_dtype)) if act_dtype is not None else (
        lambda a: a)
    if kind == "sum":
        return sum(per_attr[1:], start=per_attr[0])
    if kind != "concat":
        raise ValueError(f"unknown fusion kind {kind!r}")
    x = per_attr[0] if len(per_attr) == 1 else torch.cat(per_attr, -1)
    if params is None:
        return x  # identity: single attribute, linear
    h = x @ cast(params["w1"]) + cast(params["b1"])
    if nonlinear:
        h = torch.tanh(h)
        h = h @ cast(params["w2"]) + cast(params["b2"])
    return h
