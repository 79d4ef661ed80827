"""Attribute-to-embedding fusion (port of `arec/fusion/fuse.py`).

Two modes:
  concat: concat per-attribute embeddings [B, n*D] → linear proj → [B, D];
          with nonlinear=True a tanh hidden layer is inserted (the ref's
          --nonlinear). Single-attribute + linear is the identity and takes
          no parameters (see EncoderSpec.needs_proj).
  sum:    elementwise sum of per-attribute embeddings (all dim D).

Training-time dropout (keep_prob < 1) draws its mask from a
`torch.Generator`.
"""

from __future__ import annotations

import math

import torch


def init_fusion(gen: torch.Generator, n_attrs: int, dim: int,
                nonlinear: bool, device=None) -> dict:
    """Same shapes and scales as arec's init; the draws come from `gen` and
    land on `device` (default `gen.device`; `meta` gives the shapes alone).
    torch and jax give different numbers from one seed, so parity runs hand
    arec's weights over through the bridge."""
    d_in = n_attrs * dim
    dev = gen.device if device is None else device
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
                 nonlinear: bool, act_dtype=None, dropout_gen=None,
                 keep_prob: float = 1.0) -> torch.Tensor:
    """act_dtype: arec's train-path activation dtype; when set, the
    projection weights are cast to it so the matmul runs in that dtype.
    dropout_gen/keep_prob: inverted dropout on the fused output, the keep
    mask drawn from `dropout_gen` (on the output's device)."""
    cast = (lambda a: a.to(act_dtype)) if act_dtype is not None else (
        lambda a: a)
    if kind == "sum":
        out = sum(per_attr[1:], start=per_attr[0])
    elif kind == "concat":
        x = per_attr[0] if len(per_attr) == 1 else torch.cat(per_attr, -1)
        if params is None:
            out = x  # identity: single attribute, linear
        else:
            out = x @ cast(params["w1"]) + cast(params["b1"])
            if nonlinear:
                out = torch.tanh(out)
                out = out @ cast(params["w2"]) + cast(params["b2"])
    else:
        raise ValueError(f"unknown fusion kind {kind!r}")
    if dropout_gen is not None and keep_prob < 1.0:
        keep = torch.rand(out.shape, generator=dropout_gen,
                          device=out.device) < keep_prob
        out = torch.where(keep, out / keep_prob, 0.0)
    return out
