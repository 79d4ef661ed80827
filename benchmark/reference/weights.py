"""The weights of a run, made on the device from its seed in one call per
leaf and handed to both sides: the program gets them copied into its own
state, the reference makes them again from the same seed. Leaves are
named flat ("user.table", "rnn_w"); `nest` gives the reference's tree.

Plain PyTorch; imports nothing of the program."""

from __future__ import annotations

import math

import torch

from reference.keys import mix
from reference.layout import Entity

WEIGHTS_KEY = 0x5EED


def shapes(family: str, ents: dict) -> dict:
    """{leaf name: (shape, scale)} of a family's parameters."""
    out = {}
    names = ("user", "item") if family == "mf" else ("item_in",)
    for name in names:
        e: Entity = ents["item" if name == "item_in" else name]
        n_in = len(e.fields) * e.dim
        out[f"{name}.table"] = ((e.rows, e.width), 1 / math.sqrt(e.dim))
        out[f"{name}.w1"] = ((n_in, e.dim), math.sqrt(1 / n_in))
        out[f"{name}.b1"] = ((e.dim,), 0.01)
    if family == "seq":
        d, v = ents["item"].dim, ents["item"].num
        out["rnn_w"] = ((2 * d, 4 * d), 1 / math.sqrt(2 * d))
        out["rnn_b"] = ((4 * d,), 0.01)
        out["item_out"] = ((v + 1, d + 1), 1 / math.sqrt(d))
    return out


def make(family: str, ents: dict, seed: int, device) -> dict:
    """{leaf name: float32 tensor}: N(0, scale²) draws from one generator
    on `device`, every pad row zero, the LSTM's forget-gate bias + 1."""
    gen = torch.Generator(device=device).manual_seed(mix(seed, WEIGHTS_KEY))
    out = {}
    for name, (shape, scale) in shapes(family, ents).items():
        out[name] = torch.randn(shape, generator=gen, device=device) * scale
    for name in ("user", "item", "item_in"):
        if f"{name}.table" in out:
            e = ents["item" if name == "item_in" else name]
            out[f"{name}.table"][e.pad_rows()] = 0.0
    if family == "seq":
        d = ents["item"].dim
        out["rnn_b"][d:2 * d] += 1.0
        out["item_out"][ents["item"].num] = 0.0
    return out


def nest(flat: dict) -> dict:
    """{"user.table": t} → {"user": {"table": t}}."""
    out: dict = {}
    for name, t in flat.items():
        head, _, rest = name.partition(".")
        if rest:
            out.setdefault(head, {})[rest] = t
        else:
            out[head] = t
    return out
