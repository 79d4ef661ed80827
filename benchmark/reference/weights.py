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
GATES = {"lstm": 4, "gru": 3}


def shapes(family: str, ents: dict, cell: str | None = None) -> dict:
    """{leaf name: (shape, scale)} of a family's parameters; a sequence
    family's recurrent layer is [2d, G·d] with G the gates of `cell`."""
    out = {}
    names = ("user", "item") if family == "mf" else ("item_in",)
    for name in names:
        e: Entity = ents["item" if name == "item_in" else name]
        n_in = len(e.fields) * e.dim
        out[f"{name}.table"] = ((e.rows, e.width), 1 / math.sqrt(e.dim))
        out[f"{name}.w1"] = ((n_in, e.dim), math.sqrt(1 / n_in))
        out[f"{name}.b1"] = ((e.dim,), 0.01)
    if family == "seq":
        if cell not in GATES:
            raise ValueError(f"unknown recurrent cell {cell!r}")
        d, v, g = ents["item"].dim, ents["item"].num, GATES[cell]
        out["rnn_w"] = ((2 * d, g * d), 1 / math.sqrt(2 * d))
        out["rnn_b"] = ((g * d,), 0.01)
        out["item_out"] = ((v + 1, d + 1), 1 / math.sqrt(d))
    return out


def make(family: str, ents: dict, seed: int, device,
         cell: str | None = None) -> dict:
    """{leaf name: float32 tensor}: N(0, scale²) draws from one generator
    on `device`, every pad row zero, the LSTM's forget-gate bias + 1
    (the GRU's gates keep their draws)."""
    gen = torch.Generator(device=device).manual_seed(mix(seed, WEIGHTS_KEY))
    out = {}
    for name, (shape, scale) in shapes(family, ents, cell).items():
        out[name] = torch.randn(shape, generator=gen, device=device) * scale
    for name in ("user", "item", "item_in"):
        if f"{name}.table" in out:
            e = ents["item" if name == "item_in" else name]
            out[f"{name}.table"][e.pad_rows()] = 0.0
    if family == "seq":
        d = ents["item"].dim
        if cell == "lstm":
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
