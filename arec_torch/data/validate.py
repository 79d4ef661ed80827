"""Prep-output validation: deterministic summaries + golden contracts (the
port's copy of `arec/data/validate.py`, numpy only: the same summary and
digest for the same prepared dataset).

  * `prep_summary(ds)` — a deterministic JSON-able summary: cardinalities,
    per-field vocab/degree stats, and content hashes of every array that
    downstream training consumes. Two preps agree iff their summaries agree.
  * golden contract — `--validate-prep` (arec_torch.cli.main) prints the
    summary and compares it against `<data_dir>/golden_<dataset>.json` when
    present (exit 1 on drift); `--write-golden` records the current summary
    as the contract.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

from arec_torch.data.dataset import PreparedDataset


def _h(arr: np.ndarray) -> str:
    """Stable content hash of one array (dtype+shape+bytes)."""
    if arr is None:
        return "absent"
    a = np.ascontiguousarray(arr)
    m = hashlib.sha256()
    m.update(str(a.dtype).encode())
    m.update(str(a.shape).encode())
    m.update(a.tobytes())
    return m.hexdigest()[:16]


def _side(schema, attrs) -> dict:
    fields = []
    for f in schema.fields:
        v = attrs.values[f.name]
        fields.append({
            "name": f.name, "kind": f.kind, "vocab": int(f.vocab_size),
            "max_degree": int(f.max_degree),
            "values": _h(v),
            "filled": (int((v >= 0).sum()) if f.kind == "mulhot"
                       else int(v.shape[0])),
        })
    return {"entities": int(schema.num_entities), "fields": fields}


def prep_summary(ds: PreparedDataset) -> dict:
    """Deterministic summary of everything training/eval consumes."""
    return {
        "dataset": ds.name,
        "num_users": int(ds.num_users),
        "num_items": int(ds.num_items),
        "train_interactions": int(ds.train_users.shape[0]),
        "valid_positives": int(ds.valid_users.shape[0]),
        "item_freq_head": [int(x) for x in ds.item_freq[:8]],
        "item_freq_total": int(ds.item_freq.sum()),
        "user": _side(ds.user_schema, ds.user_attrs),
        "item": _side(ds.item_schema, ds.item_attrs),
        "hashes": {
            "train_users": _h(ds.train_users),
            "train_items": _h(ds.train_items),
            "valid_users": _h(ds.valid_users),
            "valid_items": _h(ds.valid_items),
            "seen_items": _h(ds.seen_items),
            "hist_items": _h(ds.hist_items),
            "item_freq": _h(ds.item_freq),
        },
    }


def summary_digest(summary: dict) -> str:
    """One hash for the whole contract (order-stable JSON)."""
    return hashlib.sha256(
        json.dumps(summary, sort_keys=True).encode()).hexdigest()[:16]


def diff_summaries(golden: dict, got: dict, prefix: str = "") -> list[str]:
    """Human-readable list of leaf paths where the summaries disagree."""
    out: list[str] = []
    if isinstance(golden, dict) and isinstance(got, dict):
        for k in sorted(set(golden) | set(got)):
            if k not in golden:
                out.append(f"{prefix}{k}: missing in golden")
            elif k not in got:
                out.append(f"{prefix}{k}: missing in current")
            else:
                out += diff_summaries(golden[k], got[k], f"{prefix}{k}.")
    elif isinstance(golden, list) and isinstance(got, list):
        if len(golden) != len(got):
            out.append(f"{prefix}len: {len(golden)} != {len(got)}")
        for i, (a, b) in enumerate(zip(golden, got)):
            out += diff_summaries(a, b, f"{prefix}{i}.")
    elif golden != got:
        out.append(f"{prefix[:-1]}: {golden!r} != {got!r}")
    return out
