"""The yardstick's arithmetic: the card's published peaks, each kernel's
least time from the bytes and operations its inputs need, and the FLOPs
of a whole training step or served call.

The peaks and the kernel bounds are frozen copies of `chip_smoke.py`'s
(`HBM_BYTES_PER_S`, `PEAK_FLOPS`, `roofline`, `bound_resid`, `bound_bwd`,
`bound_ce`, `bound_scatter`): each counts every input byte read once and
every output byte written once, and the operations the valid positions
need. Times are in seconds here (chip_smoke's are in ms).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core bf16
              "float32": 67e12}     # f32 outside the tensor cores
GATES = {"lstm": 4, "gru": 3}
BATCH_LOSSES = ("mw", "bbpr")


def roofline_s(nbytes: float, flops: float, dtype: str) -> float:
    """The larger of the bytes over the memory rate and the FLOPs over the
    peak of `dtype`."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def scan_fwd_bytes(L, B, H, cell="lstm", dtype="bfloat16") -> int:
    """The forward scan (serving launch): xw, mask, the carried-in state
    and Wh read once, h_all (and the LSTM's cT) written once."""
    welt = 2 if dtype == "bfloat16" else 4
    G, carries = GATES[cell] * H, 2 if cell == "lstm" else 1
    return (4 * (L * B * G + B * L + carries * B * H + L * B * H
                 + (carries - 1) * B * H) + welt * G * H)


def scan_fwd_s(L, B, H, valid, cell="lstm", dtype="bfloat16") -> float:
    """Serving launch: 2·G·H FLOPs for each valid (row, step)."""
    G = GATES[cell] * H
    return roofline_s(scan_fwd_bytes(L, B, H, cell, dtype),
                      2 * G * H * valid, dtype)


def scan_fwd_resid_s(L, B, H, valid, cell="lstm", dtype="bfloat16"):
    """Training launch: the forward's bytes plus the residuals written."""
    carries = 2 if cell == "lstm" else 1
    G = GATES[cell] * H
    return roofline_s(scan_fwd_bytes(L, B, H, cell, dtype)
                      + carries * 4 * L * B * H, 2 * G * H * valid, dtype)


def scan_bwd_s(L, B, H, valid, cell="lstm", dtype="bfloat16") -> float:
    """The backward scan: xw, mask, the residuals, dh_out, the LSTM's dcT
    and Wh read; dxw, dWh and the carries' gradients written; three
    [., H]·[H, G] products for each valid (row, step)."""
    welt = 2 if dtype == "bfloat16" else 4
    G, carries = GATES[cell] * H, 2 if cell == "lstm" else 1
    nbytes = 4 * (2 * L * B * G + B * L + (carries + 1) * L * B * H
                  + (2 * carries - 1) * B * H + H * G) + welt * G * H
    return roofline_s(nbytes, 3 * 2 * G * H * valid, dtype)


def ce_s(N, S, D, Dt, backward: bool, dtype="bfloat16") -> float:
    """sampled_ce: q, v_true, v_samp, c_samp and the [N] row inputs read
    (lse too in the backward); (ce, lse) or the five gradients written.
    One [N, D]·[D, S] product forward; three backward."""
    ins = N * D + N * Dt + S * D + S + 3 * N + S
    if backward:
        nbytes = 4 * (ins + N + 1 + N * D + N * Dt + S * D + S + N)
    else:
        nbytes = 4 * (ins + 2 * N + 2)
    return roofline_s(nbytes, (6 if backward else 2) * N * S * D, dtype)


def batch_rank_s(N, D, backward: bool, dtype="bfloat16",
                 ht: bool = False) -> float:
    """An in-batch ranking loss (`mw`, `bbpr`) over N rows, whatever
    computes it: q [N, D], the positives' rows v [N, D], their biases and
    ids and (with `ht`) their probabilities read once; forward the N row
    losses written, backward dq, dv and the biases' gradient. One
    [N, D]·[D, N] product forward, two backward."""
    ins = 2 * N * D + (3 if ht else 2) * N
    outs = 2 * N * D + N if backward else N
    return roofline_s(4 * (ins + outs), (4 if backward else 2) * N * N * D,
                      dtype)


def scatter_s(n_ids: int, n_valid: int, width: int) -> float:
    """row_scatter: the ids read, each valid row read once from the rows
    and written once into the table; no operations."""
    return roofline_s(4 * n_ids + 2 * 4 * n_valid * width, 0, "float32")


# ---- whole steps and calls: the FLOPs the work needs ---------------------

def fusion_flops(n_fields: int, dim: int) -> int:
    """One entity's concat fusion: [n·D] · [n·D, D]."""
    return 2 * n_fields * dim * dim


def mf_train_step_flops(N, S, D, user_fields, item_fields,
                        loss="ce") -> int:
    """One MF step. `ce`: the fusions of N users, N positives and S
    negatives forward and backward (3×), the true logits (2·N·D, 3×) and
    the sampled logits (2·N·S·D forward, twice that backward). An in-batch
    loss (`mw`, `bbpr`): the fusions of N users and N positives (3×) and
    the [N, N] scores (2·N·N·D forward, twice that backward); no
    negatives."""
    if loss in BATCH_LOSSES:
        enc = N * (fusion_flops(user_fields, D)
                   + fusion_flops(item_fields, D))
        return 3 * enc + 6 * N * N * D
    if loss != "ce":
        raise ValueError(f"no FLOP count for the MF loss {loss!r}")
    enc = (N * fusion_flops(user_fields, D)
           + (N + S) * fusion_flops(item_fields, D))
    return 3 * enc + 3 * 2 * N * D + 6 * N * S * D


def seq_train_step_flops(valid, S, D, H, item_fields, cell="lstm") -> int:
    """One sequence `ce` step over `valid` positions: each position's item
    fusion, input projection, recurrent product and true logit forward and
    backward (3×), and the sampled logits over S negatives (6·valid·S·D)."""
    G = GATES[cell] * H
    per_pos = fusion_flops(item_fields, D) + 2 * D * G + 2 * H * G + 2 * D
    return 3 * valid * per_pos + 6 * valid * S * D


def mf_serve_flops(requests, V, D, user_fields) -> int:
    """Live MF requests: each user's fusion and its scores over V items."""
    return requests * (fusion_flops(user_fields, D) + 2 * V * D)


def seq_serve_flops(valid, requests, V, D, H, item_fields,
                    cell="lstm") -> int:
    """Live sequence requests: fusion, input projection and recurrent
    product at each valid history position, and each request's scores
    over V items."""
    G = GATES[cell] * H
    per_pos = fusion_flops(item_fields, D) + 2 * D * G + 2 * H * G
    return valid * per_pos + requests * 2 * V * D
