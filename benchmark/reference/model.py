"""The plain reference of both configuration families: hybrid MF and the
sequence next-item model (an LSTM or a GRU by `model.cell`), forward,
sampled-softmax loss and scoring, written from arec's published
description (A-Recsys: attribute embeddings fused by a concat projection;
TF1 sampled softmax with log-uniform negatives, -log(S·P) correction and
accidental hits removed; left-padded masked TF1 LSTMCell or GRUCell;
per-item output bias), and MF's in-batch ranking losses `mw` and `bbpr`
(AAAI'18), with their optional Horvitz–Thompson weights.

`dt` is the precision of the products that the configuration's
`compute_dtype` governs (the sampled logits, the in-batch scores, the
recurrence's input projection and recurrent products, the serving
scores): their operands are rounded to it and the sums run in float32.
"bfloat16" is the configuration's own; "float8" (e4m3, one scale per
operand) is the control's. The attribute encode and fusion, the true
logit and the cell arithmetic run in float32. `mm` passes the gradient
through the rounding unchanged; the in-batch scores' `mm_cast` rounds it
to `dt` as well, as autodiff of a cast does (arec's product of operands
cast to `compute_dtype`, and the port's `mm_f32`, differentiate so).

Plain PyTorch; imports nothing of the program."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.layout import Entity

NEG_INF = -1e9
FP8_MAX = 448.0


def rounded(a: torch.Tensor, dt: str) -> torch.Tensor:
    """`a` rounded to precision `dt`, returned as float32; the gradient
    passes the rounding unchanged, as it does a cast."""
    a = a.float()
    if dt == "float32":
        return a
    if dt == "bfloat16":
        q = a.detach().to(torch.bfloat16).float()
    elif dt == "float8":
        scale = a.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        q = (a.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    else:
        raise ValueError(f"unknown precision {dt!r}")
    return a + (q - a.detach())


def mm(a, b, dt: str) -> torch.Tensor:
    return rounded(a, dt) @ rounded(b, dt)


class _Cast(torch.autograd.Function):
    """`a` rounded to precision `dt` as a cast rounds it: its gradient is
    rounded to `dt` too, as autodiff of a cast gives it."""

    @staticmethod
    def forward(ctx, a, dt):
        ctx.dt = dt
        return rounded(a, dt).detach()

    @staticmethod
    def backward(ctx, g):
        return rounded(g, ctx.dt), None


def mm_cast(a, b, dt: str) -> torch.Tensor:
    """a·b with both operands cast to `dt` and the sums in float32,
    differentiated through the casts (arec's dot of operands cast to
    `compute_dtype`): the operands' gradients are rounded to `dt`."""
    return _Cast.apply(a.float(), dt) @ _Cast.apply(b.float(), dt)


def encode(enc: dict, ent: Entity, slots: torch.Tensor, ids: torch.Tensor):
    """(latents [..., dim], bias [...] or None) of entity `ids` (the pad id
    `ent.num` encodes to zero): each field's rows (the mean of a mulhot
    field's valid ones), the bias from the id field's row, the fields'
    first `dim` columns concatenated and projected."""
    shape = ids.shape
    flat = ids.reshape(-1).long()
    idx = slots[flat]                                   # [n, Σ degree]
    ok = (idx >= 0).float()[..., None]
    rows = F.embedding(idx.clamp_min(0), enc["table"]) * ok
    per, col = [], 0
    for f in ent.fields:
        part = rows[:, col:col + f.degree].sum(1)
        cnt = ok[:, col:col + f.degree].sum(1).clamp_min(1.0)
        per.append(part / cnt)
        col += f.degree
    bias = per[0][:, ent.dim] if ent.with_bias else None
    x = torch.cat([p[:, :ent.dim] for p in per], dim=1)
    lat = x @ enc["w1"] + enc["b1"]
    live = (flat < ent.num).float()
    lat = (lat * live[:, None]).reshape(*shape, ent.dim)
    if bias is not None:
        bias = (bias * live).reshape(shape)
    return lat, bias


def log_uniform_prob(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    k = ids.float()
    return torch.log((k + 2.0) / (k + 1.0)) / math.log(vocab + 1.0)


def sampled_ce(q, t_vec, t_bias, t_ids, s_vec, s_bias, s_ids, s_prob,
               weights, vocab: int, dt: str) -> torch.Tensor:
    """The sampled-softmax CE: class 0 the true item, S shared negatives,
    both corrected by -log(S·P), accidental hits masked; the mean over
    rows, or weighted by `weights` over max(Σ weights, 1)."""
    S = s_ids.shape[0]
    tl = (q * t_vec).sum(-1) + t_bias - torch.log(
        S * log_uniform_prob(t_ids, vocab))
    sl = mm(q, s_vec.T, dt) + (s_bias - torch.log(S * s_prob))[None, :]
    sl = torch.where(s_ids[None, :] == t_ids[:, None], NEG_INF, sl)
    ce = torch.logsumexp(torch.cat([tl[:, None], sl], 1), 1) - tl
    if weights is None:
        return ce.mean()
    return (ce * weights).sum() / weights.sum().clamp_min(1.0)


# ---- MF ------------------------------------------------------------------

def mf_loss(P: dict, m: dict, users, pos, negs, dt: str) -> torch.Tensor:
    """P: {"user": {table, w1, b1}, "item": {...}}; m: the model's static
    parts (entities and slot maps); negs: (ids, P(ids))."""
    u, _ = encode(P["user"], m["user"], m["user_slots"], users)
    tv, tb = encode(P["item"], m["item"], m["item_slots"], pos)
    sv, sb = encode(P["item"], m["item"], m["item_slots"], negs[0])
    return sampled_ce(u, tv, tb, pos, sv, sb, negs[0], negs[1], None,
                      m["item"].num, dt)


# ---- MF's in-batch ranking losses ----------------------------------------
#
# Liu & Natarajan, "A Batch Learning Framework for Scalable Personalized
# Ranking", AAAI 2018 (arXiv:1711.04019), as arec defines them: the B
# positives of a batch are every row's candidates, so each row's
# positive is a shared negative for every other row, and the loss is
# taken over the [B, B] score matrix.

def _batch_scores(P, m, users, pos, dt):
    """(scores [B, B] = u·vᵀ + b over the batch's positives, each row's own
    positive score [B] (its diagonal), the mask [B, B] of every column
    whose item is the row's positive)."""
    u, _ = encode(P["user"], m["user"], m["user_slots"], users)
    v, b = encode(P["item"], m["item"], m["item_slots"], pos)
    s = mm_cast(u, v.T, dt) + b[None, :]
    return s, s.diagonal(), pos[None, :] == pos[:, None]


def ht_weights(probs, pos, same) -> torch.Tensor:
    """[B, B] Horvitz–Thompson weights (1 − q_t) / (n_eff · q_j): the
    vocabulary mass that candidate j stands for in row t, under the
    proposal q (the empirical item distribution) conditioned on j ≠ t;
    n_eff is the row's count of unmasked columns, and a masked column
    weighs 0."""
    q = probs[pos.long()].clamp_min(1e-12)
    q_t = probs[pos.long()][:, None]
    n_eff = (~same).sum(1, keepdim=True).clamp_min(1)
    return torch.where(same, 0.0, (1.0 - q_t) / (n_eff * q[None, :]))


def mw_loss(P, m, users, pos, dt: str, ht: bool) -> torch.Tensor:
    """`mw`: each row's margin-1 hinge against every unmasked in-batch
    candidate, weighted by the log of its estimated rank: the mean over
    rows of log1p(rank) × the mean violating hinge, where rank =
    (V − 1)·m / (B − 1) from the row's m violations. With `ht` the
    violations and the hinges are HT-weighted: rank = min(Σ w·[hinge > 0],
    V − 1), the mean hinge Σ w·hinge ÷ max(that sum, 1e-6).

    Departures from the paper, all arec's: every column whose item is the
    row's positive is masked, not only the diagonal (a batch repeats
    popular items); the score carries the item's bias; the HT weights and
    the rank's cap at V − 1 are arec's correction for a proposal that
    follows popularity, where the paper's estimate assumes a uniform
    one."""
    s, own, same = _batch_scores(P, m, users, pos, dt)
    hinge = torch.where(same, 0.0, (1.0 + s - own[:, None]).clamp_min(0.0))
    hit = (hinge > 0).float()
    V = m["item"].num
    if ht:
        w = ht_weights(m["item_probs"], pos, same)
        wm = (w * hit).sum(1)
        rank = wm.clamp(max=V - 1.0)
        mean_hinge = (w * hinge).sum(1) / wm.clamp_min(1e-6)
    else:
        n = hit.sum(1)
        rank = (V - 1) * n / max(len(pos) - 1, 1)
        mean_hinge = hinge.sum(1) / n.clamp_min(1.0)
    return (torch.log1p(rank) * mean_hinge).mean()


def bbpr_loss(P, m, users, pos, dt: str, ht: bool) -> torch.Tensor:
    """`bbpr`: the mean over rows of −log σ(own − score) over the row's
    unmasked in-batch candidates; with `ht` each candidate weighted by
    its HT weight and the row normalised by their sum. Departures from
    the paper: the duplicate-positive mask, the item bias and the HT
    weights, as for `mw`."""
    s, own, same = _batch_scores(P, m, users, pos, dt)
    ll = torch.where(same, 0.0, F.logsigmoid(own[:, None] - s))
    if ht:
        w = ht_weights(m["item_probs"], pos, same)
        return -((w * ll).sum(1) / w.sum(1).clamp_min(1e-12)).mean()
    return -(ll.sum(1) / (~same).sum(1).float().clamp_min(1.0)).mean()


BATCH_LOSSES = {"mw": mw_loss, "bbpr": bbpr_loss}


def mf_queries(P, m, users):
    return encode(P["user"], m["user"], m["user_slots"], users)[0]


def mf_items(P, m, block: int = 16384):
    """Every item's (latent, bias), in blocks."""
    n = m["item"].num
    dev = P["item"]["table"].device
    vs, bs = [], []
    for s in range(0, n, block):
        v, b = encode(P["item"], m["item"], m["item_slots"],
                      torch.arange(s, min(s + block, n), device=dev))
        vs.append(v)
        bs.append(b)
    return torch.cat(vs), torch.cat(bs)


# ---- the sequence model -------------------------------------------------

def lstm_hidden(P: dict, m: dict, inputs, mask, dt: str) -> torch.Tensor:
    """h after every step [B, T, H] of the masked LSTM over left-padded
    histories (a pad step leaves (h, c) as they were)."""
    x, _ = encode(P["item_in"], m["item"], m["item_slots"], inputs)
    D = x.shape[-1]
    w, b = P["rnn_w"], P["rnn_b"]
    xw = mm(x, w[:D], dt) + b
    wh = w[D:]
    B, T = inputs.shape
    h = torch.zeros(B, D, device=x.device)
    c = torch.zeros(B, D, device=x.device)
    out = []
    for t in range(T):
        gates = xw[:, t] + mm(h, wh, dt)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        keep = mask[:, t:t + 1]
        h = keep * h_new + (1.0 - keep) * h
        c = keep * c_new + (1.0 - keep) * c
        out.append(h)
    return torch.stack(out, 1)


def gru_hidden(P: dict, m: dict, inputs, mask, dt: str) -> torch.Tensor:
    """h after every step [B, T, H] of the masked GRU over left-padded
    histories (a pad step leaves h as it was), as TF1's GRUCell, which
    A-Recsys runs for `cell gru`, computes it:

        r  = σ(x·W_xr + h·U_r + b_r)
        u  = σ(x·W_xu + h·U_u + b_u)
        n  = tanh(x·W_xn + (r ⊙ h)·U_n + b_n)
        h' = u ⊙ h + (1 − u) ⊙ n

    with one fused [D + H, 3H] matrix in gate order r | u | n (the x rows
    first) and its bias [3H]. The reset gate scales h before the product
    with U_n; cuDNN's GRU (and torch.nn.GRU) scale the product instead,
    r ⊙ (h·U_n + b_hn), which is another cell. The operands of x·W,
    h·U_{r,u} and (r ⊙ h)·U_n are rounded to `dt`; the gates run in
    float32."""
    x, _ = encode(P["item_in"], m["item"], m["item_slots"], inputs)
    D = x.shape[-1]
    w, b = P["rnn_w"], P["rnn_b"]
    xw = mm(x, w[:D], dt) + b
    u_ru, u_n = w[D:, :2 * D], w[D:, 2 * D:]
    B, T = inputs.shape
    h = torch.zeros(B, D, device=x.device)
    out = []
    for t in range(T):
        hw = mm(h, u_ru, dt)
        r = torch.sigmoid(xw[:, t, :D] + hw[:, :D])
        u = torch.sigmoid(xw[:, t, D:2 * D] + hw[:, D:])
        n = torch.tanh(xw[:, t, 2 * D:] + mm(r * h, u_n, dt))
        h_new = u * h + (1.0 - u) * n
        keep = mask[:, t:t + 1]
        h = keep * h_new + (1.0 - keep) * h
        out.append(h)
    return torch.stack(out, 1)


HIDDEN = {"lstm": lstm_hidden, "gru": gru_hidden}


def seq_loss(P: dict, m: dict, inputs, targets, mask, negs, dt: str,
             cell: str) -> torch.Tensor:
    """The CE over every valid position against the untied output table
    (its bias in column D), after the recurrence of `cell`."""
    h = HIDDEN[cell](P, m, inputs, mask, dt)
    D = h.shape[-1]
    q = h.reshape(-1, D)
    t = targets.reshape(-1)
    out = P["item_out"]
    tr = F.embedding(t.long(), out)
    sr = F.embedding(negs[0].long(), out)
    return sampled_ce(q, tr[:, :D], tr[:, D], t, sr[:, :D], sr[:, D],
                      negs[0], negs[1], mask.reshape(-1), m["item"].num, dt)


def seq_queries(P, m, inputs, mask, dt, cell: str):
    return HIDDEN[cell](P, m, inputs, mask, dt)[:, -1]


def seq_items(P, m):
    out = P["item_out"]
    D = out.shape[1] - 1
    return out[:m["item"].num, :D], out[:m["item"].num, D]


def scores(q, v, b, dt: str) -> torch.Tensor:
    return mm(q, v.T, dt) + b[None, :]
