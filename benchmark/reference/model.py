"""The plain reference of both configurations: hybrid MF and the LSTM
next-item model, forward, sampled-softmax loss and scoring, written from
arec's published description (A-Recsys: attribute embeddings fused by a
concat projection; TF1 sampled softmax with log-uniform negatives,
-log(S·P) correction and accidental hits removed; left-padded masked
LSTM; per-item output bias).

`dt` is the precision of the products that the configuration's
`compute_dtype` governs (the sampled logits, the LSTM's input projection
and recurrent product, the serving scores): their operands are rounded to
it and the sums run in float32. "bfloat16" is the configuration's own;
"float8" (e4m3, one scale per operand) is the control's. The attribute
encode and fusion, the true logit and the cell arithmetic run in float32.

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


# ---- LSTM ----------------------------------------------------------------

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


def seq_loss(P: dict, m: dict, inputs, targets, mask, negs,
             dt: str) -> torch.Tensor:
    """The CE over every valid position against the untied output table
    (its bias in column D)."""
    h = lstm_hidden(P, m, inputs, mask, dt)
    D = h.shape[-1]
    q = h.reshape(-1, D)
    t = targets.reshape(-1)
    out = P["item_out"]
    tr = F.embedding(t.long(), out)
    sr = F.embedding(negs[0].long(), out)
    return sampled_ce(q, tr[:, :D], tr[:, D], t, sr[:, :D], sr[:, D],
                      negs[0], negs[1], mask.reshape(-1), m["item"].num, dt)


def seq_queries(P, m, inputs, mask, dt):
    return lstm_hidden(P, m, inputs, mask, dt)[:, -1]


def seq_items(P, m):
    out = P["item_out"]
    D = out.shape[1] - 1
    return out[:m["item"].num, :D], out[:m["item"].num, D]


def scores(q, v, b, dt: str) -> torch.Tensor:
    return mm(q, v.T, dt) + b[None, :]
