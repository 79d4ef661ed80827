"""LSTM/GRU sequence-recommendation model family (port of
`arec/models/seq.py`).

Next-item prediction over a user's time-ordered item sequence: the input
at step t is the fused attribute embedding of item t (optionally + the user
embedding), stacked LSTM/GRU cells, and scoring against a dedicated item
output table. Sequences are left-padded to max_seq_len L and the state
updates are masked, so pad steps are exact no-ops and the state at
position L−1 is the state after the user's whole (truncated) history.

The recurrence runs either as the plain scan below (`rnn_scan`: the
reference the kernels are held against) or, with `use_pallas_scan`,
through `arec_torch.kernels.lstm_scan` (cell="lstm") or
`arec_torch.kernels.gru_scan` (cell="gru") — the hand-written CUDA kernels
for CUDA tensors. The same (xw, wh) layout serves all of them: the input
projection x·Wx + b for all steps is one matmul outside the scan and only
the h·Wh products are sequential.

Training: `seq_loss` is the sampled-softmax CE over every valid position,
with TF1 DropoutWrapper-style output dropout and fusion dropout drawn from
`torch.Generator`s (`arec_torch.rng`), and long histories trained in
`train_segments` carried-(h, c) segments under `torch.utils.checkpoint`.
arec's `_pad_time_for_scan` is not ported: it pads for the TPU kernel's
time tiling, which the CUDA kernels do not have.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from arec_torch.config import Config
from arec_torch.data.schema import EntitySchema
from arec_torch.losses.losses import sampled_softmax_loss
from arec_torch.rng import fold_in, generator, split
from arec_torch.tables.engine import (
    EncoderSpec, dense_lookup, encode, encode_all_items_with_bias,
    encode_with_bias, init_encoder, mm_f32,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class SeqSpec:
    item_in: EncoderSpec            # input-side fused item encoder
    user: EncoderSpec | None        # optional user encoder (concat_user)
    cell: str = "lstm"              # {lstm, gru}
    num_layers: int = 1
    max_seq_len: int = 30           # scan segment length
    train_segments: int = 1         # segments per training example
    num_sampled: int = 256
    sampler: str = "log_uniform"
    keep_prob: float = 1.0
    use_pallas_scan: bool = False   # the config name: in the port, the
                                    # hand-written CUDA scan kernel
    tie_output: bool = False        # score against the fused item encoder
    compute_dtype: str = "bfloat16"
    act_dtype: str = "float32"      # train-path activation dtype

    @property
    def dim(self) -> int:
        return self.item_in.dim

    @property
    def pack_len(self) -> int:
        """Total history length per training example (data-packing width)."""
        return self.max_seq_len * self.train_segments

    @property
    def vocab(self) -> int:
        return self.item_in.schema.num_entities

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def act_dt(self):
        """torch dtype for train-path activations; None = float32."""
        return None if self.act_dtype == "float32" else _DTYPES[
            self.act_dtype]

    @staticmethod
    def from_config(cfg: Config, user_schema: EntitySchema,
                    item_schema: EntitySchema) -> "SeqSpec":
        if cfg.train.loss not in ("ce", "mce"):
            raise ValueError(
                f"sequence model supports loss ce/mce, not "
                f"{cfg.train.loss!r}")
        if not cfg.model.use_attributes:
            item_schema = item_schema.id_only()
            user_schema = user_schema.id_only()
        mk = lambda s, wb=False: EncoderSpec(
            s, cfg.model.dim, cfg.model.fusion, cfg.model.nonlinear,
            with_bias=wb,
            dense_mulhot_threshold=cfg.model.dense_vocab_threshold)
        return SeqSpec(
            item_in=mk(item_schema, wb=cfg.model.tie_output),
            user=mk(user_schema) if cfg.model.concat_user else None,
            cell=cfg.model.cell,
            num_layers=cfg.model.num_layers,
            max_seq_len=cfg.model.max_seq_len,
            train_segments=cfg.model.train_segments,
            num_sampled=cfg.train.num_sampled,
            sampler=cfg.train.sampler,
            keep_prob=cfg.model.keep_prob,
            use_pallas_scan=cfg.model.use_pallas_scan,
            tie_output=cfg.model.tie_output,
            compute_dtype=cfg.train.compute_dtype,
            act_dtype=cfg.train.act_dtype,
        )


def _gate_count(cell: str) -> int:
    return {"lstm": 4, "gru": 3}[cell]


def init_seq(gen: torch.Generator, spec: SeqSpec, device=None) -> dict:
    """arec's seq param layout, shapes and scales, drawn from `gen` on
    `device` (default `gen.device`; `meta` gives the shapes alone): {"item_in", ["user"], "rnn": [{"w", "b"}], ["item_out"]}
    with `w` the fused [D_in + H, G·H] matrix (gate order i|f|g|o for the
    LSTM, r|u|n for the GRU)."""
    d, g = spec.dim, _gate_count(spec.cell)
    dev = gen.device if device is None else device
    params: dict = {"item_in": init_encoder(gen, spec.item_in, dev)}
    if spec.user is not None:
        params["user"] = init_encoder(gen, spec.user, dev)
    layers = []
    for _ in range(spec.num_layers):
        d_in = d  # input dim == hidden dim at every layer (single --size)
        w = torch.randn(d_in + d, g * d, generator=gen, device=dev) / \
            math.sqrt(d_in + d)
        b = torch.zeros(g * d, device=dev)
        if spec.cell == "lstm":
            b[d:2 * d] = 1.0   # forget-gate bias 1.0
        layers.append({"w": w, "b": b})
    params["rnn"] = layers
    if not spec.tie_output:
        # [V+1, D+1]: per-item score bias in column D, one PAD row
        t = torch.randn(spec.vocab + 1, d + 1, generator=gen, device=dev) / \
            math.sqrt(d)
        t[:, d] = 0.0
        params["item_out"] = t
    return params


# --------------------------------------------------------------------------
# Recurrence: the plain scan (reference for the kernel)
# --------------------------------------------------------------------------

def input_projection(p: dict, x: torch.Tensor, dtype) -> torch.Tensor:
    """x [..., D_in] → xw [..., G·H] = x · Wx + b (bias folded in), with
    the operands in `dtype` and the product in f32."""
    d_in = x.shape[-1]
    return mm_f32(x, p["w"][:d_in], dtype) + p["b"]


def lstm_step(wh, xw_t, h, c, dtype):
    """One LSTM step from precomputed input projection xw_t [B, 4H]."""
    gates = xw_t + mm_f32(h, wh, dtype)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def gru_step(wh, xw_t, h, c, dtype):
    """One GRU step; xw_t [B, 3H] = x·[Wx_r|Wx_u|Wx_n] + b."""
    d = h.shape[-1]
    hw = mm_f32(h, wh[:, : 2 * d], dtype)
    r = torch.sigmoid(xw_t[:, :d] + hw[:, :d])
    u = torch.sigmoid(xw_t[:, d : 2 * d] + hw[:, d:])
    n = torch.tanh(xw_t[:, 2 * d :] + mm_f32(r * h, wh[:, 2 * d :], dtype))
    h_new = (1.0 - u) * n + u * h
    return h_new, c


def layer_scan(p: dict, cell: str, x: torch.Tensor, mask: torch.Tensor,
               dtype, state: tuple | None = None, return_state: bool = False,
               time_major: bool = False):
    """One recurrent layer: x [B, L, D], mask [B, L] → h_all [B, L, H]
    (time_major: x [L, B, D], mask [L, B] → [L, B, H]). Masked state
    updates make pad steps exact no-ops; `state` is an optional (h0, c0)
    carry-in and return_state=True also returns the final (hT, cT).
    Gradients flow through the carry, so a segmented scan is exactly the
    unsegmented one."""
    b = x.shape[1] if time_major else x.shape[0]
    d = p["w"].shape[0] - x.shape[-1]
    wh = p["w"][x.shape[-1]:]
    xw = input_projection(p, x, dtype)                    # [..., G·H]
    step_fn = lstm_step if cell == "lstm" else gru_step
    if state is None:
        zeros = torch.zeros(b, d, device=x.device)
        state = (zeros, zeros)
    h, c = state
    out = []
    for t in range(xw.shape[0] if time_major else xw.shape[1]):
        xw_t = xw[t] if time_major else xw[:, t]
        m = (mask[t] if time_major else mask[:, t])[:, None]
        h_new, c_new = step_fn(wh, xw_t, h, c, dtype)
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        out.append(h)
    out = torch.stack(out, dim=0 if time_major else 1)
    if return_state:
        return out, (h, c)
    return out


def output_dropout(h: torch.Tensor, gen: torch.Generator | None,
                   keep_prob: float) -> torch.Tensor:
    """TF1 DropoutWrapper(output_keep_prob) semantics: an independent
    per-timestep mask on a layer's OUTPUT sequence — what the next layer
    and the softmax see — while the recurrent (h, c) carry propagates
    undropped. gen=None (eval) is the identity; the mask is drawn from
    `gen`, which must live on h's device."""
    if gen is None or keep_prob >= 1.0:
        return h
    keep = torch.rand(h.shape, generator=gen, device=h.device) < keep_prob
    return torch.where(keep, h / keep_prob, 0.0)


def rnn_scan(layers: list[dict], cell: str, x: torch.Tensor,
             mask: torch.Tensor, dtype, states: list | None = None,
             return_states: bool = False, time_major: bool = False,
             dropout_gen: torch.Generator | None = None,
             keep_prob: float = 1.0):
    """Stacked layers; returns top-layer hidden states [B, L, H] ([L, B, H]
    with time_major); `states` are per-layer (h0, c0) carries.
    `dropout_gen`/`keep_prob`: output dropout per layer, layer li drawing
    from fold_in(dropout_gen, li) (see output_dropout)."""
    h = x
    new_states = []
    for li, p in enumerate(layers):
        st = states[li] if states is not None else None
        h, stT = layer_scan(p, cell, h, mask, dtype, state=st,
                            return_state=True, time_major=time_major)
        new_states.append(stT)   # carry is pre-dropout (DropoutWrapper)
        if dropout_gen is not None:
            h = output_dropout(h, fold_in(dropout_gen, li, h.device),
                               keep_prob)
    if return_states:
        return h, new_states
    return h


# --------------------------------------------------------------------------
# Forward / recommend
# --------------------------------------------------------------------------

def seq_inputs(params, spec: SeqSpec, item_dev, user_dev, batch,
               dropout_gen=None, time_major: bool = False,
               lookup_fn=dense_lookup, lookup_fns: dict | None = None):
    """Fused per-step input embeddings [B, L, D] ([L, B, D] with
    time_major: the int ids are transposed before the gather, so no
    embedding-sized transpose exists). dropout_gen: fusion dropout of the
    item encoder at spec.keep_prob. lookup_fn / lookup_fns: the row gather,
    per role ("item", "user") in lookup_fns (the sparse step's subset
    lookups)."""
    lk = lookup_fns or {}
    ids = batch["inputs"].T if time_major else batch["inputs"]
    x = encode(params["item_in"], spec.item_in, item_dev, ids,
               lk.get("item", lookup_fn), act_dtype=spec.act_dt,
               dropout_gen=dropout_gen, keep_prob=spec.keep_prob)
    if spec.user is not None:
        u = encode(params["user"], spec.user, user_dev, batch["user"],
                   lk.get("user", lookup_fn), act_dtype=spec.act_dt)
        x = x + (u[None, :, :] if time_major else u[:, None, :])
    return x


def init_states(spec: SeqSpec, batch_size: int, device) -> list:
    """Zero per-layer (h, c) carries for segmented scans."""
    z = torch.zeros(batch_size, spec.dim, device=device)
    return [(z, z) for _ in range(spec.num_layers)]


def seq_hidden(params, spec: SeqSpec, item_dev, user_dev, batch,
               dropout_gen=None, states: list | None = None,
               return_states: bool = False, time_major: bool = False,
               lookup_fn=dense_lookup, lookup_fns: dict | None = None):
    """Top-layer hidden states [B, L, H] ([L, B, H] with time_major).
    `states`/`return_states` expose the per-layer (h, c) carries of the
    segmented scan. `dropout_gen` (a training key, see arec_torch.rng)
    splits into the fusion-dropout and the output-dropout streams, as
    arec's dropout_rng does. With use_pallas_scan, both cells run their
    CUDA kernels (their plain versions on CPU tensors)."""
    dev = batch["inputs"].device
    g_in = g_rnn = None
    if dropout_gen is not None and spec.keep_prob < 1.0:
        g_in, g_rnn = split(dropout_gen, dev)
    x = seq_inputs(params, spec, item_dev, user_dev, batch, g_in,
                   time_major=time_major, lookup_fn=lookup_fn,
                   lookup_fns=lookup_fns)
    mask = batch["mask"].T if time_major else batch["mask"]
    if spec.use_pallas_scan:
        if spec.cell == "lstm":
            from arec_torch.kernels.lstm_scan import lstm_scan as scan
        else:
            from arec_torch.kernels.gru_scan import gru_scan as scan
        return scan(params["rnn"], x, mask, dtype=spec.dtype, states=states,
                    return_states=return_states, time_major=time_major,
                    dropout_gen=g_rnn, keep_prob=spec.keep_prob)
    return rnn_scan(params["rnn"], spec.cell, x, mask, spec.dtype,
                    states=states, return_states=return_states,
                    time_major=time_major, dropout_gen=g_rnn,
                    keep_prob=spec.keep_prob)


def seq_loss(params, spec: SeqSpec, item_dev, user_dev, batch,
             gen: torch.Generator, sampled: tuple | None = None,
             states: list | None = None, return_states: bool = False,
             use_kernel: bool | None = None, time_major: bool = False,
             mesh=None, pop=None, lookup_fn=dense_lookup,
             lookup_fns: dict | None = None):
    """Sampled-softmax CE over all valid positions. `gen` is the step's key
    (arec_torch.rng): it splits into the dropout and the negatives streams,
    as arec's rng does; `sampled=(ids, p)` hands pre-drawn negatives in.
    With `states`/`return_states` the loss runs one TBPTT segment.
    lookup_fn / lookup_fns: the row gather, per role ("item", "user",
    "out" for the untied output table) in lookup_fns. mesh: the batch is
    this rank's "data" slab and the loss is the global one, through the
    sharded fused CE (the dense mesh step, batch-major as arec's).

    A packed history of train_segments·L steps is scanned in segments of L
    with (h, c) carried and gradients flowing through the carries; each
    segment runs under torch.utils.checkpoint, so its scan residuals are
    recomputed in the backward instead of kept. Each segment's dropout
    seed is drawn before the checkpointed call and its generators are
    built inside it, so the recompute redraws the same masks; no draw
    comes from the global RNG, so its state is not saved and restored
    (`preserve_rng_state=False`, which also keeps the call inside a CUDA
    graph capture free of RNG-state reads)."""
    dev = batch["inputs"].device
    lk = lookup_fns or {}
    g_drop, g_neg = split(gen, dev)
    L, n = spec.max_seq_len, spec.train_segments
    if n > 1 and batch["inputs"].shape[1] == n * L:
        def seg_fn(st, seg, seed):
            return seq_hidden(params, spec, item_dev, user_dev, seg,
                              dropout_gen=generator(seed, dev), states=st,
                              return_states=True, time_major=time_major,
                              lookup_fn=lookup_fn, lookup_fns=lookup_fns)

        st = states if states is not None else init_states(
            spec, batch["inputs"].shape[0], dev)
        hs = []
        for s in range(n):
            seg = dict(batch)
            seg["inputs"] = batch["inputs"][:, s * L:(s + 1) * L]
            seg["mask"] = batch["mask"][:, s * L:(s + 1) * L]
            seed = fold_in(g_drop, s).initial_seed()
            h_s, st = checkpoint(seg_fn, st, seg, seed, use_reentrant=False,
                                 preserve_rng_state=False)
            hs.append(h_s)
        h, new_states = torch.cat(hs, dim=0 if time_major else 1), st
    else:
        h = seq_hidden(params, spec, item_dev, user_dev, batch,
                       dropout_gen=g_drop, states=states,
                       return_states=return_states, time_major=time_major,
                       lookup_fn=lookup_fn, lookup_fns=lookup_fns)
        if return_states:
            h, new_states = h
    d = h.shape[-1]
    flat_h = h.reshape(-1, d)
    if time_major:
        # position order (t, b): the loss is a weighted mean, so any
        # consistent flattening of (h, targets, mask) gives the same value
        flat_t = batch["targets"].T.reshape(-1)
        flat_w = batch["mask"].T.reshape(-1)
    else:
        flat_t = batch["targets"].reshape(-1)
        flat_w = batch["mask"].reshape(-1)
    embed_raw = None
    if spec.tie_output:
        def embed(ids):
            return encode_with_bias(params["item_in"], spec.item_in,
                                    item_dev, ids, lk.get("item", lookup_fn),
                                    act_dtype=spec.act_dt)
    else:
        # raw [n, D+1] rows (bias in lane D): the fused CE's aug mode takes
        # them as they are for the true side
        def embed_raw(ids):
            return lk.get("out", lookup_fn)(params["item_out"], ids)

        def embed(ids):
            rows = embed_raw(ids)
            return rows[:, :d], rows[:, d]
    loss = sampled_softmax_loss(
        flat_h, flat_t, embed, g_neg, spec.num_sampled, spec.vocab,
        dist=spec.sampler, weights=flat_w, compute_dtype=spec.dtype,
        sampled=sampled, use_kernel=use_kernel, mesh=mesh, pop=pop,
        embed_raw=embed_raw)
    if return_states:
        return loss, new_states
    return loss


def seq_final_state(params, spec: SeqSpec, item_dev, user_dev, batch,
                    lookup_fn=dense_lookup,
                    lookup_fns: dict | None = None) -> torch.Tensor:
    """Recommend path: with left-padding the state at the last position is
    the state after the user's whole (truncated) history. lookup_fn /
    lookup_fns: the row gather, per role (on a mesh, the masked lookups)."""
    return seq_hidden(params, spec, item_dev, user_dev, batch,
                      lookup_fn=lookup_fn, lookup_fns=lookup_fns)[:, -1, :]


def seq_final_state_full(params, spec: SeqSpec, item_dev, user_dev, batch,
                         lookup_fn=dense_lookup,
                         lookup_fns: dict | None = None) -> torch.Tensor:
    """Final state over a history of ANY length: batch["inputs"]/["mask"]
    are [B, n·L]; the scan runs in n segments of length L, carrying (h, c).
    With left-padding this is exactly the state of the unsegmented scan."""
    L = spec.max_seq_len
    total = batch["inputs"].shape[1]
    if total % L:
        raise ValueError(f"history width {total} is not a multiple of "
                         f"max_seq_len {L}")
    n = total // L
    if n == 1:
        return seq_final_state(params, spec, item_dev, user_dev, batch,
                               lookup_fn, lookup_fns)
    states = init_states(spec, batch["inputs"].shape[0],
                         batch["inputs"].device)
    for s in range(n):
        seg = dict(batch)
        seg["inputs"] = batch["inputs"][:, s * L:(s + 1) * L]
        seg["mask"] = batch["mask"][:, s * L:(s + 1) * L]
        h, states = seq_hidden(params, spec, item_dev, user_dev, seg,
                               states=states, return_states=True,
                               lookup_fn=lookup_fn, lookup_fns=lookup_fns)
    return h[:, -1, :]


def seq_item_latents(params, spec: SeqSpec, item_dev=None,
                     lookup_fn=dense_lookup, out_lookup=None, ids=None):
    """Output-side item matrix [V, D] + bias [V] for retrieval. `lookup_fn`
    serves the tie_output (fused-encoder) path; `out_lookup` (when set)
    reads the item_out rows through a lookup: on a mesh, where the table
    is row-sharded (and stored in RowPerm order under row_shard =
    "shuffle"). `ids` (1-D, a rank's own item range) encodes those items
    instead of all; an id ≥ V reads a pad row."""
    v, d = spec.vocab, spec.dim
    if spec.tie_output:
        return encode_all_items_with_bias(params["item_in"], spec.item_in,
                                          item_dev, lookup_fn=lookup_fn,
                                          ids=ids)
    t = params["item_out"]
    if out_lookup is not None:
        if ids is None:
            ids = torch.arange(v, dtype=torch.int32, device=t.device)
        rows = out_lookup(t, ids)
        return rows[:, :d], rows[:, d].contiguous()
    # the bias column is copied out contiguous (a strided [V] view would be
    # re-read with a 4(D+1)-byte stride by every query row of the top-k)
    return t[:v, :d], t[:v, d].contiguous()
