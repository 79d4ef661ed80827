"""Hybrid matrix-factorization model family (port of `arec/models/mf.py`).

user latent = fusion of the user's attribute embeddings (the user ID is
attribute 0), item latent = fusion of the item's, score = u·v + item bias.
The state is one plain dict {"user": encoder params, "item": encoder
params} in arec's layout (`arec_torch.bridge` hands it across as it is).
The candidate side of every loss is the fused item encoder itself, and the
per-item bias is the bias column of the item encoder's fused table
(EncoderSpec.with_bias), so it rides the same row gather.

`lookup_fn` / `lookup_fns` choose the row gather per role ("user",
"item"): the sparse touched-rows step (`arec_torch.train.sparse`) passes
subset-table lookups; `sampled=(ids, p)` hands pre-drawn negatives in.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from arec_torch.config import Config
from arec_torch.data.schema import EntitySchema
from arec_torch.losses.losses import (
    batch_bpr_loss, batch_mw_loss, bpr_loss, mesh_gather_cands, mesh_mean,
    sampled_softmax_loss, warp_loss,
)
from arec_torch.rng import split
from arec_torch.tables.engine import (
    EncoderSpec, dense_lookup, encode, encode_all_items_with_bias,
    encode_with_bias, init_encoder,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class MFSpec:
    user: EncoderSpec
    item: EncoderSpec
    loss: str = "ce"
    num_sampled: int = 256
    sampler: str = "log_uniform"
    batch_ht: bool = False          # HT-correct mw/bbpr's in-batch proposal
    keep_prob: float = 1.0
    compute_dtype: str = "bfloat16"
    act_dtype: str = "float32"      # train-path activation dtype; eval and
                                    # serving encode in f32

    @staticmethod
    def from_config(cfg: Config, user_schema: EntitySchema,
                    item_schema: EntitySchema) -> "MFSpec":
        if not cfg.model.use_attributes:
            user_schema = user_schema.id_only()
            item_schema = item_schema.id_only()
        mk = lambda s, wb=False: EncoderSpec(
            s, cfg.model.dim, cfg.model.fusion, cfg.model.nonlinear,
            with_bias=wb,
            dense_mulhot_threshold=cfg.model.dense_vocab_threshold)
        return MFSpec(
            user=mk(user_schema), item=mk(item_schema, wb=True),
            loss=cfg.train.loss, num_sampled=cfg.train.num_sampled,
            sampler=cfg.train.sampler, batch_ht=cfg.train.batch_ht,
            keep_prob=cfg.model.keep_prob,
            compute_dtype=cfg.train.compute_dtype,
            act_dtype=cfg.train.act_dtype,
        )

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def act_dt(self):
        """torch dtype for train-path activations; None = float32."""
        return None if self.act_dtype == "float32" else _DTYPES[
            self.act_dtype]


def init_mf(gen: torch.Generator, spec: MFSpec, device=None) -> dict:
    """arec's MF layout, shapes and scales, drawn from `gen` on `device`
    (default `gen.device`; `meta` gives the shapes alone)."""
    return {"user": init_encoder(gen, spec.user, device),
            "item": init_encoder(gen, spec.item, device)}


def mf_loss(params: dict, spec: MFSpec, user_dev: dict, item_dev: dict,
            batch: dict, gen: torch.Generator, lookup_fn=dense_lookup,
            lookup_fns: dict | None = None, sampled: tuple | None = None,
            use_kernel: bool | None = None, mesh=None, pop=None,
            gather_cands=None) -> torch.Tensor:
    """One step's loss for a (user, positive item) batch. `gen` is the
    step's key (arec_torch.rng): it splits into the dropout and the
    negatives streams, as arec's rng does. use_kernel: the fused CE kernels
    for `ce` (see `sampled_softmax_loss`).

    mesh: the batch is this rank's "data" slab and the loss returned is
    the global one, with partial gradients (the dense mesh step; see
    `losses.mesh_mean`): `ce` through the sharded fused CE, the others as
    slab means summed over "data", mw / bbpr scoring against the global
    batch's positives. gather_cands: mw / bbpr's candidates lifted to the
    global batch, without the global mean (arec's sparse-mesh step, which
    scales the slab loss itself)."""
    if mesh is not None and gather_cands is None and spec.loss in (
            "mw", "bbpr"):
        gather_cands = mesh_gather_cands(mesh)
    lk = lookup_fns or {}
    g_drop, g_neg = split(gen, batch["user"].device)
    u = encode(params["user"], spec.user, user_dev, batch["user"],
               lk.get("user", lookup_fn), act_dtype=spec.act_dt,
               dropout_gen=g_drop, keep_prob=spec.keep_prob)

    def embed(ids):
        return encode_with_bias(params["item"], spec.item, item_dev, ids,
                                lk.get("item", lookup_fn),
                                act_dtype=spec.act_dt)

    pos = batch["pos_item"]
    vocab = spec.item.schema.num_entities
    if spec.loss == "ce":
        return sampled_softmax_loss(
            u, pos, embed, g_neg, spec.num_sampled, vocab,
            dist=spec.sampler, compute_dtype=spec.dtype, sampled=sampled,
            use_kernel=use_kernel, mesh=mesh, pop=pop)
    loss = _mf_ranking_loss(spec, u, pos, embed, g_neg, vocab, sampled, pop,
                            gather_cands)
    if mesh is not None:
        return mesh_mean(loss, pos.shape[0], mesh)
    return loss


def _mf_ranking_loss(spec, u, pos, embed, g_neg, vocab, sampled, pop,
                     gather_cands):
    """warp / bpr over the sampled negatives, mw / bbpr over the in-batch
    positives: the mean over this batch's rows."""
    # warp/bpr draw from the same spec.sampler proposal as ce and take the
    # pre-drawn `sampled`, so the sparse step's touched rows and the loss's
    # candidates are one draw
    if spec.loss == "warp":
        return warp_loss(u, pos, embed, g_neg, spec.num_sampled, vocab,
                         dist=spec.sampler, compute_dtype=spec.dtype,
                         sampled=sampled, pop=pop)
    if spec.loss == "bpr":
        return bpr_loss(u, pos, embed, g_neg, spec.num_sampled, vocab,
                        dist=spec.sampler, compute_dtype=spec.dtype,
                        sampled=sampled, pop=pop)
    # mw/bbpr reuse the in-batch positives as shared negatives: no draw
    pp = None
    if spec.batch_ht and spec.loss in ("mw", "bbpr"):
        if pop is None:
            raise ValueError(
                "train.batch_ht needs the empirical item distribution: pass "
                "pop=make_pop(item_freq, 1.0)")
        pp = pop[1]
    if spec.loss == "mw":
        return batch_mw_loss(u, pos, embed, vocab, compute_dtype=spec.dtype,
                             gather_cands=gather_cands, pop_probs=pp)
    if spec.loss == "bbpr":
        return batch_bpr_loss(u, pos, embed, compute_dtype=spec.dtype,
                              gather_cands=gather_cands, pop_probs=pp)
    raise ValueError(f"unknown mf loss {spec.loss!r}")


def mf_user_latents(params, spec: MFSpec, user_dev, user_ids,
                    lookup_fn=dense_lookup) -> torch.Tensor:
    """User latents [B, dim]; `lookup_fn`: the user table's row gather
    (on a mesh, the masked lookup over "model")."""
    return encode(params["user"], spec.user, user_dev, user_ids, lookup_fn)


def mf_item_latents(params, spec: MFSpec, item_dev, block: int = 8192,
                    lookup_fn=dense_lookup, ids=None):
    """Item latent matrix [V, dim] + bias [V] for eval and retrieval, over
    every item or, on a mesh, over `ids` (a rank's own item range)."""
    return encode_all_items_with_bias(params["item"], spec.item, item_dev,
                                      block=block, lookup_fn=lookup_fn,
                                      ids=ids)
