"""Trainer (port of `arec/train/loop.py`): training, evaluation, recommend
mode and serving, on one device or on a ("data", "model") mesh.

dataset load → model build → epoch loop with periodic eval (valid
Recall@K), plateau LR decay and checkpoint → recommend mode emitting top-K
lists. The steps are the port's (`train/step.py` dense, `train/sparse.py`
touched rows, and their mesh forms `make_mesh_step_core` and
`train/sparse_mesh.py`), so every kernel of the path runs through them:
the LSTM or GRU scan and the fused sampled-softmax CE in the loss, the
row scatter in the sparse steps' write-back.

Resume is exact, as in arec: each step's key is `step_generator(seed,
step)`, a pure function of the global step; the batch order is a pure
function of (seed, epoch); a checkpoint records the step within the epoch
(the iterator fast-forwards past consumed batches) and the plateau-decay
state (the previous window's mean loss and the open loss window).

The losses stay on the device: a step's loss joins the window as a 0-d
tensor (from a K-step dispatch, a row of its cloned [K] metrics, never the
graph's own output buffer), and the window is stacked and read back only
at the eval cadence (one host sync per `steps_per_checkpoint` steps, not
one per step). A checkpoint's host snapshot is a synchronous copy that
`Checkpointer.save` finishes before it returns, so the next replay cannot
write the parameters under it.

Config knobs arec's Trainer reads, each honoured or refused:

  steps_per_dispatch = K  on one device, K steps per dispatch as arec's
                          K-step `lax.scan`: `make_multi_step` /
                          `make_sparse_multi_step`, one CUDA graph replay
                          on the card (`train/graph.py`), dispatched only
                          from a K-aligned global step with room for K
                          before max_steps; the rest (a resume off the
                          K grid, an epoch's last partial group, the
                          steps past the last full group before
                          max_steps) are single steps, as arec fills in.
                          On a mesh K single steps: gloo's collectives
                          cannot be captured, and a multi-rank NCCL
                          capture needs cards to test it on (ROADMAP).
                          arec's `steps_per_checkpoint % K` error is kept.
  compact_table_grads     served by `engine.dense_lookup`, whose
                          `embedding` backward already groups duplicate
                          ids (the engine docstring).
  eval_recall_target < 1  periodic eval through the approximate top-k
                          (`retrieval.mips.approx_max_k`), as arec's;
                          serve_recall_target < 1 serves through it.
  a mesh (data·model > 1)   trains, serves and evaluates, one rank per
                          process (`torchrun`, or a caller that set the
                          process group up); mesh.lookup = "gspmd" trains
                          through the exchange too, on natural-order
                          tables (the port has no GSPMD).

On a mesh (`_MeshServing`) each rank holds its "model" row block of every
table (padded to a model-axis multiple, in RowPerm order under row_shard
= "shuffle") and of its optimizer state, the replicated dense weights,
and its "data" slab of each batch. Training steps through the sparse mesh
step (`train/sparse_mesh.py`) or the dense one
(`train.step.make_mesh_step_core`, its loss through the exchange lookups
and the sharded CE); train.batch_size is the GLOBAL batch, and data rank
d reads the d::data strided part of each epoch's order (arec's per-host
split), so the global batch is, as a set, the single-device one.
Checkpoints stay in the natural layout: the primary gathers the row
blocks of its data row, un-permutes and writes them, so a checkpoint
moves between one device and any mesh. Queries read their rows through
the masked lookup (`tables.sharded.make_masked_lookup`: the same ids on
every model rank); each rank encodes its own contiguous item range, from
the item table gathered whole for the encode (`gather_rows`), so the
item matrix is born row-sharded; the top-k is
`retrieval.mips.make_sharded_topk`, and hit counts are summed over
"data". Every rank reaches the same evaluations, saves and drains in the
same order; side effects (metrics, files) are the primary's.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import time

import torch
import torch.distributed as dist

from arec_torch import obs, resolve_device
from arec_torch.config import Config
from arec_torch.data.dataset import eval_batches, mf_batches, seq_batches
from arec_torch.data.io import load_or_prepare
from arec_torch.data.prefetch import prefetch, to_device
from arec_torch.dist.collectives import all_sum
from arec_torch.dist.global_io import all_hosts_concat, shard_from_hosts
from arec_torch.dist.mesh import is_primary, make_mesh, multihost_init
from arec_torch.dist.specs import (
    DATA_AXIS, TABLE_AXIS, mesh_coords, shard_rows, table_role,
    tree_leaves_with_keys, tree_map_with_keys,
)
from arec_torch.losses.sampling import make_pop
from arec_torch.models import mf as mf_mod
from arec_torch.models import seq as seq_mod
from arec_torch.retrieval.mips import make_sharded_topk
from arec_torch.tables.engine import (
    attrs_to_device, dense_lookup,
)
from arec_torch.tables.layout import RowPerm
from arec_torch.tables.sharded import (
    EXCHANGE_DROPS, gather_rows, make_masked_lookup, make_perm_dense_lookup,
    make_sharded_lookup, round_up_rows, shard_row_index,
)
from arec_torch.train import sparse as sparse_mod
from arec_torch.train.checkpoint import Checkpointer, abstract_like
from arec_torch.train.evalu import recall_hits, topk_with_mask
from arec_torch.train.metrics import MetricLogger
from arec_torch.train.profile import StepProfiler
from arec_torch.train.step import (
    TrainState, decay_lr, init_state, make_mesh_step_core, make_multi_step,
    make_optimizer, make_train_step, step_generator,
)


def build_model(cfg: Config, device):
    """The prepared dataset, the model spec of cfg's family, and the item
    and user attribute maps on `device` (None for a sequence model without
    a user encoder)."""
    ds = load_or_prepare(cfg.data)
    if cfg.model.model == "lstm":
        spec = seq_mod.SeqSpec.from_config(cfg, ds.user_schema,
                                           ds.item_schema)
        item_enc = spec.item_in
    else:
        spec = mf_mod.MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
        item_enc = spec.item
    item_dev = attrs_to_device(ds.item_attrs.restrict(item_enc.schema),
                               item_enc, device)
    user_dev = (attrs_to_device(ds.user_attrs.restrict(spec.user.schema),
                                spec.user, device)
                if spec.user is not None else None)
    return ds, spec, item_dev, user_dev


def _table_roles(is_seq: bool, spec) -> dict[str, tuple[int, int]]:
    """Lookup roles → (total_rows, dense_prefix_rows) of their table, as
    arec's `Trainer._table_roles`."""
    if is_seq:
        roles = {"item": (spec.item_in.total_rows,
                          spec.item_in.dense_region_rows)}
        if spec.user is not None:
            roles["user"] = (spec.user.total_rows,
                             spec.user.dense_region_rows)
        if not spec.tie_output:
            roles["out"] = (spec.vocab + 1, 0)
        return roles
    return {"user": (spec.user.total_rows, spec.user.dense_region_rows),
            "item": (spec.item.total_rows, spec.item.dense_region_rows)}


class _MeshServing:
    """A rank's view of the ("data", "model") mesh: the process group and
    mesh, the tables' RowPerms (row_shard = "shuffle" with lookup =
    "alltoall", as arec builds them; arec's "gspmd" lookup keeps tables
    natural), the queries' per-role lookups (`lookups`: the masked
    gather, the same ids on every model rank), and the moves between a
    whole natural state and this rank's shard of it."""

    def __init__(self, cfg: Config, spec, is_seq: bool, device):
        mc = cfg.mesh
        multihost_init(device)
        self.mesh = make_mesh(mc.data, mc.model, device)
        self.d, self.n_data, self.m, self.t = mesh_coords(self.mesh)
        self.data_group = self.mesh.get_group(DATA_AXIS)
        # the checkpoint's gather of data row 0's row blocks runs on the
        # host: over the model group where it is gloo's, else over a gloo
        # group of those ranks (made by every rank, in the same order)
        self.host_group = self.mesh.get_group(TABLE_AXIS)
        if dist.get_backend(self.host_group) != "gloo":
            self.host_group = dist.new_group(list(range(self.t)),
                                             backend="gloo")
        self.is_seq, self.spec = is_seq, spec
        roles = _table_roles(is_seq, spec)
        self.perms: dict[str, RowPerm] = {}
        if mc.lookup == "alltoall" and mc.row_shard == "shuffle":
            for role, (rows, prefix) in roles.items():
                p = RowPerm.for_rows(rows, prefix)
                if p is not None:
                    self.perms[role] = p
        self.lookups = {r: make_masked_lookup(self.mesh, self.perms.get(r))
                        for r in roles}

    def sharded(self, keys, sparse: bool) -> str | None:
        """The role of a row-sharded state leaf, else None: every table of
        the params; the optimizer state's tables too, except the sparse
        state's (1, 1) placeholders (arec's sparse_mesh_state_pspecs)."""
        role = table_role(keys)
        if role is None or (keys[0] == "opt_state" and sparse):
            return None
        return role

    def abstract(self, state, sparse: bool):
        """The state's shapes with each row-sharded leaf cut to this rank's
        block of its model-axis-padded rows (meta tensors)."""
        def cut(keys, leaf):
            if self.sharded(keys, sparse) is None:
                return leaf
            rows = round_up_rows(leaf.shape[0], self.t) // self.t
            return torch.empty((rows,) + tuple(leaf.shape[1:]),
                               dtype=leaf.dtype, device="meta")
        return type(state)(**tree_map_with_keys(cut, state._asdict()))

    def shard(self, keys, leaf, sparse: bool):
        """This rank's part of a whole natural leaf: a row-sharded leaf
        permuted into its stored order, padded and cut to this rank's row
        block (a copy, so the whole table can be freed); any other leaf
        as it is."""
        role = self.sharded(keys, sparse)
        if role is None:
            return leaf
        if role in self.perms:
            leaf = self.perms[role].permute_table(leaf)
        return shard_rows(leaf, self.mesh).clone()

    def canonical(self, state, sparse: bool, natural_rows: dict):
        """The whole state in the natural layout on the primary rank (row
        blocks on the host, gathered from data row 0's model ranks,
        un-permuted and cut to the natural rows), None on every other
        rank. Ranks of other data rows hold replicas and take no part."""
        if self.d != 0:
            return None
        primary = dist.get_rank() == 0

        def whole(keys, leaf):
            role = self.sharded(keys, sparse)
            if role is None:
                return leaf
            host = leaf.detach().cpu().contiguous()
            parts = ([torch.empty_like(host) for _ in range(self.t)]
                     if primary else None)
            dist.gather(host, parts, dst=0, group=self.host_group)
            if not primary:
                return None
            full = torch.cat(parts)[:natural_rows[keys]]
            if role in self.perms:
                full = self.perms[role].permute_table(full, inverse=True)
            return full
        tree = tree_map_with_keys(whole, state._asdict())
        return TrainState(**tree) if primary else None

    def row_index(self, natural_rows: dict, sparse: bool):
        """For the checkpoint restore: keys → the natural row behind each
        of this rank's stored rows (`shard_row_index`), None for a
        replicated leaf. natural_rows: keys → the leaf's unpadded rows."""
        def rows(keys):
            role = self.sharded(keys, sparse)
            if role is None:
                return None
            return shard_row_index(natural_rows[keys], self.t, self.m,
                                   self.perms.get(role))
        return rows

    def item_view(self, params):
        """(params, lookup_fn, out_lookup) for the item-latent encode: the
        item side's table gathered whole over "model" (`gather_rows`),
        read through its RowPerm when it is stored shuffled."""
        def lookup(role):
            p = self.perms.get(role)
            return dense_lookup if p is None else make_perm_dense_lookup(p)

        def whole(enc):
            return {**enc, "tables": {k: gather_rows(t, self.mesh)
                                      for k, t in enc["tables"].items()}}
        if not self.is_seq:
            return {**params, "item": whole(params["item"])}, \
                lookup("item"), None
        if self.spec.tie_output:
            return {**params, "item_in": whole(params["item_in"])}, \
                lookup("item"), None
        return {**params, "item_out": gather_rows(params["item_out"],
                                                  self.mesh)}, \
            dense_lookup, lookup("out")

    def item_ids(self, vocab: int, device) -> torch.Tensor:
        """This rank's contiguous item range of the model-axis-padded item
        matrix, pad positions as the pad id `vocab`."""
        vs = -(-vocab // self.t)
        ids = torch.arange(self.m * vs, (self.m + 1) * vs, device=device)
        return ids.clamp(max=vocab).to(torch.int32)


def _item_latents(cfg: Config, spec, params, item_dev, sh=None):
    """The item latent matrix + bias: every item on one device; on a mesh
    (`sh`) this rank's row block of it, padded as `pad_item_shards` pads
    (zero latents, bias −1e9). serve_latents_dtype="compute" pre-casts
    the matrix to the compute dtype once (scores are unchanged: top-k
    casts its operands anyway)."""
    ids, lk, out_lk = None, dense_lookup, None
    if sh is not None:
        vocab = (spec.item.schema.num_entities
                 if isinstance(spec, mf_mod.MFSpec) else spec.vocab)
        ids = sh.item_ids(vocab, _device_of(params))
        params, lk, out_lk = sh.item_view(params)
    if isinstance(spec, mf_mod.MFSpec):
        v, b = mf_mod.mf_item_latents(params, spec, item_dev, lookup_fn=lk,
                                      ids=ids)
    else:
        v, b = seq_mod.seq_item_latents(params, spec, item_dev,
                                        lookup_fn=lk, out_lookup=out_lk,
                                        ids=ids)
    if ids is not None:
        pad = ids >= vocab
        v = torch.where(pad[:, None], 0.0, v)
        b = torch.where(pad, -1e9, b)
    if cfg.train.serve_latents_dtype == "compute":
        v = v.to(spec.dtype)
    return v, b


def _device_of(params):
    return next(leaf for _, leaf in tree_leaves_with_keys(params)).device


def _query_fn(spec, params, item_dev, user_dev, batch, sh=None):
    """Eval / serving query encode: MF's user latents, or the final
    recurrent state after each history; on a mesh through the masked
    lookups."""
    lks = {} if sh is None else sh.lookups
    if isinstance(spec, mf_mod.MFSpec):
        return mf_mod.mf_user_latents(params, spec, user_dev, batch["user"],
                                      lookup_fn=lks.get("user",
                                                        dense_lookup))
    return seq_mod.seq_final_state_full(
        params, spec, item_dev, user_dev, batch,
        lookup_fn=lks.get("item", dense_lookup), lookup_fns=lks or None)


def _serve_step(cfg: Config, spec, item_dev, user_dev, k: int, sh=None):
    """Per-batch serving step: queries → seen-masked top-k, exact or, with
    serve_recall_target < 1, approximate. Like arec's single-device step
    it passes no compute dtype to the top-k, so the scores take bf16
    operands even when the model computes in f32; on a mesh it is arec's
    sharded top-k in the model's compute dtype, over this rank's slab."""
    target = cfg.train.serve_recall_target
    mem = cfg.train.serve_score_mem_mb
    if sh is None:
        topk = functools.partial(topk_with_mask, k=k, recall_target=target,
                                 score_mem_mb=mem)
    else:
        topk = make_sharded_topk(sh.mesh, k=k, compute_dtype=spec.dtype,
                                 recall_target=target, score_mem_mb=mem)

    def step(params, v, b, batch, seen):
        with obs.span("serve.query"):
            q = _query_fn(spec, params, item_dev, user_dev, batch, sh)
        with obs.span("serve.topk", stream=q.device):
            return topk(q, v, b, seen)
    return step


class Trainer:
    def __init__(self, cfg: Config, serve_only: bool = False, device=None):
        """serve_only=True builds a restore-only trainer: the state is
        shaped on the `meta` device (no random init and no optimizer
        state; at XING scale those are gigabytes that the restore would
        overwrite) and no step function is built. evaluate(), recommend()
        and the serving helpers work as usual; train() raises.
        device: where to run; None = `cuda`, or under a launcher the rank's
        `cuda:{LOCAL_RANK}` (raises if there is none).

        On a mesh (cfg.mesh data × model > 1) this process is one rank of
        the process group (`torchrun`, or one its caller initialised) and
        holds its shard of the state: the tables are initialised whole
        from the seed, as on one device, then cut to its row block."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.serve_only = serve_only
        t = cfg.train
        self.is_seq = cfg.model.model == "lstm"
        self.ds, self.spec, self.item_dev, self.user_dev = build_model(
            cfg, self.device)
        self.lookup = dense_lookup   # also for compact_table_grads
        self.sh = (_MeshServing(cfg, self.spec, self.is_seq, self.device)
                   if cfg.mesh.data * cfg.mesh.model > 1 else None)
        if self.sh is not None and t.batch_size % self.sh.n_data:
            raise ValueError(
                f"train.batch_size ({t.batch_size}) is the GLOBAL batch and "
                f"must divide by mesh.data ({self.sh.n_data})")

        # sampler proposal, as arec's (`arec/train/loop.py:204-225`)
        if t.batch_ht and t.loss not in ("mw", "bbpr"):
            raise ValueError(
                "train.batch_ht only applies to the in-batch losses "
                f"(loss=mw|bbpr); got model={cfg.model.model!r} "
                f"loss={t.loss!r}")
        if t.batch_ht:
            self.pop = make_pop(self.ds.item_freq, 1.0, self.device)
        elif t.sampler == "pop":
            self.pop = make_pop(self.ds.item_freq, t.sampler_power,
                                self.device)
        else:
            self.pop = None

        self.opt = make_optimizer(t.optimizer, t.learning_rate)
        self.sparse = t.sparse_update
        self._paths = sparse_mod.table_paths(self.is_seq, self.spec)
        init = seq_mod.init_seq if self.is_seq else mf_mod.init_mf
        # the whole state's shapes: the natural rows of every leaf, and
        # the serve-only state
        shapes = self._init_state(init(torch.Generator().manual_seed(
            t.seed), self.spec, device="meta"))
        self._natural_rows = {keys: leaf.shape[0] for keys, leaf in
                              tree_leaves_with_keys(shapes._asdict())
                              if leaf.dim()}
        if serve_only:
            self.state = shapes
            if self.sh is not None:
                self.state = self.sh.abstract(self.state, self.sparse)
        else:
            params = init(torch.Generator(device=self.device).manual_seed(
                t.seed), self.spec)
            if self.sh is not None:
                params = tree_map_with_keys(
                    lambda keys, leaf: self.sh.shard(("params",) + keys,
                                                     leaf, self.sparse),
                    params)
            self.state = self._init_state(params)
            del params
            self.step_fn = self._make_step()
        del shapes

        self.dispatch_k = t.steps_per_dispatch
        self.multi_step_fn = None
        if self.dispatch_k > 1 and not serve_only:
            if t.steps_per_checkpoint % self.dispatch_k:
                raise ValueError(
                    "steps_per_checkpoint must be a multiple of "
                    f"steps_per_dispatch ({t.steps_per_checkpoint} % "
                    f"{self.dispatch_k})")
            if self.sh is None:
                self.multi_step_fn = self._make_multi_step()

        self.ckpt = Checkpointer(t.train_dir, async_save=t.async_ckpt)
        self.metrics = MetricLogger(t.train_dir, tensorboard=t.tensorboard,
                                    enabled=not serve_only and is_primary())
        self.start_epoch = 0
        self.start_step_in_epoch = 0
        self._resume = {"prev_loss": None, "window": [], "best_recall": 0.0}
        self._maybe_restore()

    # ------------------------------------------------------------------
    def _init_state(self, params):
        if self.sparse:
            return sparse_mod.init_sparse_state(
                params, self._paths, self.opt, self.cfg.train.optimizer)
        return init_state(params, self.opt)

    def _make_step(self):
        """The step of this run: sparse or dense, on one device or on the
        mesh (arec's `loop.py:255-296`)."""
        t = self.cfg.train
        if self.sh is not None and self.sparse:
            from arec_torch.train.sparse_mesh import (
                make_sparse_mesh_step_core,
            )
            return make_sparse_mesh_step_core(
                self.sh.mesh, self.is_seq, self.spec, self.user_dev,
                self.item_dev, self.opt, t.learning_rate, t.optimizer,
                pop=self.pop, perms=self.sh.perms)
        if self.sparse:
            return sparse_mod.make_sparse_train_step(
                self.is_seq, self.spec, self.user_dev, self.item_dev,
                self.opt, t.learning_rate, t.optimizer, pop=self.pop)
        if self.sh is not None:
            return make_mesh_step_core(
                self._loss_fn(), self.opt, t.learning_rate, self.sh.mesh)
        return make_train_step(self._loss_fn(), self.opt, t.learning_rate)

    def _make_multi_step(self):
        """K steps per dispatch on one device (arec's `loop.py:301-325`);
        on a mesh the Trainer takes K single steps."""
        t = self.cfg.train
        if self.sparse:
            return sparse_mod.make_sparse_multi_step(
                self.is_seq, self.spec, self.user_dev, self.item_dev,
                self.opt, t.learning_rate, t.optimizer, pop=self.pop,
                k=self.dispatch_k)
        return make_multi_step(self._loss_fn(), self.opt, t.learning_rate,
                               self.dispatch_k)

    def _loss_fn(self):
        """The dense step's loss: on one device through `dense_lookup`,
        time-major for the sequence family; on the mesh through the
        per-role exchange lookups (arec's `loop.py:126-158`), batch-major,
        with the global loss of `mesh=`."""
        spec, lookup, pop = self.spec, self.lookup, self.pop
        item_dev, user_dev = self.item_dev, self.user_dev
        mesh, lookup_fns = None, None
        if self.sh is not None:
            mc = self.cfg.mesh
            mesh = self.sh.mesh
            lookup = make_sharded_lookup(mesh, mc.capacity_factor,
                                         dedup=mc.dedup)
            lookup_fns = {role: make_sharded_lookup(
                mesh, mc.capacity_factor, dedup=mc.dedup,
                perm=self.sh.perms.get(role))
                for role in _table_roles(self.is_seq, spec)}
        if self.is_seq:
            def loss_fn(p, batch, gen):
                return seq_mod.seq_loss(p, spec, item_dev, user_dev, batch,
                                        gen, lookup_fn=lookup,
                                        lookup_fns=lookup_fns,
                                        time_major=mesh is None, mesh=mesh,
                                        pop=pop)
        else:
            def loss_fn(p, batch, gen):
                return mf_mod.mf_loss(p, spec, user_dev, item_dev, batch,
                                      gen, lookup_fn=lookup,
                                      lookup_fns=lookup_fns, mesh=mesh,
                                      pop=pop)
        return loss_fn

    def _batches(self, epoch: int):
        """This rank's batches of `epoch`: on one device the whole batch;
        on a mesh data rank d's batch_size/data rows of each global batch,
        from the d::data part of the epoch's order (arec's per-host
        iterators), cut to the global batch count so that every data rank
        takes the same number of steps."""
        t = self.cfg.train
        d, nd = (0, 1) if self.sh is None else (self.sh.d, self.sh.n_data)
        b = t.batch_size // nd
        if self.is_seq:
            it = seq_batches(self.ds, b, self.spec.pack_len, t.seed, epoch,
                             d, nd)
            n = int((self.ds.hist_lengths >= 2).sum())
            count = max(n // t.batch_size, 1 if n else 0)
        else:
            it = mf_batches(self.ds, b, t.seed, epoch, d, nd)
            count = len(self.ds.train_users) // t.batch_size
        return it if nd == 1 else itertools.islice(it, count)

    def _eval_params(self):
        """Plain param tree for eval paths (sparse Adagrad stores tables
        packed [V, 2D]; these are views of their param halves)."""
        if self.sparse and self.cfg.train.optimizer == "adagrad":
            return sparse_mod.unpack_params(self.state.params, self._paths)
        return self.state.params

    def _item_latents(self, params=None):
        params = self._eval_params() if params is None else params
        return _item_latents(self.cfg, self.spec, params, self.item_dev,
                             self.sh)

    def _query_fn(self, params, batch):
        return _query_fn(self.spec, params, self.item_dev, self.user_dev,
                         batch, self.sh)

    def _stage_eval(self, batch):
        """An eval batch and its users' seen slab on the device: the whole
        batch, or on a mesh this rank's "data" slab of it. The copy is
        synchronous: eval batches are staged on the calling thread, one at
        a time, with no step queued behind which to hide it."""
        tb = shard_from_hosts({**batch, "seen": self.ds.seen_items[
            batch["user"]]}, None if self.sh is None else self.sh.mesh,
            self.device)
        return tb, tb.pop("seen")

    def _eval_step(self, k: int, target: float):
        """Per-batch (hits, count) for Recall@K; on a mesh through the
        sharded top-k in the model's compute dtype, as arec's mesh eval
        step, with the counts summed over "data"."""
        if self.sh is None:
            def step(params, v, b, tb, seen):
                return recall_hits(self._query_fn(params, tb), v, b, seen,
                                   tb["pos_item"], tb["valid"], k=k,
                                   recall_target=target)
            return step
        topk = make_sharded_topk(self.sh.mesh, k=k,
                                 compute_dtype=self.spec.dtype,
                                 recall_target=target)

        def mesh_step(params, v, b, tb, seen):
            _, ids = topk(self._query_fn(params, tb), v, b, seen)
            hit = (ids == tb["pos_item"][:, None]).any(dim=1).float()
            hc = torch.stack([(hit * tb["valid"]).sum(), tb["valid"].sum()])
            dist.all_reduce(hc, group=self.sh.data_group)
            return hc[0], hc[1]
        return mesh_step

    @torch.no_grad()
    def evaluate(self, k: int | None = None, exact: bool = False) -> float:
        """Valid Recall@K with seen-item masking. exact=True overrides the
        periodic-eval cost knobs (train.eval_max_batches subsampling and
        the eval_recall_target approximate top-k): the number to
        report."""
        t = self.cfg.train
        k = k or t.eval_topk
        params = self._eval_params()
        v, b = self._item_latents(params)
        hits = total = 0.0
        n = 0
        cap = 0 if exact else t.eval_max_batches
        step = self._eval_step(k, 1.0 if exact else t.eval_recall_target)
        L = self.spec.pack_len if self.is_seq else 0
        for batch in eval_batches(self.ds, t.eval_batch_size,
                                  max_seq_len=L):
            tb, seen = self._stage_eval(batch)
            h, c = step(params, v, b, tb, seen)
            hits += float(h)
            total += float(c)
            n += 1
            if cap and n >= cap:
                break
        return hits / max(total, 1.0)

    @torch.no_grad()
    def recommend(self, k: int | None = None, out_path: str | None = None):
        """Top-K lists for every eval user; with out_path, also the
        submission file, one `user\\tid,id,...` line per user. On a mesh
        every rank returns the whole list (each batch's slabs gathered over
        "data"), and only the primary rank writes the file."""
        t = self.cfg.train
        k = k or t.eval_topk
        params = self._eval_params()
        v, b = self._item_latents(params)
        step = _serve_step(self.cfg, self.spec, self.item_dev, self.user_dev,
                           k, self.sh)
        rows = []
        L = self.spec.pack_len if self.is_seq else 0
        for batch in eval_batches(self.ds, t.eval_batch_size,
                                  max_seq_len=L):
            tb, seen = self._stage_eval(batch)
            _, ids = step(params, v, b, tb, seen)
            ids = (ids.cpu().numpy() if self.sh is None else
                   all_hosts_concat(ids, self.sh.data_group))
            for u, row, ok in zip(batch["user"], ids, batch["valid"]):
                if ok:
                    rows.append((int(u), row.tolist()))
        if out_path and is_primary():
            with open(out_path, "w") as f:
                for u, items in rows:
                    f.write(f"{u}\t{','.join(map(str, items))}\n")
        return rows

    # ------------------------------------------------------------------
    @staticmethod
    def _data_pos(pos: dict, prev_loss: float, window,
                  best_recall: float) -> dict:
        """Checkpoint position metadata: data-iterator position plus the
        plateau-decay / best-metric state (JSON-safe: inf → None)."""
        return {"epoch": pos["epoch"],
                "step_in_epoch": pos["step_in_epoch"],
                "prev_loss": (None if prev_loss == float("inf")
                              else float(prev_loss)),
                "window": [float(x) for x in window],
                "best_recall": float(best_recall)}

    def _maybe_restore(self) -> None:
        """Restore the latest checkpoint, if there is one; a checkpoint
        that exists must restore (training a fresh model over a populated
        train_dir would corrupt the run). The current state is dropped
        first, so the card never holds two."""
        step = self.latest_step()
        if step is None:
            return
        self.state = abstract_like(self.state)
        rows = (None if self.sh is None else
                self.sh.row_index(self._natural_rows, self.sparse))
        self.state, data_pos, _ = self.ckpt.restore(self.state, self.device,
                                                    rows=rows, step=step)
        self.start_epoch = int(data_pos.get("epoch", 0))
        self.start_step_in_epoch = int(data_pos.get("step_in_epoch", 0))
        self._resume = {"prev_loss": data_pos.get("prev_loss"),
                        "window": list(data_pos.get("window", [])),
                        "best_recall": float(data_pos.get("best_recall",
                                                          0.0))}
        print(f"[ckpt] restored step {int(self.state.step)} "
              f"(epoch {self.start_epoch}+{self.start_step_in_epoch} "
              f"steps)", flush=True)

    def latest_step(self):
        """The newest complete checkpoint step; on a mesh the primary
        rank's reading, so every rank restores the same step even while a
        save lands."""
        step = self.ckpt.latest_step()
        if self.sh is not None:
            box = [step]
            dist.broadcast_object_list(box, src=0)
            step = box[0]
        return step

    def save(self, step: int, data_pos: dict) -> None:
        """Checkpoint the state at `step` in the natural layout (arec's
        `_canonical_state`): on a mesh the primary gathers the row blocks
        and writes; every rank calls this at the same points."""
        state = self.state
        if self.sh is not None:
            state = self.sh.canonical(state, self.sparse, self._natural_rows)
            if state is None:
                return
        self.ckpt.save(step, state, data_pos, self.cfg.to_json())

    @property
    def _chips(self) -> int:
        return 1 if self.sh is None else dist.get_world_size()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self) -> dict:
        """Epoch loop with periodic eval, plateau LR decay and checkpoint.
        Returns the final metrics summary."""
        if self.serve_only:
            raise RuntimeError("Trainer(serve_only=True) cannot train — "
                               "construct a full Trainer")
        t = self.cfg.train
        best_recall = self._resume["best_recall"]
        rp = self._resume["prev_loss"]
        prev_loss = float("inf") if rp is None else float(rp)
        window = [torch.tensor(x, dtype=torch.float32, device=self.device)
                  for x in self._resume["window"]]
        steps_done = int(self.state.step)
        ex_since, t_since = 0, time.time()
        profiler = StepProfiler(self.device)
        skip = self.start_step_in_epoch
        pos = {"step_in_epoch": 0, "epoch": self.start_epoch}
        eval_events = 0

        def after_step(loss, lr) -> bool:
            """Counters + periodic eval / plateau decay / checkpoint.
            Returns True when max_steps is reached."""
            nonlocal steps_done, ex_since, t_since, best_recall, prev_loss
            nonlocal eval_events
            window.append(loss)
            ex_since += t.batch_size
            steps_done += 1
            pos["step_in_epoch"] += 1
            if steps_done % t.steps_per_checkpoint == 0:
                self._sync()
                dt = time.time() - t_since
                mean_loss = float(torch.stack(window).mean())
                recall = self.evaluate()
                best_recall = max(best_recall, recall)
                extra = {}
                if self.sh is not None and self.cfg.mesh.capacity_factor > 0:
                    # overflowed exchange requests since the last eval,
                    # over every rank (capacity_factor 0 cannot overflow)
                    extra["exchange_dropped"] = int(all_sum(torch.tensor(
                        EXCHANGE_DROPS.read_and_reset(),
                        device=self.device)))
                self.metrics.log(
                    steps_done, loss=mean_loss, recall_at_k=recall,
                    lr=float(lr), examples_per_s=ex_since / dt,
                    examples_per_s_per_chip=ex_since / dt / self._chips,
                    **extra)
                if mean_loss > prev_loss:        # plateau decay
                    self.state = decay_lr(self.state, t.lr_decay)
                prev_loss = mean_loss
                window.clear()
                ex_since, t_since = 0, time.time()
                eval_events += 1
                # steps_per_checkpoint is the EVAL cadence; saves ride
                # every Nth eval (the final checkpoint is always written)
                if eval_events % max(t.save_every_evals, 1) == 0:
                    self.save(steps_done, self._data_pos(
                        pos, prev_loss, window, best_recall))
            return bool(t.max_steps and steps_done >= t.max_steps)

        def single(tb) -> bool:
            profiler.on_step(steps_done)
            self.state, m = self.step_fn(
                self.state, tb, step_generator(t.seed, steps_done))
            return after_step(m["loss"], m["lr"])

        def multi(pending) -> bool:
            profiler.on_step(steps_done, K)
            self.state, ms = self.multi_step_fn(
                self.state, pending,
                [step_generator(t.seed, steps_done + i) for i in range(K)])
            for i in range(K):
                if after_step(ms["loss"][i], ms["lr"][i]):
                    return True
            return False

        # unlike arec, a run restored at max_steps takes no further step
        stop = bool(t.max_steps and steps_done >= t.max_steps)
        K = self.dispatch_k
        depth = max(2, K + 1)
        stage = to_device(self.device, depth)   # one pinned ring per run
        for epoch in range(self.start_epoch, t.n_epoch):
            if stop:
                break
            batches = self._batches(epoch)
            pos["epoch"], pos["step_in_epoch"] = epoch, 0
            if skip:
                batches = itertools.islice(batches, skip, None)
                pos["step_in_epoch"] = skip
                skip = 0
            with contextlib.closing(prefetch(batches, depth=depth,
                                             transform=stage)) as it:
                pending = []
                for tb in it:
                    pending.append(tb)
                    # K steps at once only from a K-aligned global step
                    # with room for K (arec's `loop.py:869-898`); single
                    # steps fill in around them
                    room = t.max_steps - steps_done if t.max_steps else K
                    if (self.multi_step_fn is not None
                            and steps_done % K == 0 and room >= K):
                        if len(pending) < K:
                            continue
                        stop = multi(pending)
                        pending = []
                    else:
                        stop = single(pending.pop(0))
                    if stop:
                        break
                # the epoch's tail: fewer than K batches held
                for tb in pending:
                    if stop:
                        break
                    stop = single(tb)
        profiler.close()
        self.ckpt.drain()   # async saves: publish before the step check
        if steps_done and self.latest_step() != steps_done:
            # the final checkpoint: a tail shorter than steps_per_checkpoint
            # must not be lost (serving restores the latest step)
            self.save(steps_done, self._data_pos(pos, prev_loss, window,
                                                 best_recall))
            self.ckpt.drain()
        approx = bool(t.eval_max_batches) or t.eval_recall_target < 1.0
        final_recall = self.evaluate()
        if approx and is_primary():
            print("[eval] WARNING: final recall_at_k is APPROXIMATE "
                  f"(eval_max_batches={t.eval_max_batches}, "
                  f"eval_recall_target={t.eval_recall_target}); call "
                  "trainer.evaluate(exact=True) for the exact metric",
                  flush=True)
        best_recall = max(best_recall, final_recall)
        self.metrics.log(steps_done, final_recall_at_k=final_recall,
                         best_recall_at_k=best_recall,
                         final_eval_approximate=float(approx))
        return {"steps": steps_done, "recall_at_k": final_recall,
                "best_recall_at_k": best_recall}

    def close(self) -> None:
        """Publish an in-flight checkpoint write and close the metrics
        stream."""
        self.ckpt.drain()
        self.metrics.close()
