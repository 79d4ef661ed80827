"""Standing serving layer (port of `arec/serve.py`): restore a trained
checkpoint once, hold the weights and the item latent matrix on the
device, and answer batched top-K requests — raw item histories (sequence
family, `from_histories`) or user ids (MF family, `for_users`).

The path is arec's: `Recommender.__init__` restores the latest checkpoint
under cfg.train.train_dir through a serve-only `Trainer` (its state shaped
on the `meta` device, so no random tables or optimizer state are built),
then item latents (pre-cast to the compute dtype) → per batch `_query_fn`
→ the sequence family's `seq_final_state_full` (the carried-state
segmented scan, through the CUDA LSTM or GRU kernel with
`use_pallas_scan`) or MF's `mf_user_latents` → seen-masked top-k.
A dispatch holds at most `serve_batch` requests, padded to its row
bucket: the least of 8 · 4^j (j >= 0) that holds its live requests,
capped at serve_batch (8, 32, 128, 256 at serve_batch 256), so that one
request is encoded and ranked as 8 rows, not 256. On a mesh the bucket
is serve_batch, so that each rank's "data" slab keeps its size. Each
batch's build, H2D copy, query, top-k and D2H wait are the spans
`serve.batch`, `serve.h2d`, `serve.query`, `serve.topk` and `serve.d2h`,
its live and dispatched rows (the bucket's) the counters
`serve.rows_live` and `serve.rows`
(`arec_torch.obs`, recorded while a torch profiler records). `refresh()`
follows training in place: the newest checkpoint re-restored into the live
object, the old state freed first, so residency never doubles.

On one card with the exact top-k (a CUDA device, no mesh,
serve_recall_target >= 1) a call is answered by CUDA graph replays, so the
host issues two replays instead of the step's ops one by one. The key is
the batch's shapes: its row bucket, the segment count of a history batch
(its width n·max_seq_len) and the seen slab's width. Every call, on any
path, sizes that slab to a bucket too: the least floor · 2^j that holds
the longest seen row (the floor is n·max_seq_len rounded up to 32 for a
history batch, a history being its own seen list, and 32 for MF), padded
with −1, which names no item. The first call of a key runs
`train/loop._serve_parts`' query encode and top-k once eagerly on a side
stream, then captures each as its own graph (`serve.query` and
`serve.topk` then time the two replays), all keys in one memory pool, up
to MAX_GRAPHS keys; a call past them runs the eager step. Each key holds
its batch leaves on the device and a pinned host mirror of them: a batch
is copied into the mirror and sent with one non-blocking H2D copy a leaf,
and the ids come back into a pinned buffer behind an event. `refresh()`
drops every graph, since they hold the old weights' addresses; the next
call captures anew. Elsewhere (the CPU, a mesh, the approximate top-k)
each call runs the eager step. The counters `serve.graph_replays` and
`serve.graph_captures` count the calls answered by replay and the keys
captured.

Weights may also be handed in as an arec-layout param tree (numpy or
torch; see `arec_torch.bridge`); such a Recommender follows no checkpoint.
An MF tree may be the sparse step's packed one (tables [V, 2D]); it is
read through `unpack_params`, as arec's `Trainer._eval_params` does. With
serve_recall_target < 1 the top-k is the approximate one of
`retrieval.mips` (`approx_max_k` over top-(k+S) candidates), as in arec.

On a mesh (cfg.mesh data × model > 1) the process is one rank of the
process group (`torchrun --nproc-per-node N -m arec_torch.serve ...`, or
a caller that initialised the group): it holds its row block of the
tables and of the item matrix (`pad_item_shards`' padding), encodes its
"data" slab of each padded batch, runs the sharded top-k, and gathers the
[B, k] lists over "data", so every rank returns the whole answer (arec's
replicated out_shardings). Every rank must make the same calls in the
same order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from arec_torch import bridge, obs, resolve_device
from arec_torch.config import Config
from arec_torch.dist.global_io import all_hosts_concat, shard_from_hosts
from arec_torch.models import mf as mf_mod
from arec_torch.train.loop import (
    Trainer, _item_latents, _MeshServing, _serve_parts, _serve_step,
    build_model,
)
from arec_torch.train.sparse import get_path, table_paths, unpack_params


def _mf_params(spec, params):
    """A plain MF param tree: the sparse step's packed tables ([V, 2D])
    are read through unpack_params; any other width raises."""
    paths = table_paths(False, spec)
    widths = [get_path(params, p).shape[1] for p in paths]
    want = [spec.user.width, spec.item.width]
    if widths == [2 * w for w in want]:
        return unpack_params(params, paths)
    if widths != want:
        raise ValueError(f"MF tables of width {widths}: neither plain "
                         f"{want} nor packed {[2 * w for w in want]}")
    return params


def _pad_seen(seen, n: int, width: int) -> np.ndarray:
    """[n, width] int32, PAD = -1. Rows longer than `width` keep their LAST
    (most recent) ids."""
    out = np.full((n, max(width, 1)), -1, np.int32)
    if seen is not None:
        for i, row in enumerate(seen):
            row = list(row)[-out.shape[1]:]
            out[i, : len(row)] = row
    return out


def _bucket_rows(n_live: int, serve_batch: int, sharded: bool) -> int:
    """Batch rows for one dispatch of `n_live` requests: the least of
    8 · 4^j (j >= 0) that holds them, capped at serve_batch, so that calls
    share a few row counts, a graph key each. None is below 8: the scan's
    tensor-core launch takes 8 rows a CTA, so fewer cost as much. On a
    mesh, serve_batch, so that each rank's "data" slab keeps its size."""
    if sharded:
        return serve_batch
    rows = 8
    while rows < n_live:
        rows *= 4
    return min(rows, serve_batch)


def _bucket_width(seen, floor: int) -> int:
    """Slab width for one call: the least of floor · 2^j (j >= 0) that
    holds the longest seen row, so that calls share a few widths."""
    w = max((len(row) for row in seen), default=0) if seen is not None \
        else 0
    width = floor
    while width < w:
        width *= 2
    return width


MAX_GRAPHS = 16   # input shapes a Recommender captures; past them, eager


def _graphed(device: torch.device, sharded: bool,
             recall_target: float) -> bool:
    """Whether a Recommender answers its calls by CUDA graph replays: on
    one card (no mesh, whose gathers are collectives), with the exact
    top-k (the fused kernels)."""
    return device.type == "cuda" and not sharded and recall_target >= 1.0


def _graph_key(batch: dict) -> tuple:
    """A numpy batch's captured shape: each leaf's name, shape and dtype."""
    return tuple((name, a.shape, a.dtype.str)
                 for name, a in sorted(batch.items()))


class _ServeGraph:
    """One key's serve step as two CUDA graphs, the query encode and the
    seen-masked top-k, over static device inputs with a pinned host
    mirror (see the module docstring). Built from the key's first batch:
    one eager run on a side stream, then the two captures in `pool`, with
    the program's spans and counters suspended."""

    def __init__(self, batch: dict, query, topk, params, v, b, pool):
        self.device = v.device
        self.host = {name: torch.from_numpy(a).pin_memory()
                     for name, a in batch.items()}
        self.host_np = {name: t.numpy() for name, t in self.host.items()}
        self.dev = {name: t.to(self.device) for name, t in self.host.items()}
        inputs = dict(self.dev)
        seen = inputs.pop("seen")
        # graphs capture and replay on the current device's stream
        with torch.cuda.device(self.device), obs.suspended():
            stream = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                topk(query(params, inputs), v, b, seen)
            stream.wait_stream(side)
            self.query = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.query, pool=pool,
                                  capture_error_mode="thread_local"):
                self.q = query(params, inputs)
            self.topk = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.topk, pool=pool,
                                  capture_error_mode="thread_local"):
                self.scores, self.ids = topk(self.q, v, b, seen)
            self.done = torch.cuda.Event()
        self.ids_host = torch.empty(self.ids.shape, dtype=self.ids.dtype,
                                    pin_memory=True)
        self.ids_np = self.ids_host.numpy()

    def __call__(self, batch: dict) -> np.ndarray:
        """The [B, k] ids of one batch of the key's shapes, in a host
        buffer that the key's next call overwrites."""
        with torch.cuda.device(self.device):
            with obs.span("serve.h2d"):
                for name, a in batch.items():
                    np.copyto(self.host_np[name], a)
                    self.dev[name].copy_(self.host[name], non_blocking=True)
            with obs.span("serve.query"):
                self.query.replay()
            with obs.span("serve.topk", stream=self.device):
                self.topk.replay()
            with obs.span("serve.d2h"):
                self.ids_host.copy_(self.ids, non_blocking=True)
                self.done.record()
                self.done.synchronize()
        return self.ids_np


class Recommender:
    """Load the latest checkpoint under cfg.train.train_dir and serve.

    Args:
      cfg: the training Config (the same JSON the run used).
      params: None (restore the latest checkpoint, and raise
        FileNotFoundError when there is none), or an arec-layout param
        tree handed over as it is, numpy arrays or torch tensors
        (`arec_torch.bridge`), e.g. `jax.tree.map(np.asarray, params)`.
      k: list length per request (default cfg.train.eval_topk).
      serve_batch: the most requests a dispatch holds. A dispatch is
        padded to its row bucket (`_bucket_rows`): the least of 8 · 4^j
        rows that holds its requests, at most serve_batch; on a mesh,
        serve_batch.
      seen_width: width of the per-request seen-id slab; None sizes it per
        call to the bucket that holds the longest seen list, so no
        exclusion list is truncated.
      device: where to serve; None = `cuda` (raises if there is none).

    On one card with the exact top-k, each call is answered by CUDA graph
    replays of the query encode and the top-k, captured at the first call
    of each input shape (the row bucket, the history batch's segment count
    and the seen slab's bucket width; up to MAX_GRAPHS shapes, then the
    eager step);
    `refresh()` drops the graphs. Elsewhere each call runs the eager step.
    """

    def __init__(self, cfg: Config, params=None, k: int | None = None,
                 serve_batch: int = 256, seen_width: int | None = None,
                 device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and (
                torch.backends.cuda.matmul.allow_tf32):
            raise RuntimeError(
                "TF32 matmuls change the scores and the scan's products; "
                "set torch.backends.cuda.matmul.allow_tf32 = False")
        self.cfg = cfg
        self.k = k or cfg.train.eval_topk
        self.serve_batch = serve_batch
        self.seen_width = None if seen_width is None else max(seen_width, 1)
        if params is None:
            t = self._trainer = Trainer(cfg, serve_only=True,
                                        device=self.device)
            if t.latest_step() is None:
                raise FileNotFoundError(
                    f"no checkpoint under {cfg.train.train_dir!r} — refusing "
                    "to serve an untrained model")
            self._ds, self.spec = t.ds, t.spec
            self._item_dev, self._user_dev = t.item_dev, t.user_dev
            self._sh = t.sh
            self._params = t._eval_params()
            # checkpoints are labelled with the global step, so the
            # restored state's step is the label refresh() compares against
            self._restored_step = int(t.state.step)
        else:
            self._trainer = None
            self._ds, self.spec, self._item_dev, self._user_dev = (
                build_model(cfg, self.device))
            self._sh = None
            if cfg.mesh.data * cfg.mesh.model > 1:
                self._sh = _MeshServing(cfg, self.spec, not isinstance(
                    self.spec, mf_mod.MFSpec), self.device)
                self._params = bridge.shard_params(
                    params, self._sh.mesh, self._sh.perms, self.device)
            else:
                self._params = bridge.to_torch(params, self.device)
            if isinstance(self.spec, mf_mod.MFSpec):
                self._params = _mf_params(self.spec, self._params)
            self._restored_step = None   # handed in, not restored
        self.is_seq = not isinstance(self.spec, mf_mod.MFSpec)
        if self._sh is not None and serve_batch % self._sh.n_data:
            raise ValueError(f"serve_batch {serve_batch} does not split "
                             f"over {self._sh.n_data} data ranks")
        with torch.inference_mode():
            self._vb = _item_latents(cfg, self.spec, self._params,
                                     self._item_dev, self._sh)
        self._parts = _serve_parts(cfg, self.spec, self._item_dev,
                                   self._user_dev, self.k, self._sh)
        self._step = _serve_step(*self._parts)
        self._graphs = ({} if _graphed(self.device, self._sh is not None,
                                       cfg.train.serve_recall_target)
                        else None)
        self._pool = None

    def refresh(self) -> bool:
        """Pick up the newest checkpoint in place: re-restore, re-encode the
        item latent matrix and swap, keeping the same step function. The
        old params and latents are dropped before the restore, so peak
        residency never doubles; a failed refresh therefore leaves nothing
        to serve, and says so.

        Returns True when a newer checkpoint was loaded, False when the
        latest checkpoint is the one being served. Not safe to call
        concurrently with for_users / from_histories."""
        t = self._trainer
        if t is None:
            raise RuntimeError("refresh follows a checkpoint; this "
                               "Recommender's weights were handed in")
        t.ckpt.drain()
        latest = t.latest_step()
        if latest is None:
            raise FileNotFoundError(
                f"no checkpoint under {self.cfg.train.train_dir!r}")
        if latest == self._restored_step:
            return False
        if self._graphs is not None:      # they hold the old addresses
            self._graphs.clear()
            self._pool = None
        self._params = None
        self._vb = None
        try:
            t._maybe_restore()
            self._params = t._eval_params()
            with torch.inference_mode():
                vb = _item_latents(self.cfg, self.spec, self._params,
                                   self._item_dev, self._sh)
        except Exception as e:
            raise RuntimeError(
                "Recommender.refresh failed mid-restore; this instance no "
                "longer holds a servable state — rebuild it (the previous "
                "state is freed before restoring to avoid doubling "
                "residency)") from e
        self._vb = vb
        self._restored_step = int(t.state.step)
        return True

    def for_users(self, user_ids, seen=None) -> np.ndarray:
        """Top-k item ids for known user ids (MF family). `seen`: optional
        per-request iterable of item ids to exclude."""
        if self.is_seq:
            raise ValueError("for_users serves the MF family; use "
                             "from_histories for sequence models")
        user_ids = np.asarray(user_ids, np.int32)
        sb = self.serve_batch
        pad_user = self._ds.num_users            # encodes to zero
        width = self.seen_width or _bucket_width(seen, 32)

        def batches():
            for s in range(0, len(user_ids), sb):
                chunk = user_ids[s:s + sb]
                rows = _bucket_rows(len(chunk), sb, self._sh is not None)
                users = np.full(rows, pad_user, np.int32)
                users[:len(chunk)] = chunk
                sl = None if seen is None else seen[s:s + sb]
                yield {"user": users,
                       "seen": _pad_seen(sl, rows, width)}, len(chunk)
        return self._run(batches())

    # ------------------------------------------------------------------
    def _graph(self, batch: dict):
        """The captured step of the batch's shapes, captured now at their
        first call; None off the graph path and past MAX_GRAPHS keys."""
        if self._graphs is None:
            return None
        key = _graph_key(batch)
        g = self._graphs.get(key)
        if g is None and len(self._graphs) < MAX_GRAPHS:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            g = self._graphs[key] = _ServeGraph(
                batch, *self._parts, self._params, *self._vb, self._pool)
            obs.count("serve.graph_captures", 1)
        return g

    def _run(self, batches) -> np.ndarray:
        """batches: iterable of (numpy batch dict, n_valid) → [N, k] ids,
        by the batch's captured step where there is one, else eagerly.
        On a mesh each rank encodes its "data" slab of every batch, and the
        slabs' lists are gathered back over "data"."""
        ids_out = []
        v, b = self._vb
        sh = self._sh
        replayed = False
        with torch.inference_mode():
            for batch, n_valid in obs.iterate("serve.batch", batches):
                obs.count("serve.rows_live", n_valid)
                obs.count("serve.rows", len(batch["seen"]))
                graph = self._graph(batch)
                if graph is not None:
                    ids = graph(batch)
                    replayed = True
                else:
                    with obs.span("serve.h2d"):
                        tb = shard_from_hosts(
                            batch, None if sh is None else sh.mesh,
                            self.device)
                    seen = tb.pop("seen")
                    _, ids = self._step(self._params, v, b, tb, seen)
                    with obs.span("serve.d2h"):
                        ids = (ids.cpu().numpy() if sh is None else
                               all_hosts_concat(ids, sh.data_group))
                ids_out.append(ids[:n_valid].astype(np.int32))
        if replayed:
            obs.count("serve.graph_replays", 1)
        if not ids_out:                      # empty request list
            return np.zeros((0, self.k), np.int32)
        return np.concatenate(ids_out, axis=0)

    def _history_batches(self, histories, seen_from_history=True, seen=None,
                         user_ids=None):
        """Numpy batches (and their live row counts) for
        `from_histories`, each of its row bucket's rows: histories
        left-padded / truncated to whole max_seq_len segments."""
        spec = self.spec
        L = spec.max_seq_len
        sb = self.serve_batch
        pad_id = spec.vocab                      # encodes to zero
        max_hist = max((len(h) for h in histories), default=1)
        total = max(L, L * math.ceil(max_hist / L))
        if seen_from_history and seen is None:
            seen = (histories if self.seen_width is None
                    else [list(h)[-self.seen_width:] for h in histories])
        width = self.seen_width or _bucket_width(seen, -(-total // 32) * 32)
        for s in range(0, len(histories), sb):
            chunk = histories[s:s + sb]
            n = len(chunk)
            rows = _bucket_rows(n, sb, self._sh is not None)
            inputs = np.full((rows, total), pad_id, np.int32)
            mask = np.zeros((rows, total), np.float32)
            for i, h in enumerate(chunk):
                h = list(h)[-total:]
                if h:
                    inputs[i, total - len(h):] = h
                    mask[i, total - len(h):] = 1.0
            batch = {"inputs": inputs, "mask": mask,
                     "seen": _pad_seen(
                         None if seen is None else seen[s:s + sb], rows,
                         width)}
            if spec.user is not None:
                # anonymous requests take the pad user, which encodes to 0
                u = np.full(rows, spec.user.schema.num_entities, np.int32)
                if user_ids is not None:
                    u[:n] = np.asarray(user_ids[s:s + sb], np.int32)
                batch["user"] = u
            yield batch, n

    def from_histories(self, histories, seen_from_history: bool = True,
                       seen=None, user_ids=None) -> np.ndarray:
        """Top-k next items for raw per-request item histories of any
        length (the carried-state segmented scan runs one segment per
        max_seq_len items). By default a request's own history is also its
        seen-exclusion list."""
        if not self.is_seq:
            raise ValueError("from_histories serves the sequence family")
        return self._run(self._history_batches(histories, seen_from_history,
                                               seen, user_ids))


# ---------------------------------------------------------------------------
# Standing server: `python -m arec_torch.serve --config cfg.json [--set ...]`
# (arec's `python -m arec.serve` line protocol) on stdin / stdout:
#
#   MF family:        <user_id>[\t<seen_id,seen_id,...>]
#   sequence family:  <hist_id,hist_id,...>   (history = exclusion list)
#   commands:         !refresh   — pick up the newest checkpoint in place
#                     !step      — print the served checkpoint step
#                     !quit      — exit 0
#
# Responses: `<first_field>\t<id,id,...>`; unparseable lines answer
# `!err <reason>` and the loop continues.
# ---------------------------------------------------------------------------


def _serve_loop(rec: Recommender, inp, out) -> int:
    for line in inp:
        line = line.strip()
        if not line:
            continue
        try:
            if line == "!quit":
                return 0
            if line == "!step":
                print(f"!ok step {rec._restored_step}", file=out, flush=True)
            elif line == "!refresh":
                changed = rec.refresh()
                print(f"!ok {'refreshed' if changed else 'current'} "
                      f"step {rec._restored_step}", file=out, flush=True)
            elif rec.is_seq:
                first = line.split("\t")[0]
                hist = [int(x) for x in first.split(",") if x]
                ids = rec.from_histories([hist])
                print(f"{first}\t{','.join(map(str, ids[0].tolist()))}",
                      file=out, flush=True)
            else:
                parts = line.split("\t")
                uid = int(parts[0])
                seen = ([[int(x) for x in parts[1].split(",") if x]]
                        if len(parts) > 1 and parts[1] else None)
                ids = rec.for_users([uid], seen=seen)
                print(f"{uid}\t{','.join(map(str, ids[0].tolist()))}",
                      file=out, flush=True)
        except Exception as e:  # keep serving after a bad request
            print(f"!err {type(e).__name__}: {e}", file=out, flush=True)
    return 0


def _broadcast_lines(inp):
    """The primary rank's request lines, yielded on every rank in
    lockstep (a launcher gives all ranks one shared stdin, which several
    readers would split between them)."""
    import torch.distributed as dist

    src = iter(inp) if dist.get_rank() == 0 else None
    while True:
        box = [next(src, None) if src is not None else None]
        dist.broadcast_object_list(box, src=0)
        if box[0] is None:
            return
        yield box[0]


def main(argv=None, inp=None, out=None, device=None) -> int:
    """`python -m arec_torch.serve`: restore, print the banner, serve lines
    from `inp` (stdin) to `out` (stdout). device: None = `cuda`, or the
    rank's `cuda:{LOCAL_RANK}` under `torchrun`. On a mesh every rank
    serves the primary rank's input lines and, as arec's processes do,
    writes every response to its own `out`."""
    import sys

    from arec_torch.cli.main import load_config, parse_args

    cfg = load_config(parse_args(argv))
    rec = Recommender(cfg, device=device)
    print(f"!ok serving {cfg.train.train_dir} step {rec._restored_step} "
          f"({'histories' if rec.is_seq else 'user ids'} on stdin; "
          f"!refresh / !step / !quit)",
          file=out or sys.stdout, flush=True)
    lines = inp or sys.stdin
    if rec._sh is not None:
        lines = _broadcast_lines(lines)
    return _serve_loop(rec, lines, out or sys.stdout)


if __name__ == "__main__":
    import sys

    sys.exit(main())
