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
Requests are padded to a fixed batch of `serve_batch`. Each batch's build,
H2D copy, query, top-k and D2H wait are the spans `serve.batch`,
`serve.h2d`, `serve.query`, `serve.topk` and `serve.d2h`, its live and
padded rows the counters `serve.rows_live` and `serve.rows`
(`arec_torch.obs`, recorded while a torch profiler records). `refresh()`
follows training in place: the newest checkpoint re-restored into the live
object, the old state freed first, so residency never doubles.

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
    Trainer, _item_latents, _MeshServing, _serve_step, build_model,
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


def _auto_width(seen, fallback: int = 1) -> int:
    """Slab width for one call: the longest seen row, rounded up to a
    multiple of 32."""
    w = max((len(row) for row in seen), default=0) if seen is not None else 0
    w = max(w, fallback, 1)
    return -(-w // 32) * 32


class Recommender:
    """Load the latest checkpoint under cfg.train.train_dir and serve.

    Args:
      cfg: the training Config (the same JSON the run used).
      params: None (restore the latest checkpoint, and raise
        FileNotFoundError when there is none), or an arec-layout param
        tree handed over as it is, numpy arrays or torch tensors
        (`arec_torch.bridge`), e.g. `jax.tree.map(np.asarray, params)`.
      k: list length per request (default cfg.train.eval_topk).
      serve_batch: requests are padded to this batch size per dispatch.
      seen_width: width of the per-request seen-id slab; None sizes it per
        call to the longest seen list, so no exclusion list is truncated.
      device: where to serve; None = `cuda` (raises if there is none).
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
        self._step = _serve_step(cfg, self.spec, self._item_dev,
                                 self._user_dev, self.k, self._sh)

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
        width = self.seen_width or _auto_width(seen)

        def batches():
            for s in range(0, len(user_ids), sb):
                chunk = user_ids[s:s + sb]
                users = np.full(sb, pad_user, np.int32)
                users[:len(chunk)] = chunk
                sl = None if seen is None else seen[s:s + sb]
                yield {"user": users,
                       "seen": _pad_seen(sl, sb, width)}, len(chunk)
        return self._run(batches())

    # ------------------------------------------------------------------
    def _run(self, batches) -> np.ndarray:
        """batches: iterable of (numpy batch dict, n_valid) → [N, k] ids.
        On a mesh each rank encodes its "data" slab of every batch, and the
        slabs' lists are gathered back over "data"."""
        ids_out = []
        v, b = self._vb
        sh = self._sh
        with torch.inference_mode():
            for batch, n_valid in obs.iterate("serve.batch", batches):
                obs.count("serve.rows_live", n_valid)
                obs.count("serve.rows", self.serve_batch)
                with obs.span("serve.h2d"):
                    tb = shard_from_hosts(
                        batch, None if sh is None else sh.mesh, self.device)
                seen = tb.pop("seen")
                _, ids = self._step(self._params, v, b, tb, seen)
                with obs.span("serve.d2h"):
                    ids = (ids.cpu().numpy() if sh is None else
                           all_hosts_concat(ids, sh.data_group))
                ids_out.append(ids[:n_valid].astype(np.int32))
        if not ids_out:                      # empty request list
            return np.zeros((0, self.k), np.int32)
        return np.concatenate(ids_out, axis=0)

    def _history_batches(self, histories, seen_from_history=True, seen=None,
                         user_ids=None):
        """Fixed-shape numpy batches (and their live row counts) for
        `from_histories`: histories left-padded / truncated to whole
        max_seq_len segments."""
        spec = self.spec
        L = spec.max_seq_len
        sb = self.serve_batch
        pad_id = spec.vocab                      # encodes to zero
        max_hist = max((len(h) for h in histories), default=1)
        total = max(L, L * math.ceil(max_hist / L))
        if seen_from_history and seen is None:
            seen = (histories if self.seen_width is None
                    else [list(h)[-self.seen_width:] for h in histories])
        width = self.seen_width or _auto_width(seen)
        for s in range(0, len(histories), sb):
            chunk = histories[s:s + sb]
            n = len(chunk)
            inputs = np.full((sb, total), pad_id, np.int32)
            mask = np.zeros((sb, total), np.float32)
            for i, h in enumerate(chunk):
                h = list(h)[-total:]
                if h:
                    inputs[i, total - len(h):] = h
                    mask[i, total - len(h):] = 1.0
            batch = {"inputs": inputs, "mask": mask,
                     "seen": _pad_seen(
                         None if seen is None else seen[s:s + sb], sb, width)}
            if spec.user is not None:
                # anonymous requests take the pad user, which encodes to 0
                u = np.full(sb, spec.user.schema.num_entities, np.int32)
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
