"""gloo ranks for the arec_torch mesh tests.

`run_ranks(case, world, tmp_dir, inputs)` spawns `world` processes
(torch.multiprocessing, one CPU thread each) that join one gloo group
through a `file://` store under `tmp_dir`, run `CASES[case](inputs)` on
every rank, and return each rank's result (numpy leaves) in rank order.
This module imports torch, numpy and arec_torch only, so the children
never import jax or arec; the tests compute arec's side in their own
process.
"""

from __future__ import annotations

import datetime
import io
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torch_mesh_train_cases import TRAIN_CASES


def run_ranks(case: str, world: int, tmp_dir, inputs: dict) -> list:
    tmp_dir = str(tmp_dir)
    src = os.path.join(tmp_dir, f"{case}.in.pt")
    torch.save(inputs, src)
    mp.spawn(_rank_main, args=(world, case, src, tmp_dir), nprocs=world)
    return [torch.load(os.path.join(tmp_dir, f"{case}.out.{r}.pt"),
                       weights_only=False) for r in range(world)]


def _rank_main(rank, world, case, src, tmp_dir):
    torch.set_num_threads(1)
    # a collective that one rank misses fails the case after the timeout
    # instead of hanging the suite
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp_dir, case)}.store",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=300))
    try:
        out = CASES[case](torch.load(src, weights_only=False))
        torch.save(out, os.path.join(tmp_dir, f"{case}.out.{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _gather_world(x: torch.Tensor) -> np.ndarray:
    """[n, ...] per rank → [world, n, ...] numpy on every rank."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.stack(parts).numpy()


# ---------------------------------------------------------------------------
# tables: RowPerm-stored shards, the exchange and the masked lookup
# ---------------------------------------------------------------------------

def lookups(inp):
    """For each case (mesh, table, ids, perm, dedup, capacity_factor): the
    rows this rank's data slab gets through the exchange and the masked
    lookup, and the drop count the exchange adds on this rank."""
    from arec_torch.dist.mesh import make_mesh
    from arec_torch.dist.specs import batch_slab, shard_rows
    from arec_torch.tables.layout import RowPerm
    from arec_torch.tables.sharded import (
        EXCHANGE_DROPS, make_masked_lookup, make_sharded_lookup,
    )

    out = []
    meshes = {}
    for c in inp["cases"]:
        shape = tuple(c["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape)
        mesh = meshes[shape]
        table = torch.from_numpy(c["table"])
        perm = (RowPerm.for_rows(c["rows"], c["prefix"])
                if c["prefix"] is not None else None)
        if perm is not None:
            table = perm.permute_table(table)
        shard = shard_rows(table, mesh)
        ids = batch_slab({"ids": torch.from_numpy(c["ids"])}, mesh)["ids"]
        EXCHANGE_DROPS.read_and_reset()
        with torch.inference_mode():
            ex = make_sharded_lookup(mesh, c["capacity_factor"],
                                     dedup=c["dedup"], perm=perm)(shard, ids)
            drops = EXCHANGE_DROPS.read_and_reset()
            masked = make_masked_lookup(mesh, perm)(shard, ids)
        out.append({"exchange": _np(ex), "masked": _np(masked),
                    "drops": drops})
    return out


# ---------------------------------------------------------------------------
# retrieval: the sharded top-k
# ---------------------------------------------------------------------------

def topk(inp):
    from arec_torch.dist.mesh import make_mesh
    from arec_torch.dist.specs import batch_slab, shard_rows
    from arec_torch.retrieval.mips import make_sharded_topk, pad_item_shards

    out = []
    meshes = {}
    for c in inp["cases"]:
        shape = tuple(c["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape)
        mesh = meshes[shape]
        v, b = pad_item_shards(torch.from_numpy(c["v"]),
                               torch.from_numpy(c["b"]), shape[1])
        slab = batch_slab({"q": torch.from_numpy(c["q"]),
                           "seen": torch.from_numpy(c["seen"])}, mesh)
        vals, ids = make_sharded_topk(
            mesh, k=c["k"], recall_target=c["recall_target"])(
            slab["q"], shard_rows(v, mesh), shard_rows(b, mesh),
            slab["seen"])
        out.append({"vals": _np(vals), "ids": _np(ids)})
    return out


# ---------------------------------------------------------------------------
# serving: Recommender, Trainer(serve_only) and serve.main on a mesh
# ---------------------------------------------------------------------------

def _config(c):
    from arec_torch.config import Config

    cfg = Config.from_json(c["config"])
    return cfg.override(c.get("sets", {}))


def recommend(inp):
    """For each case: Recommender(cfg) (a checkpoint under train_dir, or
    the params handed in) answers `users` (MF) or `histories` (sequence
    family); with `eval`, a serve-only Trainer's evaluate() and
    recommend() too."""
    from arec_torch.serve import Recommender
    from arec_torch.train.loop import Trainer

    out = []
    for c in inp["cases"]:
        cfg = _config(c)
        rec = Recommender(cfg, c.get("params"),
                          serve_batch=c.get("serve_batch", 16), device="cpu")
        res = {}
        if "users" in c:
            res["ids"] = rec.for_users(c["users"], seen=c.get("seen"))
        else:
            res["ids"] = rec.from_histories(c["histories"])
        v, b = rec._vb
        res["latents"], res["bias"] = _gather_world(v.float()), \
            _gather_world(b)
        # neither jax nor arec reached this rank
        res["clean"] = not any(m.split(".")[0] in ("jax", "jaxlib", "arec")
                               for m in sys.modules)
        if c.get("eval"):
            tr = Trainer(cfg, serve_only=True, device="cpu")
            res["recall"] = tr.evaluate(exact=True)
            path = os.path.join(c["out_dir"],
                                f"{c['family']}.{dist.get_rank()}.tsv")
            rows = tr.recommend(out_path=path)
            res["rows"] = rows
            res["wrote"] = os.path.exists(path)
        out.append(res)
    return out


def serve_main(inp):
    """The entry points on this rank: `cli.main --recommend --out` (its
    stdout, and whether this rank wrote the file), then serve.main fed
    the case's lines (the primary rank's are everyone's) and what it
    wrote."""
    import contextlib

    from arec_torch import serve
    from arec_torch.cli.main import main as cli_main

    path = inp["out"] + f".{dist.get_rank()}"
    cli_out = io.StringIO()
    with contextlib.redirect_stdout(cli_out):
        rc_cli = cli_main(inp["argv"] + ["--recommend", "--out", path],
                          device="cpu")
    buf = io.StringIO()
    lines = inp["lines"] if dist.get_rank() == 0 else "!quit\n"
    rc = serve.main(inp["argv"], io.StringIO(lines), buf, device="cpu")
    return {"rc": rc, "out": buf.getvalue(), "rc_cli": rc_cli,
            "cli": cli_out.getvalue(), "wrote": os.path.exists(path)}


def gloo_cuda(inp):
    """all_to_all_single, all_gather and all_reduce of tensors on
    inp["device"] through this gloo rank (the card check's probe)."""
    dev = torch.device(inp["device"])
    r, w = dist.get_rank(), dist.get_world_size()
    x = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=dev) + 100 * r
    a2a = torch.empty_like(x)
    dist.all_to_all_single(a2a, x)
    rows = torch.arange(8 * 3, dtype=torch.float32, device=dev).view(8, 3)
    rows = rows + 1000 * r
    back = torch.empty_like(rows)
    dist.all_to_all_single(back, rows)
    want = torch.cat([(torch.arange(24, dtype=torch.float32).view(8, 3)
                       + 1000 * p)[4 * r:4 * r + 4] for p in range(w)])
    parts = [torch.empty(1, device=dev) for _ in range(w)]
    dist.all_gather(parts, torch.tensor([float(r)], device=dev))
    red = torch.ones(2, device=dev) / w
    dist.all_reduce(red)
    return {"all_to_all": a2a.tolist(), "all_gather": torch.cat(parts)
            .tolist(), "all_reduce": red.tolist(),
            "rows_all_to_all": back.tolist(), "rows_want": want.tolist(),
            "device": a2a.device.type}


def chain(inp):
    """Several cases in one group, in order: inp["cases"] is a list of
    (case name, its input); returns their results."""
    return [CASES[name](sub) for name, sub in inp["cases"]]


CASES = {"lookups": lookups, "topk": topk, "recommend": recommend,
         "serve_main": serve_main, "gloo_cuda": gloo_cuda, "chain": chain}
CASES.update(TRAIN_CASES)
