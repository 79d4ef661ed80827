"""Training cases for the gloo ranks of `torch_mesh_worker.run_ranks`.

Each case runs on every rank of the spawned group and returns numpy
leaves. Like the worker, it imports torch, numpy and arec_torch only;
arec's side of each comparison runs in the test process.

Negatives are handed in: `_hand_in` replaces each module's `draw` with
one that returns the case's numpy-made draw, as the single-device parity
tests do (tests/test_torch_sparse.py).
"""

from __future__ import annotations

import io
import os

import torch
import torch.distributed as dist


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_np(v) for v in tree)
    return _np(tree)


def _mesh(shape, cache):
    from arec_torch.dist.mesh import make_mesh
    shape = tuple(shape)
    if shape not in cache:
        cache[shape] = make_mesh(*shape)
    return cache[shape]


def _hand_in(draw):
    """Every sampled loss and sparse step draws `draw` = (ids, p)."""
    import arec_torch.losses.losses as tl
    import arec_torch.train.sparse as tsparse
    import arec_torch.train.sparse_mesh as tsm

    fixed = (torch.from_numpy(draw[0]), torch.from_numpy(draw[1]))

    def hand(gen, *a, **k):
        return tuple(x.to(gen.device) for x in fixed)
    for m in (tl, tsparse, tsm):
        m.draw = hand


# ---------------------------------------------------------------------------
# the exchange's backward and the sharded CE
# ---------------------------------------------------------------------------

def exchange_grads(inp):
    """For each case: this rank's shard of d/d(table) of Σ rows·cot over
    the exchange lookup of its data slab, summed over "data". Each model
    rank of a slab takes 1/T of the slab's cotangent: the partial of its
    share, so the lookup's backward (a sum over "model") counts the slab
    once."""
    from arec_torch.dist.specs import DATA_AXIS, batch_slab, shard_rows
    from arec_torch.tables.layout import RowPerm
    from arec_torch.tables.sharded import make_sharded_lookup

    out, meshes = [], {}
    for c in inp["cases"]:
        mesh = _mesh(c["mesh"], meshes)
        table = torch.from_numpy(c["table"])
        perm = (RowPerm.for_rows(c["rows"], c["prefix"])
                if c["prefix"] is not None else None)
        if perm is not None:
            table = perm.permute_table(table)
        shard = shard_rows(table, mesh).clone().requires_grad_()
        slab = batch_slab({"ids": torch.from_numpy(c["ids"]),
                           "cot": torch.from_numpy(c["cot"])}, mesh)
        rows = make_sharded_lookup(mesh, dedup=c["dedup"], perm=perm)(
            shard, slab["ids"])
        (rows * slab["cot"] / mesh.size(1)).sum().backward()
        g = shard.grad.contiguous()
        dist.all_reduce(g, group=mesh.get_group(DATA_AXIS))
        out.append({"grad": _np(g)})
    return out


CE_ROWS = ("q", "v_true", "tl_base", "true_ids", "weights")
CE_DIFF = ("q", "v_true", "v_samp", "c_samp", "tl_base")


def sharded_ce(inp):
    """For each case: the global (num, den) of the sharded fused CE over
    this rank's slab, and the gradients of num + 0.5·den, summed over the
    ranks that hold each input (the slab's rows over "model", the
    replicated sampled side over every rank)."""
    from arec_torch.dist.specs import TABLE_AXIS, batch_slab
    from arec_torch.kernels.sampled_softmax import (
        fused_sampled_ce_sums_sharded,
    )

    out, meshes = [], {}
    for c in inp["cases"]:
        mesh = _mesh(c["mesh"], meshes)
        a = {k: torch.from_numpy(v.copy()) for k, v in c["inputs"].items()}
        a.update(batch_slab({k: a[k] for k in CE_ROWS}, mesh))
        for k in CE_DIFF:
            a[k].requires_grad_()
        num, den = fused_sampled_ce_sums_sharded(
            mesh, a["q"], a["v_true"], a["v_samp"], a["c_samp"],
            a["tl_base"], a["true_ids"], a["sampled_ids"],
            a["weights"] if c["weighted"] else None, torch.float32)
        (num + 0.5 * den).backward()
        res = {"num": num.item(), "den": den.item()}
        for k in CE_DIFF:
            g = a[k].grad.contiguous()
            dist.all_reduce(g, group=(mesh.get_group(TABLE_AXIS)
                                      if k in CE_ROWS else None))
            res[k] = _np(g)
        out.append(res)
    return out


def ce_loss_mesh(inp):
    """For each case: `sampled_softmax_loss(mesh=)` on this rank's slab of
    q / true_ids / weights, the candidates' rows from a replicated
    [V, D+1] table (bias in lane D); the global loss, and the gradients of
    q (the slab's, summed over "model") and of the table (summed over
    every rank)."""
    from arec_torch.dist.specs import TABLE_AXIS, batch_slab
    from arec_torch.losses.losses import sampled_softmax_loss

    out, meshes = [], {}
    for c in inp["cases"]:
        mesh = _mesh(c["mesh"], meshes)
        t = {k: torch.from_numpy(v.copy()) for k, v in c["inputs"].items()}
        slab = batch_slab({k: t[k] for k in ("q", "true_ids", "weights")},
                          mesh)
        q = slab["q"].requires_grad_()
        taug = t["taug"].requires_grad_()
        d = q.shape[1]
        loss = sampled_softmax_loss(
            q, slab["true_ids"], lambda i: (taug[i.long(), :d],
                                            taug[i.long(), d]),
            None, c["S"], c["V"], dist=c["dist"], weights=slab["weights"],
            compute_dtype=torch.float32,
            sampled=(t["sampled_ids"], t["p"]),
            use_kernel=c["use_kernel"], mesh=mesh)
        loss.backward()
        gq, gt = q.grad.contiguous(), taug.grad.contiguous()
        dist.all_reduce(gq, group=mesh.get_group(TABLE_AXIS))
        dist.all_reduce(gt)
        out.append({"loss": loss.item(), "q": _np(gq), "taug": _np(gt)})
    return out


def mf_loss_mesh(inp):
    """For each case: `mf_loss(mesh=)` over this rank's slab, through the
    exchange lookups on row-sharded params; the global loss, and the
    gradient of every param summed over the ranks that hold it (tables:
    over "data", the rest: over every rank), tables in this rank's row
    block."""
    from arec_torch import bridge
    from arec_torch.config import Config
    from arec_torch.data.synthetic import generate
    from arec_torch.dist.specs import (
        DATA_AXIS, batch_slab, table_role, tree_leaves_with_keys,
    )
    from arec_torch.models import mf
    from arec_torch.rng import generator
    from arec_torch.tables.engine import attrs_to_device
    from arec_torch.tables.sharded import make_sharded_lookup

    out, meshes = [], {}
    for c in inp["cases"]:
        mesh = _mesh(c["mesh"], meshes)
        cfg = Config.from_json(c["config"])
        ds = generate(cfg.data)
        spec = mf.MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
        udev = attrs_to_device(ds.user_attrs.restrict(spec.user.schema),
                               spec.user)
        idev = attrs_to_device(ds.item_attrs.restrict(spec.item.schema),
                               spec.item)
        params = bridge.shard_params(c["params"], mesh, {})
        live = {k: v for k, v in tree_leaves_with_keys(params)}
        for v in live.values():
            v.requires_grad_()
        lk = {r: make_sharded_lookup(mesh) for r in ("user", "item")}
        batch = batch_slab({k: torch.from_numpy(v)
                            for k, v in c["batch"].items()}, mesh)
        sampled = (None if c["sampled"] is None else
                   tuple(torch.from_numpy(x) for x in c["sampled"]))
        loss = mf.mf_loss(params, spec, udev, idev, batch, generator(0),
                          lookup_fns=lk, sampled=sampled, mesh=mesh)
        loss.backward()
        grads = {}
        for keys, v in live.items():
            g = v.grad.contiguous()
            sharded = table_role(keys) is not None
            dist.all_reduce(g, group=mesh.get_group(DATA_AXIS)
                            if sharded else None)
            grads["/".join(keys)] = _np(g)
        out.append({"loss": loss.item(), "grads": grads})
    return out


# ---------------------------------------------------------------------------
# the mesh steps and the Trainer
# ---------------------------------------------------------------------------

def _trainer(c):
    from arec_torch.config import Config
    from arec_torch.train.loop import Trainer

    return Trainer(Config.from_json(c["config"]), device="cpu")


def mesh_steps(inp):
    """For each case: a Trainer on the case's config and mesh, its state
    replaced by arec's handed in (natural layout) and cut to this rank's
    blocks; `batches` (global batches, each rank taking its slab) through
    its step with the key of step i and the case's draw; returns the
    losses and the final state in the natural layout (primary rank)."""
    from arec_torch import bridge
    from arec_torch.dist.collectives import all_sum
    from arec_torch.dist.global_io import shard_from_hosts
    from arec_torch.tables.sharded import EXCHANGE_DROPS
    from arec_torch.train.step import step_generator

    out = []
    for c in inp["cases"]:
        if c.get("draw") is not None:
            _hand_in(c["draw"])
        tr = _trainer(c)
        tr.state = bridge.shard_state(c["state"], tr.sh, tr.sparse)
        EXCHANGE_DROPS.read_and_reset()
        losses = []
        for i, b in enumerate(c["batches"]):
            slab = shard_from_hosts(b, tr.sh.mesh, tr.device)
            tr.state, m = tr.step_fn(tr.state, slab,
                                     step_generator(tr.cfg.train.seed, i))
            losses.append(float(m["loss"]))
        final = tr.sh.canonical(tr.state, tr.sparse, tr._natural_rows)
        drops = int(all_sum(torch.tensor(EXCHANGE_DROPS.read_and_reset())))
        out.append({"losses": losses, "drops": drops,
                    "state": None if final is None else _tree_np(
                        final._asdict())})
        tr.close()
    return out


def train(inp):
    """For each case: Trainer(cfg).train() on this rank (or, with
    `argv`, cli.main with those arguments), the case's draw handed in;
    returns the summary, what it printed, and the primary's metrics
    records."""
    import contextlib
    import json

    from arec_torch.cli.main import main as cli_main

    out = []
    for c in inp["cases"]:
        if c.get("draw") is not None:
            _hand_in(c["draw"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if "argv" in c:
                rc = cli_main(c["argv"], device="cpu")
                summary = None
            else:
                tr = _trainer(c)
                summary = tr.train()
                tr.close()
                rc = 0
        res = {"rc": rc, "summary": summary, "stdout": buf.getvalue(),
               # neither jax nor arec reached this rank
               "clean": not any(m.split(".")[0] in ("jax", "jaxlib", "arec")
                                for m in __import__("sys").modules)}
        path = os.path.join(c["train_dir"], "metrics.jsonl")
        if dist.get_rank() == 0 and os.path.exists(path):
            with open(path) as f:
                res["metrics"] = [json.loads(ln) for ln in f]
        out.append(res)
    return out


TRAIN_CASES = {"exchange_grads": exchange_grads, "sharded_ce": sharded_ce,
               "ce_loss_mesh": ce_loss_mesh, "mf_loss_mesh": mf_loss_mesh,
               "mesh_steps": mesh_steps, "train": train}
