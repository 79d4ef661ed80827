"""Readings of the checks' controls, for setting a cell's limits:

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 \
        --variant control|half

With `control` the plain reference, computed in float8 (e4m3) where the
configuration states bfloat16, stands in the program's place; with `half`
(training cells) the reference takes half of each batch, the mean over
the rest. Each is judged by the same comparison as a benchmark run, at the
cell's own sizes, and one JSON line a seed is printed. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import bench, program  # noqa: E402
from reference import data as rdata, model, serve as rserve  # noqa: E402
from reference import train as rtrain, weights  # noqa: E402


def _setup(cell, seed: int, dev):
    """(cfg, family, entities, data, static parts, the run's weights)."""
    cfg = program.config(cell, seed)
    body = cell.config["config"]
    ents = rdata.entities(body)
    d = rdata.load(body["data"], bench.CACHE)
    fam = program.family(cfg)
    return (cfg, fam, ents, d, rdata.static_parts(ents, d, dev),
            weights.make(fam, ents, seed, dev, program.rnn_cell(cfg)))


def train_readings(cell, seed: int, variant: str, dev) -> dict:
    drv = bench.Cell.driver(cell)
    cfg, fam, ents, d, m, p0 = _setup(cell, seed, dev)
    steps = 2 * cfg.train.steps_per_dispatch
    batches = list(enumerate(itertools.islice(
        rdata.batches(d, cell.config["config"], cfg.train.seed), steps)))
    lr = cfg.train.learning_rate
    rules = program.rules(p0, cfg.train.sparse_update)
    if variant == "control":
        fn, dt = drv.reference_loss(fam, cfg, ents, m, dev), "float8"
    else:
        half = cfg.train.batch_size // 2
        fn, dt = drv.reference_loss(fam, cfg, ents, m, dev,
                                    rows=slice(0, half)), "bfloat16"
    # the stand-in's own run, held where the program's would be
    K, prog, losses = steps // 2, {}, []
    state = (p0, {k: torch.full_like(v, rtrain.INIT_ACC)
                  for k, v in p0.items()})
    for tag, part in (("step1", batches[:1]), ("K", batches[1:K]),
                      ("2K", batches[K:])):
        out = rtrain.run_steps(fn, *state, part, lr, rules, dt)
        losses += out[0]
        state = (out[2], out[3])
        prog[tag] = {k: (out[2][k], out[3][k]) for k in p0}
    got = rtrain.gaps(drv.reference_loss(fam, cfg, ents, m, dev), p0,
                      batches, lr, rules, {"losses": losses, **prog})
    return {k: got[k] for k in ("loss_gap", "grad_gap", "change_gap")}


def serve_readings(cell, seed: int, variant: str, dev) -> dict:
    drv = bench.Cell.driver(cell)
    cfg, fam, ents, d, m, w = _setup(cell, seed, dev)
    pool = drv._pool(cell.traffic, d, cfg, np.random.default_rng([seed, 1]))
    reqs = [(i, j) for i in range(len(pool)) for j in range(len(pool[i][1]))]
    reqs = reqs[:cell.traffic["check_requests"]]
    P = weights.nest(w)
    seen = [pool[i][1][j] for i, j in reqs]
    k = cfg.train.eval_topk

    def queries(dt):
        if fam == "mf":
            users = torch.as_tensor(np.array([pool[i][0][j] for i, j in reqs]),
                                    device=dev)
            return model.mf_queries(P, m, users)
        return drv._seq_queries(P, m, [pool[i][0][j] for i, j in reqs],
                                cfg.model.max_seq_len, ents["item"].num, dt,
                                dev, program.rnn_cell(cfg))
    with torch.no_grad():
        v, b = (model.mf_items(P, m) if fam == "mf"
                else model.seq_items(P, m))
        q_ctl = queries("float8")
        served = []
        for s in range(0, len(reqs), 256):
            sc = model.scores(q_ctl[s:s + 256], v, b, "float8")
            for i, ids in enumerate(seen[s:s + 256]):
                if len(ids):
                    sc[i, torch.as_tensor(ids, device=dev).long()] = (
                        -float("inf"))
            served.append(torch.topk(sc, k, dim=1).indices)
        gaps = rserve.score_gaps(queries("bfloat16"), v, b, seen,
                                 torch.cat(served), "bfloat16")
    return {"score_gap": float(gaps.max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", choices=("control", "half"),
                    default="control")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    cell = bench.Cell.find(a.workload)
    dev = torch.device(a.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    read = (train_readings if cell.traffic["kind"] == "train"
            else serve_readings)
    for seed in (int(s) for s in a.seeds.split(",")):
        out = read(cell, seed, a.variant, dev)
        print(json.dumps({"workload": a.workload, "variant": a.variant,
                          "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
