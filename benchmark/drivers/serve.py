"""Serving cells: one caller in a closed loop on `serve.Recommender`.

Set-up makes the run's weights on the card from --seed and hands them
to `Recommender(params=)`, which loads the program's prepared dataset
and encodes the item latents; then the pool of calls is drawn from the
seed, over the benchmark's own copy of the dataset (reference/data.py),
and one call of each shape the pool holds is served. In the window each
call is issued when the previous one's ids are back on the host:

  * MF: `for_users` of `requests_per_call` training users, each with its
    seen list (its train items, as `Trainer.recommend` passes them);
  * the sequence family: `from_histories` of `requests_per_call` of the
    dataset's training histories (each its own seen list), the share
    that needs a second max_seq_len segment fixed by the dataset, so every
    seed draws the same sizes in another order.

A request's latency runs from its call's issue to its ids on the host.
The check, once the window has closed and the program is freed: the
served lists of `check_requests` requests drawn from the seed among those
answered (the longest history always among them) against the reference's
scores (reference/serve.py).
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from harness import bench, program
from harness.trace import traced
from reference import data as rdata, model, serve as rserve, weights


def _pool(traffic, ds, cfg, rng):
    """[(requests, seen lists)] of the pool's calls."""
    R, n_calls = traffic["requests_per_call"], traffic["pool_calls"]
    n = R * n_calls
    if cfg.model.model != "lstm":
        seen_n = ds.seen_lengths
        users = rng.choice(np.flatnonzero(seen_n > 0), size=n)
        seen = [ds.seen_items[u, :seen_n[u]].tolist() for u in users]
        return [(users[i:i + R], seen[i:i + R]) for i in range(0, n, R)]
    L = cfg.model.max_seq_len
    lens = ds.hist_lengths
    live = np.flatnonzero(lens > 0)
    long_ = live[lens[live] > L]
    n_long = int(round(n * len(long_) / len(live)))
    users = np.concatenate([rng.choice(long_, size=n_long),
                            rng.choice(live[lens[live] <= L],
                                       size=n - n_long)])
    rng.shuffle(users)
    hists = [ds.hist_items[u, :lens[u]].tolist() for u in users]
    return [(hists[i:i + R], hists[i:i + R]) for i in range(0, n, R)]


def _shape_key(call, L):
    reqs = call[0]
    if isinstance(reqs, np.ndarray):
        return 1
    return -(-max(len(h) for h in reqs) // L)


def run(r) -> None:
    from arec_torch.serve import Recommender

    dev = r.device
    cfg = program.config(r.cell, r.seed)
    fam = program.family(cfg)
    t = r.cell.traffic
    ds = rdata.load(r.cell.config["config"]["data"], bench.CACHE)
    ents = rdata.entities(r.cell.config["config"])
    w = weights.make(fam, ents, r.seed, dev)
    rec = Recommender(cfg, params=program.param_tree(fam, w), device=dev)
    del w
    rng = np.random.default_rng([r.seed, 1])
    pool = _pool(t, ds, cfg, rng)
    L = cfg.model.max_seq_len

    def call(c):
        if fam == "mf":
            return rec.for_users(c[0], seen=c[1])
        return rec.from_histories(c[0])

    warmed = set()
    for c in pool:                     # one call of each shape in the pool
        key = _shape_key(c, L)
        if key not in warmed:
            call(c)
            warmed.add(key)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    r.values["setup_s"] = time.perf_counter() - r.t_process

    lat, answers, done = [], {}, 0
    with traced(r.trace, r.recorded):
        t0 = time.perf_counter()
        deadline = t0 + r.window_seconds
        while time.perf_counter() < deadline:
            c = pool[done % len(pool)]
            s = time.perf_counter()
            with torch.profiler.record_function("bench.call"):
                ids = call(c)
            lat.append(time.perf_counter() - s)
            answers.setdefault(done % len(pool), ids)
            done += 1
        r.window_s = time.perf_counter() - t0
    R = t["requests_per_call"]
    r.attempted = done * R
    r.counts.update(calls=done, requests=done * R)
    r.values["serve_requests_per_s"] = done * R / r.window_s
    r.values["serve_p95_ms"] = 1e3 * statistics.quantiles(
        lat, n=100, method="inclusive")[94]
    r.memory_peak = (torch.cuda.max_memory_allocated(dev)
                     if dev.type == "cuda" else 0)
    _counts(r, cfg, ents, pool, done, rec.serve_batch)

    del rec
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(r, cfg, fam, ents, ds, pool, answers, dev,
          np.random.default_rng([r.seed, 2]))


def _counts(r, cfg, ents, pool, done, serve_batch: int) -> None:
    """The window's live work, for the traced run's readers: FLOPs of the
    live requests, and each serving scan launch's (batch, valid steps)."""
    from roofline.counts import mf_serve_flops, seq_serve_flops
    c = r.counts
    d, V = cfg.model.dim, ents["item"].num
    c.update(D=d, H=d, L=cfg.model.max_seq_len, V=V,
             serve_batch=serve_batch)
    if "user" in ents:
        c["flops"] = mf_serve_flops(c["requests"], V, d,
                                    len(ents["user"].fields))
        return
    L = c["L"]
    launches, valid = [], 0
    for i in range(done):
        hists = pool[i % len(pool)][0]
        total = L * -(-max(len(h) for h in hists) // L)
        for s in range(0, total, L):
            v = sum(max(0, s + L - max(s, total - len(h))) for h in hists)
            launches.append(v)
            valid += v
    c["scan_launches"] = launches
    c["flops"] = seq_serve_flops(valid, c["requests"], V, d, d,
                                 len(ents["item"].fields))


def check(r, cfg, fam, ents, ds, pool, answers, dev, rng) -> None:
    """The served lists of a sample of the answered requests (with the
    longest history) against the reference's scores."""
    want = r.cell.traffic["check_requests"]
    reqs = [(i, j) for i in sorted(answers)
            for j in range(len(pool[i][1]))]
    pick = rng.choice(len(reqs), size=min(want, len(reqs)), replace=False)
    chosen = [reqs[k] for k in pick]
    if fam == "seq":
        longest = max(reqs, key=lambda ij: len(pool[ij[0]][0][ij[1]]))
        if longest not in chosen:
            chosen[0] = longest
    m = rdata.static_parts(ents, ds, dev)
    P = weights.nest(weights.make(fam, ents, r.seed, dev))
    served = torch.as_tensor(np.stack([answers[i][j] for i, j in chosen]))
    seen = [pool[i][1][j] for i, j in chosen]
    dt = "bfloat16"
    with torch.no_grad():
        if fam == "mf":
            users = torch.as_tensor(np.array([pool[i][0][j]
                                              for i, j in chosen]),
                                    device=dev)
            q = model.mf_queries(P, m, users)
            v, b = model.mf_items(P, m)
        else:
            q = _seq_queries(P, m, [pool[i][0][j] for i, j in chosen],
                             cfg.model.max_seq_len, ents["item"].num, dt,
                             dev)
            v, b = model.seq_items(P, m)
        gaps = rserve.score_gaps(q, v, b, seen, served, dt)
    r.check("score_gap", float(gaps.max()))


def _seq_queries(P, m, hists, L, pad, dt, dev, block=256):
    """The reference's final state after each history (left-padded to a
    whole number of max_seq_len segments, scanned in one pass)."""
    out = []
    for s in range(0, len(hists), block):
        hs = hists[s:s + block]
        total = L * max(1, -(-max(len(h) for h in hs) // L))
        inputs = np.full((len(hs), total), pad, np.int64)
        mask = np.zeros((len(hs), total), np.float32)
        for i, h in enumerate(hs):
            inputs[i, total - len(h):] = h
            mask[i, total - len(h):] = 1.0
        out.append(model.seq_queries(P, m, torch.as_tensor(inputs,
                                                           device=dev),
                                     torch.as_tensor(mask, device=dev), dt))
    return torch.cat(out)
