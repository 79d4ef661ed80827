"""Training cells: the Trainer's K-step dispatch, driven as
`Trainer.train()` drives it between eval points, for the whole window.

Set-up builds one `Trainer` (its dataset from the cache under
benchmark/_cache, its model, optimizer state and `multi_step_fn`), copies
the run's weights (made on the card from --seed) into its state leaves,
and starts the Trainer's own input path: the batch iterator of each epoch
in turn (`Trainer._batches`, epochs chained so that every dispatch takes
K batches) through `data.prefetch.prefetch` with `to_device` staging.
The first dispatch runs its K steps eagerly and captures the CUDA graph;
two replays follow, and the window then replays until --seconds have
passed and ends in `torch.cuda.synchronize()`.

The check follows the first 2K steps: the first dispatch's eager steps
and the first replay's, each through the same `multi_step_fn` call and
feed as the window's. Their losses, the first step's gradient (from a
host copy of the state after step 1) and each leaf's change over each
dispatch (from host copies of the state after each) are held against
the reference's steps on batches the benchmark makes itself
(reference/data.py), with the same negatives where the loss draws any
(program.mf_loss names the loss): the first K from the same
weights, the next K from the program's state after the first dispatch
(reference/train.py says why). The host copies are check work and are
left out of setup_s. The reference runs
once the window has closed and the program's state is freed.
"""

from __future__ import annotations

import gc
import itertools
import shutil
import sys
import time

import numpy as np
import torch

from harness import bench, program
from harness.trace import traced
from reference import data as rdata, keys, model, train as rtrain, weights

SETUP_REPLAYS = 2    # replays after the capture, before the window


class AfterFirstStep:
    """Wraps the step core; after the first call (the eager warm-up's
    first step) hands the state to `take`."""

    def __init__(self, core, take):
        self.core, self.take, self.calls = core, take, 0

    def __call__(self, state, batch, gen):
        state, m = self.core(state, batch, gen)
        self.calls += 1
        if self.calls == 1:
            self.take(state)
        return state, m


def _stream(tr):
    """Every batch of the Trainer's feed, epoch after epoch."""
    for epoch in itertools.count():
        yield from tr._batches(epoch)


def run(r) -> None:
    from arec_torch.data.prefetch import prefetch, to_device
    from arec_torch.train.loop import Trainer
    from arec_torch.train.step import step_generator

    dev = r.device
    cfg = program.config(r.cell, r.seed)
    fam, rnn = program.family(cfg), program.rnn_cell(cfg)
    program.mf_loss(cfg)     # a loss the reference lacks stops the run here
    tr = Trainer(cfg, device=dev)
    ents = rdata.entities(r.cell.config["config"])
    w = weights.make(fam, ents, r.seed, dev, rnn)
    with torch.no_grad():
        for name, (p, _) in program.leaves(tr.state, fam,
                                           tr.sparse).items():
            if p.shape != w[name].shape:
                raise RuntimeError(
                    f"{name}: the program holds {tuple(p.shape)}, the "
                    f"benchmark made {tuple(w[name].shape)}")
            p.copy_(w[name])
    del w

    K, B = tr.dispatch_k, cfg.train.batch_size
    ms = tr.multi_step_fn
    held, check_s = {}, [0.0]

    def take(tag, state):
        t0 = time.perf_counter()
        held[tag] = {k: (p.detach().to("cpu", copy=True),
                         a.detach().to("cpu", copy=True))
                     for k, (p, a) in program.leaves(state, fam,
                                                     tr.sparse).items()}
        check_s[0] += time.perf_counter() - t0

    ms.core = AfterFirstStep(ms.core, lambda st: take("step1", st))
    depth = max(2, K + 1)
    feed = prefetch(_stream(tr), depth=depth, transform=to_device(dev, depth))
    steps = 0

    def dispatch():
        nonlocal steps
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.input_wait"):
            pending = [next(feed) for _ in range(K)]
        t1 = time.perf_counter()
        with torch.profiler.record_function("bench.dispatch"):
            tr.state, m = ms(tr.state, pending,
                             [step_generator(cfg.train.seed, steps + i)
                              for i in range(K)])
        t2 = time.perf_counter()
        r.span("input_wait", t1 - t0)
        r.span("dispatch", t2 - t1)
        steps += K
        return m

    losses = [dispatch()["loss"]]
    take("K", tr.state)
    losses.append(dispatch()["loss"])
    take("2K", tr.state)
    for _ in range(SETUP_REPLAYS - 1):
        dispatch()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    r.values["setup_s"] = time.perf_counter() - r.t_process - check_s[0]

    r.spans.clear()
    start = steps
    with traced(r.trace, r.recorded):
        t0 = time.perf_counter()
        deadline = t0 + r.window_seconds
        while time.perf_counter() < deadline:
            dispatch()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        r.window_s = time.perf_counter() - t0
    n = steps - start
    r.attempted, r.counts["steps"] = n, n
    r.values["train_examples_per_s"] = n * B / r.window_s
    r.memory_peak = (torch.cuda.max_memory_allocated(dev)
                     if dev.type == "cuda" else 0)

    feed.close()
    losses = torch.cat(losses).tolist()
    sparse = tr.sparse
    shutil.rmtree(cfg.train.train_dir, ignore_errors=True)
    del tr, ms, feed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rd = rdata.load(r.cell.config["config"]["data"], bench.CACHE)
    shape = _shape(cfg, ents)
    r.counts.update(shape)
    stream = rdata.batches(rd, r.cell.config["config"], cfg.train.seed)
    batches = list(itertools.islice(stream, 2 * K))
    if r.trace:
        _work_counts(r, fam, rnn, itertools.islice(
            stream, start - 2 * K, start - 2 * K + n), n)
    check(r, cfg, fam, ents, rd, batches, losses, held, sparse, dev)


def _shape(cfg, ents) -> dict:
    d = cfg.model.dim
    loss, ht = program.mf_loss(cfg)
    return {"B": cfg.train.batch_size, "S": cfg.train.num_sampled, "D": d,
            "loss": loss, "ht": ht,
            "L": cfg.model.max_seq_len, "H": d,
            "item_fields": len(ents["item"].fields),
            "user_fields": len(ents["user"].fields) if "user" in ents else 0}


def _work_counts(r, fam, rnn, window, n: int) -> None:
    """What the window's n steps needed, for the traced run's readers:
    the valid positions of each sequence batch and the steps' FLOPs (the
    recurrence's by its cell, `rnn`; MF's by its loss, `counts["loss"]`)."""
    from roofline.counts import mf_train_step_flops, seq_train_step_flops
    c = r.counts
    if fam == "seq":
        c["valid"] = [float(b["mask"].sum()) for b in window]
        c["flops"] = sum(seq_train_step_flops(v, c["S"], c["D"], c["H"],
                                              c["item_fields"], rnn)
                         for v in c["valid"])
    else:
        c["flops"] = n * mf_train_step_flops(
            c["B"], c["S"], c["D"], c["user_fields"], c["item_fields"],
            c["loss"])


def check(r, cfg, fam, ents, rd, batches, losses, held, sparse,
          dev) -> None:
    """The 2K checked steps against the reference's (see
    reference/train.py for the numbers compared)."""
    m = rdata.static_parts(ents, rd, dev)
    p0 = weights.make(fam, ents, r.seed, dev, program.rnn_cell(cfg))
    prog = {"losses": losses,
            **{tag: {k: (p.to(dev), a.to(dev)) for k, (p, a) in st.items()}
               for tag, st in held.items()}}
    got = rtrain.gaps(reference_loss(fam, cfg, ents, m, dev), p0,
                      list(enumerate(batches)), cfg.train.learning_rate,
                      program.rules(p0, sparse), prog)
    print(f"leaves not counted (reference gradient under "
          f"{rtrain.SKIP_BELOW} of the median leaf's): {got['skipped']}",
          file=sys.stderr)
    print("loss gap by step: "
          + " ".join(f"{g:.2e}" for g in got["step_gaps"])
          + "; change gap by stage: "
          + " ".join(f"{g:.2e}" for g in got["stage_change_gaps"]),
          file=sys.stderr)
    for name in ("loss_gap", "grad_gap", "change_gap"):
        r.check(name, got[name])


def reference_loss(fam, cfg, ents, m, dev, rows=None):
    """loss(params, (step, batch), dt) of the reference, for the loss the
    configuration trains (`program.mf_loss`): the sampled CE draws the
    step's negatives from the run's seed; an in-batch loss draws none, its
    candidates are the batch's positives. rows: a slice of each batch's
    rows, the candidates cut with them (a planted fault: the loss over
    part of the batch)."""
    S, V = cfg.train.num_sampled, ents["item"].num
    rnn = program.rnn_cell(cfg)
    kind, ht = program.mf_loss(cfg)
    cut = rows or slice(None)

    def t(b, k):
        return torch.as_tensor(np.asarray(b[k])[cut], device=dev)

    def loss(flat, item, dt):
        step, b = item
        if kind in model.BATCH_LOSSES:
            return model.BATCH_LOSSES[kind](
                weights.nest(flat), m, t(b, "user"), t(b, "pos_item"), dt,
                ht)
        negs = keys.negatives(cfg.train.seed, step, S, V, dev)
        P = weights.nest(flat)
        if fam == "mf":
            return model.mf_loss(P, m, t(b, "user"), t(b, "pos_item"),
                                 negs, dt)
        return model.seq_loss(P, m, t(b, "inputs"), t(b, "targets"),
                              t(b, "mask"), negs, dt, rnn)
    return loss
