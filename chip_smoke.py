#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (arec_torch) on one CUDA card and check it.

    python3 chip_smoke.py        # from the root of a checkout; one card

1. Prints the card (name, power limit) and builds every kernel of the
   serving and training paths from the sources in arec_torch/csrc/ (one
   nvcc each, all started together); prints each library's ptxas report,
   what the tensor-core kernels (the CE's, the bf16 scan forwards' serving
   and training launches and the three bf16 stages of each scan backward,
   at H = 128) use as they launch (registers, spills, shared memory,
   blocks per SM) and their HMMA instruction counts (cuobjdump), which
   must not be zero.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes its path gives it (the LSTM and GRU forwards at the serving
   shapes; their training launches and backwards and the fused
   sampled-softmax CE forward and backward at c4's training shape; the CE
   again at the MF training shape; the row scatter, bit for bit, into the
   MF model's packed item and user tables, at its edge cases and at each
   (source, destination) phase pair of its 16-byte path, with its launch
   plan: grid, registers, resident blocks, vector width), checks
   that the scans repeat bit for bit, and times kernel, plain version and
   a library call (a yardstick only); the bf16 scan backwards also by
   stage (gate pass, sweep, dWh).
3. Serves the c4 sequence model (configs/c4_lstm_attr_xing.json: LSTM,
   H = 128, L = 50, attribute fusion) at the XING-cardinality synthetic
   twin's item vocabulary (1.3M items, deg-12 tags over 4096) with seeded
   random weights, through `Recommender.from_histories` and the request
   loop, counting kernel launches on that run, and checks the answers and
   the query states against the plain scan.
4. Trains c4 on the same twin: `seq_batches` → `make_train_step` (Adagrad,
   dense updates) for one warm-up and 20 counted steps, printing loss,
   grad_norm, step time, examples/s, launches per kernel and a profile of
   one step; checks one step's gradients on the kernel path against the
   plain path on the same batch and negatives, and a two-segment step's
   carried gradient; then Recall@30 over a few `eval_batches` through the
   serving top-k.
5. Steps 3 and 4 again with the cell set to GRU (`model.cell=gru`, the
   same model otherwise), through the GRU scan kernels.
6. The MF model of configs/syn_xing_full.json at its own width (dim 128,
   1.3M items, 1.5M users, packed sparse-Adagrad tables) on one card:
   serves 256 users through `Recommender.for_users` and 3 request-loop
   lines, checking the answers against an independent f32 top-k; then
   trains it with the sparse touched-rows step (`mf_batches` →
   `make_sparse_train_step`, whose table write-back is the row-scatter
   kernel) for one warm-up and 20 counted steps, with a profile of one
   step; checks one sparse step against one dense step from the same
   state, and that step's write-back, kernel against plain version, bit
   for bit; then Recall@30.
7. K steps per dispatch, one CUDA graph replay for K = 8 steps
   (`arec_torch.train.graph`, the configs' steps_per_dispatch), at full
   width: c4's LSTM dense step (B1's training launch, B2, B5, B6) and the
   MF sparse step (B5, B6, B7), each after one eager step under
   `torch.cuda.set_sync_debug_mode("error")`: from one seeded state, 24
   eager steps twice (A) against 8 eager warm-up steps, the capture and
   two replays (B), every state leaf and each step's loss, lr and
   grad_norm bit-equal to A or within A's own run-to-run gap (printed);
   a `decay_lr` and one more replay, held the same way; the wrappers'
   launch counts over B (the warm-up's and the capture's; a replay runs
   no wrapper) and the three replays' kernel launches, counted by symbol
   in a profiler trace of them; eager and graph
   ms a step over 5 K-step runs each, device busy, idle share and device
   activities a step of each (profiler), the capture's wall, peak memory
   with the graph's pool. A small c4 with keep_prob 0.8 at K = 2: replays
   equal to eager steps, and the dropout masks of two replays differ.
   The Trainer runs of 8 and 11 go through the graph too (their configs'
   steps_per_dispatch is 8): the resumed MF run must be bit-equal to the
   straight one, and the first MF run's own AREC_PROFILE_DIR trace (the
   default window, steps 10..14) holds its replay of steps 8..15, whose
   kernel launches are counted by symbol.
8. The main path as its users run it, on a temporary train_dir under
   _train/ (deleted at the end): syn_xing_full's MF trained through
   `arec_torch.cli.main.main` (the Trainer, async checkpoints of ~2.9 GB
   every 16 steps, steps_per_dispatch 8) to step 32; a second invocation
   to 48 that restores step 32 mid-epoch, held against a straight 48-step
   run (bit-equality reported); `Recommender(cfg)` served from the
   checkpoint, a 16-step run that writes a newer one, `refresh()` (its
   peak memory against the first restore's, its lists against the
   trainer's in-memory state and a fresh Recommender) and `--recommend
   --out`; c4's LSTM through the Trainer (16 steps, one 4 GB save) and
   served from its checkpoint. Launches of each kernel are counted over
   these runs.
   Then the same checkpoints on a device mesh: the MF one on
   syn_xing_full's own 2 x 4 mesh (row_shard "shuffle") and c4's on 2 x 2,
   each rank a gloo process sharing the one card (NCCL refuses two ranks
   on one GPU), each through `Recommender(cfg)`; every rank's lists equal
   the one-card Recommender's up to ties, and the LSTM forward kernel
   runs on every rank of c4's mesh. A one-rank NCCL group then takes the
   mesh paths' collectives at syn_xing_full's full width (1 x 1 mesh): the
   exchange and masked lookups of a training batch's gather rows, bit for
   bit against `dense_lookup`, and the sharded top-k over 1,304,126 items
   against `topk_with_mask` up to ties, each timed beside it.
   Then training on a device mesh (`mesh_train_phase`): syn_xing_full's
   MF on its own 2 x 4 (the sparse mesh step, bf16) as 8 gloo ranks
   sharing the card, through `cli.main.main`: 8 steps with a save, a
   second invocation resuming to 16 and evaluating; an f32 run of 4 steps
   and 4 of the dense mesh step in the same ranks; the same runs on
   one card in the script's process: the f32 run agrees on every final
   leaf (rtol 2e-4, atol 2e-5), the bf16 run within a stated bf16
   tolerance (its largest gap printed), the sparse and dense mesh steps
   agree, the mesh's checkpoint restores on one card and evaluates to the
   mesh's recall; B5, B6 and B7 launch on every rank. c4's LSTM on 2 x 2
   (the dense mesh step) for 4 steps against 4 on one card, B1's training
   launch and B2 on every rank. A one-rank NCCL group runs the sparse
   mesh step and the dense mesh step at full width against the one-card
   steps (sparse bit for bit), ms per step beside. Startup, train()
   seconds, peak memory and launches are printed per rank.
9. The host input path at c4's shape on the twin: `seq_batches` and
   `eval_batches` packed by the C++ packer against the numpy twin (equal
   outputs, ms a batch each); the old pageable `.to()` against the pinned
   copy-stream staging of `to_device` for MF's and c4's batches; how long
   each copy call blocks its thread behind a 10 ms GPU spin; 64 batches
   staged through `prefetch` under a slower consumer, each equal to its
   numpy source.
10. The approximate top-k at serving width: syn_xing_full's MF
   `for_users` (256 users, V = 1,304,126) and c4's LSTM batch, each with
   serve_recall_target 1.0 and 0.95: batch latency, device busy, the
   reduction's (R, l) and the top-30 overlap with the exact lists (MF:
   at least 0.90); no seen id served.
11. The real configurations from raw dumps written in the published
   layouts under _data/ (deleted at the end): a RecSys'17 XING dump
   (1,304,126 items) prepared into configs/c4_lstm_attr_xing.json's
   dataset (V 50,000 after truncation) and c4 trained 16 steps through
   `cli.main.main`, Recall@30 with eval_recall_target 1.0 and 0.95, 8
   requests served with serve_recall_target 1.0 and 0.95; an ML-1M
   GroupLens dump at the published counts prepared, c2 trained 16 steps
   and 256 users served.
12. Prints one `{"kernels": [...]}` JSON line and, last, the
   `{"ok": true, "device": {...}}` line.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, when there is no CUDA device or the port is
not beside it.
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
C4 = os.path.join(ROOT, "configs", "c4_lstm_attr_xing.json")
DATA_DIR = os.path.join(ROOT, "_data", "chip_smoke")

# The XING twin's data section (configs/syn_xing_full.json); the user and
# interaction counts shape no served tensor, so they are cut to keep the
# host-side prep short.
TWIN = {"data.dataset": "synthetic", "data.syn_items": 1_300_000,
        "data.syn_mulhot_degree": 12, "data.syn_tag_vocab": 4096}
CUTS = {"data.syn_users": (1_500_000, 20_000),
        "data.syn_interactions": (12_000_000, 200_000)}

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # f32 outside the tensor cores
# kernel vs plain: f32 at tests/test_seq.py's forward tolerance; bf16
# looser because both sides round h to bf16 at the same points but sum in
# different orders, so an h on a rounding boundary can land one bf16 ulp
# (2^-8 relative) apart and carry that through later steps
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}
# scan backward (LSTM, GRU) vs plain: f32 at tests/test_seq.py's gradient
# tolerance; bf16 looser, as the gate derivatives are rounded before the
# products
BWD_TOL = {"float32": dict(rtol=2e-3, atol=2e-4),
           "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# sampled CE vs plain: f32 at tests/test_fused_softmax.py's value and
# gradient tolerances; bf16 at the tolerances of
# tests/test_torch_sampled_softmax_cuda.py (one bf16 ulp of a product)
CE_VAL = {"float32": dict(rtol=1e-5, atol=1e-6),
          "bfloat16": dict(rtol=1e-3, atol=1e-3)}
CE_GRAD = {"float32": dict(rtol=2e-4, atol=2e-5),
           "bfloat16": dict(rtol=2e-2, atol=1e-4)}
# a train step's gradients, kernel path vs plain path (bf16 compute): per
# parameter, max |kernel − plain| ≤ STEP_GRAD_TOL · max |plain|. The paths
# round to bf16 at different points (the kernels round the gate and
# softmax residues before their products, autograd of the plain path
# rounds each product's cotangent), each worth 2^-8 of a term.
STEP_GRAD_TOL = 3e-2
LOSS_TOL = 1e-3
# two checkpointed segments vs one pass, f32: the same per-step arithmetic,
# so only the order of the table-gradient and dWh sums differs
SEG_GRAD_TOL = 1e-3
TRAIN_STEPS = 20
EVAL_BATCHES = 4

XING = os.path.join(ROOT, "configs", "syn_xing_full.json")
# syn_xing_full's MF model on one card (it trains on its own 2 x 4 mesh in
# the mesh training phase, and its checkpoint is served on that mesh in
# the Trainer phase). The interaction count shapes no tensor (1M interactions
# still give 93 batches of 8192), so it is cut to keep the host-side prep
# short; the user count shapes the user table and stays.
MF_SETS = {"mesh.data": 1, "mesh.model": 1, "data.data_dir": DATA_DIR}
MF_CUTS = {"data.syn_interactions": (12_000_000, 1_000_000)}
# the packed [V, 2D] tables' rows and widths, and the touched-row bound of
# one sparse step (unique gather rows + the dense prefix) at batch 8192
# and S = 2048, as syn_xing_full gives them
MF_SHAPES = {"item": (1_304_126, 258, 14_337 + 28),
             "user": (1_504_123, 256, 12_289 + 25)}
# one sparse step against one dense step from the same state, f32 tables:
# the forward values agree bit for bit (the same rows enter the same
# products), so the parameters differ only by the embedding backward's
# summation order and the two Adagrad forms (1/(√a + eps) against
# rsqrt(a + eps)): tests/test_sparse.py's tolerance. Untouched rows are
# compared bit for bit.
SPARSE_DENSE = dict(rtol=2e-5, atol=1e-6)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


GATES = {"lstm": 4, "gru": 3}


def layer_inputs(L, B, H, dev, seed=0, cell="lstm"):
    """xw, wh, left-padded mask (varied lengths, a few all-pad rows),
    nonzero h0 and, for the LSTM, c0 — as the serving scan hands them to
    one layer."""
    import numpy as np
    import torch
    G = GATES[cell] * H
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, B)
    lengths[:4] = 0
    mask = np.arange(L)[None, :] >= (L - lengths)[:, None]
    arrays = [rng.standard_normal((L, B, G)),
              rng.standard_normal((H, G)) / math.sqrt(2 * H),
              mask,
              rng.standard_normal((B, H)) * 0.5]
    if cell == "lstm":
        arrays.append(rng.standard_normal((B, H)) * 0.5)
    return [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
            for a in arrays]


def roofline(nbytes, flops, dtype):
    """(bound_ms, bound_by, bytes, flops): the larger of the bytes over the
    card's memory rate and the FLOPs over its peak for `dtype`."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def bound(L, B, H, valid, dtype, cell="lstm"):
    """The forward scan's roofline (lstm_scan_fwd, gru_scan_fwd): xw, mask,
    the carried-in state ((h0, c0) or h0) and Wh read once, h_all (and the
    LSTM's cT) written once, against 2·G·H FLOPs (G = 4H or 3H) for each
    valid (row, step)."""
    welt = 2 if dtype == "bfloat16" else 4
    G, carries = GATES[cell] * H, 2 if cell == "lstm" else 1
    nbytes = 4 * (L * B * G + B * L + carries * B * H + L * B * H
                  + (carries - 1) * B * H) + welt * G * H
    return roofline(nbytes, 2 * G * H * valid, dtype)


def bound_resid(L, B, H, valid, dtype, cell="lstm"):
    """The training launch: the forward's bytes plus the residuals (hp, cp
    or hp) written."""
    _, _, nbytes, flops = bound(L, B, H, valid, dtype, cell)
    carries = 2 if cell == "lstm" else 1
    return roofline(nbytes + carries * 4 * L * B * H, flops, dtype)


def bound_bwd(L, B, H, valid, dtype, cell="lstm"):
    """The backward scan (lstm_scan_bwd, gru_scan_bwd): xw, mask, the
    residuals (hp, cp or hp), dh_out, the LSTM's dcT and Wh read; dxw, dWh
    and d(h0, c0) or dh0 written; three [., H]·[H, G]-sized products (gate
    recompute, dh carry, dWh) for each valid (row, step) (pad steps add
    nothing)."""
    welt = 2 if dtype == "bfloat16" else 4
    G, carries = GATES[cell] * H, 2 if cell == "lstm" else 1
    nbytes = 4 * (2 * L * B * G + B * L + (carries + 1) * L * B * H
                  + (2 * carries - 1) * B * H + H * G) + welt * G * H
    return roofline(nbytes, 3 * 2 * G * H * valid, dtype)


def bound_ce(N, S, D, Dt, dtype, backward):
    """sampled_ce: q, v_true, v_samp, c_samp and the [N] row inputs read
    (lse too in the backward); (ce, lse) or (dq, d(v_true), d(v_samp),
    d(c_samp), d(tl_base)) written. One [N, D]·[D, S] product forward
    (the logits); three backward (logits, dq, d(v_samp))."""
    ins = N * D + N * Dt + S * D + S + 3 * N + S      # + tl, ids, w; sids
    if backward:
        nbytes = 4 * (ins + N + 1 + N * D + N * Dt + S * D + S + N)
    else:
        nbytes = 4 * (ins + 2 * N + 2)
    return roofline(nbytes, (6 if backward else 2) * N * S * D, dtype)


def _kernel_name(mangled):
    """A kernel's name from its mangled symbol, with its integer or bool
    template arguments: `lstm_sweep_kernel<1>`."""
    import re
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        n = re.match(r"\d+", mangled[pos:]).group()
        pos += len(n)
        name = mangled[pos:pos + int(n)]
        pos += int(n)
    args = re.match(r"I((?:L[a-z]+\d+E)+)E", mangled[pos:])
    if args:
        name += "<" + ",".join(re.findall(r"L[a-z]+(\d+)E",
                                          args.group(1))) + ">"
    return name


def hmma_counts(build, kernel):
    """{kernel function: tensor-core (HMMA) instructions in its SASS} of
    the library of `kernel`, by the toolkit's cuobjdump ({} where it is
    missing)."""
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        log("cuobjdump not found: no SASS instruction count")
        return {}
    sass = subprocess.run([tool, "-sass", str(build.library_path(kernel))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = _kernel_name(line.split("Function :")[1].strip())
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    log(f"HMMA instructions in the SASS of {kernel}: {counts}")
    return counts


def ce_kernel_report(build, tks):
    """What the CE kernels use as they launch at D = 128 (registers, spilled
    bytes, dynamic shared memory, resident blocks per SM), and, where the
    toolkit's cuobjdump is present, the tensor-core (HMMA) instructions in
    each kernel's SASS; the bf16 kernels must have some. Returns {kernel:
    HMMA count} ({} without cuobjdump)."""
    for name, k in tks.kernel_info(128).items():
        log(f"{name} at D=128: {k['registers']} registers, "
            f"{k['local_bytes']} local bytes, {k['smem_bytes']} B dynamic "
            f"shared memory, {k['blocks_per_sm']} blocks per SM")
    counts = hmma_counts(build, tks.KERNEL)
    mma = {k: n for k, n in counts.items() if "_mma_" in k}
    assert not counts or (mma and all(mma.values())), (
        f"bf16 kernels without HMMA: {mma}")
    return counts


def scan_fwd_report(build, tk, kernel, H=128):
    """What the bf16 tensor-core scan forward `kernel` uses as it launches
    at width H (serving and training launches: registers, spilled bytes,
    dynamic shared memory, resident blocks per SM), and the HMMA
    instruction counts of its library: each tensor-core kernel
    (`*_fwd_mma_*`) must have some. Returns ({launch: launch resources},
    {kernel function: HMMA count})."""
    info = tk.fwd_kernel_info(kernel, H)
    for launch, k in info.items():
        log(f"{kernel} bf16 {launch} launch at H={H}: {k['registers']} "
            f"registers, {k['local_bytes']} local bytes, {k['smem_bytes']} B "
            f"dynamic shared memory, {k['blocks_per_sm']} blocks per SM")
    counts = hmma_counts(build, kernel)
    mma = {k: n for k, n in counts.items() if "_fwd_mma_" in k}
    assert not counts or (mma and all(mma.values())), (
        f"{kernel}: bf16 kernels without HMMA: {mma}")
    return info, counts


def fwd_times(fn, plain, bounds, plain_iters=10):
    """The forward kernel `fn()`'s device time per call queued behind a GPU
    spin (`queued_ms`: back to back, a call of tens of µs times its
    wrapper's host cost) and back to back, its plain version `plain()`'s,
    and the bound (`bound` / `bound_resid`)."""
    return dict(ms=queued_ms([fn]), back_to_back_ms=cuda_ms(fn, 50),
                plain_ms=cuda_ms(plain, plain_iters),
                **dict(zip(BOUND_KEYS, bounds)))


def assert_repeats(fn, got, kernel):
    """fn() gives the tensors `got` again, bit for bit (no atomics)."""
    import torch
    again = fn()
    assert all(torch.equal(g, a) for g, a in zip(got, again)), (
        f"{kernel} does not repeat bit for bit")


def scan_bwd_report(build, tk, kernel, H=128):
    """What the bf16 stages of the scan backward `kernel` use as they
    launch at width H (registers, spilled bytes, dynamic shared memory,
    resident blocks per SM), and their HMMA instruction counts: the gate
    pass, the sweep and the dWh product must each have some. Returns
    ({stage: launch resources}, {kernel function: HMMA count})."""
    info = tk.bwd_kernel_info(kernel, H)
    for stage, k in info.items():
        log(f"{kernel} bf16 {stage} at H={H}: {k['registers']} registers, "
            f"{k['local_bytes']} local bytes, {k['smem_bytes']} B dynamic "
            f"shared memory, {k['blocks_per_sm']} blocks per SM")
    counts = hmma_counts(build, kernel)
    mma = {k: n for k, n in counts.items()
           if any(s in k for s in ("gates", "sweep", "dwh_mma"))}
    assert not counts or (len(mma) >= 3 and all(mma.values())), (
        f"{kernel}: bf16 stages without HMMA: {mma}")
    return info, counts


def stage_ms(fn, reps=20):
    """Device ms per call of each stage of a bf16 scan backward `fn()`
    (kernels by name under torch.profiler, over `reps` calls): the gate
    pass, the sweep, the dWh product with the sum of its partials, and
    any other kernel of the call (the wrapper's cast of Wh)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {"gates": 0.0, "sweep": 0.0, "dwh": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.self_device_time_total <= 0):
            continue
        stage = next((s for s, key in (("gates", "gates_kernel"),
                                       ("sweep", "_sweep_"),
                                       ("dwh", "dwh_")) if key in e.key),
                     "other")
        out[stage] += e.self_device_time_total / reps / 1e3
    return out


def kernel_phase(dev):
    """lstm_scan_fwd vs lstm_layer_plain at the serving shapes (repeating
    bit for bit), and times."""
    import torch
    from arec_torch.kernels import lstm_scan as tk

    L, H = 50, 128
    errs = {}
    for B in (256, 200):
        xw, wh, mask, h0, c0 = layer_inputs(L, B, H, dev, seed=B)
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            fn = lambda: tk.lstm_layer(xw, wh, mask, h0, c0, dt)
            got = fn()
            torch.cuda.synchronize()
            want = tk.lstm_layer_plain(xw, wh, mask, h0, c0, dt)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, **TOL[name])
            assert_repeats(fn, got, tk.KERNEL)
            errs[name] = max(errs.get(name, 0.0), err)
            log(f"kernel vs plain  B={B} L={L} H={H} {name} "
                f"({tk.fwd_route(dt, H)} kernel): max abs err {err:.3e} "
                f"(tolerance {TOL[name]}), repeats bit for bit")

    B = 256
    xw, wh, mask, h0, c0 = layer_inputs(L, B, H, dev, seed=B)
    valid = int(mask.sum())
    times = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        times[name] = fwd_times(
            lambda: tk.lstm_layer(xw, wh, mask, h0, c0, dt),
            lambda: tk.lstm_layer_plain(xw, wh, mask, h0, c0, dt),
            bound(L, B, H, valid, name))

    # yardstick: cuDNN's LSTM on the same [L, B, H] sequence, all-ones mask
    # (no per-step mask exists there) and its own input projection included
    torch.backends.cudnn.allow_tf32 = False
    x = torch.randn(L, B, H, device=dev)
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        lstm = torch.nn.LSTM(H, H, device=dev, dtype=dt)
        # one weight buffer, as cuDNN wants; a no-op for bf16, which torch's
        # flatten_parameters does not take, so that call compacts its
        # weights every time (and warns so)
        lstm.flatten_parameters()
        xs, st = x.to(dt), (h0[None].to(dt), c0[None].to(dt))
        with torch.inference_mode():
            times[name]["library_ms"] = cuda_ms(lambda: lstm(xs, st), 50)
    for name, t in times.items():
        report("lstm_scan_fwd", f"B={B} L={L} H={H}", name, t,
               "cuDNN nn.LSTM, all-ones mask, with input projection")
    return errs, times


DTYPES = ("float32", "bfloat16")
BOUND_KEYS = ("bound_ms", "bound_by", "bytes", "flops")


def max_err(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def report(kernel, shape, name, t, library):
    b2b = t.get("back_to_back_ms")
    log(f"{kernel} {shape} {name}: kernel {t['ms']:.4f} ms"
        + (f" (device time queued behind a GPU spin; back to back, with "
           f"its wrapper's host cost, {b2b:.4f} ms)" if b2b else "")
        + f", plain {t['plain_ms']:.4f} ms, library ({library}) "
        f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}: {t['bytes']} bytes, {t['flops']} FLOPs)")


def lstm_train_phase(dev):
    """lstm_scan_fwd's training launch (with the hp, cp residuals) and
    lstm_scan_bwd against their plain versions at c4's training shape
    (L = 50, B = 128, H = 128) and a ragged B = 100, with all-pad rows,
    nonzero (h0, c0) and a nonzero dcT; then their times at B = 128."""
    import numpy as np
    import torch
    from arec_torch.kernels import lstm_scan as tk

    L, H = 50, 128

    def operands(B):
        rng = np.random.default_rng(B + 7)
        cot = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dev) for s in ((L, B, H), (B, H))]     # dh_out, dcT
        return layer_inputs(L, B, H, dev, seed=B + 1) + cot

    errs = {"fwd": {}, "bwd": {}}
    for B in (128, 100):
        xw, wh, mask, h0, c0, dh, dcT = operands(B)
        for name in DTYPES:
            dt = getattr(torch, name)
            fwd = lambda: tk.lstm_scan_fwd(xw, wh, mask, h0, c0, dt,
                                           residuals=True)
            got = fwd()
            torch.cuda.synchronize()
            want = tk.lstm_layer_plain(xw, wh, mask, h0, c0, dt,
                                       residuals=True)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, **TOL[name])
            assert_repeats(fwd, got, tk.KERNEL)
            e_f = max_err(got, want)
            hp, cp = want[2:]
            got = tk.lstm_layer_bwd(xw, wh, mask, hp, cp, dh, dcT, dt)
            torch.cuda.synchronize()
            want = tk.lstm_layer_bwd_plain(xw, wh, mask, hp, cp, dh, dcT, dt)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, **BWD_TOL[name])
            again = tk.lstm_layer_bwd(xw, wh, mask, hp, cp, dh, dcT, dt)
            assert all(torch.equal(g, a) for g, a in zip(got, again)), (
                "lstm_scan_bwd does not repeat bit for bit")
            e_b = max_err(got, want)
            errs["fwd"][name] = max(errs["fwd"].get(name, 0.0), e_f)
            errs["bwd"][name] = max(errs["bwd"].get(name, 0.0), e_b)
            log(f"kernel vs plain  B={B} L={L} H={H} {name}: training "
                f"forward (h_all, cT, hp, cp) max abs err {e_f:.3e} "
                f"(tolerance {TOL[name]}); lstm_scan_bwd (dxw, dWh, dh0, "
                f"dc0) max abs err {e_b:.3e} (tolerance {BWD_TOL[name]}); "
                f"both repeat bit for bit")

    B = 128
    xw, wh, mask, h0, c0, dh, dcT = operands(B)
    valid = int(mask.sum())
    times = {"fwd": {}, "bwd": {}}
    for name in DTYPES:
        dt = getattr(torch, name)
        hp, cp = tk.lstm_layer_plain(xw, wh, mask, h0, c0, dt,
                                     residuals=True)[2:]
        times["fwd"][name] = fwd_times(
            lambda: tk.lstm_scan_fwd(xw, wh, mask, h0, c0, dt,
                                     residuals=True),
            lambda: tk.lstm_layer_plain(xw, wh, mask, h0, c0, dt,
                                        residuals=True),
            bound_resid(L, B, H, valid, name))
        bwd_k = lambda: tk.lstm_layer_bwd(xw, wh, mask, hp, cp, dh, dcT, dt)
        times["bwd"][name] = dict(
            ms=queued_ms([bwd_k]), back_to_back_ms=cuda_ms(bwd_k, 50),
            plain_ms=cuda_ms(lambda: tk.lstm_layer_bwd_plain(
                xw, wh, mask, hp, cp, dh, dcT, dt), 5),
            **dict(zip(BOUND_KEYS, bound_bwd(L, B, H, valid, name))))
        if name == "bfloat16":
            stages = stage_ms(bwd_k)

    # yardstick: cuDNN's LSTM on the same [L, B, H] sequence (all-ones mask,
    # its own input projection included): its training forward, and its
    # forward + backward less that forward
    torch.backends.cudnn.allow_tf32 = False
    x = torch.randn(L, B, H, device=dev)
    gy = torch.randn(L, B, H, device=dev)
    for name in DTYPES:
        dt = getattr(torch, name)
        lstm = torch.nn.LSTM(H, H, device=dev, dtype=dt)
        lstm.flatten_parameters()
        xs = x.to(dt).requires_grad_()
        st, g = (h0[None].to(dt), c0[None].to(dt)), gy.to(dt)
        fwd = cuda_ms(lambda: lstm(xs, st), 20)
        both = cuda_ms(lambda: lstm(xs, st)[0].backward(g), 20)
        times["fwd"][name]["library_ms"] = fwd
        times["bwd"][name]["library_ms"] = both - fwd
    shape = f"B={B} L={L} H={H}"
    for name in times["fwd"]:
        report("lstm_scan_fwd (training launch, with hp/cp)", shape, name,
               times["fwd"][name], "cuDNN nn.LSTM training forward, "
               "all-ones mask, with input projection")
        report("lstm_scan_bwd", shape, name, times["bwd"][name],
               "cuDNN nn.LSTM forward+backward less its forward, all-ones "
               "mask")
    log(f"lstm_scan_bwd bf16 {shape} by stage (device ms per call, "
        f"profiler): " + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    times["bwd_stages_ms"] = stages
    return errs, times


def ce_inputs(N, S, D, aug, dev, seed):
    """The fused CE's operands as c4's training step hands them over:
    q [N, D]; v_true [N, D+1] (aug: the raw output-table rows) or [N, D];
    v_samp [S, D]; c_samp [S]; tl_base [N]; true ids (1/8 of the sampled
    ids forced to hit); 0/1 position weights."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    true_ids = rng.integers(0, 1_300_000, N).astype(np.int32)
    sampled_ids = rng.integers(0, 1_300_000, S).astype(np.int32)
    sampled_ids[: S // 8] = true_ids[: S // 8]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    arrays = [f(N, D), f(N, D + aug) * 0.3, f(S, D) * 0.3, f(S) * 0.5,
              f(N) * 0.5, true_ids, sampled_ids,
              rng.integers(0, 2, N).astype(np.float32)]
    return [torch.from_numpy(a).to(dev) for a in arrays]


def ce_check(N, S, D, aug, dev, g_num):
    """sampled_ce_fwd / sampled_ce_bwd against their plain versions at one
    shape, both dtypes, weighted, with forced accidental hits; each repeats
    bit for bit. Returns {dtype: (forward err, backward err)}."""
    import torch
    from arec_torch.kernels import sampled_softmax as tks

    args = ce_inputs(N, S, D, aug, dev, seed=aug + N)
    out = {}
    for name in DTYPES:
        dt = getattr(torch, name)
        got = tks.sampled_ce_fwd(*args, dt)
        torch.cuda.synchronize()
        want = tks.sampled_ce_fwd_plain(*args, dt)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **CE_VAL[name])
        again = tks.sampled_ce_fwd(*args, dt)
        assert all(torch.equal(g, a) for g, a in zip(got, again)), (
            "sampled_ce_fwd does not repeat bit for bit")
        e_f = max_err(got[2:], want[2:])            # per-row ce, lse
        num_rel = abs(float(got[0] / want[0]) - 1.0)
        lse = want[3]
        got = tks.sampled_ce_bwd(*args, lse, g_num, dt)
        torch.cuda.synchronize()
        want = tks.sampled_ce_bwd_plain(*args, lse, g_num, dt)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **CE_GRAD[name])
        again = tks.sampled_ce_bwd(*args, lse, g_num, dt)
        assert all(torch.equal(g, a) for g, a in zip(got, again)), (
            "sampled_ce_bwd does not repeat bit for bit")
        e_b = max_err(got, want)
        out[name] = (e_f, e_b)
        if name == "bfloat16":
            # what the bf16 backward forms again from the d-order logit
            p = torch.exp(tks._logits_plain(args[0], args[2], args[3],
                                            args[5], args[6], dt)
                          - lse[:, None])
            per_row = ((p > 2.0 ** -8) & (args[7] != 0)[:, None]).sum(1)
            log(f"  residues above |g·w|·2^-8 (formed again in d order): "
                f"{int(per_row.sum())}, {float(per_row.float().mean()):.2f} "
                f"a row, at most {int(per_row.max())}")
        log(f"kernel vs plain  N={N} S={S} D={D} aug={aug} {name}: "
            f"sampled_ce_fwd (ce, lse) max abs err {e_f:.3e}, Σw·ce "
            f"relative err {num_rel:.3e} (tolerance {CE_VAL[name]}); "
            f"sampled_ce_bwd max abs err {e_b:.3e} (tolerance "
            f"{CE_GRAD[name]}); both repeat bit for bit")
    return out


def ce_timing(N, S, D, aug, dev, g_num):
    """Times of both CE kernels, their plain versions and the library
    yardstick at one shape, both dtypes: device time per call
    (`queued_ms`: the bf16 kernels take tens of µs, less than their
    wrapper's host cost), and the kernel's back-to-back time with that
    host cost (`back_to_back_ms`)."""
    import torch
    import torch.nn.functional as F
    from arec_torch.kernels import sampled_softmax as tks

    args = ce_inputs(N, S, D, aug, dev, seed=aug + N)
    q, vt, vs, cs, tl, tid, sid, w = args
    times = {"fwd": {}, "bwd": {}}
    for name in DTYPES:
        dt = getattr(torch, name)
        lse = tks.sampled_ce_fwd_plain(*args, dt)[3]
        fwd_k = lambda: tks.sampled_ce_fwd(*args, dt)
        bwd_k = lambda: tks.sampled_ce_bwd(*args, lse, g_num, dt)
        times["fwd"][name] = dict(
            ms=queued_ms([fwd_k]), back_to_back_ms=cuda_ms(fwd_k, 50),
            plain_ms=queued_ms(
                [lambda: tks.sampled_ce_fwd_plain(*args, dt)], 16),
            **dict(zip(BOUND_KEYS, bound_ce(N, S, D, D + aug, name, False))))
        times["bwd"][name] = dict(
            ms=queued_ms([bwd_k]), back_to_back_ms=cuda_ms(bwd_k, 50),
            plain_ms=queued_ms([lambda: tks.sampled_ce_bwd_plain(
                *args, lse, g_num, dt)], 16),
            **dict(zip(BOUND_KEYS, bound_ce(N, S, D, D + aug, name, True))))

        # yardstick: torch.matmul in `dt` + F.cross_entropy over the
        # materialised [N, 1+S] logits (true logit first), weighted sum
        zero = torch.zeros(N, dtype=torch.long, device=dev)
        hit = sid[None, :] == tid[:, None]

        def library(q, vt, vs, cs):
            tl_ = tl + (q * vt[:, :D]).sum(1)
            if aug:
                tl_ = tl_ + vt[:, D]
            raw = torch.matmul(q.to(dt), vs.to(dt).T).float() + cs
            logits = torch.cat([tl_[:, None],
                                torch.where(hit, -1e9, raw)], 1)
            return (F.cross_entropy(logits, zero, reduction="none")
                    * w).sum()

        leaves = [t.clone().requires_grad_() for t in (q, vt, vs, cs)]
        with torch.no_grad():
            times["fwd"][name]["library_ms"] = queued_ms(
                [lambda: library(q, vt, vs, cs)], 16)
        fwd = queued_ms([lambda: library(*leaves)], 16)
        both = queued_ms([lambda: library(*leaves).backward()], 16)
        times["bwd"][name]["library_ms"] = both - fwd
    shape = f"N={N} S={S} D={D} {'aug' if aug else 'non-aug'}"
    for name in times["fwd"]:
        for kind, library in (
                ("fwd", f"torch.matmul in {name} + F.cross_entropy over the "
                        f"materialised [N, 1+S] logits, forward"),
                ("bwd", "the same, forward+backward less its forward")):
            t = times[kind][name]
            report(f"sampled_ce_{kind}", shape, name, t, library)
            log(f"  (device times per call, queued behind a GPU spin; "
                f"the kernel back to back, with its wrapper's host cost: "
                f"{t['back_to_back_ms']:.4f} ms)")
    return times


def ce_phase(dev):
    """sampled_ce_fwd / sampled_ce_bwd against their plain versions at c4's
    training shape (N = 128·50 rows, S = 1024, D = 128), aug and non-aug,
    and at the MF training shape of syn_xing_full (N = 8192, S = 2048,
    D = 128, non-aug: MF's `ce` gives no raw rows); then their times in
    the mode each path takes. Returns ({"c4"|"mf": errs}, {"c4"|"mf":
    times})."""
    import torch

    g_num = torch.tensor(0.7, device=dev)   # cotangent of Σ w·ce
    errs = {"c4": {"fwd": {}, "bwd": {}}, "mf": {"fwd": {}, "bwd": {}}}
    for key, (N, S, D), modes in (("c4", (6400, 1024, 128), (1, 0)),
                                  ("mf", (8192, 2048, 128), (0,))):
        for aug in modes:
            for name, (e_f, e_b) in ce_check(N, S, D, aug, dev,
                                             g_num).items():
                if aug == modes[0]:
                    errs[key]["fwd"][name] = e_f
                    errs[key]["bwd"][name] = e_b
    times = {"c4": ce_timing(6400, 1024, 128, 1, dev, g_num),
             "mf": ce_timing(8192, 2048, 128, 0, dev, g_num)}
    return errs, times


GRU_LIBRARY = ("torch.nn.GRU (cuDNN), all-ones mask, with input "
               "projection; it applies r after the h·W_n product, arec "
               "before it, so it computes another function: a cost "
               "yardstick only")


def gru_kernel_phase(dev):
    """gru_scan_fwd's serving launch against gru_layer_plain at the serving
    shapes (B = 256, 200); its training launch (with hp) and gru_scan_bwd
    against their plain versions at c4's training shape (B = 128) and a
    ragged B = 100; all with all-pad rows and a nonzero h0. Then the times
    of kernel, plain version and cuDNN's GRU (a yardstick only) at
    B = 256 (serving) and B = 128 (training)."""
    import numpy as np
    import torch
    from arec_torch.kernels import gru_scan as tg
    from arec_torch.kernels.lstm_scan import fwd_route

    L, H = 50, 128
    errs = {"fwd": {}, "train_fwd": {}, "bwd": {}}

    def note(kind, name, err):
        errs[kind][name] = max(errs[kind].get(name, 0.0), err)

    for B in (256, 200):
        xw, wh, mask, h0 = layer_inputs(L, B, H, dev, seed=B, cell="gru")
        for name in DTYPES:
            dt = getattr(torch, name)
            fwd = lambda: tg.gru_layer(xw, wh, mask, h0, dt)
            got = fwd()
            torch.cuda.synchronize()
            want = tg.gru_layer_plain(xw, wh, mask, h0, dt)
            torch.testing.assert_close(got, want, **TOL[name])
            assert_repeats(lambda: [fwd()], [got], tg.KERNEL)
            note("fwd", name, max_err([got], [want]))
            log(f"kernel vs plain  B={B} L={L} H={H} {name}: gru_scan_fwd "
                f"({fwd_route(dt, H)} kernel) max abs err "
                f"{max_err([got], [want]):.3e} (tolerance {TOL[name]}), "
                f"repeats bit for bit")

    def operands(B):
        rng = np.random.default_rng(B + 7)
        dh = torch.from_numpy(rng.standard_normal((L, B, H))
                              .astype(np.float32)).to(dev)
        return layer_inputs(L, B, H, dev, seed=B + 1, cell="gru") + [dh]

    for B in (128, 100):
        xw, wh, mask, h0, dh = operands(B)
        for name in DTYPES:
            dt = getattr(torch, name)
            fwd = lambda: tg.gru_scan_fwd(xw, wh, mask, h0, dt,
                                          residuals=True)
            got = fwd()
            torch.cuda.synchronize()
            want = tg.gru_layer_plain(xw, wh, mask, h0, dt, residuals=True)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, **TOL[name])
            assert_repeats(fwd, got, tg.KERNEL)
            e_f = max_err(got, want)
            hp = want[1]
            got = tg.gru_layer_bwd(xw, wh, mask, hp, dh, dt)
            torch.cuda.synchronize()
            want = tg.gru_layer_bwd_plain(xw, wh, mask, hp, dh, dt)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, **BWD_TOL[name])
            again = tg.gru_layer_bwd(xw, wh, mask, hp, dh, dt)
            assert all(torch.equal(g, a) for g, a in zip(got, again)), (
                "gru_scan_bwd does not repeat bit for bit")
            e_b = max_err(got, want)
            note("train_fwd", name, e_f)
            note("bwd", name, e_b)
            log(f"kernel vs plain  B={B} L={L} H={H} {name}: GRU training "
                f"forward (h_all, hp) max abs err {e_f:.3e} (tolerance "
                f"{TOL[name]}); gru_scan_bwd (dxw, dWh, dh0) max abs err "
                f"{e_b:.3e} (tolerance {BWD_TOL[name]}); both repeat bit "
                f"for bit")

    times = {"fwd": {}, "train_fwd": {}, "bwd": {}}
    xw, wh, mask, h0 = layer_inputs(L, 256, H, dev, seed=256, cell="gru")
    valid = int(mask.sum())
    for name in DTYPES:
        dt = getattr(torch, name)
        times["fwd"][name] = fwd_times(
            lambda: tg.gru_layer(xw, wh, mask, h0, dt),
            lambda: tg.gru_layer_plain(xw, wh, mask, h0, dt),
            bound(L, 256, H, valid, name, "gru"))
    B = 128
    txw, twh, tmask, th0, dh = operands(B)
    tvalid = int(tmask.sum())
    for name in DTYPES:
        dt = getattr(torch, name)
        hp = tg.gru_layer_plain(txw, twh, tmask, th0, dt, residuals=True)[1]
        times["train_fwd"][name] = fwd_times(
            lambda: tg.gru_scan_fwd(txw, twh, tmask, th0, dt,
                                    residuals=True),
            lambda: tg.gru_layer_plain(txw, twh, tmask, th0, dt,
                                       residuals=True),
            bound_resid(L, B, H, tvalid, name, "gru"))
        bwd_k = lambda: tg.gru_layer_bwd(txw, twh, tmask, hp, dh, dt)
        times["bwd"][name] = dict(
            ms=queued_ms([bwd_k]), back_to_back_ms=cuda_ms(bwd_k, 50),
            plain_ms=cuda_ms(lambda: tg.gru_layer_bwd_plain(
                txw, twh, tmask, hp, dh, dt), 5),
            **dict(zip(BOUND_KEYS, bound_bwd(L, B, H, tvalid, name,
                                             "gru"))))
        if name == "bfloat16":
            stages = stage_ms(bwd_k)

    # yardstick: cuDNN's GRU on the same [L, B, H] sequences (all-ones
    # mask, its own input projection included): its serving forward at
    # B = 256; at B = 128 its training forward, and its forward + backward
    # less that forward
    torch.backends.cudnn.allow_tf32 = False
    for name in DTYPES:
        dt = getattr(torch, name)
        gru = torch.nn.GRU(H, H, device=dev, dtype=dt)
        gru.flatten_parameters()
        xs, st = torch.randn(L, 256, H, device=dev, dtype=dt), h0[None].to(dt)
        with torch.inference_mode():
            times["fwd"][name]["library_ms"] = cuda_ms(lambda: gru(xs, st),
                                                       50)
        xs = torch.randn(L, B, H, device=dev, dtype=dt).requires_grad_()
        st, g = th0[None].to(dt), dh.to(dt)
        fwd = cuda_ms(lambda: gru(xs, st), 20)
        both = cuda_ms(lambda: gru(xs, st)[0].backward(g), 20)
        times["train_fwd"][name]["library_ms"] = fwd
        times["bwd"][name]["library_ms"] = both - fwd
    for name in DTYPES:
        report("gru_scan_fwd", f"B=256 L={L} H={H}", name,
               times["fwd"][name], GRU_LIBRARY + ", serving forward")
        report("gru_scan_fwd (training launch, with hp)", f"B={B} L={L} "
               f"H={H}", name, times["train_fwd"][name],
               GRU_LIBRARY + ", training forward")
        report("gru_scan_bwd", f"B={B} L={L} H={H}", name, times["bwd"][name],
               GRU_LIBRARY + ", forward+backward less its forward")
    log(f"gru_scan_bwd bf16 B={B} L={L} H={H} by stage (device ms per call, "
        f"profiler): " + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    times["bwd_stages_ms"] = stages
    return errs, times


def load(config, sets):
    """The config file with `--set` overrides `sets` (the CLI's own
    parsing), and its prepared dataset (built on first use, then read from
    its cache), with the seconds that took."""
    from arec_torch.cli.main import load_config, parse_args
    from arec_torch.data.io import load_or_prepare

    argv = ["--config", config] + [a for k, v in sets.items()
                                   for a in ("--set", f"{k}={v}")]
    cfg = load_config(parse_args(argv))
    t0 = time.perf_counter()
    ds = load_or_prepare(cfg.data)
    return cfg, ds, time.perf_counter() - t0


def load_c4(twin, cuts, cell="lstm"):
    """c4's config on the XING twin's data section, with the recurrent cell
    set to `cell`, and the prepared dataset."""
    return load(C4, {**twin, **{k: v for k, (_, v) in cuts.items()},
                     "data.data_dir": DATA_DIR, "model.cell": cell})


# {kernel name (its wrapper's counter): the symbol of the one device kernel
# that each call of the wrapper launches}; a profiler trace's kernel events
# are counted by it (a CUDA graph replay runs no wrapper, so its launches
# are counted only there)
KERNEL_SYMBOLS = {
    "lstm_scan_fwd": r"\blstm_(fwd_mma(_reg)?|scan_fwd)_kernel\b",
    "lstm_scan_bwd": r"\blstm_(sweep(_reg)?|scan_bwd)_kernel\b",
    "gru_scan_fwd": r"\bgru_(fwd_mma(_reg)?|scan_fwd)_kernel\b",
    "gru_scan_bwd": r"\bgru_(sweep(_reg)?|scan_bwd)_kernel\b",
    "sampled_ce_fwd": r"\bsampled_ce_fwd_(mma_)?kernel\b",
    "sampled_ce_bwd": r"\bsampled_ce_bwd_cols_(mma_)?kernel\b",
    "row_scatter": r"::scatter<",
}


def kernel_counts(events):
    """{kernel name: device launches} over (symbol, count) pairs of a
    profiler's kernel events, by KERNEL_SYMBOLS."""
    import re
    out = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for symbol, n in events:
        for name, pat in KERNEL_SYMBOLS.items():
            if re.search(pat, symbol):
                out[name] += n
    return out


def trace_kernel_counts(path):
    """kernel_counts of a Chrome trace JSON written by torch.profiler."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return kernel_counts((e.get("name", ""), 1) for e in events
                         if e.get("cat", "").lower() == "kernel")


def traced(fn):
    """fn() under torch.profiler (host and device); returns (its result,
    the profiler's device events as {key: (count, self device us)}, the
    wall ms, the device's busy ms: the union of its activity intervals, so
    work that overlaps on two streams counts once)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness.trace import union_s
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = {e.key: (e.count, e.self_device_time_total)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0}     # kernels, not aten ops
    busy_ms = union_s(
        (e.start_ns() / 1e6, (e.start_ns() + e.duration_ns()) / 1e6)
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA
        and not e.is_user_annotation())
    return result, dev, wall_ms, busy_ms


def device_breakdown(what, fn):
    """Run fn() once under torch.profiler and print device busy time (the
    union of the device's intervals), the idle share of the wall time and
    the top kernels by device time; returns (busy ms, wall ms, the number
    of device activities: kernels, copies, fills)."""
    _, dev, wall_ms, busy_ms = traced(fn)
    dev_us = {key: us for key, (_, us) in dev.items()}
    count = sum(n for n, _ in dev.values())
    log(f"profile of {what}: device busy {busy_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall (idle share {1 - busy_ms / wall_ms:.3f}), "
        f"{count} device activities")
    ce_ms = sum(us for key, us in dev_us.items() if "sampled_ce" in key) / 1e3
    if ce_ms:
        log(f"  sampled CE kernels (sampled_ce.cu): {ce_ms:.3f} ms, "
            f"{ce_ms / busy_ms:.3f} of device busy")
    rs_ms = sum(us for key, us in dev_us.items() if "::scatter<" in key) / 1e3
    if rs_ms:
        log(f"  row_scatter kernels (row_scatter.cu): {rs_ms:.4f} ms, "
            f"{rs_ms / busy_ms:.4f} of device busy")
    for key, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {us / 1e3:9.3f} ms  {key[:100]}")
    return busy_ms, wall_ms, count


def scan_counters(cell):
    """{kernel name: the wrapper whose `launches` counts it} of the scan
    kernels of `cell`, and of the other cell's (which its runs must not
    launch)."""
    from arec_torch.kernels import gru_scan as tg
    from arec_torch.kernels import lstm_scan as tk
    both = {"lstm": {tk.KERNEL: tk.lstm_layer,
                     tk.KERNEL_BWD: tk.lstm_layer_bwd},
            "gru": {tg.KERNEL: tg.gru_layer,
                    tg.KERNEL_BWD: tg.gru_layer_bwd}}
    return both[cell], both["gru" if cell == "lstm" else "lstm"]


def slice_phase(dev, cell="lstm", twin=TWIN, cuts=CUTS):
    """c4 (with the recurrent cell set to `cell`) at the XING twin's
    vocabulary, served through the port's entry points; returns the scan
    kernel's launches of the served run."""
    import numpy as np
    import torch
    from arec_torch.models.seq import SeqSpec, init_seq
    from arec_torch.serve import Recommender
    from arec_torch.train.loop import _item_latents, _query_fn
    from arec_torch.serve import _serve_loop

    scans, others = scan_counters(cell)
    (fwd_name, fwd), _ = scans.items()               # forward, backward
    cfg, ds, prep_s = load_c4(twin, cuts, cell)
    log("reduced: " + ", ".join(f"{k} {a} -> {b}"
                                for k, (a, b) in cuts.items())
        + " (no served tensor depends on them)")
    spec = SeqSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    V, L = spec.vocab, spec.max_seq_len
    assert V == twin["data.syn_items"] and spec.dim == 128 and L == 50, (
        V, spec.dim, L)
    assert spec.use_pallas_scan and spec.cell == cell
    params = init_seq(torch.Generator(device=dev).manual_seed(0), spec)
    nparam = sum(t.numel() for t in (
        params["item_in"]["tables"]["__fused__"], params["item_out"]))
    log(f"c4 ({cell}) on the XING twin: V={V} H={spec.dim} L={L} layers="
        f"{spec.num_layers} item fields "
        f"{[f.name for f in spec.item_in.schema.fields]}, dense "
        f"{[f.name for f in spec.item_in.dense_fields]}; "
        f"{nparam} table parameters; prep {prep_s:.2f} s")

    t0 = time.perf_counter()
    rec = Recommender(cfg, params, serve_batch=256, device=dev)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    with torch.inference_mode():
        enc_ms = cuda_ms(lambda: _item_latents(cfg, spec, rec._params,
                                               rec._item_dev), 5, warmup=1)

    rng = np.random.default_rng(1)
    lengths = [5, 12, 30, 49, 50, 120, 20, 1]
    hists = [rng.integers(0, V, n).tolist() for n in lengths]
    seen = [list(h) for h in hists]
    seen[6] = rng.integers(0, V, 40).tolist()        # an explicit seen list
    segments = math.ceil(max(lengths) / L)

    t0 = time.perf_counter()
    rec.from_histories(hists, seen=seen)             # first call: warm-up
    first_s = time.perf_counter() - t0

    for f in (fwd, *others.values()):                # ---- the main path
        f.launches = 0
    t0 = time.perf_counter()
    ids = rec.from_histories(hists, seen=seen)
    batch_ms = (time.perf_counter() - t0) * 1e3
    batch_launches = fwd.launches
    lines = [",".join(map(str, rng.integers(0, V, n).tolist()))
             for n in (3, 40, 17)]
    out = io.StringIO()
    _serve_loop(rec, io.StringIO("\n".join(lines) + "\n!quit\n"), out)
    launches = fwd.launches                          # ---- read just after
    assert not any(f.launches for f in others.values()), others

    assert ids.shape == (len(hists), 30), ids.shape
    assert ((ids >= 0) & (ids < V)).all()
    for row, s in zip(ids, seen):
        assert not set(row.tolist()) & set(s), "a seen id was served"
    assert batch_launches == spec.num_layers * segments, (
        batch_launches, spec.num_layers, segments)
    answers = out.getvalue().strip().split("\n")
    assert len(answers) == 3, answers
    for line, ans in zip(lines, answers):
        first, got = ans.split("\t")
        got = [int(x) for x in got.split(",")]
        assert first == line and len(got) == 30
        assert all(0 <= i < V for i in got)
        assert not set(got) & {int(x) for x in line.split(",")}
    assert launches == batch_launches + 3 * spec.num_layers, launches

    # the same batch's query states through the plain scan on the card
    batch, _ = next(rec._history_batches(hists, seen=seen))
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()
          if k != "seen"}
    plain_spec = dataclasses.replace(spec, use_pallas_scan=False)
    with torch.inference_mode():
        q_kernel = _query_fn(spec, rec._params, rec._item_dev, None, tb)
        q_plain = _query_fn(plain_spec, rec._params, rec._item_dev, None, tb)
    assert torch.isfinite(q_kernel).all()
    torch.testing.assert_close(q_kernel, q_plain, **TOL["bfloat16"])
    q_err = float((q_kernel - q_plain).abs().max())
    log(f"served {len(hists)} histories (longest {max(lengths)} = "
        f"{segments} segments) + {len(lines)} loop lines; query states vs "
        f"plain scan on the card: max abs err {q_err:.3e} "
        f"(tolerance {TOL['bfloat16']})")
    log(f"startup {startup_s:.3f} s (from the prepared cache), item-latent "
        f"encode {enc_ms:.3f} ms, first batch {first_s:.3f} s, batch of "
        f"{len(hists)} requests padded to 256: {batch_ms:.3f} ms; "
        f"{fwd_name} launches {launches}")

    # where one served batch's time goes: device time by kernel name
    device_breakdown(f"one served batch ({cell})",
                     lambda: rec.from_histories(hists, seen=seen))
    return launches


def grad_gap(got, want):
    """max over parameters of max|got − want| / max|want|."""
    return max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
               for g, w in zip(got, want))


def train_phase(dev, cell="lstm", twin=TWIN, cuts=CUTS, steps=TRAIN_STEPS):
    """c4 (with the recurrent cell set to `cell`) trained on the XING twin
    through the port's train step: batches from `seq_batches`,
    `make_train_step` with Adagrad and dense table updates, each step's key
    from `step_generator`. Returns the launches of each kernel over the
    counted steps."""
    import itertools

    import torch
    from arec_torch.data.dataset import seq_batches
    from arec_torch.kernels import sampled_softmax as tks
    from arec_torch.losses.sampling import draw
    from arec_torch.models.seq import (SeqSpec, init_seq, seq_item_latents,
                                       seq_loss)
    from arec_torch.rng import generator
    from arec_torch.train.loop import _query_fn
    from arec_torch.tables.engine import attrs_to_device
    from arec_torch.train.step import (_leaves, init_state, make_optimizer,
                                       make_train_step, step_generator,
                                       tree_map)

    cfg, ds, _ = load_c4(twin, cuts, cell)
    tc = cfg.train
    spec = SeqSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    assert (spec.vocab, spec.dim, spec.pack_len, spec.num_sampled,
            spec.cell) == (twin["data.syn_items"], 128, 50, 1024, cell), spec
    assert (tc.optimizer, tc.batch_size, tc.sparse_update) == (
        "adagrad", 128, False), tc
    item_dev = attrs_to_device(ds.item_attrs.restrict(spec.item_in.schema),
                               spec.item_in, dev)
    params = init_seq(torch.Generator(device=dev).manual_seed(0), spec)
    n_params = sum(t.numel() for t in _leaves(params))

    def loss_fn(p, batch, gen):
        return seq_loss(p, spec, item_dev, None, batch, gen, time_major=True)

    opt = make_optimizer(tc.optimizer, tc.learning_rate)
    state = init_state(params, opt)
    step = make_train_step(loss_fn, opt, tc.learning_rate)
    # the batches are packed on the host ahead of the steps, as a
    # prefetching input pipeline would; each step moves its own to the card
    host = list(itertools.islice(
        seq_batches(ds, tc.batch_size, spec.pack_len, tc.seed, epoch=0),
        steps + 3))
    assert len(host) == steps + 3, len(host)

    def on_dev(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    state, _ = step(state, on_dev(host[0]), step_generator(tc.seed, 0))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    scans, others = scan_counters(cell)
    fwd_name, bwd_name = scans
    counters = {**scans, "sampled_ce_fwd": tks.sampled_ce_fwd,
                "sampled_ce_bwd": tks.sampled_ce_bwd}
    for fn in (*counters.values(), *others.values()):  # ---- the main path
        fn.launches = 0
    metrics = []
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        state, m = step(state, on_dev(host[i]), step_generator(tc.seed, i))
        metrics.append(m)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    # read before the checks below: a finite check of a whole table holds
    # its temporaries (|t| in f32, three bool masks) on the card
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: fn.launches for k, fn in counters.items()}
    # ---- read just after
    assert not any(f.launches for f in others.values()), others
    per_step = spec.num_layers * spec.train_segments
    recompute = 2 if spec.train_segments > 1 else 1   # checkpointed segments
    assert launches == {
        fwd_name: steps * per_step * recompute,
        bwd_name: steps * per_step,
        "sampled_ce_fwd": steps, "sampled_ce_bwd": steps}, launches

    loss = torch.stack([m["loss"] for m in metrics]).cpu()
    norm = torch.stack([m["grad_norm"] for m in metrics]).cpu()
    assert torch.isfinite(loss).all() and torch.isfinite(norm).all()
    assert (norm > 0).all()
    assert all(torch.isfinite(t).all() for t in _leaves(state.params))
    positions = sum(float(b["mask"].sum()) for b in host[1:steps + 1])
    step_ms = wall_s / steps * 1e3
    log(f"trained c4 ({cell}) on the XING twin (V={spec.vocab}, {n_params} "
        f"parameters, Adagrad lr {tc.learning_rate}, dense updates, batch "
        f"{tc.batch_size}, S={spec.num_sampled}): first step "
        f"{first_s:.3f} s, then {steps} steps: loss {float(loss[0]):.4f} -> "
        f"{float(loss[-1]):.4f}, grad_norm {float(norm[0]):.4f} -> "
        f"{float(norm[-1]):.4f}; step {step_ms:.3f} ms, "
        f"{tc.batch_size * steps / wall_s:.1f} examples/s "
        f"({positions / wall_s:.0f} valid positions/s); peak device memory "
        f"{peak_gib:.2f} GiB ({held_gib:.2f} GiB held before the first "
        f"step); launches {launches}")
    log("loss per step: " + " ".join(f"{float(x):.4f}" for x in loss))

    b = on_dev(host[steps + 1])
    gen = step_generator(tc.seed, steps + 1)
    device_breakdown(f"one train step ({cell})",
                     lambda: step(state, b, gen))

    # one step's gradients, kernel path vs plain path (plain scan, pure CE),
    # on the same batch and the same pre-drawn negatives
    b = on_dev(host[steps + 2])
    sampled = draw(generator(7, dev), spec.num_sampled, spec.vocab,
                   spec.sampler)
    gen = step_generator(tc.seed, steps + 2)

    def grads(sp, use_kernel):
        live = tree_map(lambda t: t.detach().requires_grad_(), state.params)
        value = seq_loss(live, sp, item_dev, None, b, gen, sampled=sampled,
                         use_kernel=use_kernel, time_major=True)
        return value.detach(), torch.autograd.grad(
            value, _leaves(live), allow_unused=True, materialize_grads=True)

    l_k, g_k = grads(spec, True)
    l_p, g_p = grads(dataclasses.replace(spec, use_pallas_scan=False), False)
    gap = grad_gap(g_k, g_p)
    assert abs(float(l_k / l_p) - 1.0) < LOSS_TOL, (float(l_k), float(l_p))
    assert gap <= STEP_GRAD_TOL, gap
    log(f"one step's gradients, kernel path vs plain path ({spec.dtype}): "
        f"loss {float(l_k):.6f} vs {float(l_p):.6f}, worst parameter "
        f"max|Δ|/max|plain| {gap:.3e} (tolerance {STEP_GRAD_TOL}, loss "
        f"{LOSS_TOL} relative)")
    del g_k, g_p

    # the carried gradient: two checkpointed segments of L/2 against one
    # pass over the same L-wide batch, kernel path, f32
    one = dataclasses.replace(spec, compute_dtype="float32")
    two = dataclasses.replace(one, max_seq_len=spec.max_seq_len // 2,
                              train_segments=2)
    assert two.pack_len == one.pack_len
    before = {k: fn.launches for k, fn in counters.items()}
    l_2, g_2 = grads(two, True)
    seg_launches = {k: fn.launches - before[k] for k, fn in counters.items()}
    l_1, g_1 = grads(one, True)
    gap = grad_gap(g_2, g_1)
    assert seg_launches[fwd_name] == 2 * 2 * spec.num_layers, seg_launches
    assert seg_launches[bwd_name] == 2 * spec.num_layers, seg_launches
    assert abs(float(l_2 / l_1) - 1.0) < 1e-5, (float(l_2), float(l_1))
    assert gap <= SEG_GRAD_TOL, gap
    log(f"two segments of L={two.max_seq_len} vs one pass of "
        f"L={one.max_seq_len} (float32, kernel path): loss {float(l_2):.6f} "
        f"vs {float(l_1):.6f}, worst parameter max|Δ|/max|one pass| "
        f"{gap:.3e} (tolerance {SEG_GRAD_TOL}); launches {seg_launches} "
        f"(the forward again in each segment's recompute)")
    del g_1, g_2

    with torch.inference_mode():
        v, bias = seq_item_latents(state.params, spec, item_dev)
        recall_at_k(
            ds, tc, dev, spec.pack_len, v, bias,
            lambda tb: _query_fn(spec, state.params, item_dev, None, tb),
            f"({cell}) after {steps + 1} steps")
    return launches


def recall_at_k(ds, tc, dev, pack_len, v, bias, query, what):
    """Recall@K of trained weights through the serving top-k over
    EVAL_BATCHES `eval_batches`; `query(batch on the card)` gives the
    query latents."""
    import itertools

    import torch
    from arec_torch.data.dataset import eval_batches
    from arec_torch.train.evalu import recall_hits

    k, hits, total, n = tc.eval_topk, 0.0, 0.0, 0
    for batch in itertools.islice(
            eval_batches(ds, tc.eval_batch_size, pack_len), EVAL_BATCHES):
        seen = torch.from_numpy(ds.seen_items[batch["user"]]).to(dev)
        tb = {kk: torch.from_numpy(x).to(dev) for kk, x in batch.items()}
        q = query(tb)
        assert torch.isfinite(q).all()
        h, t = recall_hits(q, v, bias, seen, tb["pos_item"], tb["valid"],
                           k=k)
        hits, total, n = hits + float(h), total + float(t), n + 1
    recall = hits / max(total, 1.0)
    assert n == EVAL_BATCHES and 0.0 <= recall <= 1.0, (n, recall)
    log(f"Recall@{k} {what} over {n} eval batches ({int(total)} held-out "
        f"rows): {recall:.4f}")
    return recall


def scatter_case(V, W, N, n_valid, dev, seed):
    """A table [V, W], sorted unique ids (n_valid in range, then a suffix
    of sentinels V) and rows [N, W], as the sparse step's write-back hands
    them to the kernel."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    valid = np.sort(rng.choice(V, size=n_valid, replace=False))
    ids = np.concatenate([valid, np.full(N - n_valid, V)]).astype(np.int32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(V, W, generator=gen, device=dev),
            torch.from_numpy(ids).to(dev),
            torch.randn(N, W, generator=gen, device=dev))


def bound_scatter(ids, rows, V):
    """row_scatter: the ids read, each valid row read once from `rows` and
    written once into the table; no operations."""
    n_valid = int(((ids >= 0) & (ids < V)).sum())
    return roofline(4 * ids.shape[0] + 2 * 4 * n_valid * rows.shape[1], 0,
                    "float32") + (n_valid,)


def phase_case(V, W, N, table_base, src_phase, dst_phase, dev, seed):
    """A write-back whose in-range ids all take one (source phase,
    destination phase) pair of the kernel's 16-byte path: the table [V, W]
    and the rows [N, W] start `table_base` mod 16 (a view one row into a
    larger tensor for 8), only the rows whose base is `src_phase` mod 16
    carry in-range ids, each to a distinct table row whose base is
    `dst_phase` mod 16; every other id is a sentinel (V, or -1 at every
    fourth row). Returns (the tensor under the table, table, ids, rows)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    off = 1 if table_base % 16 == 8 else 0
    big = torch.randn(V + off, W, generator=gen, device=dev)
    rows = torch.randn(N + off, W, generator=gen, device=dev)[off:]
    table = big[off:]
    assert table.data_ptr() % 16 == table_base % 16
    src = (rows.data_ptr() + np.arange(N) * W * 4) % 16 == src_phase
    dst = np.flatnonzero((table.data_ptr() + np.arange(V) * W * 4) % 16
                         == dst_phase)
    ids = np.where(np.arange(N) % 4 == 1, -1, V)
    ids[src] = rng.choice(dst, size=int(src.sum()), replace=False)
    return big, table, torch.from_numpy(ids.astype(np.int32)).to(dev), rows


def phase_counts(table, ids, rows):
    """{"src/dst": in-range rows} by the byte phases mod 16 of their source
    and destination rows, as the kernel's 16-byte path meets them."""
    import torch
    V, W = table.shape
    ok = (ids >= 0) & (ids < V)
    r = torch.arange(ids.shape[0], device=ids.device)[ok]
    sp = (rows.data_ptr() + r * W * 4) % 16
    dp = (table.data_ptr() + ids[ok].long() * W * 4) % 16
    return {f"{a}/{b}": int(((sp == a) & (dp == b)).sum())
            for a in (0, 8) for b in (0, 8)}


def queued_ms(calls, reps: int = 48) -> float:
    """Mean device time of `calls`, cycled `reps` times and queued behind
    a spin of the GPU, so that the CUDA events time the launches back to
    back on the device and no host gap between them: for a kernel of a few
    µs, plain back-to-back timing (`cuda_ms`) measures the host's launch
    cost instead. The spin (at most 2e6 GPU cycles a ms) must outlast the
    host's queuing, or the device waits on the host between calls: when
    the host took more than 80 % of it, the run is repeated (three runs at
    most: a call that waits on the device never fits) with a spin twice as
    long as the host took."""
    import torch
    for c in calls:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin_ms = 25.0
    for _ in range(3):
        torch.cuda._sleep(int(spin_ms * 2e6))   # the host queues meanwhile
        t0 = time.perf_counter()
        start.record()
        for i in range(reps):
            calls[i % len(calls)]()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms < 0.8 * spin_ms:
            break
        spin_ms = 2 * host_ms
    return start.elapsed_time(end) / reps


def scatter_timing(cases):
    """Kernel, plain version and index_copy_ of the valid prefix (the
    library yardstick, never called by the port) over write-backs
    `cases` = [(table, ids, rows), ...], cycled so that the rows written
    are not left in the 50 MB L2 by the previous call (the sparse step's
    table rows are cold): device time per call (`queued_ms`), the
    kernel's back-to-back time with its host launch cost, and the bound
    of one write-back."""
    from arec_torch.kernels import row_scatter as trs
    table, ids, rows = cases[0]
    bms, by, nbytes, _, n_valid = bound_scatter(ids, rows, table.shape[0])
    keep = [(t, i[:n_valid].long(), r[:n_valid]) for t, i, r in cases]
    return dict(
        ms=queued_ms([lambda c=c: trs.row_scatter(*c) for c in cases]),
        plain_ms=queued_ms([lambda c=c: trs.scatter_rows_set_plain(*c)
                            for c in cases]),
        library_ms=queued_ms([lambda k=k: k[0].index_copy_(0, k[1], k[2])
                              for k in keep]),
        back_to_back_ms=cuda_ms(lambda: trs.row_scatter(*cases[0]), 50),
        bound_ms=bms, bound_by=by, bytes=nbytes, n=ids.shape[0],
        n_valid=n_valid, width=rows.shape[1])


def row_scatter_phase(dev, shapes=MF_SHAPES):
    """row_scatter against its plain version, bit for bit, at the MF main
    path's two write-back shapes (1/16 of the ids sentinel) and at the edge
    cases: an odd width, a base aligned to 8 bytes only, no ids, only
    sentinel ids, and each (source phase, destination phase) pair of a
    258-wide row on a 16- and an 8-byte aligned table base; in place,
    untouched rows unchanged. Prints the launch (grid, registers, resident
    blocks, vector width) and the phase pairs of the main-path shapes,
    then their times. Returns ({shape: times}, {shape: launch plan})."""
    import torch
    from arec_torch.kernels import row_scatter as trs

    cases = {name: (V, W, N, N - N // 16) for name, (V, W, N) in
             shapes.items()}
    cases.update(odd_width=(20_000, 129, 3_000, 2_900),
                 all_sentinel=(20_000, 258, 64, 0), empty=(20_000, 258, 0, 0),
                 narrow=(1_000, 3, 300, 250))
    times, plans = {}, {}
    for name, (V, W, N, n_valid) in cases.items():
        table, ids, rows = scatter_case(V, W, N, n_valid, dev, seed=W + N)
        if name in shapes:
            plans[name] = dict(trs.launch_plan(table, rows),
                               phase_pairs=phase_counts(table, ids, rows))
            log(f"row_scatter launch for the {name} table [{V}, {W}], {N} "
                f"ids: {plans[name]}")
        want = trs.scatter_rows_set_plain(table.clone(), ids, rows)
        orig = table.clone()
        ptr = table.data_ptr()
        before = trs.row_scatter.launches
        got = trs.scatter_rows_set(table, ids, rows, use_kernel=True)
        torch.cuda.synchronize()
        assert got.data_ptr() == ptr and torch.equal(got, want), name
        assert trs.row_scatter.launches == before + (N > 0), name
        touched = torch.zeros(V, dtype=torch.bool, device=dev)
        touched[ids[:n_valid].long()] = True
        assert torch.equal(got[~touched], orig[~touched]), name
        log(f"row_scatter vs plain  {name} table [{V}, {W}], {N} ids "
            f"({n_valid} in range): equal bit for bit, in place, untouched "
            f"rows unchanged")
        if name in shapes:
            # four write-backs of the same shape and valid count into the
            # table, each into other rows
            times[name] = scatter_timing([(table, ids, rows)] + [
                (table, *scatter_case(V, W, N, n_valid, dev, seed=k)[1:])
                for k in range(1, 4)])
        del table, rows, want, orig
    # a view starting at an odd row of a 258-wide table: 8-byte vectors
    big, ids, rows = scatter_case(20_001, 258, 2_000, 1_900, dev, seed=9)
    view, row0 = big[1:], big[0].clone()
    assert view.data_ptr() % 16 == 8
    want = trs.scatter_rows_set_plain(view.clone(), ids, rows)
    trs.row_scatter(view, ids, rows)
    torch.cuda.synchronize()
    assert torch.equal(view, want) and torch.equal(big[0], row0)
    log("row_scatter vs plain  a base aligned to 8 bytes only: equal bit "
        "for bit")
    for base in (16, 8):
        for sp in (0, 8):
            for dp in (0, 8):
                big, table, ids, rows = phase_case(20_000, 258, 2_000, base,
                                                   sp, dp, dev,
                                                   seed=base + 2 * sp + dp)
                pairs = phase_counts(table, ids, rows)
                assert pairs[f"{sp}/{dp}"] == sum(pairs.values()) > 0, pairs
                orig = big.clone()
                want = trs.scatter_rows_set_plain(table.clone(), ids, rows)
                trs.row_scatter(table, ids, rows)
                torch.cuda.synchronize()
                assert torch.equal(table, want), (base, sp, dp)
                touched = torch.zeros(big.shape[0], dtype=torch.bool,
                                      device=dev)
                ok = (ids >= 0) & (ids < table.shape[0])
                off = big.shape[0] - table.shape[0]
                touched[ids[ok].long() + off] = True
                assert torch.equal(big[~touched], orig[~touched])
                log(f"row_scatter vs plain  table base {base} mod 16, "
                    f"source/destination phases {sp}/{dp} "
                    f"({pairs[f'{sp}/{dp}']} rows): equal bit for bit, "
                    f"untouched rows unchanged")
                del big, table, orig, want
    for name, t in times.items():
        log(f"row_scatter {name} table, {t['n']} ids ({t['n_valid']} in "
            f"range) of {t['width']} f32, device time per call: kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
            f"(index_copy_ of the valid prefix) {t['library_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} "
            f"bytes); kernel back to back (host launch cost included) "
            f"{t['back_to_back_ms']:.4f} ms")
    return times, plans


def load_mf(sets=MF_SETS, cuts=MF_CUTS):
    """syn_xing_full's config on one card with the listed cuts, and the
    prepared dataset."""
    return load(XING, {**sets, **{k: v for k, (_, v) in cuts.items()}})


def all_counters():
    """{kernel name: the wrapper whose `launches` counts it}, every kernel
    of the port."""
    from arec_torch.kernels import row_scatter as trs
    from arec_torch.kernels import sampled_softmax as tks
    lstm, gru = scan_counters("lstm")
    return {**lstm, **gru, "sampled_ce_fwd": tks.sampled_ce_fwd,
            "sampled_ce_bwd": tks.sampled_ce_bwd,
            trs.KERNEL: trs.row_scatter}


def mf_serve_phase(dev, sets=MF_SETS, cuts=MF_CUTS, shapes=MF_SHAPES):
    """syn_xing_full's MF model served through `Recommender.for_users`
    from a packed sparse-Adagrad param tree (seeded random weights): 256
    users with their train items as seen lists, then 3 request-loop lines;
    the answers against an independent f32 top-k of the same scores; a
    profile of one batch. MF serving runs no kernel of the port: every
    count stays 0."""
    import numpy as np
    import torch
    from arec_torch.models.mf import MFSpec, init_mf
    from arec_torch.serve import Recommender, _serve_loop
    from arec_torch.train.loop import _query_fn
    from arec_torch.train.sparse import pack_tables, table_paths

    cfg, ds, prep_s = load_mf(sets, cuts)
    log("reduced: " + ", ".join(f"{k} {a} -> {b}"
                                for k, (a, b) in cuts.items())
        + f" (no tensor depends on it; {len(ds.train_users)} train rows)")
    spec = MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    for enc, key in ((spec.item, "item"), (spec.user, "user")):
        assert not shapes or (enc.total_rows, 2 * enc.width) == shapes[
            key][:2], (key, enc.total_rows, enc.width)
    params = pack_tables(
        init_mf(torch.Generator(device=dev).manual_seed(0), spec),
        table_paths(False, spec))
    log(f"MF on the XING twin: items {spec.item.total_rows} rows x "
        f"{spec.item.width} (fields {[f.name for f in spec.item.schema.fields]}"
        f", dense {[f.name for f in spec.item.dense_fields]}), users "
        f"{spec.user.total_rows} x {spec.user.width} (fields "
        f"{[f.name for f in spec.user.schema.fields]}); packed tables "
        f"{sum(t.numel() for t in (params['item']['tables']['__fused__'], params['user']['tables']['__fused__'])) * 4 / 1e9:.3f} GB; prep {prep_s:.2f} s")

    t0 = time.perf_counter()
    rec = Recommender(cfg, params, serve_batch=256, device=dev)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    del params
    rng = np.random.default_rng(2)
    users = rng.choice(np.flatnonzero(ds.seen_lengths > 0), 256,
                       replace=False).astype(np.int32)
    seen = [ds.seen_items[u][ds.seen_items[u] >= 0].tolist() for u in users]
    t0 = time.perf_counter()
    rec.for_users(users, seen=seen)                  # first call: warm-up
    first_s = time.perf_counter() - t0

    counters = all_counters()
    for f in counters.values():                      # ---- the main path
        f.launches = 0
    t0 = time.perf_counter()
    ids = rec.for_users(users, seen=seen)
    batch_ms = (time.perf_counter() - t0) * 1e3
    lines = [f"{users[0]}\t{','.join(map(str, seen[0][:5]))}",
             f"{users[1]}", f"{users[2]}\t{','.join(map(str, seen[2]))}"]
    out = io.StringIO()
    _serve_loop(rec, io.StringIO("\n".join(lines) + "\n!quit\n"), out)
    launches = {k: f.launches for k, f in counters.items()}
    assert not any(launches.values()), launches    # ---- read just after

    V, k = spec.item.schema.num_entities, rec.k
    assert ids.shape == (256, k), ids.shape
    for row, s in zip(ids, seen):
        assert len(set(row.tolist())) == k and ((row >= 0) & (row < V)).all()
        assert not set(row.tolist()) & set(s), "a seen id was served"
    answers = out.getvalue().strip().split("\n")
    assert len(answers) == 3, answers
    for line, ans, s in zip(lines, answers,
                            (seen[0][:5], [], seen[2])):
        first, got = ans.split("\t")
        got = [int(x) for x in got.split(",")]
        assert first == line.split("\t")[0] and len(set(got)) == k
        assert not set(got) & set(s)

    # an independent f32 top-k of the same scores: one product of the
    # rounded operands the serving top-k multiplies, seen ids set to -inf
    tb = {"user": torch.from_numpy(users).to(dev)}
    with torch.inference_mode():
        q = _query_fn(spec, rec._params, rec._item_dev, rec._user_dev, tb)
        v, b = rec._vb
        scores = (q.to(torch.bfloat16).float()
                  @ v.to(torch.bfloat16).float().T) + b
        for i, s in enumerate(seen):
            scores[i, torch.tensor(s, dtype=torch.long, device=dev)] = (
                -float("inf"))
        ref_vals = torch.topk(scores, k, dim=1).values
        mine = scores.gather(1, torch.from_numpy(ids).long().to(dev))
        mine = torch.sort(mine, dim=1, descending=True).values
    assert torch.isfinite(q).all()
    gap = float((mine - ref_vals).abs().max())
    tol = 1e-5 * float(ref_vals.abs().max()) + 1e-5
    assert gap <= tol, (gap, tol)
    log(f"served {len(users)} users (seen lists of up to "
        f"{max(map(len, seen))} train items) + {len(lines)} loop lines: "
        f"k={k} distinct unseen ids each; served scores vs an independent "
        f"f32 top-k: max |Δ| {gap:.3e} (tolerance {tol:.3e}); no kernel "
        f"launched ({launches})")
    log(f"startup {startup_s:.3f} s (from the prepared cache, item "
        f"latents of {V} items included), first batch {first_s:.3f} s, "
        f"batch of 256 users: {batch_ms:.3f} ms")
    device_breakdown("one served MF batch",
                     lambda: rec.for_users(users, seen=seen))
    return launches


def dense_state_from_sparse(state, paths):
    """The dense step's state holding the same values as a packed sparse
    state: plain tables (the param halves) and their Adagrad accumulators
    (the other halves) beside the rest's, all copies."""
    import torch
    from arec_torch.train.sparse import get_path, set_path, unpack_params
    from arec_torch.train.step import TrainState, tree_map

    copy = lambda t: t.clone(memory_format=torch.contiguous_format)
    rest = state.opt_state["rest"]
    acc = tree_map(copy, rest["sum_of_squares"])
    for p in paths:
        t = get_path(state.params, p)
        acc = set_path(acc, p, copy(t[:, t.shape[1] // 2:]))
    return TrainState(
        params=tree_map(copy, unpack_params(state.params, paths)),
        opt_state={"count": copy(rest["count"]),
                   "learning_rate": copy(rest["learning_rate"]),
                   "sum_of_squares": acc},
        lr_scale=copy(state.lr_scale), step=copy(state.step))


def mf_train_phase(dev, sets=MF_SETS, cuts=MF_CUTS, shapes=MF_SHAPES,
                   steps=TRAIN_STEPS):
    """syn_xing_full's MF model trained through the sparse touched-rows
    step: `mf_batches` (seed 0, epoch 0) → `make_sparse_train_step`
    (packed Adagrad, the row-scatter kernel writing each table back), one
    warm-up and `steps` counted steps with launches per kernel and a
    profile of one step; one sparse step against one dense step from the
    same state (and that step's write-back, kernel against plain version,
    bit for bit, and timed); Recall@30. Returns (launches, write-back
    times, examples/s of the bare steps)."""
    import itertools

    import torch
    import arec_torch.train.sparse as tsparse
    from arec_torch.data.dataset import mf_batches
    from arec_torch.kernels import row_scatter as trs
    from arec_torch.models.mf import (MFSpec, init_mf, mf_item_latents,
                                      mf_loss, mf_user_latents)
    from arec_torch.tables.engine import attrs_to_device
    from arec_torch.train.step import (_leaves, make_optimizer,
                                       make_train_step, step_generator)

    cfg, ds, _ = load_mf(sets, cuts)
    tc = cfg.train
    spec = MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    if shapes is MF_SHAPES:
        assert (tc.batch_size, spec.num_sampled, spec.loss, spec.sampler,
                tc.optimizer, tc.learning_rate, spec.user.dim, spec.dtype) == (
            8192, 2048, "ce", "log_uniform", "adagrad", 0.3, 128,
            torch.bfloat16), (tc, spec)
    assert tc.sparse_update, tc
    udev = attrs_to_device(ds.user_attrs.restrict(spec.user.schema),
                           spec.user, dev)
    idev = attrs_to_device(ds.item_attrs.restrict(spec.item.schema),
                           spec.item, dev)
    paths = tsparse.table_paths(False, spec)
    opt = make_optimizer(tc.optimizer, tc.learning_rate)
    state = tsparse.init_sparse_state(
        init_mf(torch.Generator(device=dev).manual_seed(0), spec), paths,
        opt, tc.optimizer)
    step = tsparse.make_sparse_train_step(False, spec, udev, idev, opt,
                                          tc.learning_rate, tc.optimizer)
    # the batches are packed on the host ahead of the steps, as a
    # prefetching input pipeline would; each step moves its own to the card
    host = list(itertools.islice(mf_batches(ds, tc.batch_size, tc.seed, 0),
                                 steps + 3))
    assert len(host) == steps + 3, len(host)

    def on_dev(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    state, _ = step(state, on_dev(host[0]), step_generator(tc.seed, 0))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    counters = all_counters()
    for fn in counters.values():                     # ---- the main path
        fn.launches = 0
    metrics = []
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        state, m = step(state, on_dev(host[i]), step_generator(tc.seed, i))
        metrics.append(m)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30  # before the checks
    launches = {k: fn.launches for k, fn in counters.items()}
    # ---- read just after
    want = {k: 0 for k in counters}
    want.update({trs.KERNEL: 2 * steps, "sampled_ce_fwd": steps,
                 "sampled_ce_bwd": steps})
    assert launches == want, launches
    loss = torch.stack([m["loss"] for m in metrics]).cpu()
    assert torch.isfinite(loss).all()
    assert all(torch.isfinite(t).all() for t in _leaves(state.params))
    step_ms = wall_s / steps * 1e3
    log(f"trained MF on the XING twin (sparse touched-rows step, packed "
        f"Adagrad lr {tc.learning_rate}, batch {tc.batch_size}, "
        f"S={spec.num_sampled}, {spec.compute_dtype}): first step "
        f"{first_s:.3f} s, then {steps} steps: loss {float(loss[0]):.4f} -> "
        f"{float(loss[-1]):.4f}; step {step_ms:.3f} ms, "
        f"{tc.batch_size * steps / wall_s:.1f} examples/s (bare steps); "
        f"peak device memory {peak_gib:.2f} GiB ({held_gib:.2f} GiB held "
        f"before the first step); "
        f"launches {{{', '.join(f'{k}: {v}' for k, v in launches.items() if v)}}}")
    log("loss per step: " + " ".join(f"{float(x):.4f}" for x in loss))
    b = on_dev(host[steps + 1])
    gen = step_generator(tc.seed, steps + 1)
    device_breakdown("one sparse MF train step", lambda: step(state, b, gen))

    # one sparse step against one dense step from the same state, the same
    # batch and the same key (so the same negatives); the sparse step's
    # write-back inputs are captured on the way
    b = on_dev(host[steps + 2])
    gen = step_generator(tc.seed, steps + 2)
    dense_state = dense_state_from_sparse(state, paths)
    dense_step = make_train_step(
        lambda p, bb, g: mf_loss(p, spec, udev, idev, bb, g),
        make_optimizer(tc.optimizer, tc.learning_rate), tc.learning_rate)
    captured = []
    real = tsparse.scatter_rows_set

    def capture(table, idx, rows, use_kernel):
        captured.append((idx.clone(), rows.clone()))
        return real(table, idx, rows, use_kernel)

    tsparse.scatter_rows_set = capture
    try:
        state, sm = step(state, b, gen)
    finally:
        tsparse.scatter_rows_set = real
    dense_state, dm = dense_step(dense_state, b, gen)
    torch.cuda.synchronize()
    loss_rel = abs(float(sm["loss"] / dm["loss"]) - 1.0)
    assert loss_rel <= 1e-6, (float(sm["loss"]), float(dm["loss"]))
    got = tsparse.unpack_params(state.params, paths)
    worst, n_touched = 0.0, {}
    for (idx, _), p in zip(captured, paths):
        g, w = tsparse.get_path(got, p), tsparse.get_path(dense_state.params,
                                                          p)
        touched = torch.zeros(g.shape[0], dtype=torch.bool, device=dev)
        touched[idx[idx < g.shape[0]].long()] = True
        n_touched[p[0]] = int(touched.sum())
        assert torch.equal(g[~touched], w[~touched]), p
        torch.testing.assert_close(g[touched], w[touched], **SPARSE_DENSE)
        worst = max(worst, float((g[touched] - w[touched]).abs().max()))
    rest = [(a, c) for a, c in zip(_leaves(tsparse._strip_tables(got, paths)),
                                   _leaves(tsparse._strip_tables(
                                       dense_state.params, paths)))]
    for a, c in rest:
        torch.testing.assert_close(a, c, **SPARSE_DENSE)
        worst = max(worst, float((a - c).abs().max()))
    log(f"one sparse step vs one dense step from the same state: loss "
        f"{float(sm['loss']):.6f} vs {float(dm['loss']):.6f}; touched rows "
        f"{n_touched} max |Δ| {worst:.3e} (tolerance {SPARSE_DENSE}), "
        f"untouched rows equal bit for bit")

    # the dense step's own cost at this shape, for comparison only: a few
    # steps on the dense copy (its values no longer matter) and a profile
    dense_n = 5
    t0 = time.perf_counter()
    for i in range(1, dense_n + 1):
        dense_state, _ = dense_step(dense_state, on_dev(host[i]),
                                    step_generator(tc.seed, i))
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t0) / dense_n * 1e3
    log(f"dense MF step (make_train_step on mf_loss, dense Adagrad over "
        f"every row) at the same shape: {dense_ms:.3f} ms over {dense_n} "
        f"steps, {tc.batch_size / dense_ms * 1e3:.1f} examples/s; the "
        f"sparse step: {step_ms:.3f} ms")
    device_breakdown("one dense MF train step",
                     lambda: dense_step(dense_state, b, gen))
    del dense_state

    # the captured write-back: kernel and plain version into two copies of
    # the same packed table must agree bit for bit (and equal the step's)
    wb = {}
    for (idx, rows), p in zip(captured, paths):
        table = tsparse.get_path(state.params, p)
        a, c = table.clone(), table.clone()
        trs.row_scatter(a, idx, rows)
        trs.scatter_rows_set_plain(c, idx, rows)
        torch.cuda.synchronize()
        assert torch.equal(a, c) and torch.equal(a, table), p
        del c
        # the same write-back into four copies of the table, so each
        # call's table rows are cold, as in the step
        wb[p[0]] = scatter_timing([(t, idx, rows) for t in
                                   (a, *(table.clone() for _ in range(3)))])
        del a
        t = wb[p[0]]
        log(f"the step's {p[0]} write-back ({t['n']} ids, {t['n_valid']} "
            f"in range, rows of {t['width']}): kernel == plain version bit "
            f"for bit; device time per call: kernel {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, index_copy_ "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms; "
            f"kernel back to back {t['back_to_back_ms']:.4f} ms")

    with torch.inference_mode():
        params = tsparse.unpack_params(state.params, paths)
        v, bias = mf_item_latents(params, spec, idev)
        recall_at_k(ds, tc, dev, 0, v, bias,
                    lambda tb: mf_user_latents(params, spec, udev,
                                               tb["user"]),
                    f"(MF) after {steps + 3} sparse steps")
    return launches, wb, tc.batch_size * steps / wall_s


DISPATCH_K = 8        # steps_per_dispatch of both flagship configs
DISPATCH_REPS = 5     # replays (and K-step eager runs) timed
SMALL_C4 = {"data.syn_items": 20_000, "data.syn_users": 4_000,
            "data.syn_interactions": 80_000, "model.keep_prob": 0.8}


def run_gap(a, b):
    """Largest |a - b| over two runs' state leaves and [steps] metrics."""
    from arec_torch.train.step import _leaves
    (sa, ma), (sb, mb) = a, b
    pairs = list(zip(_leaves(sa._asdict()), _leaves(sb._asdict())))
    pairs += [(ma[k], mb[k]) for k in ma]
    return max(float((x.double() - y.double()).abs().max())
               for x, y in pairs if x.numel())


def dispatch_check(what, dev, state, core, batches, k, decay, expect,
                   reps=DISPATCH_REPS):
    """One step core at K steps per dispatch against its eager steps, from
    one seeded state (cloned three times): path A, 3K eager steps, twice;
    path B (`train.graph.scan_multi`), the first dispatch's K eager
    warm-up steps and its capture, then two replays; every state leaf and
    each step's metrics of B bit-equal to A, or no further from A than A's
    two runs are from each other (printed beside). Then `decay_lr` on each
    and K more steps (B: one replay), held the same way, with the lr of
    that replay checked. Over B the wrappers' counts must be `expect` (per
    step) times 2K (the warm-up's launches and the capture's, which records
    them into the graph), and B's three replays run under torch.profiler:
    their kernel events, counted by symbol, must be `expect` times 3K. Then
    eager and graph ms a step over `reps` dispatches each, device busy,
    idle share and kernels a step of one eager K-step run and one replay,
    the capture's wall and each path's peak memory above the state.
    Returns ({kernel: wrapper count over B}, {kernel: device launches of
    B's replays}, the numbers)."""
    import torch
    from arec_torch.train.graph import scan_multi
    from arec_torch.train.step import decay_lr, step_generator, tree_map

    def clone(st):
        return type(st)(*(tree_map(torch.clone, x) for x in st))

    def keys(lo, hi):
        return [step_generator(0, i) for i in range(lo, hi)]

    def eager(st, lo, hi):
        ms = []
        for i in range(lo, hi):
            st, m = core(st, batches[i % len(batches)], step_generator(0, i))
            ms.append(m)
        return st, {key: torch.stack([m[key] for m in ms]) for key in ms[0]}

    multi = scan_multi(core, k)

    def graphed(st, lo, hi):
        ms = []
        for d in range(lo, hi, k):
            st, m = multi(st, [batches[i % len(batches)]
                               for i in range(d, d + k)], keys(d, d + k))
            ms.append(m)
        return st, {key: torch.cat([m[key] for m in ms]) for key in ms[0]}

    def replays(st, lo, hi):
        """graphed(st, lo, hi) under the profiler: (its result, {kernel:
        device launches})."""
        out, dev_events, _, _ = traced(lambda: graphed(st, lo, hi))
        return out, kernel_counts(
            (key, n) for key, (n, _) in dev_events.items())

    a1, a2, b = state, clone(state), clone(state)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a1 = eager(a1, 0, 3 * k)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() - base
    a2 = eager(a2, 0, 3 * k)
    counters = all_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():                     # ---- the main path
        fn.launches = 0
    t0 = time.perf_counter()
    b = graphed(b, 0, k)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    b1, replayed = replays(b[0], k, 3 * k)
    b = (b1[0], {key: torch.cat([b[1][key], b1[1][key]]) for key in b[1]})
    launches = {n: fn.launches for n, fn in counters.items()}
    graph_peak = torch.cuda.max_memory_allocated() - base
    gaps = [(run_gap(a1, b), run_gap(a1, a2))]
    a1, a2, b = ((decay_lr(x[0], decay), x[1]) for x in (a1, a2, b))
    a1, a2 = eager(a1[0], 3 * k, 4 * k), eager(a2[0], 3 * k, 4 * k)
    for fn in counters.values():
        fn.launches = 0
    b, more = replays(b[0], 3 * k, 4 * k)
    for n, fn in counters.items():
        launches[n] += fn.launches                   # ---- read just after
        replayed[n] += more[n]
    gaps.append((run_gap(a1, b), run_gap(a1, a2)))
    assert (multi.captures, multi.replays) == (1, 3), (multi.captures,
                                                       multi.replays)
    want = {n: 2 * k * expect.get(n, 0) for n in counters}
    assert launches == want, (launches, want)
    want = {n: 3 * k * expect.get(n, 0) for n in counters}
    assert replayed == want, (replayed, want)
    lr = b[1]["lr"].cpu()
    assert torch.all(lr == lr[0]), lr
    assert float(a1[1]["lr"][0]) == float(lr[0]), (a1[1]["lr"], lr)
    for (graph_gap, eager_gap), when in zip(gaps, ("3K", "4K")):
        assert graph_gap <= eager_gap, (what, when, graph_gap, eager_gap)
    assert all(torch.isfinite(b[1][m]).all() for m in b[1])
    log(f"{what} at K={k}: 3K steps eager (A, twice) and as the warm-up, "
        f"capture and 2 replays (B): graph vs eager max|d| {gaps[0][0]:.3e} "
        f"(eager vs eager {gaps[0][1]:.3e}); decay_lr({decay}) and one "
        f"more replay: lr {float(lr[0]):.6g} "
        f"(eager {float(a1[1]['lr'][0]):.6g}), "
        f"max|d| {gaps[1][0]:.3e} (eager vs eager {gaps[1][1]:.3e}); "
        f"first dispatch (K eager steps on a side stream + capture) "
        f"{first_s:.3f} s, capture {multi.capture_s:.3f} s; wrapper counts "
        f"over B (K warm-up steps, K captured) "
        f"{ {n: v for n, v in launches.items() if v} }; kernel events of "
        f"B's {multi.replays} replays ({multi.replays * k} steps) in the "
        f"profiler's trace { {n: v for n, v in replayed.items() if v} }")
    del a1, a2
    state = b[0]

    # times: eager K-step runs and replays in turns (E, G, G, E)
    def run_eager(lo):
        return eager(state, lo, lo + k)

    def run_graph(lo):
        return multi(state, [batches[i % len(batches)]
                             for i in range(lo, lo + k)], keys(lo, lo + k))

    walls = {"eager": [], "graph": []}
    lo = 4 * k
    for kind in ("eager", "graph", "graph", "eager"):
        fn = run_eager if kind == "eager" else run_graph
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(lo)
            lo += k
        torch.cuda.synchronize()
        walls[kind].append((time.perf_counter() - t0) / (reps * k) * 1e3)
    prof = {}
    for kind, fn in (("eager", run_eager), ("graph", run_graph)):
        busy, wall, n = device_breakdown(
            f"{what}: {k} steps, "
            f"{'eager' if kind == 'eager' else 'one replay'}",
            lambda fn=fn, lo=lo: fn(lo))
        lo += k
        prof[kind] = {"busy_ms_per_step": busy / k,
                      "wall_ms_per_step": wall / k,
                      "idle_share": 1 - busy / wall,
                      "kernels_per_step": n / k}
    log(f"{what}: ms a step eager {walls['eager']} vs graph {walls['graph']} "
        f"({reps} K-step runs each, in turns E G G E); per step eager "
        f"{prof['eager']} vs graph {prof['graph']}; peak device memory above "
        f"the three states: eager {eager_peak / 2**30:.3f} GiB, graph (its "
        f"pool, the warm-up and the replays) {graph_peak / 2**30:.3f} GiB")
    return launches, replayed, {
        "k": k, "eager_ms_per_step": walls["eager"],
        "graph_ms_per_step": walls["graph"], "profile": prof,
        "capture_s": multi.capture_s, "gap": gaps,
        "peak_gib_eager": eager_peak / 2**30,
        "peak_gib_graph": graph_peak / 2**30}


def sync_check(what, dev, state, core, batch, gen):
    """One eager step under `torch.cuda.set_sync_debug_mode("error")`: an
    op that syncs with the host raises and names itself."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = core(state, batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert math.isfinite(float(m["loss"]))
    log(f"{what}: one eager step under set_sync_debug_mode('error'): no op "
        f"synced with the host")
    return state


def dispatch_phase(dev, twin=TWIN, cuts=CUTS, sets=MF_SETS, mf_cuts=MF_CUTS,
                   k=DISPATCH_K, small=SMALL_C4):
    """K steps per dispatch (`train.graph`, one CUDA graph replay for K
    steps) at full width: (i) c4's LSTM dense step (B1's training launch,
    B2, B5, B6) and (ii) syn_xing_full's MF sparse step (B5, B6, B7), each
    through `dispatch_check` after one eager step under the sync check;
    (iii) a small c4 with keep_prob 0.8 at K = 2: replays equal to eager
    steps, and, with lr 0 and one set of negatives in every step, the
    dropout masks of the slots and of two replays differ (their losses
    do). Returns ({kernel: wrapper counts over (i) and (ii)}, {kernel:
    device launches of their replays, from the profiler}, the numbers)."""
    import itertools

    import torch
    import arec_torch.train.sparse as tsparse
    from arec_torch.data.dataset import mf_batches, seq_batches
    from arec_torch.kernels import lstm_scan as tk
    from arec_torch.kernels import row_scatter as trs
    from arec_torch.models.mf import MFSpec, init_mf
    from arec_torch.models.seq import SeqSpec, init_seq, seq_loss
    from arec_torch.tables.engine import attrs_to_device
    from arec_torch.train.graph import scan_multi
    from arec_torch.train.step import (init_state, make_optimizer,
                                       make_step_core, step_generator)

    def on_dev(batch):
        return {key: torch.from_numpy(v).to(dev) for key, v in batch.items()}

    def c4(cfg, ds, lr=None, sampled=None):
        tc = cfg.train
        spec = SeqSpec.from_config(cfg, ds.user_schema, ds.item_schema)
        idev = attrs_to_device(ds.item_attrs.restrict(spec.item_in.schema),
                               spec.item_in, dev)
        lr = tc.learning_rate if lr is None else lr

        def loss_fn(p, batch, gen):
            return seq_loss(p, spec, idev, None, batch, gen, sampled=sampled,
                            time_major=True)
        opt = make_optimizer(tc.optimizer, lr)
        state = init_state(init_seq(torch.Generator(device=dev).manual_seed(0),
                                    spec), opt)
        host = list(itertools.islice(
            seq_batches(ds, tc.batch_size, spec.pack_len, tc.seed, 0),
            8 * k))
        return spec, state, make_step_core(loss_fn, opt, lr), host

    out, replayed, numbers = {}, {}, {}
    scans = {tk.KERNEL: 1, tk.KERNEL_BWD: 1, "sampled_ce_fwd": 1,
             "sampled_ce_bwd": 1}

    # (i) c4's LSTM, dense step
    cfg, ds, _ = load_c4(twin, cuts)
    spec, state, core, host = c4(cfg, ds)
    assert cfg.train.steps_per_dispatch == k, cfg.train
    if twin is TWIN:
        assert (spec.vocab, spec.dim, spec.pack_len, spec.num_sampled) == (
            twin["data.syn_items"], 128, 50, 1024), spec
    batches = [on_dev(h) for h in host]
    state = sync_check("c4 (lstm) dense step", dev, state, core,
                       on_dev(host[-1]), step_generator(0, 10_000))
    launches, rep, numbers["c4"] = dispatch_check(
        "c4 (lstm) dense step", dev, state, core, batches, k,
        cfg.train.lr_decay, scans)
    out = launches
    replayed.update(rep)
    del state, core, batches
    free()

    # (ii) syn_xing_full's MF, sparse step
    cfg, ds, _ = load_mf(sets, mf_cuts)
    tc = cfg.train
    mspec = MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    assert (tc.steps_per_dispatch, tc.sparse_update) == (k, True), tc
    if sets is MF_SETS:
        assert (tc.batch_size, mspec.num_sampled, mspec.user.dim) == (
            8192, 2048, 128), tc
    udev = attrs_to_device(ds.user_attrs.restrict(mspec.user.schema),
                           mspec.user, dev)
    idev = attrs_to_device(ds.item_attrs.restrict(mspec.item.schema),
                           mspec.item, dev)
    opt = make_optimizer(tc.optimizer, tc.learning_rate)
    state = tsparse.init_sparse_state(
        init_mf(torch.Generator(device=dev).manual_seed(0), mspec),
        tsparse.table_paths(False, mspec), opt, tc.optimizer)
    core = tsparse.make_sparse_step_core(False, mspec, udev, idev, opt,
                                         tc.learning_rate, tc.optimizer)
    host = list(itertools.islice(mf_batches(ds, tc.batch_size, tc.seed, 0),
                                 8 * k))
    batches = [on_dev(h) for h in host]
    state = sync_check("MF sparse step", dev, state, core, batches[-1],
                       step_generator(0, 10_000))
    launches, rep, numbers["mf"] = dispatch_check(
        "MF sparse step", dev, state, core, batches, k, tc.lr_decay,
        {"sampled_ce_fwd": 1, "sampled_ce_bwd": 1, trs.KERNEL: 2})
    out = {n: out[n] + launches[n] for n in out}
    replayed.update({n: replayed.get(n, 0) + v for n, v in rep.items()})
    del state, core, batches, udev, idev
    free()

    # (iii) a small c4 with dropout, K = 2
    cfg, ds, _ = load_c4({**twin, **{kk: v for kk, v in small.items()
                                     if kk.startswith("data.")}},
                         {}, "lstm")
    cfg = cfg.override({kk: v for kk, v in small.items()
                        if kk.startswith("model.")})
    spec, state, core, host = c4(cfg, ds)
    assert spec.keep_prob == 0.8, spec
    batches = [on_dev(h) for h in host]
    dispatch_check("small c4 (lstm), keep_prob 0.8", dev, state, core,
                   batches, 2, cfg.train.lr_decay, scans, reps=1)
    g = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, spec.vocab, (spec.num_sampled,), generator=g,
                        device=dev, dtype=torch.int32)
    fixed = (ids, torch.full((spec.num_sampled,), 1.0 / spec.vocab,
                             device=dev))
    _, state, core, _ = c4(cfg, ds, lr=0.0, sampled=fixed)
    multi = scan_multi(core, 2)
    losses = []
    for d in range(3):
        state, m = multi(state, [batches[0]] * 2, [
            step_generator(0, 2 * d + i) for i in range(2)])
        losses.append(m["loss"])
    seen = torch.cat(losses[1:]).tolist()
    assert len(set(seen)) == 4, seen
    log(f"small c4 (lstm), keep_prob 0.8, lr 0, one batch and one set of "
        f"negatives in every step: the losses of two replays' slots "
        f"{[f'{x:.6f}' for x in seen]} all differ (new dropout masks each "
        f"replay)")
    del state, core, batches
    return out, replayed, numbers


class Tee(io.TextIOBase):
    """A stdout that prints through and keeps a copy (the Trainer's
    `[ckpt]` lines and the CLI's summary are read back from it)."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        return self.buf.write(s)

    def flush(self):
        self.out.flush()


def run_logged(fn, *args, **kw):
    """fn(*args, **kw) with stdout kept; returns (result, its output)."""
    import contextlib
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = fn(*args, **kw)
    return result, tee.buf.getvalue()


def saves_in(out):
    """The `[ckpt] saved step ...` lines of a run's output, as dicts."""
    import re
    pat = re.compile(r"\[ckpt\] saved step (\d+): (\d+) bytes; save\(\) "
                     r"blocked ([\d.]+) s, write ([\d.]+) s \((\w+)\)")
    return [{"step": int(m[1]), "bytes": int(m[2]),
             "blocked_s": float(m[3]), "write_s": float(m[4]),
             "mode": m[5]} for m in pat.finditer(out)]


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def load_ckpt_state(train_dir, step):
    """A checkpoint's TrainState dict, memory-mapped on the host."""
    import torch
    return torch.load(os.path.join(train_dir, "ckpt", str(step), "state.pt"),
                      map_location="cpu", weights_only=True, mmap=True)


def compare_states(a, b, path=""):
    """(bit-equal, max |a − b|, the differing leaves) of two state trees,
    each leaf held to SPARSE_DENSE."""
    import torch
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        parts = [compare_states(a[k], b[k], f"{path}/{k}") for k in sorted(a)]
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        parts = [compare_states(x, y, f"{path}/{i}")
                 for i, (x, y) in enumerate(zip(a, b))]
    else:
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if torch.equal(a, b):
            return True, 0.0, []
        torch.testing.assert_close(a, b, **SPARSE_DENSE)
        gap = float((a.double() - b.double()).abs().max())
        return False, gap, [path]
    return (all(p[0] for p in parts), max((p[1] for p in parts), default=0.0),
            [x for p in parts for x in p[2]])


MF_PACKED_BYTES = 4 * sum(rows * width for rows, width, _ in
                          MF_SHAPES.values())


def trainer_phase(dev, sets=MF_SETS, cuts=MF_CUTS, shapes=MF_SHAPES,
                  twin=TWIN, c4_cuts=CUTS, root=None):
    """The port's main path as its users run it, on a temporary train_dir
    that the phase deletes at its end:
    (a) syn_xing_full's MF trained through `cli.main.main` (Trainer, async
        checkpoints every 16 steps, steps_per_dispatch 8) for 32 steps;
    (b) a second invocation to 48 steps that restores step 32 and resumes
        mid-epoch, held against a straight 48-step run;
    (c) `Recommender(cfg)` served from the checkpoint, a 16-step run that
        writes a newer one, `refresh()` (peak memory against the first
        restore's), and `--recommend --out`;
    (d) c4's LSTM through the Trainer (16 steps, one save), served from
        its checkpoint;
    (e) the MF checkpoint of (c) served on syn_xing_full's own 2 x 4 mesh
        (row_shard "shuffle"): 8 gloo ranks sharing the card, each through
        `Recommender(cfg)`, 256 users and 3 request-loop lines, lists equal
        to the one-card Recommender's up to ties (`mesh_serve`);
    (f) c4's checkpoint of (d) on a 2 x 2 mesh: 4 ranks, 8 requests
        padded to 256, the LSTM forward kernel launched on every rank.
    The Trainers step through the CUDA graph (steps_per_dispatch 8), so the
    wrappers count the eager warm-up and the capture of each run, and run
    (a) also writes the Trainer's own trace (AREC_PROFILE_DIR) of its
    replay of steps 8..15, whose kernel events are counted.
    Returns ({kernel name: wrapper counts} over the Trainer runs, {"mf",
    "c4": {kernel: launches summed over the mesh ranks}}, the same per
    rank, {kernel name: device launches in the trace of (a)})."""
    import itertools
    import shutil
    import tempfile

    import numpy as np
    import torch
    from arec_torch.cli.main import load_config, main as cli_main, parse_args
    from arec_torch.data.dataset import mf_batches
    from arec_torch.data.prefetch import to_device
    from arec_torch.serve import Recommender, _serve_loop
    from arec_torch.train.loop import Trainer

    base = os.path.join(ROOT, "_train") if root is None else root
    os.makedirs(base, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke-", dir=base)
    free_gb = shutil.disk_usage(root).free / 1e9
    log(f"trainer phase under {root} ({free_gb:.1f} GB free on its disk)")
    counters = all_counters()
    launches = {k: 0 for k in counters}
    mesh, per_rank = {}, {}

    def counted(fn, *args, **kw):
        for f in counters.values():                  # ---- the main path
            f.launches = 0
        result = run_logged(fn, *args, **kw)
        for k, f in counters.items():                # ---- read just after
            launches[k] += f.launches
        return result, {k: f.launches for k, f in counters.items()
                        if f.launches}

    def mf_argv(train_dir, max_steps, **extra):
        s = {**sets, **{k: v for k, (_, v) in cuts.items()},
             "train.steps_per_checkpoint": 16, "train.eval_max_batches": 4,
             "train.async_ckpt": "true", "train.train_dir": train_dir,
             "train.max_steps": max_steps, **extra}
        return ["--config", XING] + [a for k, v in s.items()
                                     for a in ("--set", f"{k}={v}")]

    try:
        # ---- (a) MF through the CLI -------------------------------------
        mf_dir = os.path.join(root, "mf")
        prof_dir = os.path.join(root, "profile")
        os.environ["AREC_PROFILE_DIR"] = prof_dir   # steps [10, 15)
        t0 = time.perf_counter()
        try:
            (rc, out), used = counted(cli_main, mf_argv(mf_dir, 32),
                                      device=dev)
        finally:
            del os.environ["AREC_PROFILE_DIR"]
        wall_s = time.perf_counter() - t0
        assert rc == 0, rc
        # the Trainer's own trace holds the dispatch of steps 8..15, a
        # replay: its kernel launches, counted by symbol
        assert os.listdir(prof_dir) == ["trace_steps_8.json"], os.listdir(
            prof_dir)
        replayed = trace_kernel_counts(
            os.path.join(prof_dir, "trace_steps_8.json"))
        want = dict.fromkeys(KERNEL_SYMBOLS, 0)
        want.update({"sampled_ce_fwd": 8, "sampled_ce_bwd": 8,
                     "row_scatter": 16})
        assert replayed == want, (replayed, want)
        summary = json.loads(out.strip().splitlines()[-1])
        assert summary["steps"] == 32, summary
        cfg = load_config(parse_args(mf_argv(mf_dir, 32)))
        tc = cfg.train
        assert (tc.steps_per_dispatch, tc.sparse_update, tc.async_ckpt) == (
            8, True, True), tc
        with open(os.path.join(mf_dir, "metrics.jsonl")) as f:
            records = [json.loads(x) for x in f]
        assert [r["step"] for r in records] == [16, 32, 32], records
        saves = saves_in(out)
        assert [s["step"] for s in saves] == [16, 32], saves
        if shapes is MF_SHAPES:
            assert all(MF_PACKED_BYTES <= s["bytes"] <= 1.01 * MF_PACKED_BYTES
                       for s in saves), (saves, MF_PACKED_BYTES)
            # 8 eager warm-up steps and the 8 the capture records; the
            # replays of steps 8..31 run no wrapper
            assert (used.get("sampled_ce_fwd"), used.get("sampled_ce_bwd"),
                    used.get("row_scatter")) == (16, 16, 32), used
        assert set(used) <= {"sampled_ce_fwd", "sampled_ce_bwd",
                             "row_scatter"}, used
        log(f"(a) MF trained through cli.main.main to step 32 in "
            f"{wall_s:.2f} s (dataset load, state build, 32 steps, 3 evals "
            f"of {tc.eval_max_batches} batches, 2 async saves): summary "
            f"{summary}")
        for r in records:
            log(f"  metrics record {r}")
        log(f"  wrapper counts {used} (8 warm-up steps, 8 captured); the "
            f"Trainer's AREC_PROFILE_DIR trace of the replay of steps 8..15: "
            f"kernel events { {n: v for n, v in replayed.items() if v} }")
        for s in saves:
            log(f"  checkpoint step {s['step']}: {s['bytes']} bytes "
                f"({MF_PACKED_BYTES} of packed tables by reckoning); save() "
                f"blocked the loop {s['blocked_s']:.3f} s, the async write "
                f"took {s['write_s']:.3f} s")
        windows = [round(r["examples_per_s"], 1) for r in records
                   if "examples_per_s" in r]
        log(f"  examples/s through the Trainer's loop (metrics, windows of "
            f"16 steps, K = 8 steps a CUDA graph replay): {windows} (beside "
            f"the eager loop's windows of 5.2e5-8.3e5 in PERF.md section 5)")

        # ---- (b) exact resume ---------------------------------------------
        (rc, out), used_b = counted(cli_main, mf_argv(mf_dir, 48),
                                    device=dev)
        assert rc == 0, rc
        assert "[ckpt] restored step 32 (epoch 0+32 steps)" in out, out[-2000:]
        assert [s["step"] for s in saves_in(out)] == [48], saves_in(out)
        straight = os.path.join(root, "straight")
        (rc, _), _ = counted(cli_main, mf_argv(
            straight, 48, **{"train.save_every_evals": 3}), device=dev)
        assert rc == 0, rc
        t0 = time.perf_counter()
        with open(os.path.join(straight, "metrics.jsonl")) as f:
            windows = [round(r["examples_per_s"], 1) for r in map(
                json.loads, f) if "examples_per_s" in r]
        log(f"  examples/s of the straight run's windows (no save between "
            f"its evals; the first holds the warm-up and the capture): "
            f"{windows} (beside the eager loop's 5.2e5-8.3e5 in PERF.md "
            f"section 5)")
        equal, gap, leaves = compare_states(load_ckpt_state(mf_dir, 48),
                                            load_ckpt_state(straight, 48))
        assert equal, (gap, leaves)
        _, ds, load_s = load_mf(sets, cuts)
        log(f"(b) resumed at step 32 (mid-epoch: 32 of "
            f"{len(ds.train_users) // tc.batch_size} batches) and trained "
            f"to 48; its checkpoint against a straight "
            f"48-step run's: bit-equal {equal}, max |Δ| {gap:.3e} "
            f"(tolerance {SPARSE_DENSE}); differing leaves {leaves} "
            f"({time.perf_counter() - t0:.1f} s to compare)")
        shutil.rmtree(straight)
        # the Trainer's MF input path alone (its windows above include it;
        # mf_train_phase's bare steps pack their batches before the clock)
        t0 = time.perf_counter()
        host = list(itertools.islice(
            mf_batches(ds, tc.batch_size, tc.seed, 0), 16))
        pack_ms = (time.perf_counter() - t0) / len(host) * 1e3
        put = to_device(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in host:
            put(b).wait()
        torch.cuda.synchronize()
        h2d_ms = (time.perf_counter() - t0) / len(host) * 1e3
        log(f"  MF input path alone, 16 batches of {tc.batch_size}: "
            f"mf_batches {pack_ms:.4f} ms a batch (epoch permutation "
            f"included), to_device (pinned, copy stream) {h2d_ms:.4f} ms a "
            f"batch")

        # ---- (c) serving from the checkpoint -------------------------------
        users = ds.valid_users[:256].astype(np.int32)
        seen = [ds.seen_items[u][ds.seen_items[u] >= 0].tolist()
                for u in users]
        free()
        torch.cuda.reset_peak_memory_stats()
        held0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        rec = Recommender(cfg, device=dev)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        restore_peak = torch.cuda.max_memory_allocated()
        assert rec._restored_step == 48
        ids48 = rec.for_users(users, seen=seen)
        lines = [f"{users[0]}", "!step", "!refresh"]
        out = io.StringIO()
        _serve_loop(rec, io.StringIO("\n".join(lines) + "\n"), out)
        answers = out.getvalue().strip().split("\n")
        assert answers == [
            f"{users[0]}\t{','.join(map(str, rec.for_users([users[0]])[0].tolist()))}",
            "!ok step 48", "!ok current step 48"], answers
        log(f"(c) Recommender(cfg) from the step-48 checkpoint: startup "
            f"{startup_s:.3f} s (serve-only Trainer: dataset load — "
            f"{load_s:.3f} s alone, from its cache — restore onto the card, "
            f"item latents), peak device memory "
            f"{restore_peak / 2**30:.3f} GiB ({held0 / 2**30:.3f} held "
            f"before); {len(users)} users served, loop lines {answers[1:]}")

        t0 = time.perf_counter()
        (tr, out), used_c = counted(Trainer, load_config(parse_args(
            mf_argv(mf_dir, 64))), device=dev)
        (_, out2), used_c2 = counted(tr.train)
        tr.close()
        assert [s["step"] for s in saves_in(out2)] == [64], saves_in(out2)
        mem = Recommender(cfg, tr._eval_params(), device=dev).for_users(
            users, seen=seen)
        for k, v in used_c2.items():
            used_c[k] = used_c.get(k, 0) + v
        log(f"    a 16-step run to step 64 (restored at 48) in "
            f"{time.perf_counter() - t0:.2f} s; launches {used_c}")
        del tr
        free()
        torch.cuda.reset_peak_memory_stats()
        held1 = torch.cuda.memory_allocated()
        step_fn = rec._step
        t0 = time.perf_counter()
        assert rec.refresh() is True
        torch.cuda.synchronize()
        refresh_s = time.perf_counter() - t0
        refresh_peak = torch.cuda.max_memory_allocated()
        assert rec._restored_step == 64 and rec._step is step_fn
        ids64 = rec.for_users(users, seen=seen)
        assert np.array_equal(ids64, mem), "refreshed != trainer's state"
        assert not np.array_equal(ids64, ids48)
        one_mf = Recommender(cfg, device=dev)
        fresh = one_mf.for_users(users, seen=seen)
        assert np.array_equal(ids64, fresh), "refreshed != fresh"
        assert refresh_peak <= 1.05 * restore_peak, (refresh_peak,
                                                     restore_peak)
        log(f"    refresh() -> True in {refresh_s:.3f} s: peak device "
            f"memory {refresh_peak / 2**30:.3f} GiB across it "
            f"({held1 / 2**30:.3f} held before) against the first "
            f"restore's {restore_peak / 2**30:.3f} GiB (limit +5 %); its "
            f"{len(users)} lists equal the Trainer's in-memory state's and "
            f"a fresh Recommender's; ckpt dir holds "
            f"{sorted(os.listdir(os.path.join(mf_dir, 'ckpt')))} "
            f"({dir_bytes(os.path.join(mf_dir, 'ckpt')) / 1e9:.3f} GB)")
        del rec
        free()

        tsv = os.path.join(root, "top30.tsv")
        t0 = time.perf_counter()
        (rc, out), _ = counted(cli_main, mf_argv(mf_dir, 64) + [
            "--recommend", "--out", tsv], device=dev)
        rec_s = time.perf_counter() - t0
        assert rc == 0, rc
        result = json.loads(out.strip().splitlines()[-1])
        with open(tsv) as f:
            n_rows = sum(1 for _ in f)
        assert n_rows == result["users"] > 0, (n_rows, result)
        log(f"    --recommend --out: {n_rows} rows (every eval user) in "
            f"{rec_s:.2f} s (restore included); {result}")
        # ---- (e) the step-64 checkpoint on syn_xing_full's own mesh ------
        from arec_torch.serve import _auto_width, _pad_seen
        mesh["mf"], per_rank["mf"] = mesh_serve(
            "(e) syn_xing_full's MF from the step-64 checkpoint", dev,
            root, mf_argv(mf_dir, 64), MESH_MF,
            {"users": users, "seen": seen, "lines": lines}, one_mf,
            [({"user": users, "seen": _pad_seen(seen, len(users),
                                                _auto_width(seen))},
              len(users))], fresh)
        del one_mf
        shutil.rmtree(mf_dir)
        free()

        # ---- (d) c4's LSTM through the Trainer ---------------------------
        c4_dir = os.path.join(root, "c4")
        c4_sets = {**twin, **{k: v for k, (_, v) in c4_cuts.items()},
                   "data.data_dir": DATA_DIR, "train.max_steps": 16,
                   "train.steps_per_checkpoint": 8,
                   "train.save_every_evals": 2, "train.eval_max_batches": 4,
                   "train.train_dir": c4_dir}
        cfg4, ds4, _ = load(C4, c4_sets)

        def train_c4():
            tr = Trainer(cfg4, device=dev)
            tr.train()
            tr.close()
            return tr
        t0 = time.perf_counter()
        (tr, out), used_d = counted(train_c4)
        d_s = time.perf_counter() - t0
        saves = saves_in(out)
        assert [s["step"] for s in saves] == [16], saves
        for k in ("lstm_scan_fwd", "lstm_scan_bwd", "sampled_ce_fwd",
                  "sampled_ce_bwd"):
            assert used_d.get(k, 0) > 0, (k, used_d)
        hists = [ds4.hist_items[u][: ds4.hist_lengths[u]].tolist()
                 for u in range(8)]
        one4 = Recommender(cfg4, device=dev)
        served = one4.from_histories(hists)
        mem = Recommender(cfg4, tr.state.params,
                          device=dev).from_histories(hists)
        assert served.shape == (8, cfg4.train.eval_topk)
        assert np.array_equal(served, mem)
        log(f"(d) c4 LSTM trained through the Trainer for 16 steps in "
            f"{d_s:.2f} s; launches {used_d}; one save: {saves[0]['bytes']} "
            f"bytes, save() blocked {saves[0]['blocked_s']:.3f} s, write "
            f"{saves[0]['write_s']:.3f} s ({saves[0]['mode']}); "
            f"Recommender(cfg).from_histories from the checkpoint equals the "
            f"trainer's in-memory state on {len(hists)} histories")
        del tr
        free()
        # ---- (f) c4's checkpoint on a 2 x 2 mesh: B1 on every rank --------
        mesh["c4"], per_rank["c4"] = mesh_serve(
            "(f) c4's LSTM from its step-16 checkpoint, 8 requests padded "
            "to 256,", dev, root, ["--config", C4] + [
                a for k, v in c4_sets.items() for a in ("--set", f"{k}={v}")],
            MESH_C4, {"histories": hists}, one4,
            list(one4._history_batches(hists)), served)
        if dev.type == "cuda":    # (a CPU rehearsal launches no kernel)
            assert all(n > 0 for n in per_rank["c4"]["lstm_scan_fwd"]), (
                per_rank)
        del one4
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, mesh, per_rank, replayed


# ---- serving on a device mesh -----------------------------------------

# the meshes of the card run: syn_xing_full's own 2 x 4 (row_shard
# "shuffle", its config's) and c4's LSTM on 2 x 2, each as gloo ranks that
# share the one card (NCCL refuses two ranks on one GPU)
MESH_MF = (2, 4)
MESH_C4 = (2, 2)
TIE_TOL = dict(rtol=1e-5, atol=1e-5)


def tie_scores(q, v, b, seen, ids):
    """float64 masked scores of `ids` [B, k] (−1 ids read row 0): query
    and item rows rounded to bf16, as both top-ks round their operands,
    plus the bias, −1e9 per seen occurrence."""
    import torch
    ids = torch.as_tensor(ids, device=q.device).long()
    safe = ids.clamp_min(0)
    s = torch.einsum("bkd,bd->bk", v[safe].to(torch.bfloat16).double(),
                     q.to(torch.bfloat16).double()) + b[safe].double()
    seen = torch.as_tensor(seen, device=q.device).long()
    hits = (ids[:, :, None] == seen[:, None, :]).sum(-1)
    return (s - 1e9 * hits).cpu().numpy()


def lists_match(one, batches, got, want):
    """Compare two [N, k] list sets up to ties: at each rank the two ids'
    scores agree within TIE_TOL, and no list repeats an id. `batches`:
    the one-card Recommender's (numpy batch, n) pairs for the same
    requests. Returns the number of lists that differ at all."""
    import numpy as np
    import torch
    from arec_torch.train.loop import _query_fn
    v, b = one._vb
    differ, s = 0, 0
    for batch, n in batches:
        tb = {k: torch.from_numpy(x).to(one.device)
              for k, x in batch.items() if k != "seen"}
        g, w = got[s:s + n], want[s:s + n]
        rows = np.flatnonzero((g != w).any(axis=1))
        if rows.size:
            with torch.inference_mode():
                q = _query_fn(one.spec, one._params, one._item_dev,
                              one._user_dev, tb)[:n]
            seen = batch["seen"][:n]
            np.testing.assert_allclose(tie_scores(q, v, b, seen, g)[rows],
                                       tie_scores(q, v, b, seen, w)[rows],
                                       **TIE_TOL)
            assert all(len(set(r.tolist())) == r.size for r in g[rows])
        differ += rows.size
        s += n
    assert s == len(want)
    return differ


def _mesh_rank(rank, world, out_dir, job):
    """One gloo rank of the card's mesh run (torch.multiprocessing): the
    user's entry point, `Recommender(cfg)` from the checkpoint under
    job["argv"]'s train_dir, on the shared card; serves the job's requests
    and, for MF, its request-loop lines; saves its lists, its launches per
    kernel and its timings."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(job["device"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
        rank=rank, world_size=world)
    try:
        from arec_torch.cli.main import load_config, parse_args
        from arec_torch.serve import Recommender, _serve_loop
        counters = all_counters()
        cfg = load_config(parse_args(job["argv"]))
        t0 = time.perf_counter()
        rec = Recommender(cfg, device=dev)
        sync()
        startup_s = time.perf_counter() - t0
        for f in counters.values():                  # ---- the main path
            f.launches = 0
        t0 = time.perf_counter()
        if "users" in job:
            ids = rec.for_users(job["users"], seen=job["seen"])
            out = io.StringIO()
            _serve_loop(rec, io.StringIO("\n".join(job["lines"]) + "\n"),
                        out)
            answers = out.getvalue().strip().split("\n")
        else:
            ids = rec.from_histories(job["histories"])
            answers = []
        sync()
        serve_s = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if dev.type == "cuda" else float("nan"))
        torch.save({"ids": ids, "answers": answers, "launches": launches,
                    "startup_s": startup_s, "serve_s": serve_s,
                    "step": rec._restored_step, "peak_gib": peak},
                   os.path.join(out_dir, f"out.{rank}.pt"))
    finally:
        dist.destroy_process_group()


def mesh_serve(what, dev, root, argv, shape, job, one, batches, want):
    """Serve `job` on a data × model mesh of gloo ranks sharing the card,
    each rank through `Recommender(cfg)` from the checkpoint; every rank's
    lists must equal the one-card Recommender's (`one`, `want`) up to
    ties. Returns {kernel: launches summed over the ranks}."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp
    world = shape[0] * shape[1]
    out_dir = tempfile.mkdtemp(prefix="mesh-", dir=root)
    argv = argv + [a for k, v in {"mesh.data": shape[0],
                                  "mesh.model": shape[1]}.items()
                   for a in ("--set", f"{k}={v}")]
    try:
        t0 = time.perf_counter()
        # ranks share the card: "cuda:0" for each, not its LOCAL_RANK's
        job = {**job, "argv": argv,
               "device": "cuda:0" if dev.type == "cuda" else str(dev)}
        mp.spawn(_mesh_rank, args=(world, out_dir, job), nprocs=world)
        wall_s = time.perf_counter() - t0
        res = [torch.load(os.path.join(out_dir, f"out.{r}.pt"),
                          weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for r in res:
        assert np.array_equal(r["ids"], res[0]["ids"])
        assert r["answers"] == res[0]["answers"]
    differ = lists_match(one, batches, res[0]["ids"], want)
    launches = {k: sum(r["launches"][k] for r in res) for k in
                res[0]["launches"]}
    per_rank = {k: [r["launches"][k] for r in res] for k in launches
                if launches[k]}
    log(f"{what} on a {shape[0]} x {shape[1]} mesh of {world} gloo ranks "
        f"sharing the card (not a multi-GPU measurement): every rank "
        f"returns the same {res[0]['ids'].shape} lists, equal to the "
        f"one-card Recommender's up to ties ({differ} lists differ at a "
        f"tie); restored step {res[0]['step']}; launches per rank "
        f"{per_rank}; loop lines {res[0]['answers'][1:]}")
    log(f"  gloo ranks sharing one card, host wall: spawn to last rank "
        f"{wall_s:.2f} s; Recommender startup per rank "
        f"{[round(r['startup_s'], 2) for r in res]} s; serving per rank "
        f"{[round(r['serve_s'], 3) for r in res]} s; peak device memory "
        f"per rank {[round(r['peak_gib'], 3) for r in res]} GiB")
    return launches, per_rank


def mesh_nccl_phase(dev, sets=MF_SETS, cuts=MF_CUTS, n_queries=256):
    """The mesh paths' collectives on a one-rank NCCL group at
    syn_xing_full's full width, through a 1 x 1 mesh handed to the sharded
    functions: the exchange lookup and the masked lookup of one training
    batch's gather rows (8192 users and their 8192 positive items, through
    each encoder's attribute maps) into the item [1304126, 129] and user
    [1504123, 128] f32 tables in their shuffled layout, bit for bit against
    `dense_lookup` on the natural tables; the sharded top-k over the
    1,304,126-item matrix for 256 queries against `topk_with_mask`, up to
    ties. Prints ms for each beside the single-device call."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from arec_torch.data.dataset import mf_batches
    from arec_torch.dist.mesh import make_mesh
    from arec_torch.dist.specs import shard_rows
    from arec_torch.models.mf import MFSpec
    from arec_torch.retrieval.mips import make_sharded_topk
    from arec_torch.tables.engine import (
        attrs_to_device, dense_lookup, gather_row_ids,
    )
    from arec_torch.tables.layout import RowPerm
    from arec_torch.tables.sharded import (
        make_masked_lookup, make_sharded_lookup,
    )
    from arec_torch.train.evalu import topk_with_mask

    cfg, ds, _ = load_mf(sets, cuts)
    spec = MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    batch = next(mf_batches(ds, cfg.train.batch_size, cfg.train.seed, 0))
    os.makedirs(os.path.join(ROOT, "_train"), exist_ok=True)
    store = tempfile.mkdtemp(prefix="chip_smoke-nccl-",
                             dir=os.path.join(ROOT, "_train"))
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1, dev)
        g = torch.Generator(device=dev).manual_seed(11)
        for role, enc, key in (("item", spec.item, "pos_item"),
                               ("user", spec.user, "user")):
            attrs = (ds.item_attrs if role == "item" else ds.user_attrs)
            adev = attrs_to_device(attrs.restrict(enc.schema), enc, dev)
            ids = gather_row_ids(enc, adev, torch.from_numpy(
                batch[key]).to(dev))
            ids = torch.where(ids < enc.total_rows, ids, 0)   # encode's row 0
            table = torch.randn(enc.total_rows, enc.width, generator=g,
                                device=dev)
            perm = RowPerm.for_rows(enc.total_rows, enc.dense_region_rows)
            shard = shard_rows(perm.permute_table(table), mesh)
            want = dense_lookup(table, ids)
            exch = make_sharded_lookup(mesh, cfg.mesh.capacity_factor,
                                       dedup=cfg.mesh.dedup, perm=perm)
            masked = make_masked_lookup(mesh, perm)
            with torch.inference_mode():
                assert torch.equal(exch(shard, ids), want), role
                assert torch.equal(masked(shard, ids), want), role
                t = {"exchange": cuda_ms(lambda: exch(shard, ids), 10),
                     "masked": cuda_ms(lambda: masked(shard, ids), 10),
                     "dense_lookup": cuda_ms(lambda: dense_lookup(table, ids),
                                             10)}
            log(f"mesh (a) one-rank NCCL group, {role} table "
                f"[{enc.total_rows}, {enc.width}] f32 in its shuffled "
                f"layout, {ids.numel()} gather rows of a batch of "
                f"{cfg.train.batch_size}: exchange (2 all_to_all_single + "
                f"all_gather) and masked (all_reduce) lookups bit-equal to "
                f"dense_lookup; ms {t}")
            del table, shard, want
        v_items = spec.item.schema.num_entities
        lat = torch.randn(v_items, spec.item.dim, generator=g, device=dev)
        bias = torch.randn(v_items, generator=g, device=dev) * 0.1
        users = ds.valid_users[:n_queries]
        q = torch.randn(n_queries, spec.item.dim, generator=g, device=dev)
        seen = torch.from_numpy(ds.seen_items[users]).to(dev)
        topk = make_sharded_topk(mesh, k=30)
        with torch.inference_mode():
            got = topk(q, lat, bias, seen)
            want = topk_with_mask(q, lat, bias, seen, k=30)
            torch.testing.assert_close(got[0], want[0], **TIE_TOL)
            s_got, s_want = (tie_scores(q, lat, bias, seen, x[1])
                             for x in (got, want))
            np.testing.assert_allclose(s_got, s_want, **TIE_TOL)
            differ = int((got[1] != want[1]).any(dim=1).sum())
            t = {"sharded_topk": cuda_ms(lambda: topk(q, lat, bias, seen), 5),
                 "topk_with_mask": cuda_ms(
                     lambda: topk_with_mask(q, lat, bias, seen, k=30), 5)}
        log(f"mesh (a) sharded top-30 over V = {v_items} (D "
            f"{spec.item.dim}) for {n_queries} queries, seen width "
            f"{seen.shape[1]}, through all_gather of the candidates: equal "
            f"to topk_with_mask up to ties ({differ} lists differ at a "
            f"tie); ms {t}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


# ---- training on a device mesh ---------------------------------------

# the bf16 mesh run against the same run on one card, per element: both
# round the same operands to bf16 at the same points and differ by the
# order of the sums over the batch (the rows split over ranks, the
# gradients summed over them), which moves a bf16 operand by an ulp now
# and then; the gap follows the updates, not the values, so the
# tolerance is absolute. Set from two readings on the H100 (PERF.md §6):
# the sound runs' largest gaps, 2.678e-05 (MF, 16 steps) and 2.053e-05
# (c4, 4 steps), and the control that `_tolerance_control` reads in
# every run: the one-card run's params before its first step
# against its last, which must fall outside the tolerance in every table
# leaf (the rows B5 / B6 / B7 feed), so a mesh run whose table updates
# were lost could not pass.
MESH_BF16_TOL = dict(rtol=0.0, atol=1e-4)
# the f32 parity run (tests/test_multiprocess.py:124's tolerance)
MESH_F32_TOL = dict(rtol=2e-4, atol=2e-5)
# a collective that one rank misses fails the group after this long
MESH_TIMEOUT_S = 300


def _to_host(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    if hasattr(x, "detach"):
        return x.detach().to("cpu", copy=True)
    return x


class _FirstCall:
    """Stands in for a kernel wrapper in its module while entered (`with`):
    keeps a host copy of the inputs of the first call that `when(args,
    kwargs)` accepts, taken before the call, and of that call's outputs.
    Its `launches` is the wrapper's own, so the wrapper counts on as
    before."""

    def __init__(self, module, attr, when=lambda a, k: True):
        self.module, self.attr, self.when = module, attr, when
        self.fn = getattr(module, attr)
        self.args = self.kwargs = self.out = None

    launches = property(lambda self: self.fn.launches,
                        lambda self, n: setattr(self.fn, "launches", n))

    def __call__(self, *a, **k):
        first = self.args is None and self.when(a, k)
        if first:
            self.args, self.kwargs = _to_host(a), k
        out = self.fn(*a, **k)
        if first:
            self.out = _to_host(out)
        return out

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.fn)


# kernel name → (module, wrapper attribute, plain version, tolerances, the
# calls to take): the wrappers the mesh training runs launch
def _first_call_specs():
    from arec_torch.kernels import lstm_scan as tk
    from arec_torch.kernels import row_scatter as trs
    from arec_torch.kernels import sampled_softmax as tks
    exact = {"float32": dict(rtol=0.0, atol=0.0)}
    every = lambda a, k: True
    return {
        "lstm_scan_fwd": (tk, "lstm_scan_fwd", tk.lstm_layer_plain, TOL,
                          lambda a, k: k.get("residuals", False)),
        "lstm_scan_bwd": (tk, "lstm_layer_bwd", tk.lstm_layer_bwd_plain,
                          BWD_TOL, every),
        "sampled_ce_fwd": (tks, "sampled_ce_fwd", tks.sampled_ce_fwd_plain,
                           CE_VAL, every),
        "sampled_ce_bwd": (tks, "sampled_ce_bwd", tks.sampled_ce_bwd_plain,
                           CE_GRAD, every),
        trs.KERNEL: (trs, "row_scatter", trs.scatter_rows_set_plain, exact,
                     every)}


def _check_first_calls(caps, dev):
    """Each kernel's first captured main-path call: its outputs against
    the plain version on the same inputs, at the kernel checks'
    tolerances (the scans at TOL / BWD_TOL, the CE kernels at CE_VAL /
    CE_GRAD, each at the call's dtype; the row scatter bit for bit).
    Returns {kernel: {"shapes", "dtype", "tolerance", "errs": max |err|
    of each output}}."""
    import torch
    specs = _first_call_specs()
    out = {}
    for name, cap in caps.items():
        assert cap.out is not None, f"{name}: no main-path call captured"
        args = [a.to(dev) if torch.is_tensor(a) else a for a in cap.args]
        dtype = next((a for a in (*args, *cap.kwargs.values())
                      if isinstance(a, torch.dtype)), torch.float32)
        dt = str(dtype).split(".")[1]
        want = specs[name][2](*args, **cap.kwargs)
        got = cap.out
        got, want = ((got, want) if isinstance(want, tuple)
                     else ((got,), (want,)))
        got = [g.to(dev) for g in got]
        for g, w in zip(got, want):
            torch.testing.assert_close(
                g, w, **specs[name][3][dt],
                msg=lambda m: f"{name} against its plain version: {m}")
        out[name] = {"shapes": [list(a.shape) for a in args
                                if torch.is_tensor(a)],
                     "dtype": dt, "tolerance": specs[name][3][dt],
                     "errs": [float((g - w).abs().max())
                              for g, w in zip(got, want)]}
    return out


def _mesh_train_rank(rank, world, out_dir, job):
    """One gloo rank of a mesh training run (torch.multiprocessing), on
    the shared card: each of job["runs"] through `cli.main.main` as its
    users launch it (one rank a process), with its kernel launches
    counted (those before the run's first evaluation apart), Trainer
    startup and train() seconds, and peak device memory. On the last
    rank, the first call of each kernel in run["check"] is captured
    (`_FirstCall`) and held against its plain version after the run
    (`_check_first_calls`)."""
    import contextlib
    import datetime

    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        # the context and the allocator, before their statistics are read
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        from arec_torch.cli.main import main as cli_main
        from arec_torch.train import loop
        counters = all_counters()
        init, train, evaluate = (loop.Trainer.__init__, loop.Trainer.train,
                                 loop.Trainer.evaluate)
        results = []
        for run in job["runs"]:
            rec = {"name": run["name"], "before_eval": None}

            def timed_init(self, *a, **k):
                t0 = time.perf_counter()
                init(self, *a, **k)
                rec["startup_s"] = time.perf_counter() - t0

            def timed_train(self):
                t0 = time.perf_counter()
                out = train(self)
                rec["train_s"] = time.perf_counter() - t0
                return out

            def first_eval(self, *a, **k):
                if rec["before_eval"] is None:
                    rec["before_eval"] = {n: f.launches
                                          for n, f in counters.items()}
                return evaluate(self, *a, **k)
            loop.Trainer.__init__, loop.Trainer.train = (timed_init,
                                                         timed_train)
            loop.Trainer.evaluate = first_eval
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            specs = _first_call_specs()
            caps = ({k: _FirstCall(specs[k][0], specs[k][1], specs[k][4])
                     for k in run.get("check", ())}
                    if rank == world - 1 and dev.type == "cuda" else {})
            for f in counters.values():              # ---- the main path
                f.launches = 0
            try:
                with contextlib.ExitStack() as stack:
                    for cap in caps.values():
                        stack.enter_context(cap)
                    rc, out = run_logged(cli_main, run["argv"], device=dev)
            finally:
                loop.Trainer.__init__, loop.Trainer.train = init, train
                loop.Trainer.evaluate = evaluate
            cuda = dev.type == "cuda"
            if cuda:
                torch.cuda.synchronize(dev)
            rec.update(rc=rc, launches={n: f.launches
                                        for n, f in counters.items()},
                       peak_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                                 if cuda else float("nan")),
                       out=out if rank == 0 else "",
                       summary=json.loads(out.strip().splitlines()[-1]),
                       first_calls=_check_first_calls(caps, dev))
            results.append(rec)
        torch.save(results, os.path.join(out_dir, f"out.{rank}.pt"))
    finally:
        dist.destroy_process_group()


def mesh_train_run(what, dev, root, shape, runs):
    """`runs` (each {"name", "argv"}) in order on one data × model group of
    gloo ranks that share the card (NCCL refuses two ranks on one GPU):
    returns each rank's records (see `_mesh_train_rank`)."""
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp
    world = shape[0] * shape[1]
    out_dir = tempfile.mkdtemp(prefix="mesh-train-", dir=root)
    mesh_sets = ["--set", f"mesh.data={shape[0]}",
                 "--set", f"mesh.model={shape[1]}"]
    job = {"device": "cuda:0" if dev.type == "cuda" else str(dev),
           "runs": [{**r, "argv": r["argv"] + mesh_sets} for r in runs]}
    try:
        t0 = time.perf_counter()
        mp.spawn(_mesh_train_rank, args=(world, out_dir, job), nprocs=world)
        wall_s = time.perf_counter() - t0
        res = [torch.load(os.path.join(out_dir, f"out.{r}.pt"),
                          weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    log(f"{what}: {world} gloo ranks sharing the card ({shape[0]} x "
        f"{shape[1]}; not a multi-GPU measurement), spawn to the last rank "
        f"{wall_s:.2f} s")
    for i, run in enumerate(runs):
        recs = [r[i] for r in res]
        assert all(r["rc"] == 0 for r in recs), [r["rc"] for r in recs]
        assert all(r["summary"] == recs[0]["summary"] for r in recs)
        log(f"  {run['name']}: summary {recs[0]['summary']}; Trainer "
            f"startup per rank {[round(r['startup_s'], 2) for r in recs]} "
            f"s; train() per rank {[round(r['train_s'], 2) for r in recs]} "
            f"s; peak device memory per rank "
            f"{[round(r['peak_gib'], 3) for r in recs]} GiB; launches per "
            f"rank {_per_rank(recs)}")
        for line in recs[0]["out"].splitlines():
            if line.startswith(("[metrics]", "[ckpt]")):
                log(f"    rank 0 {line}")
        checked = recs[-1]["first_calls"]
        if dev.type == "cuda":
            assert set(checked) == set(run.get("check", ())), checked
        for k, c in checked.items():
            log(f"    rank {world - 1}: {k}'s first call of the run against "
                f"its plain version on the same inputs: shapes {c['shapes']}"
                f" {c['dtype']}, max abs err of each output "
                f"{[float(f'{e:.3e}') for e in c['errs']]} (tolerance "
                f"{c['tolerance']})")
    return res


def _per_rank(recs, key="launches"):
    return {k: [r[key][k] for r in recs] for k in recs[0][key]
            if any(r[key][k] for r in recs)}


def _named_leaves(tree, path=""):
    """(path, leaf) of a state tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _compare_ckpts(what, dev, a_dir, b_dir, step, tol, unpack=None):
    """Two checkpoints' states, leaf by leaf on the card: (bit-equal
    leaves, leaves, max |a − b|), each leaf held to `tol`. unpack: the
    packed tables' paths whose param halves `a` holds whole (a sparse
    state against a dense one: params only)."""
    import torch
    a = load_ckpt_state(a_dir, step)
    b = load_ckpt_state(b_dir, step)
    if unpack is not None:
        a, b = {"params": a["params"]}, {"params": b["params"]}

    la, lb = dict(_named_leaves(a)), dict(_named_leaves(b))
    assert set(la) == set(lb), (sorted(la), sorted(lb))
    equal, gap = 0, 0.0
    for k in la:
        x, y = la[k].to(dev), lb[k].to(dev)
        if unpack is not None and x.dim() == 2 and x.shape[1] == 2 * \
                y.shape[1]:
            x = x[:, : y.shape[1]]
        assert x.shape == y.shape, (k, x.shape, y.shape)
        if torch.equal(x, y):
            equal += 1
            continue
        gap = max(gap, float((x.double() - y.double()).abs().max()))
        torch.testing.assert_close(x, y, **tol, msg=lambda m: f"{k}: {m}")
    log(f"  {what}: {equal} of {len(la)} leaves bit-equal, the largest "
        f"gap {gap:.3e} (tolerance rtol {tol['rtol']}, atol "
        f"{tol['atol']})")
    return equal, len(la), gap


def _host_params(tr):
    """A Trainer's params as they stand, copied to the host, by path."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in _named_leaves({"params": tr.state.params})}


def _tolerance_control(what, dev, init, b_dir, step, tol):
    """The control of a tolerance: `init` (a one-card run's params before
    its first step, `_host_params`) against that run's checkpoint at
    `step`, as a mesh run whose updates were all lost would stand. Prints
    each param leaf's largest |Δ| over its tolerance (atol + rtol·|x|);
    every table leaf must read above 1. Returns {leaf: that share}."""
    b = dict(_named_leaves({"params": load_ckpt_state(b_dir, step)[
        "params"]}))
    assert set(b) == set(init), (sorted(b), sorted(init))
    share = {}
    for k, x0 in init.items():
        x, y = x0.to(dev).double(), b[k].to(dev).double()
        share[k] = float(((x - y).abs() / (tol["atol"] + tol["rtol"]
                                             * y.abs())).max())
    log(f"  {what}: control, the one-card run's params before its first "
        f"step against step {step}, largest |change| over the tolerance "
        f"per leaf: { {k: round(v, 2) for k, v in share.items()} }")
    tables = [k for k in share if "/tables/" in k or "/item_out" in k]
    assert tables and all(share[k] > 1.0 for k in tables), (what, share)
    return share


def mesh_train_phase(dev, sets=MF_SETS, cuts=MF_CUTS, twin=TWIN,
                     c4_cuts=CUTS, root=None, steps=16, f32_steps=4,
                     c4_steps=4):
    """Training on a device mesh, on a temporary train_dir the phase
    deletes at its end:
    (a) syn_xing_full's MF on its own 2 x 4 (row_shard "shuffle", the
        sparse mesh step, bf16), 8 gloo ranks sharing the card, through
        `cli.main.main`: `steps`/2 steps with a save, then a second
        invocation that resumes and trains to `steps`, evaluating; then
        the same in f32 for `f32_steps`, and the dense mesh step (f32,
        sparse_update false) as long, in the same ranks. Against one
        card (this process, the same global batches and negatives): the
        f32 run agrees on every final leaf at MESH_F32_TOL, the bf16 run
        at MESH_BF16_TOL (with its control, `_tolerance_control`),
        the sparse and dense mesh steps agree (SPARSE_DENSE), the mesh's
        checkpoint restores on one card and evaluates to the mesh's
        recall; B5, B6 and B7 launch on every rank, and their first calls
        on the last rank match their plain versions (`_FirstCall`).
    (b) c4's LSTM on 2 x 2 (the dense mesh step, bf16), 4 ranks, for
        `c4_steps` steps, against as many on one card (as the bf16 run
        above); B1's training launch and B2 on every rank, and B1, B2,
        B5 and B6's first calls on the last rank against plain.
    (c) `mesh_nccl_train`: a one-rank NCCL group.
    Returns ({kernel: launches summed over the ranks and runs}, {run:
    {kernel: launches per rank}})."""
    import shutil
    import tempfile

    import torch
    from arec_torch.cli.main import load_config, parse_args
    from arec_torch.train.loop import Trainer

    t_phase = time.perf_counter()
    base = os.path.join(ROOT, "_train") if root is None else root
    os.makedirs(base, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke-mt-", dir=base)
    counters = all_counters()
    launches = {k: 0 for k in counters}
    per_rank = {}

    def add(name, recs):
        per_rank[name] = _per_rank(recs)
        for r in recs:
            for k, n in r["launches"].items():
                launches[k] += n

    def mf_argv(name, max_steps, **extra):
        s = {**sets, **{k: v for k, (_, v) in cuts.items()},
             "train.steps_per_checkpoint": 8, "train.eval_max_batches": 4,
             "train.async_ckpt": "true",
             "train.train_dir": os.path.join(root, name),
             "train.max_steps": max_steps, **extra}
        return ["--config", XING] + [a for k, v in s.items()
                                     for a in ("--set", f"{k}={v}")]
    f32 = {"train.compute_dtype": "float32", "train.steps_per_dispatch": 2,
           "train.steps_per_checkpoint": f32_steps}
    c4_sets = {**twin, **{k: v for k, (_, v) in c4_cuts.items()},
               "data.data_dir": DATA_DIR, "train.max_steps": c4_steps,
               "train.steps_per_checkpoint": 8,
               "train.eval_max_batches": 4}
    # the datasets are prepared here, once, before the ranks load them
    load_mf(sets, cuts)
    load(C4, c4_sets)
    try:
        # ---- (a) syn_xing_full on its own 2 x 4 ---------------------------
        runs = [{"name": "bf16 to the first save",
                 "argv": mf_argv("bf16", steps // 2),
                 "check": ("sampled_ce_fwd", "sampled_ce_bwd", "row_scatter")},
                {"name": "bf16 resumed", "argv": mf_argv("bf16", steps)},
                {"name": "f32 sparse", "argv": mf_argv(
                    "f32", f32_steps, **f32)},
                {"name": "f32 dense", "argv": mf_argv(
                    "f32_dense", f32_steps, **f32,
                    **{"train.sparse_update": "false"}),
                 "check": ("sampled_ce_fwd", "sampled_ce_bwd")}]
        res = mesh_train_run("(a) syn_xing_full's MF", dev, root, MESH_MF,
                             runs)
        for i, run in enumerate(runs):
            recs = [r[i] for r in res]
            add(f"mf {run['name']}", recs)
            if run["name"].startswith("bf16") and dev.type == "cuda":
                for k in ("sampled_ce_fwd", "sampled_ce_bwd", "row_scatter"):
                    assert all(r["launches"][k] > 0 for r in recs), (k, recs)
        assert f"[ckpt] restored step {steps // 2}" in res[0][1]["out"]
        mesh_recall = res[0][1]["summary"]["recall_at_k"]
        # the same runs on one card, in this process
        one = {}
        for name, argv in (("one_bf16", mf_argv("one_bf16", steps)),
                           ("one_f32", mf_argv("one_f32", f32_steps,
                                               **f32))):
            cfg = load_config(parse_args(argv))
            t0 = time.perf_counter()
            for f in counters.values():
                f.launches = 0
            tr = Trainer(cfg, device=dev)
            if name == "one_bf16":
                init = _host_params(tr)
            one[name] = tr.train()
            tr.close()
            del tr
            free()
            ran = {k: f.launches for k, f in counters.items() if f.launches}
            log(f"  one card, {name}: {one[name]} in "
                f"{time.perf_counter() - t0:.2f} s; launches {ran}")
        d = lambda name: os.path.join(root, name)
        _compare_ckpts("(a) f32 parity: the mesh run against one card at "
                       f"step {f32_steps}", dev, d("f32"), d("one_f32"),
                       f32_steps, MESH_F32_TOL)
        _compare_ckpts(f"(a) bf16: the mesh run against one card at step "
                       f"{steps}", dev, d("bf16"), d("one_bf16"), steps,
                       MESH_BF16_TOL)
        _tolerance_control("(a) bf16", dev, init, d("one_bf16"), steps,
                           MESH_BF16_TOL)
        del init
        _compare_ckpts("(a) the sparse mesh step against the dense mesh "
                       f"step at step {f32_steps}, params (f32)", dev,
                       d("f32"), d("f32_dense"), f32_steps, SPARSE_DENSE,
                       unpack=True)
        restored = Trainer(load_config(parse_args(
            mf_argv("bf16", steps))).override(
            {"mesh.data": 1, "mesh.model": 1}), serve_only=True, device=dev)
        assert int(restored.state.step) == steps
        one_recall = restored.evaluate()
        n_eval = restored.cfg.train.eval_batch_size * 4
        log(f"  (a) the mesh's step-{steps} checkpoint restored on one "
            f"card: Recall@30 {one_recall:.6f} over {n_eval} eval rows, "
            f"the mesh's {mesh_recall:.6f}; the one-card bf16 run's "
            f"{one['one_bf16']['recall_at_k']:.6f}")
        # equal up to ties: at most one eval row may flip
        assert abs(one_recall - mesh_recall) <= 1.0 / n_eval + 1e-9
        del restored
        free()
        for name in ("bf16", "f32", "f32_dense", "one_bf16", "one_f32"):
            shutil.rmtree(d(name), ignore_errors=True)

        # ---- (b) c4 on 2 x 2: the dense mesh step -------------------------
        def c4_argv(name):
            s = {**c4_sets, "train.train_dir": d(name)}
            return ["--config", C4] + [a for k, v in s.items()
                                       for a in ("--set", f"{k}={v}")]
        res4 = mesh_train_run("(b) c4's LSTM", dev, root, MESH_C4,
                              [{"name": "dense", "argv": c4_argv("c4"),
                                "check": ("lstm_scan_fwd", "lstm_scan_bwd",
                                          "sampled_ce_fwd",
                                          "sampled_ce_bwd")}])
        recs = [r[0] for r in res4]
        add("c4 dense", recs)
        per_rank["c4 dense, before its evaluation"] = _per_rank(
            recs, "before_eval")
        if dev.type == "cuda":
            for k in ("lstm_scan_fwd", "lstm_scan_bwd", "sampled_ce_fwd",
                      "sampled_ce_bwd"):
                assert all(r["before_eval"][k] > 0 for r in recs), (k, recs)
        cfg4 = load_config(parse_args(c4_argv("one_c4")))
        t0 = time.perf_counter()
        tr = Trainer(cfg4, device=dev)
        init = _host_params(tr)
        one4 = tr.train()
        tr.close()
        del tr
        free()
        log(f"  one card, c4 {c4_steps} steps: {one4} in "
            f"{time.perf_counter() - t0:.2f} s")
        _compare_ckpts(f"(b) c4 bf16: the 2 x 2 run against one card at "
                       f"step {c4_steps}", dev, d("c4"), d("one_c4"), c4_steps,
                       MESH_BF16_TOL)
        _tolerance_control("(b) c4 bf16", dev, init, d("one_c4"), c4_steps,
                           MESH_BF16_TOL)
        del init
        for name in ("c4", "one_c4"):
            shutil.rmtree(d(name), ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # ---- (c) a one-rank NCCL group: its mesh steps' launches alone -----
    nccl = mesh_nccl_train(dev, sets, cuts)
    per_rank["nccl 1 x 1"] = {k: [n] for k, n in nccl.items() if n}
    for k, n in nccl.items():
        launches[k] += n
    log(f"mesh training phase: {time.perf_counter() - t_phase:.1f} s; "
        f"launches summed over ranks and runs "
        f"{ {k: n for k, n in launches.items() if n} }")
    return launches, per_rank


def mesh_nccl_train(dev, sets=MF_SETS, cuts=MF_CUTS, reps=5):
    """The mesh training steps on a one-rank NCCL group at syn_xing_full's
    full width (a 1 x 1 mesh handed to the Trainer's mesh set-up): the
    sparse mesh step core and the dense mesh step, each from the state of
    a one-card Trainer and on its first batch, against the one-card step
    (sparse: bit for bit; dense: SPARSE_DENSE, as the exchange's backward
    sums duplicate rows in another order than `embedding`'s); ms per step
    beside the one-card step's. Returns {kernel: launches} of the mesh
    steps alone (the one-card steps beside them are not counted)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from arec_torch import bridge
    from arec_torch.dist.global_io import shard_from_hosts
    from arec_torch.train.loop import Trainer, _MeshServing
    from arec_torch.train.step import TrainState, step_generator

    cfg, _, _ = load_mf(sets, cuts)
    counters = all_counters()
    launches = dict.fromkeys(counters, 0)
    os.makedirs(os.path.join(ROOT, "_train"), exist_ok=True)
    store = tempfile.mkdtemp(prefix="chip_smoke-nccl-train-",
                             dir=os.path.join(ROOT, "_train"))
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1)

    def clone(state):
        return TrainState(**bridge.to_torch(state._asdict(), dev))

    def copy(state):
        def c(t):
            if isinstance(t, dict):
                return {k: c(v) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(c(v) for v in t)
            return t.clone()
        return TrainState(**c(state._asdict()))

    try:
        for sparse in (True, False):
            c = cfg.override({"train.sparse_update": str(sparse).lower(),
                              "train.train_dir": os.path.join(store, "t")})
            tr = Trainer(c, device=dev)
            batch = shard_from_hosts(next(tr._batches(0)), None, dev)
            gen = lambda i: step_generator(c.train.seed, i)
            state0 = copy(tr.state)
            one, m_one = tr.step_fn(copy(state0), batch, gen(0))
            tr.sh = _MeshServing(c, tr.spec, tr.is_seq, dev)
            mesh_step = counted(tr._make_step(), counters, launches)
            mesh, m_mesh = mesh_step(bridge.shard_state(
                state0._asdict(), tr.sh, sparse, dev), batch, gen(0))
            got = tr.sh.canonical(mesh, sparse, tr._natural_rows)
            torch.cuda.synchronize(dev)
            loss = (float(m_one["loss"]), float(m_mesh["loss"]))
            gaps, equal, n = 0.0, 0, 0
            for (k, a), (_, b) in zip(
                    _named_leaves(one._asdict()),
                    _named_leaves(clone(got)._asdict())):
                n += 1
                if torch.equal(a, b):
                    equal += 1
                    continue
                assert not sparse, f"sparse mesh step differs at {k}"
                gaps = max(gaps, float((a.double() - b.double()).abs().max()))
                torch.testing.assert_close(b, a, **SPARSE_DENSE)
            if sparse:
                assert loss[0] == loss[1], loss
            else:
                torch.testing.assert_close(loss[1], loss[0], rtol=1e-5,
                                           atol=0.0)
            del got
            t = {}
            for name, fn, st in (("one card", tr.step_fn, one),
                                 ("1 x 1 mesh", mesh_step, mesh),
                                 ("1 x 1 mesh ", mesh_step, mesh),
                                 ("one card ", tr.step_fn, one)):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                for i in range(reps):
                    st, _ = fn(st, batch, gen(1 + i))
                torch.cuda.synchronize(dev)
                t.setdefault(name.strip(), []).append(
                    (time.perf_counter() - t0) * 1e3 / reps)
            kind = "sparse" if sparse else "dense"
            for name, fn, st in (("one card", tr.step_fn, one),
                                 ("the 1 x 1 mesh", mesh_step, mesh)):
                device_breakdown(f"one {kind} step on {name}",
                                 lambda: fn(st, batch, gen(1 + reps)))
            log(f"mesh (c) one-rank NCCL group, syn_xing_full "
                f"{kind} step at full width, "
                f"bf16: loss one card {loss[0]:.7f}, 1 x 1 mesh "
                f"{loss[1]:.7f}; {equal} of {n} state leaves bit-equal, the "
                f"largest gap {gaps:.3e}; ms per step (host clock to a "
                f"synchronize, {reps} steps, order one, mesh, mesh, one) "
                f"{ {k: [round(x, 3) for x in v] for k, v in t.items()} }")
            del tr, one, mesh, state0, batch
            free()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return launches


def counted(fn, counters, into):
    """fn, with the kernel launches made inside each of its calls added to
    into[kernel] (counters: `all_counters()`)."""
    def call(*a, **k):
        before = {n: f.launches for n, f in counters.items()}
        out = fn(*a, **k)
        for n, f in counters.items():
            into[n] += f.launches - before[n]
        return out
    return call



# ---- the host input path, raw-data prep and the approximate top-k -------

# A GPU spin of `ms` milliseconds: torch.cuda._sleep counts cycles, at
# most 2e6 a millisecond on this card (1.98 GHz)
SPIN_CYCLES_PER_MS = 2e6
INPUT_BATCHES = 32       # batches timed through each packer and each copy
STAGED_BATCHES = 64      # staged batches checked against their sources


def host_ms(fn, items) -> float:
    """Mean host ms of fn(item) over `items` (after one warm-up call)."""
    fn(items[0])
    t0 = time.perf_counter()
    for it in items:
        fn(it)
    return (time.perf_counter() - t0) / len(items) * 1e3


def input_path_phase(dev, twin=TWIN, cuts=CUTS, batches=INPUT_BATCHES,
                     staged=STAGED_BATCHES):
    """The host input path at c4's shape on the XING twin: `seq_batches`
    and `eval_batches` (L 50) packed by the numpy twin and by the C++
    packer (outputs equal); the old pageable `.to()` (inlined here as a
    yardstick) against the pinned copy-stream staging for MF's
    8192-row batch and c4's batch; how long each copy call blocks its
    thread behind a 10 ms GPU spin queued on the consumer's stream; and
    `staged` batches through `prefetch` with a consumer slower than the
    worker, each equal to its numpy source."""
    import itertools

    import numpy as np
    import torch
    from arec_torch import native
    from arec_torch.data.dataset import eval_batches, seq_batches
    from arec_torch.data.prefetch import prefetch, to_device

    cfg, ds, _ = load_c4(twin, cuts)
    tc, L, pad = cfg.train, cfg.model.max_seq_len, ds.num_items
    t0 = time.perf_counter()
    train = list(itertools.islice(
        seq_batches(ds, tc.batch_size, L, tc.seed, 0), batches))
    seq_ms = (time.perf_counter() - t0) / len(train) * 1e3
    evals = list(itertools.islice(
        eval_batches(ds, tc.eval_batch_size, max_seq_len=L), batches))
    assert len(train) == len(evals) == batches
    for kind, users in (("train", [b["user"] for b in train]),
                        ("eval", [b["user"].astype(np.int32)
                                  for b in evals])):
        cpp = getattr(native, f"pack_{kind}_sequences")
        twin_np = getattr(native, f"pack_{kind}_sequences_np")
        got = [cpp(ds.hist_items, ds.hist_lengths, u, L, pad) for u in users]
        want = [twin_np(ds.hist_items, ds.hist_lengths, u, L, pad)
                for u in users]
        assert all(np.array_equal(g, w) for gs, ws in zip(got, want)
                   for g, w in zip(gs, ws)), kind
        cpp_ms = host_ms(lambda u: cpp(ds.hist_items, ds.hist_lengths, u, L,
                                       pad), users)
        np_ms = host_ms(lambda u: twin_np(ds.hist_items, ds.hist_lengths, u,
                                          L, pad), users)
        log(f"(a) pack_{kind}_sequences, {len(users)} batches of "
            f"{len(users[0])} x L {L}: C++ {cpp_ms:.4f} ms a batch, numpy "
            f"twin {np_ms:.4f} ms ({np_ms / cpp_ms:.1f}x); outputs equal")
    log(f"    seq_batches through the C++ packer: {seq_ms:.4f} ms a batch "
        f"over {len(train)} (the epoch's user permutation included)")

    rng = np.random.default_rng(3)
    mf = [{"user": rng.integers(0, 1_504_123, 8192).astype(np.int32),
           "pos_item": rng.integers(0, 1_304_126, 8192).astype(np.int32)}
          for _ in range(batches)]

    def pageable(b):        # the copy the port made before: .to() per leaf
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in b.items()}

    for name, host in (("MF batch 8192 (user, pos_item)", mf),
                       (f"c4 batch {tc.batch_size} x {L}", train)):
        stager = to_device(dev)
        times = {}
        for how, fn in (("pageable", pageable),
                        ("pinned", lambda b: stager(b).wait()),
                        ("pinned again", lambda b: stager(b).wait()),
                        ("pageable again", pageable)):
            torch.cuda.synchronize()
            times[how] = host_ms(fn, host)
            torch.cuda.synchronize()
        log(f"(a) to_device, {name}, ms a batch over {len(host)} "
            f"(host time of the calls, in the order shown): "
            + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))

    # what each copy call does to its thread with a step queued before it
    b = train[0]
    stager = to_device(dev)
    for _ in range(len(stager.ring)):              # every slot allocated
        stager(b).wait()
    spin_done = torch.cuda.Event(enable_timing=True)
    spin_start = torch.cuda.Event(enable_timing=True)
    blocked = {}
    for how in ("pageable", "pinned"):
        torch.cuda.synchronize()
        spin_start.record()
        torch.cuda._sleep(int(10 * SPIN_CYCLES_PER_MS))
        spin_done.record()
        t0 = time.perf_counter()
        out = pageable(b) if how == "pageable" else stager(b)
        call_ms = (time.perf_counter() - t0) * 1e3
        waited = spin_done.query()
        if how == "pinned":
            out = out.wait()
        torch.cuda.synchronize()
        for k in b:
            assert np.array_equal(out[k].cpu().numpy(), b[k]), (how, k)
        blocked[how] = (call_ms, waited, spin_start.elapsed_time(spin_done))
    for how, (call_ms, waited, spin_ms) in blocked.items():
        log(f"(a) behind a {spin_ms:.3f} ms GPU spin on the consumer's "
            f"stream, the {how} copy call blocked its thread {call_ms:.4f} "
            f"ms; the spin had {'ended' if waited else 'not ended'} when "
            f"it returned")
    assert not blocked["pinned"][1], "the pinned copy waited for the spin"

    src = list(itertools.islice(
        seq_batches(ds, tc.batch_size, L, tc.seed, 1), staged))
    outs = []
    t0 = time.perf_counter()
    for tb in prefetch(iter(src), depth=2, transform=to_device(dev, 2)):
        torch.cuda._sleep(int(0.5 * SPIN_CYCLES_PER_MS))    # the step
        outs.append({k: v.clone() for k, v in tb.items()})
        del tb
        time.sleep(0.002)                # the consumer is the slower side
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    assert len(outs) == len(src) == staged
    for got, want in zip(outs, src):
        for k in want:
            assert np.array_equal(got[k].cpu().numpy(), want[k]), k
    log(f"(a) {staged} batches staged through prefetch (depth 2, a 0.5 ms "
        f"spin and 2 ms of host sleep a step, {wall_s:.2f} s): each equals "
        f"its numpy source")


def _zipf_ids(rng, n, size, a):
    """`size` draws from range(n), the r-th most popular with weight
    1/(r+1)^a, popularity ranks shuffled over the ids."""
    import numpy as np
    w = 1.0 / np.arange(1, n + 1) ** a
    return rng.permutation(n)[rng.choice(n, size=size, p=w / w.sum())]


def _id_lists(rng, n, vocab, lo, hi):
    """n comma-separated lists of lo..hi ids below `vocab`."""
    import numpy as np
    lens = rng.integers(lo, hi + 1, n)
    toks = rng.integers(0, vocab, int(lens.sum())).astype(str)
    ends = np.cumsum(lens)
    return [",".join(toks[e - k:e]) for e, k in zip(ends, lens)]


def _write_tsv(path, header, columns):
    with open(path, "w") as f:
        f.write("\t".join(header) + "\n")
        f.write("\n".join("\t".join(r) for r in zip(*columns)) + "\n")


# The RecSys'17 dump's layout (tab-separated, a header row, multi-valued
# fields comma-separated), at syn_xing_full's item count. Users and
# interaction rows are cut so that the prep (arec's Python loops, ported
# as they are) stays near a minute on the card's host.
XING_RAW = {"items": 1_304_126, "users": 400_000,
            "interactions": 1_500_000}
XING_RAW_CUTS = ("users.csv: about 1.5M users in the published dump -> "
                 "400,000; interactions.csv: hundreds of millions of rows "
                 "(impressions included) -> 1,500,000")
# interaction types 0-5 (impression, click, bookmark, reply, delete,
# recruiter interest); arec keeps 1-3
XING_TYPE_SHARES = (0.35, 0.45, 0.08, 0.05, 0.05, 0.02)


def write_xing_raw(d, items, users, interactions, seed=0):
    """A raw XING dump in the RecSys'17 layout under `d`: items.csv,
    users.csv, interactions.csv (raw ids sparse, item and user activity
    Zipf-distributed, repeated (user, item) pairs, every interaction
    type)."""
    import numpy as np
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    item_ids = rng.permutation(3 * items)[:items] + 1
    user_ids = rng.permutation(2 * users)[:users] + 1

    def cat(n, m):
        return rng.integers(0, m, n).astype(str)
    countries = np.array(["de", "at", "ch", "non_dach"])
    _write_tsv(os.path.join(d, "items.csv"),
               ("id", "title", "career_level", "discipline_id",
                "industry_id", "country", "is_payed", "region", "latitude",
                "longitude", "employment", "tags", "created_at"),
               (item_ids.astype(str), _id_lists(rng, items, 100_000, 1, 6),
                cat(items, 7), cat(items, 24), cat(items, 24),
                countries[rng.integers(0, 4, items)], cat(items, 2),
                cat(items, 17),
                np.round(rng.uniform(46, 55, items), 1).astype(str),
                np.round(rng.uniform(6, 15, items), 1).astype(str),
                cat(items, 6), _id_lists(rng, items, 100_000, 0, 8),
                rng.integers(1_480_000_000, 1_487_000_000, items).astype(
                    str)))
    _write_tsv(os.path.join(d, "users.csv"),
               ("id", "jobroles", "career_level", "discipline_id",
                "industry_id", "country", "region",
                "experience_n_entries_class", "experience_years_experience",
                "experience_years_in_current", "edu_degree",
                "edu_fieldofstudies", "wtcj", "premium"),
               (user_ids.astype(str), _id_lists(rng, users, 50_000, 0, 8),
                cat(users, 7), cat(users, 24), cat(users, 24),
                countries[rng.integers(0, 4, users)], cat(users, 17),
                cat(users, 4), cat(users, 7), cat(users, 7), cat(users, 4),
                cat(users, 10), cat(users, 2), cat(users, 2)))
    _write_tsv(os.path.join(d, "interactions.csv"),
               ("user_id", "item_id", "interaction_type", "created_at"),
               (user_ids[_zipf_ids(rng, users, interactions, 0.7)].astype(
                   str),
                item_ids[_zipf_ids(rng, items, interactions, 1.0)].astype(
                    str),
                rng.choice(6, interactions, p=XING_TYPE_SHARES).astype(str),
                np.sort(rng.integers(1_484_000_000, 1_487_000_000,
                                     interactions)).astype(str)))


# ML-1M's published counts (GroupLens README): 6,040 users, movie ids to
# 3,952, 1,000,209 ratings, every user with at least 20
ML1M_RAW = {"users": 6_040, "movies": 3_952, "ratings": 1_000_209}
ML1M_MAX_PER_USER = 2_314          # ML-1M's most active user
ML1M_GENRES = ("Action", "Adventure", "Animation", "Children's", "Comedy",
               "Crime", "Documentary", "Drama", "Fantasy", "Film-Noir",
               "Horror", "Musical", "Mystery", "Romance", "Sci-Fi",
               "Thriller", "War", "Western")


def write_ml1m_raw(d, users, movies, ratings, seed=0):
    """A raw ML-1M dump in the GroupLens `::` layout under `d`:
    users.dat, movies.dat, ratings.dat (≥ 20 ratings a user, no repeated
    (user, movie) pair, timestamps increasing per user)."""
    import numpy as np
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    ages = np.array([1, 18, 25, 35, 45, 50, 56])
    with open(os.path.join(d, "users.dat"), "w", encoding="latin-1") as f:
        f.write("\n".join(
            f"{u}::{'FM'[rng.integers(0, 2)]}::{ages[rng.integers(0, 7)]}::"
            f"{rng.integers(0, 21)}::{rng.integers(0, 100_000):05d}"
            for u in range(1, users + 1)) + "\n")
    with open(os.path.join(d, "movies.dat"), "w", encoding="latin-1") as f:
        f.write("\n".join(
            f"{m}::Movie {m} ({rng.integers(1919, 2001)})::"
            + "|".join(sorted(set(rng.choice(ML1M_GENRES,
                                             rng.integers(1, 4)))))
            for m in range(1, movies + 1)) + "\n")
    # ratings a user: 20 + a heavy-tailed share of the rest, at most
    # ML1M_MAX_PER_USER, summing to `ratings`
    cap = min(ML1M_MAX_PER_USER, movies)
    weight = rng.lognormal(0.0, 1.0, users)
    counts = 20 + rng.multinomial(ratings - 20 * users, weight / weight.sum())
    while (over := np.maximum(counts - cap, 0)).any():
        counts -= over
        room = weight * (counts < cap)
        counts += rng.multinomial(over.sum(), room / room.sum())
    pop = 1.0 / np.arange(1, movies + 1) ** 0.8
    pop = pop[rng.permutation(movies)] / pop.sum()
    rows = []
    t = 956_703_932
    for u, n in enumerate(counts, 1):
        ms = rng.choice(movies, size=n, replace=False, p=pop) + 1
        stars = rng.integers(1, 6, n)
        ts = t + np.sort(rng.integers(0, 10_000_000, n))
        rows.append("\n".join(f"{u}::{m}::{s}::{x}"
                              for m, s, x in zip(ms, stars, ts)))
    with open(os.path.join(d, "ratings.dat"), "w", encoding="latin-1") as f:
        f.write("\n".join(rows) + "\n")
    assert counts.sum() == ratings


def approx_overlap(exact, approx):
    """Mean share of each exact top-k list that the approximate list
    holds."""
    import numpy as np
    k = exact.shape[1]
    return float(np.mean([len(set(e.tolist()) & set(a.tolist())) / k
                          for e, a in zip(exact, approx)]))


APPROX_TARGET = 0.95
APPROX_MIN_OVERLAP = 0.90     # MF at V = 1.3M, seeded random weights


def serve_compare(what, make, call, seen, reps=5):
    """One request batch served by the exact and the approximate top-k
    (`make(target)` builds the Recommender, `call(rec)` serves the batch):
    batch latency (median host ms of `reps` synchronised calls), device
    busy, the approximate path's (R, l) and the mean top-k overlap with
    the exact lists. No list may hold a seen id. Returns the overlap."""
    import numpy as np
    import torch
    from arec_torch.retrieval.mips import approx_reduction_size
    from arec_torch.serve import _auto_width

    out = {}
    for target in (1.0, APPROX_TARGET):
        rec = make(target)
        ids = call(rec)                               # warm-up
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            ids = call(rec)
            ms.append((time.perf_counter() - t0) * 1e3)
        busy, _, _ = device_breakdown(f"{what}, recall_target {target}",
                                   lambda: call(rec))
        for row, s in zip(ids, seen):
            assert len(set(row.tolist())) == rec.k and (row >= 0).all()
            assert not set(row.tolist()) & set(s), "a seen id was served"
        out[target] = (ids, float(np.median(ms)), busy)
        V, k = rec._vb[0].shape[0], rec.k
        del rec
    width = _auto_width(seen)
    r, l = approx_reduction_size(V, k + width, APPROX_TARGET)
    overlap = approx_overlap(out[1.0][0], out[APPROX_TARGET][0])
    log(f"(d) {what}: V {V}, k {k}, seen slab {width} -> "
        f"{min(k + width, V)} candidates; recall_target 1.0: batch "
        f"{out[1.0][1]:.3f} ms (median of {reps}), device busy "
        f"{out[1.0][2]:.3f} ms; {APPROX_TARGET}: batch "
        f"{out[APPROX_TARGET][1]:.3f} ms, device busy "
        f"{out[APPROX_TARGET][2]:.3f} ms, R {r}, l {l}; mean top-{k} "
        f"overlap with the exact lists {overlap:.4f}")
    torch.cuda.synchronize()
    return overlap


def approx_topk_phase(dev, sets=MF_SETS, cuts=MF_CUTS, twin=TWIN,
                      c4_cuts=CUTS):
    """The approximate top-k at serving width: syn_xing_full's MF
    `for_users` (256 users with their train items as seen lists, V =
    1,304,126) and c4's LSTM serving batch (8 requests padded to 256),
    each with serve_recall_target 1.0 and 0.95, seeded random weights.
    The MF overlap must reach APPROX_MIN_OVERLAP. Returns the LSTM
    forward's launches."""
    import numpy as np
    import torch
    from arec_torch.models.mf import MFSpec, init_mf
    from arec_torch.models.seq import SeqSpec, init_seq
    from arec_torch.serve import Recommender
    from arec_torch.train.sparse import pack_tables, table_paths

    def with_target(cfg, target):
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, serve_recall_target=target))

    cfg, ds, _ = load_mf(sets, cuts)
    spec = MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    params = pack_tables(
        init_mf(torch.Generator(device=dev).manual_seed(0), spec),
        table_paths(False, spec))
    rng = np.random.default_rng(2)
    users = rng.choice(np.flatnonzero(ds.seen_lengths > 0), 256,
                       replace=False).astype(np.int32)
    seen = [ds.seen_items[u][ds.seen_items[u] >= 0].tolist() for u in users]
    overlap = serve_compare(
        "MF for_users, 256 users",
        lambda t: Recommender(with_target(cfg, t), params, serve_batch=256,
                              device=dev),
        lambda rec: rec.for_users(users, seen=seen), seen)
    assert overlap >= APPROX_MIN_OVERLAP, (overlap, APPROX_MIN_OVERLAP)
    del params
    free()

    fwd = scan_counters("lstm")[0]["lstm_scan_fwd"]
    cfg, ds, _ = load_c4(twin, c4_cuts)
    spec = SeqSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    params = init_seq(torch.Generator(device=dev).manual_seed(0), spec)
    rng = np.random.default_rng(1)
    hists = [rng.integers(0, spec.vocab, n).tolist()
             for n in (5, 12, 30, 49, 50, 120, 20, 1)]
    fwd.launches = 0                                 # ---- the main path
    serve_compare(
        "c4 LSTM from_histories, 8 requests padded to 256",
        lambda t: Recommender(with_target(cfg, t), params, serve_batch=256,
                              device=dev),
        lambda rec: rec.from_histories(hists), hists)
    launches = fwd.launches                          # ---- read just after
    assert launches > 0
    return {"lstm_scan_fwd": launches}


def raw_data_phase(dev, root=None, xing=XING_RAW, ml1m=ML1M_RAW, steps=16,
                   window=8, serve_users=256):
    """The real configurations from raw dumps, as users run them, under a
    temporary directory in _data/ that the phase deletes at its end:
    (b) a raw XING dump (RecSys'17 layout) prepared into c4's dataset, c4
        (configs/c4_lstm_attr_xing.json as it stands) trained for `steps`
        steps through `cli.main.main`, Recall@30 from its checkpoint with
        eval_recall_target 1.0 and 0.95, and 8 requests served with
        serve_recall_target 1.0 and 0.95;
    (c) a raw ML-1M dump (GroupLens layout, published counts) prepared,
        c2 (configs/c2_mf_attr_ml1m.json) trained for `steps` steps
        through the CLI, and `serve_users` users served.
    The only overrides are data.raw_dir, data.data_dir, train.train_dir,
    train.max_steps (= steps) and train.steps_per_checkpoint (= window, so
    that the loop's metrics record its examples/s over each window of
    steps; the first window holds the loop's start). Returns {kernel:
    launches}."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from arec_torch.cli.main import load_config, main as cli_main, parse_args
    from arec_torch.data.io import load_or_prepare
    from arec_torch.retrieval.mips import approx_reduction_size
    from arec_torch.serve import Recommender
    from arec_torch.train.loop import Trainer

    base = os.path.join(ROOT, "_data") if root is None else root
    os.makedirs(base, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_raw-", dir=base)
    counters = all_counters()
    launches = {k: 0 for k in counters}
    mesh, per_rank = {}, {}

    def counted(fn, *args, **kw):
        for f in counters.values():                  # ---- the main path
            f.launches = 0
        result = run_logged(fn, *args, **kw)
        for k, f in counters.items():                # ---- read just after
            launches[k] += f.launches
        return result, {k: f.launches for k, f in counters.items()
                        if f.launches}

    def config(path, name):
        argv = ["--config", path]
        for k, v in (("data.raw_dir", os.path.join(root, name)),
                     ("data.data_dir", os.path.join(root, "prep")),
                     ("train.train_dir", os.path.join(root, f"t_{name}")),
                     ("train.max_steps", steps),
                     ("train.steps_per_checkpoint", window)):
            argv += ["--set", f"{k}={v}"]
        return argv, load_config(parse_args(argv))

    def train(what, argv, cfg):
        t0 = time.perf_counter()
        ds = load_or_prepare(cfg.data)
        prep_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (rc, out), used = counted(cli_main, argv, device=dev)
        wall_s = time.perf_counter() - t0
        assert rc == 0, rc
        summary = json.loads(out.strip().splitlines()[-1])
        assert summary["steps"] == steps, summary
        with open(os.path.join(cfg.train.train_dir, "metrics.jsonl")) as f:
            records = [r for r in map(json.loads, f) if "loss" in r]
        assert [r["step"] for r in records] == list(
            range(window, steps + 1, window)), records
        assert all(math.isfinite(r["loss"]) for r in records), records
        log(f"{what}: prep {prep_s:.2f} s ({ds.num_users} users, V "
            f"{ds.num_items} after truncation, {len(ds.train_users)} train "
            f"interactions, {len(ds.valid_users)} held out, seen slab "
            f"{ds.seen_items.shape[1]}); {steps} steps through "
            f"cli.main.main in {wall_s:.2f} s (state build, "
            f"{len(records) + 1} evals, save): loss "
            f"{[round(r['loss'], 4) for r in records]}, examples/s through "
            f"the loop {[round(r['examples_per_s'], 1) for r in records]} "
            f"(windows of {window} steps); launches {used}; summary "
            f"{summary}")
        return ds

    def with_train(cfg, **kw):
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, **kw))

    try:
        # ---- (b) raw XING -> c4 -----------------------------------------
        t0 = time.perf_counter()
        write_xing_raw(os.path.join(root, "xing"), **xing)
        log(f"(b) wrote a raw XING dump ({xing}) in "
            f"{time.perf_counter() - t0:.2f} s; reduced: {XING_RAW_CUTS}")
        argv, cfg = config(C4, "xing")
        assert cfg.data.dataset == "xing" and cfg.model.model == "lstm"
        ds = train("(b) c4 from raw XING", argv, cfg)
        if xing is XING_RAW:
            assert ds.num_items == cfg.data.item_vocab_size, ds.num_items
        k, width = cfg.train.eval_topk, ds.seen_items.shape[1]
        r, l = approx_reduction_size(ds.num_items, k + width, APPROX_TARGET)
        for target in (1.0, APPROX_TARGET):
            tr = Trainer(with_train(cfg, eval_recall_target=target),
                         serve_only=True, device=dev)
            t0 = time.perf_counter()
            recall = tr.evaluate(exact=target == 1.0)
            log(f"(b) Recall@{k} from the step-{steps} checkpoint, "
                f"eval_recall_target {target}: {recall:.5f} over "
                f"{len(ds.valid_users)} held-out rows in "
                f"{time.perf_counter() - t0:.2f} s"
                + (f" (the eval's seen slab is {width} wide: "
                   f"{min(k + width, ds.num_items)} candidates, R {r}, l "
                   f"{l})" if target < 1 else ""))
            del tr
        rng = np.random.default_rng(4)
        users = rng.choice(np.flatnonzero(ds.hist_lengths >= 1), 8,
                           replace=False)
        hists = [ds.hist_items[u][: ds.hist_lengths[u]].tolist()
                 for u in users]
        served = {}
        for target in (1.0, APPROX_TARGET):
            rec = Recommender(with_train(cfg, serve_recall_target=target),
                              device=dev)
            served[target] = rec.from_histories(hists)
            for row, h in zip(served[target], hists):
                assert not set(row.tolist()) & set(h)
                assert ((row >= 0) & (row < ds.num_items)).all()
            del rec
        log(f"(b) served {len(hists)} requests (histories of "
            f"{[len(h) for h in hists]}) from the checkpoint with "
            f"serve_recall_target 1.0 and {APPROX_TARGET}: top-30 overlap "
            f"{approx_overlap(served[1.0], served[APPROX_TARGET]):.4f}")
        del ds
        free()

        # ---- (c) raw ML-1M -> c2 ----------------------------------------
        t0 = time.perf_counter()
        write_ml1m_raw(os.path.join(root, "ml1m"), **ml1m)
        log(f"(c) wrote a raw ML-1M dump ({ml1m}) in "
            f"{time.perf_counter() - t0:.2f} s")
        argv, cfg = config(os.path.join(ROOT, "configs",
                                        "c2_mf_attr_ml1m.json"), "ml1m")
        assert cfg.data.dataset == "ml1m" and cfg.model.model == "mf"
        ds = train("(c) c2 from raw ML-1M", argv, cfg)
        users = ds.valid_users[:serve_users].astype(np.int32)
        seen = [ds.seen_items[u][ds.seen_items[u] >= 0].tolist()
                for u in users]
        rec = Recommender(cfg, device=dev)
        t0 = time.perf_counter()
        ids = rec.for_users(users, seen=seen)
        ms = (time.perf_counter() - t0) * 1e3
        assert ids.shape == (len(users), cfg.train.eval_topk)
        for row, s in zip(ids, seen):
            if ds.num_items - len(set(s)) >= cfg.train.eval_topk:
                assert not set(row.tolist()) & set(s)
            assert ((row >= 0) & (row < ds.num_items)).all()
        log(f"(c) served {len(users)} users from the checkpoint in "
            f"{ms:.3f} ms (first call)")
        del rec
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def free():
    """Drop the last phase's model, tables and optimizer state from the
    card before the next phase builds its own."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory still allocated after the phase: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from arec_torch.kernels import _build, lstm_scan as tk
        from arec_torch.kernels import gru_scan as tg
        from arec_torch.kernels import row_scatter as trs
        from arec_torch.kernels import sampled_softmax as tks
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    reports = _build.build([tk.KERNEL, tk.KERNEL_BWD, tks.KERNEL,
                            tg.KERNEL, tg.KERNEL_BWD, trs.KERNEL])
    log(f"built {sorted(reports) or 'nothing (already built)'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in reports.items():
        regs = sorted({ln.split("Used")[1].strip() for ln in
                       text.splitlines() if "Used" in ln})
        log(f"{name} ptxas: {regs}")
    hmma = ce_kernel_report(_build, tks)
    fwd_reports = {k: scan_fwd_report(_build, tk, k)
                   for k in (tk.KERNEL, tg.KERNEL)}
    bwd_reports = {k: scan_bwd_report(_build, tk, k)
                   for k in (tk.KERNEL_BWD, tg.KERNEL_BWD)}

    errs, times = kernel_phase(dev)
    lstm_errs, lstm_times = lstm_train_phase(dev)
    ce_errs, ce_times = ce_phase(dev)
    gru_errs, gru_times = gru_kernel_phase(dev)
    scatter_times, scatter_plans = row_scatter_phase(dev)
    free()
    served, trained = {}, {}
    for cell in ("lstm", "gru"):
        served[cell] = slice_phase(dev, cell)
        free()
        trained[cell] = train_phase(dev, cell)
        free()
    mf_serve_phase(dev)
    free()
    trained["mf"], writeback, bare_eps = mf_train_phase(dev)
    free()
    through_dispatch, dispatch_replayed, dispatch_numbers = dispatch_phase(
        dev)
    log("dispatch numbers " + json.dumps(dispatch_numbers))
    free()
    (through_trainer, through_mesh, mesh_per_rank,
     trainer_replayed) = trainer_phase(dev)
    log(f"MF examples/s: bare sparse steps {bare_eps:.1f} (the MF phase) "
        f"beside the Trainer's loop in the metrics records above")
    free()
    mesh_nccl_phase(dev)
    free()
    through_mesh_train, mesh_train_per_rank = mesh_train_phase(dev)
    free()
    input_path_phase(dev)
    free()
    through_approx = approx_topk_phase(dev)
    free()
    through_raw = raw_data_phase(dev)
    free()

    def row(name, source, replaces, fn, launches, err, t, shape, library):
        # c4 computes in bfloat16: the row's numbers are bf16, the f32
        # (parity) ones sit beside them
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        b = t["bfloat16"]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "replaces_fn": fn,
                "launches": launches, "max_abs_err": err["bfloat16"],
                "max_err_f32": err["float32"],
                "max_err_bf16": err["bfloat16"],
                "ms": b["ms"], "kernel_ms": b["ms"],
                "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "library_ms": b["library_ms"],
                "library": library, "dtype": "bfloat16", "shape": shape,
                "f32": {k: t["float32"][k] for k in keys}}

    def fwd_row(name, source, replaces, fn, cell, err, t, train_err,
                train_t, library, train_library, residuals):
        # bf16: the tensor-core kernel's serving and training launches, their
        # launch resources at H = 128 and its library's HMMA counts; f32:
        # the CUDA-core kernel
        out = row(name, source, replaces, fn,
                  served[cell] + trained[cell][name], err, t,
                  "L=50 B=256 H=128", library)
        info, counts = fwd_reports[name]
        out.update(launches_serving=served[cell],
                   launches_training=trained[cell][name],
                   back_to_back_ms=t["bfloat16"]["back_to_back_ms"],
                   resources=info, hmma={k: n for k, n in counts.items() if n},
                   timing="device time per call, launches queued behind a "
                          "GPU spin (CUDA events); back_to_back_ms: 50 "
                          "launches as the host issues them",
                   training_launch={
                       "shape": f"L=50 B=128 H=128, with {residuals} "
                                f"residuals",
                       "max_err_f32": train_err["float32"],
                       "max_err_bf16": train_err["bfloat16"],
                       "library": train_library,
                       **{dt: {k: train_t[dt][k] for k in
                               ("ms", "back_to_back_ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms")}
                          for dt in DTYPES}})
        out["f32"]["back_to_back_ms"] = t["float32"]["back_to_back_ms"]
        return out

    def ce_row(name, line, fn, kind, library):
        out = row(name, "arec_torch/csrc/sampled_ce.cu",
                  f"arec/kernels/sampled_softmax.py:{line}",
                  f"arec/kernels/sampled_softmax.py:{fn}",
                  sum(trained[c][name] for c in trained),
                  ce_errs["c4"][kind], ce_times["c4"][kind],
                  "N=6400 S=1024 D=128 aug", library)
        out["launches_training"] = {c: trained[c][name] for c in trained}
        out["hmma"] = {k: n for k, n in hmma.items() if kind in k}
        out["timing"] = ("device time per call, launches queued behind a "
                         "GPU spin (CUDA events); back_to_back_ms: 50 "
                         "launches as the host issues them")
        out["back_to_back_ms"] = ce_times["c4"][kind]["bfloat16"][
            "back_to_back_ms"]
        mf_err, mf_t = ce_errs["mf"][kind], ce_times["mf"][kind]
        out["mf_shape"] = {
            "shape": "N=8192 S=2048 D=128 non-aug",
            "max_err_f32": mf_err["float32"],
            "max_err_bf16": mf_err["bfloat16"],
            **{dt: {k: mf_t[dt][k] for k in
                    ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "back_to_back_ms")}
               for dt in DTYPES}}
        return out

    def scatter_row():
        t = scatter_times["item"]
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "back_to_back_ms", "n", "n_valid", "width")
        return {"name": trs.KERNEL, "route": "cuda",
                "source": "arec_torch/csrc/row_scatter.cu",
                "replaces": "tools/ab_row_update.py:50",
                "replaces_fn": "tools/ab_row_update.py:_scatter_rows_pallas",
                "launches": trained["mf"][trs.KERNEL], "max_abs_err": 0.0,
                "max_err_f32": 0.0, "ms": t["ms"], "kernel_ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "library": "Tensor.index_copy_ of the valid prefix",
                "timing": "device time per call, launches queued behind "
                          "a GPU spin, 4 write-backs cycled (CUDA events); "
                          "back_to_back_ms: 50 launches as the host "
                          "issues them",
                "back_to_back_ms": t["back_to_back_ms"], "dtype": "float32",
                "shape": f"table [{MF_SHAPES['item'][0]}, "
                         f"{MF_SHAPES['item'][1]}], {t['n']} ids",
                "user_table": {k: scatter_times["user"][k] for k in keys},
                "launch_plan": scatter_plans,
                "main_path_writeback": {
                    tab: {k: w[k] for k in keys}
                    for tab, w in writeback.items()}}

    def bwd_row(kernel, line, fn, cell, errs_, times_, library):
        # the bf16 backward's three tensor-core stages: their device times,
        # launch resources at H = 128 and HMMA counts, and its time back
        # to back beside the queued one in `ms`
        base = kernel.split("_")[0]
        out = row(kernel, f"arec_torch/csrc/{kernel}.cu",
                  f"arec/kernels/{base}_scan.py:{line}",
                  f"arec/kernels/{base}_scan.py:{fn}",
                  trained[cell][kernel], errs_["bwd"], times_["bwd"],
                  "L=50 B=128 H=128", library)
        info, counts = bwd_reports[kernel]
        out.update(
            stages_ms=times_["bwd_stages_ms"], stage_resources=info,
            hmma={k: n for k, n in counts.items() if n},
            back_to_back_ms=times_["bwd"]["bfloat16"]["back_to_back_ms"],
            timing="device time per call, launches queued behind a GPU "
                   "spin (CUDA events); back_to_back_ms: 50 launches as "
                   "the host issues them; stages_ms: profiler device time "
                   "per call by kernel")
        out["f32"]["back_to_back_ms"] = times_["bwd"]["float32"][
            "back_to_back_ms"]
        return out

    kernels = [
        fwd_row(tk.KERNEL, "arec_torch/csrc/lstm_scan_fwd.cu",
                "arec/kernels/lstm_scan.py:89",
                "arec/kernels/lstm_scan.py:_fwd_kernel", "lstm", errs, times,
                lstm_errs["fwd"], lstm_times["fwd"],
                "torch.nn.LSTM (cuDNN), all-ones mask, bf16, weights "
                "compacted per call",
                "torch.nn.LSTM (cuDNN) training forward, all-ones mask",
                "hp/cp"),
        bwd_row(tk.KERNEL_BWD, 182, "_bwd_kernel", "lstm", lstm_errs,
                lstm_times, "torch.nn.LSTM (cuDNN) forward+backward less its "
                "forward, all-ones mask"),
        ce_row("sampled_ce_fwd", 146, "_sums_fwd_kernel", "fwd",
               "torch.matmul + F.cross_entropy over materialised [N, 1+S] "
               "logits, forward"),
        ce_row("sampled_ce_bwd", 189, "_sums_bwd_kernel", "bwd",
               "torch.matmul + F.cross_entropy over materialised [N, 1+S] "
               "logits, forward+backward less its forward"),
        fwd_row(tg.KERNEL, "arec_torch/csrc/gru_scan_fwd.cu",
                "arec/kernels/gru_scan.py:38",
                "arec/kernels/gru_scan.py:_fwd_kernel", "gru",
                gru_errs["fwd"], gru_times["fwd"], gru_errs["train_fwd"],
                gru_times["train_fwd"], GRU_LIBRARY + ", serving forward",
                GRU_LIBRARY + ", training forward", "hp"),
        bwd_row(tg.KERNEL_BWD, 117, "_bwd_kernel", "gru", gru_errs,
                gru_times, GRU_LIBRARY + ", forward+backward less its "
                "forward"),
        scatter_row(),
    ]
    for k in kernels:
        # the Trainer phase's runs and the raw-data configurations' runs:
        # the main path as users run it; the approximate serving batches
        k["launches_trainer"] = through_trainer[k["name"]]
        # the device launches of the Trainer's replay of steps 8..15 (its
        # AREC_PROFILE_DIR trace), which run no wrapper
        k["launches_trainer_replayed"] = trainer_replayed[k["name"]]
        k["launches_raw_data"] = through_raw[k["name"]]
        k["launches_approx_serving"] = through_approx.get(k["name"], 0)
        # the mesh runs (gloo ranks sharing the card), summed over ranks
        k["launches_mesh"] = sum(m[k["name"]] for m in through_mesh.values())
        k["launches_mesh_per_rank"] = {
            run: per.get(k["name"], []) for run, per in mesh_per_rank.items()}
        # the mesh training runs (gloo ranks sharing the card, and the
        # one-rank NCCL group), summed over ranks and runs
        k["launches_mesh_train"] = through_mesh_train[k["name"]]
        k["launches_mesh_train_per_rank"] = {
            run: per.get(k["name"], [])
            for run, per in mesh_train_per_rank.items()}
        # the K-step dispatch phase (c4's dense and MF's sparse step, each
        # 32 steps: 8 eager warm-up steps, and 24 in CUDA graph replays,
        # which run no wrapper): the wrappers' counts (the warm-up's
        # launches and the capture's, which records 8 steps' launches into
        # the graph), and the replays' device launches, counted by kernel
        # symbol in their profiler trace
        k["launches_dispatch"] = through_dispatch.get(k["name"], 0)
        k["launches_dispatch_replayed"] = dispatch_replayed.get(k["name"], 0)
        k["launches"] += (k["launches_trainer"] + k["launches_raw_data"]
                          + k["launches_approx_serving"]
                          + k["launches_mesh"] + k["launches_mesh_train"]
                          + k["launches_dispatch"])
    assert all(k["launches"] > 0 for k in kernels), [
        (k["name"], k["launches"]) for k in kernels]
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
