#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (arec_torch) on one CUDA card and check it.

    python3 chip_smoke.py        # from the root of a checkout; one card

1. Prints the card (name, power limit) and builds every kernel of the
   serving path from the sources in arec_torch/csrc/ (one nvcc each, all
   started together).
2. Holds each kernel against its plain PyTorch version on the card at the
   serving shapes, and times kernel, plain version and the library call
   that computes the same function.
3. Serves the c4 sequence model (configs/c4_lstm_attr_xing.json: LSTM,
   H = 128, L = 50, attribute fusion) at the XING-cardinality synthetic
   twin's item vocabulary (1.3M items, deg-12 tags over 4096) with seeded
   random weights, through `Recommender.from_histories` and the request
   loop, counting kernel launches on that run, and checks the answers and
   the query states against the plain scan.
4. Prints one `{"kernels": [...]}` JSON line and, last, the
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


def layer_inputs(L, B, H, dev, seed=0):
    """xw, wh, left-padded mask (varied lengths, a few all-pad rows),
    nonzero h0, c0 — as the serving scan hands them to one layer."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, B)
    lengths[:4] = 0
    mask = np.arange(L)[None, :] >= (L - lengths)[:, None]
    arrays = (rng.standard_normal((L, B, 4 * H)),
              rng.standard_normal((H, 4 * H)) / math.sqrt(2 * H),
              mask,
              rng.standard_normal((B, H)) * 0.5,
              rng.standard_normal((B, H)) * 0.5)
    return [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
            for a in arrays]


def bound(L, B, H, valid, dtype):
    """(bound_ms, bound_by, bytes, flops): each input read once and each
    output written once, against 2·4H·H FLOPs for each valid (row, step)."""
    welt = 2 if dtype == "bfloat16" else 4
    nbytes = 4 * (L * B * 4 * H + B * L + 2 * B * H + L * B * H + B * H) \
        + welt * 4 * H * H
    flops = 2 * 4 * H * H * valid
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def kernel_phase(dev):
    """lstm_scan_fwd vs lstm_layer_plain at the serving shapes, and times."""
    import torch
    from arec_torch.kernels import lstm_scan as tk

    L, H = 50, 128
    errs = {}
    for B in (256, 200):
        xw, wh, mask, h0, c0 = layer_inputs(L, B, H, dev, seed=B)
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            got = tk.lstm_layer(xw, wh, mask, h0, c0, dt)
            torch.cuda.synchronize()
            want = tk.lstm_layer_plain(xw, wh, mask, h0, c0, dt)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, **TOL[name])
            errs[name] = max(errs.get(name, 0.0), err)
            log(f"kernel vs plain  B={B} L={L} H={H} {name}: max abs err "
                f"{err:.3e} (tolerance {TOL[name]})")

    B = 256
    xw, wh, mask, h0, c0 = layer_inputs(L, B, H, dev, seed=B)
    valid = int(mask.sum())
    times = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        times[name] = dict(
            ms=cuda_ms(lambda: tk.lstm_layer(xw, wh, mask, h0, c0, dt), 50),
            plain_ms=cuda_ms(
                lambda: tk.lstm_layer_plain(xw, wh, mask, h0, c0, dt), 10))
        bms, by, nbytes, flops = bound(L, B, H, valid, name)
        times[name].update(bound_ms=bms, bound_by=by, bytes=nbytes,
                           flops=flops)

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
        log(f"lstm_scan_fwd B={B} L={L} H={H} {name}: kernel {t['ms']:.4f} ms"
            f", plain {t['plain_ms']:.4f} ms, library (cuDNN nn.LSTM, "
            f"all-ones mask, with input projection) {t['library_ms']:.4f} ms"
            f", bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
            f"{t['bytes']} bytes, {t['flops']} FLOPs)")
    return errs, times


def slice_phase(dev, twin=TWIN, cuts=CUTS):
    """c4 at the XING twin's vocabulary, served through the port's entry
    points; returns the kernel launches of the served run."""
    import numpy as np
    import torch
    from arec_torch.cli.main import load_config, parse_args
    from arec_torch.data.io import load_or_prepare
    from arec_torch.kernels import lstm_scan as tk
    from arec_torch.models.seq import SeqSpec, init_seq
    from arec_torch.serve import Recommender, _item_latents, _query_fn
    from arec_torch.serve import _serve_loop

    sets = {**twin, **{k: v for k, (_, v) in cuts.items()},
            "data.data_dir": DATA_DIR}
    argv = ["--config", C4] + [a for k, v in sets.items()
                               for a in ("--set", f"{k}={v}")]
    cfg = load_config(parse_args(argv))
    log("reduced: " + ", ".join(f"{k} {a} -> {b}"
                                for k, (a, b) in cuts.items())
        + " (no served tensor depends on them)")
    t0 = time.perf_counter()
    ds = load_or_prepare(cfg.data)
    prep_s = time.perf_counter() - t0
    spec = SeqSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    V, L = spec.vocab, spec.max_seq_len
    assert V == twin["data.syn_items"] and spec.dim == 128 and L == 50, (
        V, spec.dim, L)
    assert spec.use_pallas_scan and spec.cell == "lstm"
    params = init_seq(torch.Generator(device=dev).manual_seed(0), spec)
    nparam = sum(t.numel() for t in (
        params["item_in"]["tables"]["__fused__"], params["item_out"]))
    log(f"c4 on the XING twin: V={V} H={spec.dim} L={L} layers="
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

    tk.lstm_layer.launches = 0                       # ---- the main path
    t0 = time.perf_counter()
    ids = rec.from_histories(hists, seen=seen)
    batch_ms = (time.perf_counter() - t0) * 1e3
    batch_launches = tk.lstm_layer.launches
    lines = [",".join(map(str, rng.integers(0, V, n).tolist()))
             for n in (3, 40, 17)]
    out = io.StringIO()
    _serve_loop(rec, io.StringIO("\n".join(lines) + "\n!quit\n"), out)
    launches = tk.lstm_layer.launches                # ---- read just after

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
        f"lstm_scan_fwd launches {launches}")

    # where one served batch's time goes: device time by kernel name
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec.from_histories(hists, seen=seen)
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0}     # kernels, not aten ops
    busy_ms = sum(dev_us.values()) / 1e3
    log(f"profile of one served batch: device busy {busy_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall (idle share {1 - busy_ms / wall_ms:.3f})")
    for key, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {us / 1e3:9.3f} ms  {key[:100]}")
    return launches


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
    reports = _build.build([tk.KERNEL])
    log(f"built {sorted(reports) or 'nothing (already built)'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in reports.items():
        regs = sorted({ln.split("Used")[1].strip() for ln in
                       text.splitlines() if "Used" in ln})
        log(f"{name} ptxas: {regs}")

    errs, times = kernel_phase(dev)
    launches = slice_phase(dev)

    t = times["bfloat16"]          # c4 serves with compute_dtype=bfloat16
    kernels = [{
        "name": tk.KERNEL, "route": "cuda",
        "source": "arec_torch/csrc/lstm_scan_fwd.cu",
        "replaces": "arec/kernels/lstm_scan.py:89",
        "replaces_fn": "arec/kernels/lstm_scan.py:_fwd_kernel",
        "launches": launches,
        "max_abs_err": errs["bfloat16"],
        "max_err_f32": errs["float32"], "max_err_bf16": errs["bfloat16"],
        "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "library": "torch.nn.LSTM (cuDNN), all-ones mask, bf16, weights "
                   "compacted per call",
        "dtype": "bfloat16", "shape": "L=50 B=256 H=128",
        "f32": {k: times["float32"][k] for k in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }]
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
