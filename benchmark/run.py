"""One run of one benchmark cell of `arec_torch` on the card:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

It loads, warms up, measures for --seconds, checks what the timed path
produced against the plain reference (`benchmark/reference/`), and prints
one JSON line last on standard output: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), `device`, with --trace 1 `breakdown`, and `checks` (each number
compared with its limit), which also close standard error.

Everything the cell needs is found by its name: BENCHMARK.json's entry,
configs/, traffic/ (whose `kind` names the driver in drivers/), limits/
and one reader per per-layer metric in metrics/.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(HERE, "_cache", sub)
os.environ["USE_FLAX"] = "0"

from harness import bench  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int) -> int:
    print(msg, file=sys.stderr, flush=True)
    return code


def main(argv=None, device: str = "cuda") -> int:
    """Run a cell; `device="cpu"` (the tests) skips the look for a card."""
    args = parse(argv)
    spec = bench.benchmark()
    cell = bench.Cell.find(args.workload, spec)
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            return fail("no CUDA device: the benchmark runs on the card", 3)
        if torch.cuda.device_count() < cell.chips:
            return fail(f"{args.workload} needs {cell.chips} cards, "
                        f"{torch.cuda.device_count()} present", 3)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    run = bench.Run(cell, args.seed % (1 << 63), int(args.seconds),
                    bool(args.trace), T_PROCESS)
    run.device = torch.device(device)
    cell.driver().run(run)

    found = bench.banned_modules()
    if found:
        return fail(f"modules of JAX or the JAX package loaded in the "
                    f"measuring process: {', '.join(found)}", 4)
    metrics = {}
    for m in bench.metrics_of(cell.name, spec, run.trace):
        value = (bench.reader(m["name"])(run) if run.trace
                 else run.values.get(m["name"]))
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(run.memory_peak)}
    line = {"correct": run.correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": dev}
    if run.trace:
        dev["busy_s"] = run.recorded.busy_s()
        dev["window_s"] = run.window_s
        line["breakdown"] = run.recorded.breakdown()
        print(f"trace activities: {run.recorded.kinds}", file=sys.stderr)
    line["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                          "limit": lim}
                      for k, (v, lim) in run.checks.items()}
    spans = {k: round(v, 4) for k, v in run.spans.items()}
    print(f"host spans (s): {spans}, counts: {run.attempted}",
          file=sys.stderr)
    for k, (v, lim) in run.checks.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
