"""What a run reads by name: the cell in `BENCHMARK.json`, its
configuration file, its traffic mix, the driver for the mix's kind, the
limits its check holds to, and one reader per per-layer metric. A later
cell, mix or metric is a file of its own, found here with no edit."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field

from harness.trace import Trace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")
BANNED = ("jax", "jaxlib", "flax", "arec")
TRACE_WINDOW_S = 10


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return _json(REPO, "BENCHMARK.json")


@dataclass
class Cell:
    """One workload with everything found for it by name."""
    name: str
    entry: dict
    config: dict          # the configuration file
    traffic: dict         # the traffic mix
    limits: dict          # {number compared: limit}
    chips: int

    @staticmethod
    def find(name: str, bench: dict | None = None) -> "Cell":
        bench = bench or benchmark()
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        conf = next(c for c in bench["configs"]
                    if c["name"] == entry["config"])
        return Cell(name, entry, _json(REPO, conf["file"]),
                    _json(HERE, "traffic", entry["traffic"] + ".json"),
                    _json(HERE, "limits", name + ".json"), entry["chips"])

    def driver(self):
        kind = self.traffic["kind"]
        return _module(os.path.join(HERE, "drivers", kind + ".py"),
                       f"bench_driver_{kind}")


def metrics_of(cell: str, bench: dict, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: with trace the per-layer ones
    that list it under `workloads`, else the end-to-end ones that list it
    (or list no cells)."""
    if trace:
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def reader(metric: str):
    """metrics/<name>.py's `read(run) -> float | None`."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    return _module(path, "bench_metric_" + metric.replace(".", "_")).read


@dataclass
class Run:
    """What the driver measured, for the result line and the readers."""
    cell: Cell
    seed: int
    seconds: int
    trace: bool
    t_process: float
    values: dict = field(default_factory=dict)    # end-to-end
    spans: dict = field(default_factory=dict)     # host seconds by name
    counts: dict = field(default_factory=dict)
    checks: dict = field(default_factory=dict)    # name: (value, limit)
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    recorded: Trace = field(default_factory=Trace)
    memory_peak: int = 0
    device: object = None

    @property
    def window_seconds(self) -> float:
        """The measured window: --seconds, or in a traced run at most
        TRACE_WINDOW_S (its per-layer metrics are rates and shares of a
        steady window; a longer trace only takes longer to read)."""
        return min(self.seconds, TRACE_WINDOW_S) if self.trace else (
            self.seconds)

    def span(self, name: str, seconds: float) -> None:
        self.spans[name] = self.spans.get(name, 0.0) + seconds

    def check(self, name: str, value: float) -> None:
        self.checks[name] = (value, self.cell.limits[name])

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for v, lim in
                                         self.checks.values())


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))
