"""CLI helpers of the port: the same flags and the same dotted
section.field overrides as `arec/cli/main.py`, so one command line
configures either package. Training and `--recommend` come with their
slices; this module only parses and loads.
"""

from __future__ import annotations

import argparse

from arec_torch.config import Config


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", help="JSON config file (see configs/)")
    ap.add_argument("--set", action="append", default=[],
                    metavar="SECTION.FIELD=VALUE",
                    help="config override, e.g. train.batch_size=256")
    ap.add_argument("--recommend", action="store_true",
                    help="skip training; restore + emit top-K lists")
    ap.add_argument("--out", default="",
                    help="submission-style output path for --recommend")
    ap.add_argument("--validate-prep", action="store_true",
                    help="prepare (or load cached) dataset, print its "
                         "deterministic summary, and compare against the "
                         "golden contract in <data_dir>/golden_<dataset>"
                         ".json if present (exit 1 on drift)")
    ap.add_argument("--write-golden", action="store_true",
                    help="with --validate-prep: record the current summary "
                         "as the golden contract")
    return ap.parse_args(argv)


def load_config(args) -> Config:
    cfg = Config()
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    overrides = {}
    for item in args.set:
        key, _, value = item.partition("=")
        if not value:
            raise SystemExit(f"--set needs SECTION.FIELD=VALUE, got {item!r}")
        overrides[key] = value
    return cfg.override(overrides) if overrides else cfg
