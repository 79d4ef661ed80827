"""Command-line entry point (port of `arec/cli/main.py`) for both model
families, with arec's flags and dotted section.field overrides, so one
command line configures either package.

    python -m arec_torch.cli.main --config configs/syn_mf.json
    python -m arec_torch.cli.main --config ... --set train.batch_size=256
    python -m arec_torch.cli.main --config ... --recommend --out top30.tsv
    python -m arec_torch.cli.main --config ... --validate-prep

Training prints the summary JSON; --recommend restores the latest
checkpoint under train.train_dir and writes the top-K lists; the
standing server is `python -m arec_torch.serve`. Both run on `cuda`;
`main(argv, device="cpu")` runs them on the CPU from Python. A config
with a mesh (mesh.data × mesh.model > 1) trains and runs --recommend one
rank per process (`torchrun --nproc-per-node N -m arec_torch.cli.main
...`, each rank on `cuda:{LOCAL_RANK}`; ranks that share a card are
given `main(argv, device=...)`); every rank prints the summary, the
primary writes the metrics, the checkpoints and the file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

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


def validate_prep(cfg: Config, write_golden: bool) -> int:
    """Prep-output contract check (arec_torch/data/validate.py)."""
    from arec_torch.data.io import load_or_prepare
    from arec_torch.data.validate import (
        diff_summaries, prep_summary, summary_digest,
    )

    ds = load_or_prepare(cfg.data)
    ds.validate()
    summary = prep_summary(ds)
    print(json.dumps({"digest": summary_digest(summary), **summary},
                     indent=2, sort_keys=True))
    golden_path = os.path.join(cfg.data.data_dir,
                               f"golden_{cfg.data.dataset}.json")
    if write_golden:
        os.makedirs(cfg.data.data_dir, exist_ok=True)
        with open(golden_path, "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
        print(f"[golden] wrote {golden_path}", file=sys.stderr)
        return 0
    if os.path.exists(golden_path):
        with open(golden_path) as f:
            golden = json.load(f)
        drift = diff_summaries(golden, summary)
        if drift:
            for line in drift:
                print(f"[golden] DRIFT {line}", file=sys.stderr)
            return 1
        print(f"[golden] matches {golden_path}", file=sys.stderr)
    else:
        print(f"[golden] no contract at {golden_path} (use --write-golden)",
              file=sys.stderr)
    return 0


def main(argv=None, device=None) -> int:
    """Train (print the summary JSON), --recommend, or --validate-prep.
    device: None = `cuda` (raises if there is none)."""
    args = parse_args(argv)
    cfg = load_config(args)
    if args.validate_prep:
        return validate_prep(cfg, args.write_golden)
    from arec_torch.train.loop import Trainer

    # on a mesh (one rank per process, `torchrun`) --recommend restores
    # into a serve-only Trainer
    on_mesh = cfg.mesh.data * cfg.mesh.model > 1
    trainer = Trainer(cfg, serve_only=args.recommend and on_mesh,
                      device=device)
    if trainer.serve_only and trainer.latest_step() is None:
        raise FileNotFoundError(
            f"no checkpoint under {cfg.train.train_dir!r} to recommend from")
    try:
        if args.recommend:
            rows = trainer.recommend(out_path=args.out or None)
            recall = trainer.evaluate()
            print(json.dumps({"users": len(rows),
                              f"recall@{cfg.train.eval_topk}": recall}))
            return 0
        print(json.dumps(trainer.train()))
        return 0
    finally:
        trainer.close()


if __name__ == "__main__":
    sys.exit(main())
