"""`python -m arec_torch.cli.main` on small configs: training prints the
summary, --recommend writes arec's submission TSV, --validate-prep prints
the same summary (and digest) as arec's for the same dataset; the port's
xing_score copy scores as arec's."""

import json
import os

import pytest
import torch

from arec.cli.main import load_config as jload_config
from arec.cli.main import parse_args as jparse_args
from arec.data.io import load_or_prepare as jload_or_prepare
from arec.data.validate import prep_summary as jprep_summary
from arec.data.validate import summary_digest as jsummary_digest
from arec.train import xing_score as jxs
from arec_torch.cli.main import main
from arec_torch.train import xing_score as txs

torch.set_num_threads(1)

SYN_MF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "syn_mf.json")


def _argv(tmp_path, *extra):
    sets = {"data.data_dir": tmp_path / "d", "data.syn_users": 200,
            "data.syn_items": 150, "data.syn_interactions": 4000,
            "model.dim": 8, "train.batch_size": 32, "train.num_sampled": 16,
            "train.n_epoch": 1, "train.max_steps": 24,
            "train.steps_per_checkpoint": 8, "train.sparse_update": "true",
            "train.compute_dtype": "float32",
            "train.train_dir": tmp_path / "t"}
    return ["--config", SYN_MF] + [
        a for k, v in sets.items() for a in ("--set", f"{k}={v}")] + list(
            extra)


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_train_then_recommend(tmp_path, capsys):
    assert main(_argv(tmp_path), device="cpu") == 0
    summary = _last_json(capsys.readouterr().out)
    assert summary["steps"] == 24
    assert 0.0 <= summary["recall_at_k"] <= summary["best_recall_at_k"] <= 1
    with open(tmp_path / "t" / "metrics.jsonl") as f:
        assert [json.loads(x)["step"] for x in f] == [8, 16, 24, 24]

    out = tmp_path / "top.tsv"
    assert main(_argv(tmp_path, "--recommend", "--out", str(out)),
                device="cpu") == 0
    printed = capsys.readouterr().out
    assert "[ckpt] restored step 24" in printed
    result = _last_json(printed)
    assert result["recall@30"] == pytest.approx(summary["recall_at_k"])
    rows = txs.read_submission(str(out))
    assert len(rows) == result["users"] > 0
    assert all(len(ids) == 30 and len(set(ids)) == 30
               for ids in rows.values())
    assert rows == jxs.read_submission(str(out))


def test_entry_point_refuses_cpu_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_argv(tmp_path))


def test_validate_prep_matches_arec(tmp_path, capsys):
    argv = _argv(tmp_path, "--validate-prep")
    assert main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    jcfg = jload_config(jparse_args(argv))
    want = jprep_summary(jload_or_prepare(jcfg.data))
    digest = got.pop("digest")
    assert got == json.loads(json.dumps(want))
    assert digest == jsummary_digest(want)

    assert main(argv + ["--write-golden"]) == 0
    assert main(argv) == 0
    golden = tmp_path / "d" / "golden_synthetic.json"
    drift = json.loads(golden.read_text())
    drift["num_items"] += 1
    golden.write_text(json.dumps(drift))
    capsys.readouterr()
    assert main(argv) == 1
    assert "DRIFT num_items" in capsys.readouterr().err


def test_xing_score_matches_arec(tmp_path):
    """tests/test_prep.py's hand-computed toy example, through both."""
    recs = {1: [10, 11], 2: [10, 12], 3: [13]}
    inter = [(1, 10, 1), (1, 11, 4), (2, 10, 2), (2, 12, 5), (9, 13, 1)]
    for kw in ({}, {"weights": txs.XingWeights(click=3.0, delete=1.0)}):
        got = txs.leaderboard_score(recs, inter, premium_users={1},
                                    paid_items={10}, **kw)
        jkw = ({"weights": jxs.XingWeights(click=3.0, delete=1.0)}
               if kw else {})
        assert got == jxs.leaderboard_score(recs, inter, premium_users={1},
                                            paid_items={10}, **jkw)
    assert txs.leaderboard_score(recs, inter, premium_users={1},
                                 paid_items={10}) == 2 - 10 + 5 + 20 + 50 + 25
    p = tmp_path / "sub.tsv"
    p.write_text("1\t10,11\n2\t10,12\n\n3\t13\n")
    assert txs.read_submission(str(p)) == jxs.read_submission(str(p)) == recs
