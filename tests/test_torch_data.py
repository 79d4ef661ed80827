"""arec_torch's copies of the pure-Python host code against arec's: every
checked-in config loads to the same fields, the CLI overrides parse the
same, both synthetic generators give identical datasets, and a prepared
dataset cached by one package loads in the other (same fingerprint, same
npz layout)."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from arec.cli.main import load_config as j_load_config
from arec.cli.main import parse_args as j_parse_args
from arec.config import DataConfig as JDataConfig
from arec.data import io as jio
from arec.data.synthetic import generate as jgenerate
from arec_torch.cli.main import load_config as t_load_config
from arec_torch.cli.main import parse_args as t_parse_args
from arec_torch.config import DataConfig as TDataConfig
from arec_torch.data import io as tio
from arec_torch.data.synthetic import generate as tgenerate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.json")))


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_config_and_overrides_load_identically(path):
    argv = ["--config", path, "--set", "train.batch_size=96",
            "--set", "model.use_pallas_scan=false"]
    want = j_load_config(j_parse_args(argv))
    got = t_load_config(t_parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_json() == want.to_json()


def test_bad_override_fails_the_same():
    with pytest.raises(ValueError, match="unknown config field"):
        t_load_config(t_parse_args(["--set", "model.nope=1"]))
    with pytest.raises(SystemExit):
        t_load_config(t_parse_args(["--set", "model.dim"]))


SYN = {"small": dict(syn_users=80, syn_items=60, syn_interactions=900),
       "big": dict(syn_users=100, syn_items=400, syn_interactions=2000,
                   syn_mulhot_degree=12, syn_tag_vocab=4096)}


def _assert_same(got, want):
    assert got.name == want.name
    for side in ("user", "item"):
        gs, ws = getattr(got, f"{side}_schema"), getattr(want,
                                                         f"{side}_schema")
        assert dataclasses.asdict(gs) == dataclasses.asdict(ws)
        ga, wa = getattr(got, f"{side}_attrs"), getattr(want, f"{side}_attrs")
        for store in ("values", "lengths"):
            g, w = getattr(ga, store), getattr(wa, store)
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    for k in jio._ARRAYS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


@pytest.mark.parametrize("kind", list(SYN))
def test_synthetic_generators_agree(kind):
    _assert_same(tgenerate(TDataConfig(**SYN[kind])),
                 jgenerate(JDataConfig(**SYN[kind])))


@pytest.mark.parametrize("writer", ["arec", "arec_torch"])
def test_prepared_cache_is_shared(tmp_path, writer):
    kw = dict(SYN["small"], data_dir=str(tmp_path))
    jcfg, tcfg = JDataConfig(**kw), TDataConfig(**kw)
    assert tio.fingerprint(tcfg) == jio.fingerprint(jcfg)
    first, second = (jio, tio) if writer == "arec" else (tio, jio)
    made = first.load_or_prepare(jcfg if first is jio else tcfg)
    files = os.listdir(tmp_path)
    loaded = second.load_or_prepare(tcfg if second is tio else jcfg)
    assert os.listdir(tmp_path) == files       # read the cache, no re-prep
    _assert_same(loaded, made)
