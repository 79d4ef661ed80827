"""The port's ML-1M and XING prep against arec's on hand-written raw files
in the published layouts (the fixtures are copies of tests/test_prep.py's):
every array and schema equal under each prep option (min_timestamp,
item_vocab_size truncation, user_sample, vocab_min_thresh), the dedupe
that keeps the first occurrence, the fingerprint and cache file name, a
cache written by either package loading in the other, and a missing raw
file raising FileNotFoundError."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from arec.config import DataConfig as JDataConfig
from arec.data import io as jio
from arec.data.movielens import prepare_ml1m as j_ml1m
from arec.data.xing import prepare_xing as j_xing
from arec_torch.config import DataConfig as TDataConfig
from arec_torch.data import io as tio
from arec_torch.data.movielens import prepare_ml1m as t_ml1m
from arec_torch.data.xing import prepare_xing as t_xing

torch.set_num_threads(1)


@pytest.fixture
def ml1m_raw(tmp_path):
    d = tmp_path / "ml-1m"
    d.mkdir()
    rng = np.random.default_rng(0)
    users, movies = 30, 20
    (d / "users.dat").write_text("\n".join(
        f"{u}::{'M' if u % 2 else 'F'}::{[1,18,25,35,45,50,56][u % 7]}::{u % 21}::9{u:04d}"
        for u in range(1, users + 1)))
    genres = ["Action", "Comedy", "Drama", "Thriller"]
    (d / "movies.dat").write_text("\n".join(
        f"{m}::Movie {m} ({1980 + m % 40})::" +
        "|".join(sorted({genres[m % 4], genres[(m * 7) % 4]}))
        for m in range(1, movies + 1)))
    rows = []
    t = 0
    for u in range(1, users + 1):
        seen = rng.choice(np.arange(1, movies + 1), size=rng.integers(3, 10),
                          replace=False)
        for m in seen:
            rows.append(f"{u}::{m}::{rng.integers(1, 6)}::{978300000 + t}")
            t += 1
    (d / "ratings.dat").write_text("\n".join(rows))
    return str(d)


@pytest.fixture
def xing_raw(tmp_path):
    d = tmp_path / "xing"
    d.mkdir()
    rng = np.random.default_rng(1)
    users, items = 25, 15
    (d / "users.csv").write_text("\n".join(
        ["user_id\tjobroles\tcareer_level\tdiscipline_id\tindustry_id\tcountry\tregion\texperience_years\tedu_degree"] +
        [f"{u}\t{','.join(str(x) for x in rng.integers(0, 30, rng.integers(0, 5)))}\t"
         f"{u % 6}\t{u % 10}\t{u % 12}\tde\t{u % 16}\t{u % 7}\t{u % 4}"
         for u in range(100, 100 + users)]))
    (d / "items.csv").write_text("\n".join(
        ["item_id\ttitle\tcareer_level\tdiscipline_id\tindustry_id\tcountry\tregion\temployment\ttags\tis_payed"] +
        [f"{i}\t{','.join(str(x) for x in rng.integers(0, 40, rng.integers(1, 6)))}\t"
         f"{i % 6}\t{i % 10}\t{i % 12}\tde\t{i % 16}\t{i % 3}\t"
         f"{','.join(str(x) for x in rng.integers(0, 40, rng.integers(0, 4)))}\t{i % 2}"
         for i in range(500, 500 + items)]))
    rows = ["user_id\titem_id\tinteraction_type\tcreated_at"]
    t = 0
    for u in range(100, 100 + users):
        for i in rng.choice(np.arange(500, 500 + items),
                            size=rng.integers(3, 8), replace=False):
            # mix of impressions (0, dropped), positives (1-3), deletes (4)
            rows.append(f"{u}\t{i}\t{rng.integers(0, 5)}\t{1484000000 + t}")
            t += 1
    (d / "interactions.csv").write_text("\n".join(rows))
    return str(d)


def _assert_same(got, want):
    assert got.name == want.name
    for side in ("user", "item"):
        assert dataclasses.asdict(getattr(got, f"{side}_schema")) == \
            dataclasses.asdict(getattr(want, f"{side}_schema"))
        ga, wa = getattr(got, f"{side}_attrs"), getattr(want, f"{side}_attrs")
        for store in ("values", "lengths"):
            g, w = getattr(ga, store), getattr(wa, store)
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k])
    for k in jio._ARRAYS:
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w)


ML1M_OPTIONS = {
    "default": {},
    "min_timestamp": dict(min_timestamp=978300050),
    "item_vocab_size": dict(item_vocab_size=10),
    "user_sample": dict(user_sample=0.5, syn_seed=4),
    "vocab_min_thresh": dict(vocab_min_thresh=3),
}
XING_OPTIONS = {
    "default": {},
    "min_thresh_1": dict(vocab_min_thresh=1),
    "min_timestamp": dict(min_timestamp=1484000060, vocab_min_thresh=1),
    "item_vocab_size": dict(item_vocab_size=6),
    "user_sample": dict(user_sample=0.6, syn_seed=2),
}


@pytest.mark.parametrize("opts", list(ML1M_OPTIONS))
def test_ml1m_prep_equals_arec(ml1m_raw, opts):
    kw = dict(dataset="ml1m", raw_dir=ml1m_raw, **ML1M_OPTIONS[opts])
    got, want = t_ml1m(TDataConfig(**kw)), j_ml1m(JDataConfig(**kw))
    _assert_same(got, want)
    if opts == "item_vocab_size":
        assert got.num_items == 10 and got.train_items.max() < 10
    if opts == "user_sample":
        assert 0 < got.num_users < 30


@pytest.mark.parametrize("opts", list(XING_OPTIONS))
def test_xing_prep_equals_arec(xing_raw, opts):
    kw = dict(dataset="xing", raw_dir=xing_raw, **XING_OPTIONS[opts])
    got, want = t_xing(TDataConfig(**kw)), j_xing(JDataConfig(**kw))
    _assert_same(got, want)
    if opts == "item_vocab_size":
        assert got.num_items == 6


def test_xing_dedupe_keeps_the_first_occurrence(tmp_path, xing_raw):
    """Repeat (user, item) pairs later in time, with other positive types
    and out of order in the file: both packages keep one interaction per
    pair, the earliest."""
    path = os.path.join(xing_raw, "interactions.csv")
    lines = open(path).read().split("\n")
    header, rows = lines[0], lines[1:]
    pos = [r.split("\t") for r in rows if r.split("\t")[2] in "123"]
    extra = [f"{u}\t{i}\t{(int(k) % 3) + 1}\t{int(t) + 10_000 + n}"
             for n, (u, i, k, t) in enumerate(pos[::2])]
    with open(path, "w") as f:
        f.write("\n".join([header] + extra + rows))
    kw = dict(dataset="xing", raw_dir=xing_raw, vocab_min_thresh=1)
    got, want = t_xing(TDataConfig(**kw)), j_xing(JDataConfig(**kw))
    _assert_same(got, want)
    n = len(got.train_users) + len(got.valid_users)
    assert n == len({(r[0], r[1]) for r in pos})
    pairs = set(zip(got.train_users.tolist(), got.train_items.tolist()))
    assert len(pairs) == len(got.train_users)


@pytest.mark.parametrize("dataset", ["ml1m", "xing"])
@pytest.mark.parametrize("writer", ["arec", "arec_torch"])
def test_prepared_cache_is_shared(ml1m_raw, xing_raw, tmp_path, dataset,
                                  writer):
    raw = ml1m_raw if dataset == "ml1m" else xing_raw
    kw = dict(dataset=dataset, raw_dir=raw, data_dir=str(tmp_path / "c"))
    jcfg, tcfg = JDataConfig(**kw), TDataConfig(**kw)
    assert tio.fingerprint(tcfg) == jio.fingerprint(jcfg)
    first, second = (jio, tio) if writer == "arec" else (tio, jio)
    made = first.load_or_prepare(jcfg if first is jio else tcfg)
    files = sorted(os.listdir(tmp_path / "c"))
    assert files == [f"{dataset}-{tio.fingerprint(tcfg)}.npz"]
    loaded = second.load_or_prepare(tcfg if second is tio else jcfg)
    assert sorted(os.listdir(tmp_path / "c")) == files   # no re-prep
    _assert_same(loaded, made)


@pytest.mark.parametrize("dataset,prepare", [("ml1m", t_ml1m),
                                             ("xing", t_xing)])
def test_missing_raw_file_raises(tmp_path, dataset, prepare):
    cfg = TDataConfig(dataset=dataset, raw_dir=str(tmp_path / "none"),
                      data_dir=str(tmp_path / "c"))
    with pytest.raises(FileNotFoundError, match="raw file"):
        prepare(cfg)
    with pytest.raises(FileNotFoundError, match="raw file"):
        tio.load_or_prepare(cfg)
