"""The port's approximate top-k (`recall_target < 1`) against arec's:

- `approx_reduction_size` equals jaxlib's own reduction-size rule
  (`approx_top_k_reduction_output_size`) over a grid of V, K and targets;
- `approx_max_k` bins element i into bin i mod R (held against a padded
  numpy version), reaches recall ≥ 0.94 at a 0.95 target on Gaussian
  scores, and is not the exact top-k there;
- with the selection made exact (arec's CPU lowering of `approx_max_k` is
  exact), the port's approximate pipeline in `blocked_topk_mips` (top-(k+S)
  candidates, seen ids masked by a sorted search, −inf / −1 sentinels)
  equals arec's: ids up to ties, values to rtol 1e-6;
- the Trainer evaluates with eval_recall_target < 1, and `recommend()` and
  a Recommender serve with serve_recall_target < 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.lib import _jax

from arec.retrieval.mips import blocked_topk_mips as j_blocked
from arec_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from arec_torch.retrieval import mips
from arec_torch.train.loop import Trainer
from torch_topk_check import ref_scores

torch.set_num_threads(1)

GRID_V = (100, 128, 1000, 3706, 50000, 300000, 1304126)
GRID_K = (1, 2, 30, 60, 80, 130)
GRID_R = (0.8, 0.9, 0.95, 0.99)


@pytest.mark.parametrize("v", GRID_V)
def test_reduction_size_equals_xla_rule(v):
    for k in GRID_K:
        for r in GRID_R + (1.0,):
            want = tuple(_jax.approx_top_k_reduction_output_size(
                v, 2, k, r, False, -1))
            assert mips.approx_reduction_size(v, k, r) == want, (v, k, r)


def _binned_reference(scores, k, r, l):
    """Pad to R·2^l with −inf, view [2^l, R], max per bin, exact top-k."""
    b, v = scores.shape
    padded = np.full((b, r << l), -np.inf, scores.dtype)
    padded[:, :v] = scores
    view = padded.reshape(b, 1 << l, r)
    bins_v, bins_j = view.max(axis=1), view.argmax(axis=1)
    order = np.argsort(-bins_v, axis=1, kind="stable")[:, :k]
    ids = np.take_along_axis(bins_j, order, 1) * r + order
    return np.take_along_axis(bins_v, order, 1), ids


@pytest.mark.parametrize("v,k,target", [
    (1000, 1, 0.95),      # k = 1: one tile of 128, ragged last row
    (3706, 60, 0.95),     # l = 1, R·2^l > V
    (50000, 30, 0.9),     # l = 6
    (4096, 2, 0.99),      # V a multiple of R·2^l
])
def test_approx_max_k_bins_element_i_into_bin_i_mod_r(v, k, target):
    r, l = mips.approx_reduction_size(v, k, target)
    assert l > 0
    scores = np.random.default_rng(v).standard_normal((5, v)).astype(
        np.float32)
    got_v, got_i = mips.approx_max_k(torch.from_numpy(scores), k, target)
    want_v, want_i = _binned_reference(scores, k, r, l)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(
        np.take_along_axis(scores, got_i.numpy(), 1), got_v.numpy())


def test_approx_max_k_without_reduction_is_exact():
    scores = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 1000)).astype(np.float32))
    assert mips.approx_reduction_size(1000, 30, 0.95)[1] == 0
    got = mips.approx_max_k(scores, 30, 0.95)
    want = torch.topk(scores, 30, dim=1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_approx_max_k_recall_on_gaussian_scores():
    scores = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (64, 300000)).astype(np.float32))
    _, got = mips.approx_max_k(scores, 60, 0.95)
    _, want = torch.topk(scores, 60, dim=1)
    hits = [len(set(g.tolist()) & set(w.tolist()))
            for g, w in zip(got, want)]
    assert np.mean(hits) / 60 >= 0.94, np.mean(hits) / 60
    assert min(hits) < 60          # really approximate: some row differs


def _inputs(b, v, d, seen_width, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    lat = rng.standard_normal((v, d)).astype(np.float32)
    bias = (rng.standard_normal(v) * 0.1).astype(np.float32)
    seen = np.full((b, seen_width), -1, np.int32)
    for r in range(b):
        n = rng.integers(0, seen_width + 1)
        seen[r, :n] = rng.integers(0, v, n)
    if seen_width >= 2:
        seen[0, :2] = [3, 3]              # a duplicated seen id
    if seen_width:
        seen[1] = rng.permutation(v)[:seen_width]    # a full row
    return q, lat, bias, seen


CASES = {
    "plain": dict(b=12, v=300, d=16, seen_width=8, k=30),
    "width0_seen": dict(b=12, v=300, d=16, seen_width=0, k=30),
    "k_over_unseen": dict(b=12, v=40, d=16, seen_width=30, k=35),
    "large_v": dict(b=9, v=5000, d=8, seen_width=20, k=30),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("qblock", [0, 5])
def test_pipeline_with_exact_selection_equals_arec(monkeypatch, name,
                                                   qblock):
    """qblock 5 does not divide B: a ragged last block."""
    c = CASES[name]
    monkeypatch.setattr(mips, "approx_max_k",
                        lambda s, k, r: torch.topk(s, k, dim=1))
    q, lat, bias, seen = _inputs(c["b"], c["v"], c["d"], c["seen_width"])
    want_v, want_i = map(np.asarray, j_blocked(
        jnp.asarray(q), jnp.asarray(lat), jnp.asarray(bias),
        jnp.asarray(seen), k=c["k"], qblock=qblock, recall_target=0.95))
    got_v, got_i = (t.numpy() for t in mips.blocked_topk_mips(
        *map(torch.from_numpy, (q, lat, bias, seen)), k=c["k"],
        qblock=qblock, recall_target=0.95))
    np.testing.assert_allclose(got_v, want_v, rtol=1e-6, atol=0)
    scores = ref_scores(q, lat, bias, np.full((c["b"], 0), -1, np.int32))
    masked = ~np.isfinite(want_v)
    np.testing.assert_array_equal(got_i[masked], -1)
    np.testing.assert_array_equal(want_i[masked], -1)
    for r in range(c["b"]):
        mine = got_i[r][~masked[r]]
        assert len(set(mine.tolist())) == len(mine)
        assert not set(mine.tolist()) & set(seen[r].tolist())
        np.testing.assert_allclose(scores[r, mine], want_v[r][~masked[r]],
                                   rtol=1e-6, atol=0)
    if name == "k_over_unseen":
        assert masked.any()


def _tiny(tmp_path, model, **train):
    extra = dict(max_seq_len=6) if model == "lstm" else {}
    return Config(
        data=DataConfig(dataset="synthetic", data_dir=str(tmp_path / "d"),
                        syn_users=120, syn_items=400,
                        syn_interactions=3000),
        model=ModelConfig(model=model, dim=8, **extra),
        train=TrainConfig(batch_size=32, num_sampled=16, n_epoch=1,
                          max_steps=3, steps_per_checkpoint=3,
                          eval_batch_size=32, compute_dtype="float32",
                          train_dir=str(tmp_path / "t"), **train))


@pytest.mark.parametrize("model", ["mf", "lstm"])
def test_trainer_evaluates_and_serves_approximately(tmp_path, model,
                                                    monkeypatch, capsys):
    """Periodic and final eval take the approximate path; evaluate(exact=
    True) the exact one; recommend() and a Recommender serve through it,
    and no list holds a seen id."""
    from arec_torch.serve import Recommender
    targets = []
    real = mips.blocked_topk_mips

    def spy(*a, recall_target=1.0, **kw):
        targets.append(recall_target)
        return real(*a, recall_target=recall_target, **kw)
    monkeypatch.setattr(mips, "blocked_topk_mips", spy)
    cfg = _tiny(tmp_path, model, eval_recall_target=0.95,
                serve_recall_target=0.9)
    tr = Trainer(cfg, device="cpu")
    summary = tr.train()
    assert 0.0 <= summary["recall_at_k"] <= 1.0
    assert targets and set(targets) == {0.95}
    assert "final recall_at_k is APPROXIMATE" in capsys.readouterr().out
    targets.clear()
    assert 0.0 <= tr.evaluate(exact=True) <= 1.0
    assert 0.95 not in targets
    targets.clear()
    rows = tr.recommend()
    assert rows and set(targets) == {0.9}
    for u, ids in rows:
        seen = set(tr.ds.seen_items[u][tr.ds.seen_items[u] >= 0].tolist())
        assert len(ids) == 30 and not seen & set(ids)
    tr.close()
    rec = Recommender(cfg, device="cpu")
    if model == "mf":
        users = np.array([u for u, _ in rows[:4]], np.int32)
        got = rec.for_users(users)
    else:
        got = rec.from_histories([[1, 2, 3], [5]])
    assert got.shape[1] == 30 and (got >= 0).all()


def test_approximate_pipeline_never_returns_a_seen_id():
    q, lat, bias, seen = _inputs(16, 5000, 8, 40, seed=3)
    assert mips.approx_reduction_size(5000, 30 + 40, 0.9)[1] > 0
    vals, ids = mips.blocked_topk_mips(
        *map(torch.from_numpy, (q, lat, bias, seen)), k=30, qblock=6,
        recall_target=0.9)
    scores = ref_scores(q, lat, bias, np.full((16, 0), -1, np.int32))
    ids, vals = ids.numpy(), vals.numpy()
    for r in range(16):
        assert (ids[r] >= 0).all() and len(set(ids[r].tolist())) == 30
        assert not set(ids[r].tolist()) & set(seen[r].tolist())
        np.testing.assert_allclose(scores[r, ids[r]], vals[r], rtol=1e-6)
        assert (np.diff(vals[r]) <= 0).all()
