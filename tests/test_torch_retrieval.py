"""arec_torch seen-masked top-k vs arec's: the one-device plain path
(`topk_with_mask` on the CPU) against `_topk_full`, the query-blocked
`blocked_topk_mips` and the `topk_with_mask` dispatch, on the same numpy
inputs. Scores are held to rtol 1e-5; ids must be equal wherever the
neighbouring scores differ by more than that (lax.top_k and torch.topk may
order exact or near ties differently; see torch_topk_check)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arec.retrieval.mips import blocked_topk_mips as j_blocked
from arec.train.evalu import _topk_full as j_full
from arec.train.evalu import topk_with_mask as j_topk
from arec_torch.retrieval import mips as tmips
from arec_torch.retrieval.mips import blocked_topk_mips as t_blocked
from arec_torch.train import evalu as tev
from torch_topk_check import assert_topk_equal_up_to_ties, ref_scores

torch.set_num_threads(1)

RTOL = 1e-5
B, D = 12, 16


def _inputs(v, seen_width, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    lat = rng.standard_normal((v, D)).astype(np.float32)
    bias = (rng.standard_normal(v) * 0.1).astype(np.float32)
    seen = np.full((B, seen_width), -1, np.int32)
    for r in range(B):
        n = rng.integers(0, seen_width + 1)
        seen[r, :n] = rng.integers(0, v, n)
    if seen_width >= 2:
        seen[0, :2] = [3, 3]              # a duplicated seen id
    return q, lat, bias, seen


CASES = {
    "plain": dict(v=300, seen_width=8, k=30),
    "width0_seen": dict(v=300, seen_width=0, k=30),
    "k_over_unseen": dict(v=40, seen_width=40, k=35),
    "small_k": dict(v=500, seen_width=5, k=3),
}


def _both(fn_j, fn_t, case, bf16=True, **kw):
    """(port result, arec result, seen, float64 reference scores)."""
    q, lat, bias, seen = _inputs(case["v"], case["seen_width"])
    want = fn_j(jnp.asarray(q), jnp.asarray(lat), jnp.asarray(bias),
                jnp.asarray(seen), k=case["k"], **kw)
    got = fn_t(torch.from_numpy(q), torch.from_numpy(lat),
               torch.from_numpy(bias), torch.from_numpy(seen), k=case["k"],
               **kw)
    return got, want, seen, ref_scores(q, lat, bias, seen, bf16)


def _check(got, want, scores):
    assert_topk_equal_up_to_ties(got[0], got[1], want[0], want[1], scores,
                                 rtol=RTOL)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_topk_full_matches_arec(name, dtype):
    got, want, seen, scores = _both(
        lambda *a, **k: j_full(*a, compute_dtype=getattr(jnp, dtype), **k),
        lambda *a, **k: tev.topk_with_mask(
            *a, compute_dtype=getattr(torch, dtype), **k),
        CASES[name], bf16=dtype == "bfloat16")
    _check(got, want, scores)
    if CASES[name]["k"] <= CASES[name]["v"] - CASES[name]["seen_width"]:
        ids = got[1].numpy()
        for r in range(B):
            assert not set(ids[r]) & set(seen[r][seen[r] >= 0])


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("score_mem_mb,qblock", [(512, 0), (0, 0), (512, 5)])
def test_blocked_topk_matches_arec(name, score_mem_mb, qblock):
    """score_mem_mb=0 forces one query per block; qblock=5 gives a ragged
    last block."""
    got, want, _, scores = _both(j_blocked, t_blocked, CASES[name],
                                 score_mem_mb=score_mem_mb, qblock=qblock)
    _check(got, want, scores)


def test_blocked_equals_full_in_the_port():
    """One block of every query against one query a block."""
    arrays = _inputs(300, 8)
    q, lat, bias, seen = map(torch.from_numpy, arrays)
    full = t_blocked(q, lat, bias, seen, k=30)
    blocked = t_blocked(q, lat, bias, seen, k=30, score_mem_mb=0)
    _check(blocked, full, ref_scores(*arrays))


def test_topk_with_mask_dispatch_matches_arec(monkeypatch):
    """Above BLOCKED_EVAL_MIN_V both sides take the blocked path."""
    import arec.train.evalu as jev
    monkeypatch.setattr(jev, "BLOCKED_EVAL_MIN_V", 100)
    monkeypatch.setattr(tmips, "BLOCKED_EVAL_MIN_V", 100)
    got, want, _, scores = _both(j_topk, tev.topk_with_mask, CASES["plain"],
                                 score_mem_mb=0)
    _check(got, want, scores)


def test_recall_hits_matches_arec():
    from arec.train.evalu import recall_hits as j_recall
    q, lat, bias, seen = _inputs(300, 8)
    _, ids = tev.topk_with_mask(*map(torch.from_numpy, (q, lat, bias, seen)),
                                k=30)
    pos = np.where(np.arange(B) % 2 == 0, ids[:, 4].numpy(), 299)
    valid = np.ones(B, np.float32)
    valid[-1] = 0.0
    want = j_recall(*map(jnp.asarray, (q, lat, bias, seen, pos, valid)), k=30)
    got = tev.recall_hits(*map(torch.from_numpy, (q, lat, bias, seen, pos,
                                                  valid)), k=30)
    assert [float(x) for x in got] == [float(x) for x in want]


@pytest.mark.parametrize("recall_target", [1.0, 0.9])
def test_offset_moves_only_real_ids(recall_target):
    """A shard's ids are its block's plus the block's offset; the −1 of a
    masked candidate (approximate, where fewer than k unseen items
    remain) stays −1."""
    q, lat, bias, seen = map(torch.from_numpy, _inputs(40, 40))
    seen[1] = torch.arange(40)          # row 1 has seen every item
    args = (q, lat, bias, seen, 35, torch.bfloat16, recall_target)
    v0, i0 = tmips.score_and_select(*args)
    v1, i1 = tmips.score_and_select(*args, offset=1000)
    assert torch.equal(v0, v1)
    assert torch.equal(i1, torch.where(i0 >= 0, i0 + 1000, -1))
    assert (i0 == -1).any() == (recall_target < 1.0)


@pytest.mark.parametrize("recall_target", [1.0, 0.9])
def test_blocked_reads_an_id_past_v_as_arec(recall_target):
    """`blocked_topk_mips` clamps a seen id ≥ V to V − 1 where it selects
    exactly and drops it where it selects approximately, as arec's does.
    Item V − 1 is every row's best, so either rule shows (at V 100 the
    approximate selection reduces nothing, so arec's CPU lowering and
    the port's agree)."""
    q, lat, bias, seen = _inputs(100, 8)
    bias[-1] = 1e3
    seen[:, -1] = 100 + np.arange(B)
    want = j_blocked(*map(jnp.asarray, (q, lat, bias, seen)), k=30,
                     recall_target=recall_target)
    got = t_blocked(*map(torch.from_numpy, (q, lat, bias, seen)), k=30,
                    recall_target=recall_target)
    rule = np.where(seen >= 100, 99 if recall_target >= 1.0 else -1, seen)
    _check(got, want, ref_scores(q, lat, bias, rule))
    assert ((got[1][:, 0] == 99).numpy() == (recall_target < 1.0)).all()
