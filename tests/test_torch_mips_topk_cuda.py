"""The mips_topk CUDA kernels vs their plain version (`mips_topk_plain`: the
query-blocked loop of `retrieval.mips` over the seen slab as `seen_rule`
reads it), on the card: MF's serving shape (B 256,
V 1,304,126, D 128) and c4's (B 256, V 50,001, D 128), D 64, D 256, k 30,
k 1 and k 64, an f32 item matrix and a bf16 query; seen slabs of width 0, 32 and 96 holding PAD,
duplicated ids, ids below 0 and at or past V, ids of each row's own best
items, and a row whose seen ids all fall in one slab; V on both sides of
BLOCKED_EVAL_MIN_V, where an id ≥ V is dropped or clamped to V − 1; rows
at a tiny V where fewer than k unseen items remain, so penalised ids are
returned; planted exact ties.

The scores must agree within f32 round-off of the two sum orders
(ATOL + RTOL·|score|: the scores here are O(1), and a penalised score
−1e9 + s is f32 with an ulp of 64), and the ids at each rank must be equal
or carry, in a float64 reference of the same masked scores, the plain
version's score at that rank: ties may be ordered either way.

Marked `cuda`: they skip where no CUDA device is present. On a machine with
one (and no jax), run them without the jax-loading conftest:

    python -m pytest tests/test_torch_mips_topk_cuda.py --noconftest -q
"""

import pytest
import torch

from arec_torch.kernels import mips_topk as tmk
from arec_torch.retrieval import mips
from arec_torch.train import evalu

ATOL, RTOL = 1e-4, 1e-6
MIN_V = mips.BLOCKED_EVAL_MIN_V


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(B, V, D, S, k, dev, seed=0, ties=False):
    """query, items (bf16), bias and a seen slab [B, S] that holds PAD, a
    duplicated id, ids below 0 and past V, each row's own best ids (with
    `ties`, four copies of one item that are every row's best instead)
    and, in row 0, S consecutive ids (all in one slab)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, D, generator=g, device=dev)
    items = (0.1 * torch.randn(V, D, generator=g, device=dev)).to(
        torch.bfloat16)
    bias = 0.1 * torch.randn(V, generator=g, device=dev)
    if ties:   # exact ties among every row's best: copies of one item
        hot = torch.tensor([3, V // 2, V - 2], device=dev)
        items[hot] = items[1].clone()
        bias[hot] = bias[1] = 20.0
    seen = torch.randint(0, V, (B, S), generator=g, device=dev,
                         dtype=torch.int32)
    if S:
        width = torch.randint(0, S + 1, (B, 1), generator=g, device=dev)
        seen = torch.where(torch.arange(S, device=dev) < width, seen, -1)
        if not ties:
            best = tmk.mips_topk_plain(q, items, bias, seen[:, :0], k=4)[1]
            n = min(S, 4)
            seen[1:, :n] = best[1:, :n].to(torch.int32)
    if S >= 8:
        seen[:, 4] = seen[:, 5]                   # a duplicated id
        seen[::3, 6] = V + 3                      # past V
        seen[1::3, 6] = V                         # at V
        seen[2::3, 7] = -7                        # below 0
        seen[0] = torch.arange(S, device=dev, dtype=torch.int32) + V // 3
    return q, items, bias, seen


def _scores_at(q, items, bias, seen, ids):
    """float64 masked scores of each (row, id): bf16-rounded operands,
    −1e9 per seen occurrence under the plain path's rule at this V."""
    qb = q.to(torch.bfloat16).double()
    s = torch.einsum("bd,bkd->bk", qb, items[ids].double())
    s = s + bias[ids].double()
    rule = tmk.seen_rule(seen, items.shape[0])
    hits = (rule[:, None, :].long() == ids[:, :, None]).sum(-1)
    return s - 1e9 * hits


def _assert_same_topk(got, want, q, items, bias, seen):
    (gv, gi), (wv, wi) = got, want
    V, k = items.shape[0], wv.shape[1]
    assert gv.shape == wv.shape and gi.shape == wi.shape
    assert gv.dtype == torch.float32 and gi.dtype == torch.int64
    assert ((gi >= 0) & (gi < V)).all()
    srt = gi.sort(dim=1).values
    assert (srt[:, 1:] != srt[:, :-1]).all(), "an id repeats in a row"
    tol = ATOL + RTOL * wv.abs()
    gap = (gv - wv).abs()
    assert (gap <= tol).all(), f"scores apart by {float(gap.max()):.3e}"
    mine = _scores_at(q, items, bias, seen, gi)
    bad = ((mine - wv.double()).abs() > tol) & (gi != wi)
    assert not bad.any(), (
        f"{int(bad.sum())} ranks hold ids {gi[bad][:8].tolist()} (scores "
        f"{mine[bad][:8].tolist()}) where the plain path has "
        f"{wi[bad][:8].tolist()} ({wv[bad][:8].tolist()})")
    assert (gv[:, 1:] <= gv[:, :-1]).all(), "not best first"


CASES = {
    # (B, V, D, S, k)
    "mf_seen32": (256, 1_304_126, 128, 32, 30),
    "mf_seen96": (256, 1_304_126, 128, 96, 30),
    "mf_seen0": (256, 1_304_126, 128, 0, 30),
    "c4_seen32": (256, 50_001, 128, 32, 30),
    "c4_seen96": (256, 50_001, 128, 96, 30),
    "c4_seen0": (256, 50_001, 128, 0, 30),
    "c4_one_row": (1, 50_001, 128, 32, 30),
    "d64": (200, 300_000, 64, 32, 30),
    "d256": (40, 20_000, 256, 32, 30),
    "k1_mf": (256, 1_304_126, 128, 32, 1),
    "k1_c4": (256, 50_001, 128, 32, 1),
    "k64": (300, 400_000, 128, 96, 64),
    "k64_d256": (130, 60_000, 256, 32, 64),
    "v_at_min": (64, MIN_V, 128, 32, 30),
    "v_past_min": (64, MIN_V + 1, 128, 32, 30),
    "odd_rows": (37, 9_999, 48, 13, 7),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain(dev, name):
    B, V, D, S, k = CASES[name]
    q, items, bias, seen = _case(B, V, D, S, k, dev)
    want = tmk.mips_topk_plain(q, items, bias, seen, k=k)
    before = tmk.mips_topk.launches
    got = tmk.mips_topk(q, items, bias, seen, k=k)
    torch.cuda.synchronize()
    assert tmk.mips_topk.launches == before + 1
    _assert_same_topk(got, want, q, items, bias, seen)


@pytest.mark.cuda
@pytest.mark.parametrize("V", [MIN_V, MIN_V + 1])
def test_out_of_range_seen_id_follows_the_branch_at_v(dev, V):
    """Every row's best item is V − 1, and every row's seen slab holds V:
    at V ≤ BLOCKED_EVAL_MIN_V it is dropped and V − 1 stays first; above,
    it is clamped to V − 1, which is penalised."""
    q, items, bias, _ = _case(16, V, 64, 0, 30, dev, seed=4)
    bias[V - 1] = 50.0
    seen = torch.full((16, 4), -1, dtype=torch.int32, device=dev)
    seen[:, 1] = V
    got = tmk.mips_topk(q, items, bias, seen, k=30)
    want = tmk.mips_topk_plain(q, items, bias, seen, k=30)
    _assert_same_topk(got, want, q, items, bias, seen)
    first = got[1][:, 0] == V - 1
    assert (first.all() if V <= MIN_V else not first.any()), got[1][:, :3]


@pytest.mark.cuda
@pytest.mark.parametrize("dup", [False, True])
def test_fewer_unseen_than_k_returns_penalised_ids(dev, dup):
    """V = 40, k = 30, 20 seen ids a row (a duplicated one penalised
    twice): the 20 unseen items first, then the least penalised."""
    B, V, k = 8, 40, 30
    q, items, bias, _ = _case(B, V, 16, 0, k, dev, seed=5)
    g = torch.Generator(device=dev).manual_seed(6)
    seen = torch.stack([torch.randperm(V, generator=g, device=dev)[:20]
                        for _ in range(B)]).to(torch.int32)
    if dup:
        seen = torch.cat([seen, seen[:, :3]], dim=1)
    got = tmk.mips_topk(q, items, bias, seen, k=k)
    want = tmk.mips_topk_plain(q, items, bias, seen, k=k)
    _assert_same_topk(got, want, q, items, bias, seen)
    for r in range(B):
        unseen = set(range(V)) - set(seen[r].tolist())
        assert set(got[1][r, :20].tolist()) == unseen
        assert (got[0][r, 20:] < -5e8).all()
        if dup:
            twice = set(seen[r, :3].tolist())
            assert not twice & set(got[1][r, 20:].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 1_304_126), (256, 50_001)])
def test_planted_ties(dev, shape):
    B, V = shape
    q, items, bias, seen = _case(B, V, 128, 32, 30, dev, seed=7, ties=True)
    got = tmk.mips_topk(q, items, bias, seen, k=30)
    want = tmk.mips_topk_plain(q, items, bias, seen, k=30)
    _assert_same_topk(got, want, q, items, bias, seen)
    # the four copies are every row's best unless seen; the kernel puts
    # tied ids lowest first
    top = got[1][:, :4].sort(dim=1).values
    rows = ~(seen[:, :, None] == torch.tensor(
        [1, 3, V // 2, V - 2], device=dev)).any(dim=(1, 2))
    assert (top[rows] == torch.tensor([1, 3, V // 2, V - 2],
                                      device=dev)).all()
    assert (got[1][rows, :4] == top[rows]).all()


@pytest.mark.cuda
def test_f32_items_and_a_bf16_query_through_topk_with_mask(dev):
    """An f32 item matrix is rounded to bf16 by the wrapper; a bf16 query
    reaches the kernels through `topk_with_mask` as f32. Both give the
    plain version's answer."""
    q, items, bias, seen = _case(256, 50_001, 128, 32, 30, dev, seed=8)
    q = q.to(torch.bfloat16).float()
    want = tmk.mips_topk_plain(q, items, bias, seen, k=30)
    _assert_same_topk(tmk.mips_topk(q, items.float(), bias, seen, k=30),
                      want, q, items, bias, seen)
    _assert_same_topk(evalu.topk_with_mask(q.to(torch.bfloat16), items,
                                           bias, seen, k=30),
                      want, q, items, bias, seen)


@pytest.mark.cuda
def test_repeats_bit_for_bit_and_topk_with_mask_takes_it(dev):
    q, items, bias, seen = _case(256, 1_304_126, 128, 32, 30, dev, seed=9)
    a = tmk.mips_topk(q, items, bias, seen, k=30)
    before = tmk.mips_topk.launches
    b = evalu.topk_with_mask(q, items, bias, seen, k=30)
    assert tmk.mips_topk.launches == before + 1
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_launch_plan_at_the_main_paths(dev):
    for V in (1_304_126, 50_001):
        q = torch.zeros(256, 128, device=dev)
        items = torch.zeros(V, 128, dtype=torch.bfloat16, device=dev)
        plan = tmk.launch_plan(q, items, 30)
        assert plan["query_tiles"] == 1 and plan["threads"] == 256
        # two select CTAs a SM cap a thread at 128 registers: a word or
        # two of stack, no more
        assert plan["local_bytes"] <= 16, plan
        assert plan["blocks_per_sm"] >= 1
        assert 1 <= plan["splits"] <= min(256, -(-V // 64))
        assert plan["splits"] >= plan["sms"] // 2, plan
        assert plan["blocks_per_sm"] == 2, plan
        assert plan["kept_per_row"] == 64 and plan["scratch_bytes"] > 0


@pytest.mark.cuda
def test_guards_raise_on_the_card(dev):
    q, items, bias, seen = _case(8, 1_000, 64, 4, 30, dev)
    with pytest.raises(ValueError):
        tmk.mips_topk(q, items.half(), bias, seen)
    with pytest.raises(ValueError):
        tmk.mips_topk(q, items, bias, seen.long())
    with pytest.raises(ValueError):
        tmk.mips_topk(q, items, bias.cpu(), seen)
    with pytest.raises(ValueError):
        tmk.mips_topk(q.t().contiguous().t(), items, bias, seen)
