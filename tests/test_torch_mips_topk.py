"""The mips_topk wrapper on the CPU: its plain version answers as arec's
`topk_with_mask` dispatch (`_topk_full` up to BLOCKED_EVAL_MIN_V items,
`blocked_topk_mips` above) at each V, up to ties; `seen_rule`, the per-id
rule the kernel applies to the seen slab, leaves each of arec's branches'
answer unchanged at its own V (an id ≥ V dropped by the first, clamped to
V − 1 by the second); `topk_with_mask`
keeps the CPU's dispatch and launches nothing; and the wrapper's guards on
D, k, dtypes, shapes, layout and device raise before any launch. The kernel
itself is held against the plain version on the card
(test_torch_mips_topk_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arec.train.evalu import topk_with_mask as j_topk
from arec_torch.kernels import mips_topk as tmk
from arec_torch.retrieval import mips
from arec_torch.train import evalu
from torch_topk_check import assert_topk_equal_up_to_ties, ref_scores

MIN_V = mips.BLOCKED_EVAL_MIN_V
B, D = 6, 16


def _inputs(v, s=12, seed=0):
    """query, f32 latents, bias and a seen slab holding PAD, a duplicated
    id, ids below 0, at V and past it, and each row's own best id."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    lat = torch.from_numpy(rng.standard_normal((v, D)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(v)).astype(np.float32))
    seen = torch.from_numpy(rng.integers(0, v, (B, s)).astype(np.int32))
    seen[:, 0] = -1
    seen[:, 1] = seen[:, 2]
    seen[:, 3] = -7
    seen[::2, 4] = v
    seen[1::2, 4] = v + 11
    best = tmk.mips_topk_plain(q, lat, bias, seen[:, :0], k=1)[1]
    seen[:, 5] = best[:, 0].to(torch.int32)
    lat[v - 1] = lat[0]            # the item a clamped id penalises is
    bias[v - 1] = 1e3              # every row's best
    return q, lat, bias, seen


def _equal(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _arec(q, lat, bias, seen, k):
    """arec's `topk_with_mask` at this V, as torch tensors."""
    return tuple(torch.from_numpy(np.array(x)) for x in j_topk(
        *(jnp.asarray(t.numpy()) for t in (q, lat, bias, seen)), k=k))


@pytest.mark.parametrize("v", [300, MIN_V, MIN_V + 1, 140_000])
def test_plain_is_the_plain_paths_dispatch(v):
    q, lat, bias, seen = _inputs(v)
    got = tmk.mips_topk_plain(q, lat, bias, seen, k=30)
    want = _arec(q, lat, bias, seen, 30)
    scores = ref_scores(q, lat, bias, tmk.seen_rule(seen, v))
    assert_topk_equal_up_to_ties(*got, *want, scores)


@pytest.mark.parametrize("v", [300, MIN_V, MIN_V + 1, 140_000])
def test_seen_rule_keeps_each_branchs_answer(v):
    """arec's branch at V, and the plain version, answer the same from the
    raw slab and from `seen_rule`'s, where every id is −1 or in [0, V)."""
    q, lat, bias, seen = _inputs(v, seed=1)
    rule = tmk.seen_rule(seen, v)
    assert rule.dtype == torch.int32 and rule.shape == seen.shape
    assert ((rule == -1) | ((rule >= 0) & (rule < v))).all()
    _equal(_arec(q, lat, bias, rule, 30), _arec(q, lat, bias, seen, 30))
    _equal(tmk.mips_topk_plain(q, lat, bias, rule, k=30),
           tmk.mips_topk_plain(q, lat, bias, seen, k=30))


@pytest.mark.parametrize("v,clamped", [(MIN_V, False), (MIN_V + 1, True)])
def test_seen_rule_drops_or_clamps_by_v(v, clamped):
    seen = torch.tensor([[-1, -7, 0, 5, v - 1, v, v + 9]], dtype=torch.int32)
    high = v - 1 if clamped else -1
    assert tmk.clamps(v) is clamped
    assert tmk.seen_rule(seen, v).tolist() == [[-1, -1, 0, 5, v - 1, high,
                                                 high]]
    # the item V − 1 is every row's best: a seen id ≥ V penalises it only
    # where the branch clamps
    q, lat, bias, slab = _inputs(v, seed=2)
    slab[:, 6:] = -1
    slab[:, 5] = v + 3
    ids = tmk.mips_topk_plain(q, lat, bias, slab, k=30)[1]
    first = ids[:, 0] == v - 1
    assert (~first).all() if clamped else first.all()


def test_topk_with_mask_keeps_the_cpu_dispatch():
    before = tmk.mips_topk.launches
    for v in (300, MIN_V + 1):
        q, lat, bias, seen = _inputs(v, seed=3)
        _equal(evalu.topk_with_mask(q, lat, bias, seen, k=30),
               tmk.mips_topk_plain(q, lat, bias, seen, k=30))
    assert tmk.mips_topk.launches == before


def _ok(v=200, k=30):
    q, lat, bias, seen = _inputs(v, seed=4)
    return dict(query=q, items=lat.to(torch.bfloat16), bias=bias, seen=seen,
                k=k)


BAD = {
    "d_not_16": lambda a: {**a, "query": a["query"][:, :8].contiguous(),
                           "items": a["items"][:, :8].contiguous()},
    "d_past_256": lambda a: {**a, "query": torch.zeros(B, 272),
                             "items": torch.zeros(200, 272,
                                                  dtype=torch.bfloat16)},
    "d_mismatch": lambda a: {**a, "items": torch.zeros(200, 32,
                                                       dtype=torch.bfloat16)},
    "k_zero": lambda a: {**a, "k": 0},
    "k_past_64": lambda a: {**a, "k": 65},
    "k_past_v": lambda a: {**a, "items": a["items"][:20], "bias":
                           a["bias"][:20], "k": 30},
    "items_f16": lambda a: {**a, "items": a["items"].half()},
    "items_f32_on_cpu": lambda a: {**a, "items": a["items"].float()},
    "query_f16": lambda a: {**a, "query": a["query"].half()},
    "query_bf16": lambda a: {**a, "query": a["query"].to(torch.bfloat16)},
    "query_int": lambda a: {**a, "query": a["query"].int()},
    "bias_f64": lambda a: {**a, "bias": a["bias"].double()},
    "bias_short": lambda a: {**a, "bias": a["bias"][:-1]},
    "seen_int64": lambda a: {**a, "seen": a["seen"].long()},
    "seen_rows": lambda a: {**a, "seen": a["seen"][:-1]},
    "seen_1d": lambda a: {**a, "seen": a["seen"][0]},
    "query_strided": lambda a: {**a, "query": torch.zeros(D, B).t()},
    "cpu_tensors": lambda a: a,
}


@pytest.mark.parametrize("name", list(BAD))
def test_guards_raise(name):
    a = BAD[name](_ok())
    before = tmk.mips_topk.launches
    with pytest.raises(ValueError):
        tmk.mips_topk(a["query"], a["items"], a["bias"], a["seen"], k=a["k"])
    assert tmk.mips_topk.launches == before


def test_guard_compute_dtype():
    a = _ok()
    with pytest.raises(ValueError, match="bf16"):
        tmk.mips_topk(a["query"], a["items"], a["bias"], a["seen"],
                      compute_dtype=torch.float32)
