"""The fused in-batch BPR loss (`kernels/batch_rank.py`) on the CPU: its
plain versions, through the autograd Function that the kernels sit behind,
against `losses.batch_bpr_loss`'s library ops in the loss and the
gradients of q, v and b, with and without the HT weights, at ragged N, with
repeated items (a row's every column of its own item masked), a batch of
one item (every column masked) and items of probability 0 and 1; and the
routing: on one card in bf16 `bbpr` takes the kernels, while CPU tensors,
the mesh's gathered candidates, float32 products and `mw` keep the library
ops, whose results do not change.

A CUDA tensor cannot be made here, so the routing cases pretend the query
is on the card (`Tensor.is_cuda`); the Function then takes the plain
versions, as it does for every CPU tensor."""

import numpy as np
import pytest
import torch

from arec_torch.kernels import batch_rank as kbr
from arec_torch.losses import losses

torch.set_num_threads(1)

SHAPES = [(7, 8), (77, 16), (300, 40), (1, 4)]
IDS = [f"N{n}-D{d}" for n, d in SHAPES]


def _inputs(N, D, seed=0, vocab=None):
    """q, v, b, pos (items repeated: the batch draws from N // 3 + 1), and
    pop_probs over the vocabulary with an item of probability 0 and, past
    the batch's items, the rest of the mass."""
    rng = np.random.default_rng(seed)
    vocab = vocab or N // 3 + 1
    pos = rng.integers(0, vocab, N).astype(np.int64)
    freq = rng.integers(0, 50, vocab + 5).astype(np.float64)
    freq[pos[0]] = 0.0                         # clamped to 1e-12
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return (f(N, D), f(N, D) * 0.5, f(N) * 0.3, torch.from_numpy(pos),
            torch.from_numpy(freq / max(freq.sum(), 1.0)).float())


def _library(q, v, b, pos, pop, dtype):
    """The library ops' loss and gradients (CPU tensors take them)."""
    q, v, b = (x.clone().requires_grad_() for x in (q, v, b))
    out = losses.batch_bpr_loss(q, pos, lambda ids: (v, b), dtype,
                                pop_probs=pop)
    return (out.detach(), *torch.autograd.grad(out, [q, v, b]))


def _fused(q, v, b, pos, pop, dtype):
    """In bf16 the kernels' Function on the CPU (its plain versions); in
    f32, which the Function does not take, the plain versions themselves,
    the backward under the mean's cotangents 1/N."""
    if dtype == torch.bfloat16:
        q, v, b = (x.clone().requires_grad_() for x in (q, v, b))
        out = kbr.batch_bpr_rows(q, v, b, pos, pop).mean()
        return (out.detach(), *torch.autograd.grad(out, [q, v, b]))
    pq = None if pop is None else pop[pos]
    loss, rs, tsum = kbr.batch_rank_fwd_plain(q, v, b, pos, pq, dtype)
    g = torch.full_like(loss, 1.0 / len(loss))
    return (loss.mean(), *kbr.batch_rank_bwd_plain(q, v, b, pos, pq, g, rs,
                                                   tsum, dtype))


def _assert_close(got, want, dtype):
    """The tolerances, and why. Both sides round the same operands and sum
    in f32, in other orders (the library differentiates through its
    graph, the plain versions form ∂L/∂s in one expression): the loss to a
    few ulps, a gradient to a few ulps of its row's sum. In bf16 dq and dv
    are rounded to bf16 last on both sides, and a sum that lies within
    those ulps of a rounding tie lands one bf16 ulp (2^-8) apart."""
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-7)
    bf = dtype == torch.bfloat16
    for k, (g, w) in enumerate(zip(got[1:], want[1:])):
        scale = float(w.abs().max())
        rtol = 2 ** -7 if bf and k < 2 else 1e-4
        torch.testing.assert_close(g, w, rtol=rtol, atol=1e-5 * scale,
                                   msg=lambda s, k=k: f"grad {k}: {s}")


@pytest.mark.parametrize("ht", [True, False], ids=["ht", "plain"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("N,D", SHAPES, ids=IDS)
def test_the_plain_versions_are_the_library_ops(N, D, dtype, ht):
    q, v, b, pos, pop = _inputs(N, D, seed=N + D)
    pop = pop if ht else None
    want = _library(q, v, b, pos, pop, dtype)
    assert N == 1 or min(float(g.abs().max()) for g in want[1:]) > 0
    _assert_close(_fused(q, v, b, pos, pop, dtype), want, dtype)


def test_the_batch_repeats_items():
    pos = _inputs(77, 16)[3]
    same = pos[None, :] == pos[:, None]
    assert int(same.sum(dim=1).max()) > 1


@pytest.mark.parametrize("ht", [True, False], ids=["ht", "plain"])
def test_a_batch_of_one_item_reads_zero(ht):
    """Every column masked: the row counts clamp to 1 (the weights' sum to
    1e-12) and the loss and its gradients are 0, not NaN."""
    q, v, b, _, pop = _inputs(9, 8)
    pos = torch.full((9,), 2, dtype=torch.int64)
    got = _fused(q, v, b, pos, pop if ht else None, torch.bfloat16)
    want = _library(q, v, b, pos, pop if ht else None, torch.bfloat16)
    for g, w in zip(got, want):
        assert torch.equal(g, torch.zeros_like(g)) and torch.equal(g, w)


def test_an_item_of_probability_one_weighs_its_row_zero():
    """(1 − q_t) = 0 zeroes a row's HT weights: its loss reads 0, as the
    library's clamped quotient does."""
    q, v, b, pos, _ = _inputs(12, 8)
    pop = torch.zeros(int(pos.max()) + 1)
    pop[pos[0]] = 1.0
    loss, rs, _ = kbr.batch_rank_fwd_plain(q, v, b, pos, pop[pos],
                                           torch.bfloat16)
    mine = pos == pos[0]
    assert torch.equal(loss[mine], torch.zeros(int(mine.sum())))
    assert torch.equal(rs[mine], torch.zeros(int(mine.sum())))
    _assert_close(_fused(q, v, b, pos, pop, torch.bfloat16),
                  _library(q, v, b, pos, pop, torch.bfloat16), torch.bfloat16)


def test_the_backward_is_the_gradient_of_the_rows():
    """batch_rank_bwd_plain with row cotangents g equals autograd of
    Σ g·loss through the library's ops, in float32."""
    q, v, b, pos, pop = _inputs(50, 12, seed=3)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(50)
                         .astype(np.float32))
    pq = pop[pos]
    loss, rs, tsum = kbr.batch_rank_fwd_plain(q, v, b, pos, pq,
                                              torch.float32)
    got = kbr.batch_rank_bwd_plain(q, v, b, pos, pq, g, rs, tsum,
                                   torch.float32)
    qq, vv, bb = (x.clone().requires_grad_() for x in (q, v, b))
    rows = kbr.batch_rank_fwd_plain(qq, vv, bb, pos, pq, torch.float32)[0]
    torch.testing.assert_close(rows.detach(), loss)
    want = torch.autograd.grad((g * rows).sum(), [qq, vv, bb])
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-4,
                                   atol=1e-6 * float(y.abs().max()))


# ---- the routing ---------------------------------------------------------

@pytest.fixture
def on_card(monkeypatch):
    """Tensors claim to be on the card; calls of `batch_bpr_rows` are
    recorded and run through (the Function takes its plain versions)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda",
                        property(lambda self: True))
    calls = []
    real = kbr.batch_bpr_rows

    def recorded(*a, **k):
        calls.append(a)
        return real(*a, **k)
    monkeypatch.setattr(kbr, "batch_bpr_rows", recorded)
    return calls


@pytest.mark.parametrize("ht", [True, False], ids=["ht", "plain"])
def test_bbpr_on_the_card_takes_the_kernels(on_card, ht):
    q, v, b, pos, pop = _inputs(77, 16)
    pop = pop if ht else None
    got = _library(q, v, b, pos, pop, torch.bfloat16)   # routed
    assert len(on_card) == 1
    want = _fused(q, v, b, pos, pop, torch.bfloat16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _identity_gather(ids, v, b):
    return ids, v, b, 0


@pytest.mark.parametrize("case", ["cpu", "gather_cands", "float32"])
def test_the_library_ops_stay_where_the_kernels_do_not_go(monkeypatch,
                                                          case):
    q, v, b, pos, pop = _inputs(77, 16)
    want = _library(q, v, b, pos, pop, torch.bfloat16 if case != "float32"
                    else torch.float32)
    calls = []
    monkeypatch.setattr(kbr, "batch_bpr_rows",
                        lambda *a, **k: calls.append(a))
    if case != "cpu":
        monkeypatch.setattr(torch.Tensor, "is_cuda",
                            property(lambda self: True))
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    gather = _identity_gather if case == "gather_cands" else None
    qq, vv, bb = (x.clone().requires_grad_() for x in (q, v, b))
    out = losses.batch_bpr_loss(qq, pos, lambda ids: (vv, bb), dtype,
                                gather_cands=gather, pop_probs=pop)
    got = (out.detach(), *torch.autograd.grad(out, [qq, vv, bb]))
    assert calls == []
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("ht", [True, False], ids=["ht", "plain"])
def test_mw_is_unchanged_on_the_card(on_card, ht):
    q, v, b, pos, pop = _inputs(77, 16)
    pop = pop if ht else None

    def mw():
        qq, vv, bb = (x.clone().requires_grad_() for x in (q, v, b))
        out = losses.batch_mw_loss(qq, pos, lambda ids: (vv, bb), 500,
                                   compute_dtype=torch.bfloat16,
                                   pop_probs=pop)
        return (out.detach(), *torch.autograd.grad(out, [qq, vv, bb]))
    on = mw()
    with pytest.MonkeyPatch.context() as mp:
        mp.delattr(torch.Tensor, "is_cuda")
        off = mw()
    assert on_card == []
    for g, w in zip(on, off):
        assert torch.equal(g, w)


@pytest.mark.parametrize("ht", [True, False], ids=["ht", "plain"])
def test_the_mf_step_loss_takes_the_kernels(on_card, ht):
    """`models/mf.mf_loss` with `bbpr` on the card reaches the kernels'
    Function through `_mf_ranking_loss`, and its loss and gradients are
    the library path's (up to the bf16 rounding of dq and dv)."""
    from arec_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from arec_torch.data.synthetic import generate
    from arec_torch.losses.sampling import make_pop
    from arec_torch.models import mf
    from arec_torch.rng import generator
    from arec_torch.tables.engine import attrs_to_device
    cfg = Config(data=DataConfig(syn_users=300, syn_items=200,
                                 syn_interactions=6000),
                 model=ModelConfig(model="mf", dim=16, use_attributes=True),
                 train=TrainConfig(batch_size=64, loss="bbpr", batch_ht=ht,
                                   compute_dtype="bfloat16"))
    ds = generate(cfg.data)
    spec = mf.MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    cpu = torch.device("cpu")
    udev = attrs_to_device(ds.user_attrs.restrict(spec.user.schema),
                           spec.user, cpu)
    idev = attrs_to_device(ds.item_attrs.restrict(spec.item.schema),
                           spec.item, cpu)
    rng = np.random.default_rng(5)
    batch = {"user": torch.from_numpy(rng.integers(0, 300, 64)),
             "pos_item": torch.from_numpy(rng.integers(0, 40, 64))}
    pop = make_pop(ds.item_freq, 1.0) if ht else None

    def run():
        params = mf.init_mf(torch.Generator().manual_seed(0), spec)
        leaves = [params["user"]["tables"]["__fused__"],
                  params["item"]["tables"]["__fused__"]]
        for x in leaves:
            x.requires_grad_()
        out = mf.mf_loss(params, spec, udev, idev, batch, generator(7),
                         pop=pop)
        return (out.detach(), *torch.autograd.grad(out, leaves))
    fused = run()
    assert len(on_card) == 1
    with pytest.MonkeyPatch.context() as mp:
        mp.delattr(torch.Tensor, "is_cuda")
        library = run()
    assert len(on_card) == 1
    torch.testing.assert_close(fused[0], library[0], rtol=1e-5, atol=1e-7)
    for g, w in zip(fused[1:], library[1:]):
        torch.testing.assert_close(g, w, rtol=2 ** -7,
                                   atol=1e-5 * float(w.abs().max()))


def test_the_wrappers_raise_off_the_card_and_in_float32():
    q, v, b, pos, pop = _inputs(7, 8)
    before = kbr.batch_rank_fwd.launches, kbr.batch_rank_bwd.launches
    with pytest.raises(ValueError, match="cuda"):
        kbr.batch_rank_fwd(q, v, b, pos.int(), pop[pos])
    g = torch.ones(7)
    with pytest.raises(ValueError, match="cuda"):
        kbr.batch_rank_bwd(q, v, b, pos.int(), None, g, g, g)
    # bf16 is the kernels' own precision: there is none to ask for
    with pytest.raises(TypeError):
        kbr.batch_rank_fwd(q, v, b, pos.int(), None, torch.float32)
    assert (kbr.batch_rank_fwd.launches,
            kbr.batch_rank_bwd.launches) == before
