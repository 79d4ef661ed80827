"""batch_rank_fwd / batch_rank_bwd CUDA kernels on the card, against
`losses.batch_bpr_loss`'s library ops and the plain versions: at
xing-mf's batch (N = 8192, D = 128) and at sizes that cross every tile
edge (N off the 64-row tile and the range splits, N < 64, D off the MMA
depth 16, D = 256), with and without the HT weights, items repeated in the
batch; the scratch size and the entry points' check of it; runs repeating
bit for bit; the launch counters; and a `bbpr` sparse MF step with HT
weights replayed from a CUDA graph equal to its eager steps.

Marked `cuda`: they skip where no CUDA device is present. On a machine with
one (and no jax), run them without the jax-loading conftest:

    python -m pytest tests/test_torch_batch_rank_cuda.py --noconftest -q -s

The tolerances, and why. Both sides round q and v to bf16 and sum the
scores in f32, in other orders (the kernels on the tensor cores, the
library in cuBLAS's f32 product): a score differs by a few f32 ulps of
Σ|q·v|, so the loss and each row's sums agree to ~1e-5 relative. The
gradients' products take ∂L/∂s in f32 on both sides (the kernels as three
bf16 parts) and round dq and dv to bf16 last: a sum that lies within its
ulps of a bf16 rounding tie lands one bf16 ulp (2^-8 of it) apart, so each
element is held to 2^-7 relative (plus 1e-6 of the largest), and the share
of elements that differ at all to a few in a thousand. db stays in f32,
a sum of terms of both signs (the diagonal's is the row's negative sum):
1e-4 relative, and 1e-5 of the largest for a sum that cancels."""

import numpy as np
import pytest
import torch

from arec_torch.kernels import batch_rank as kbr
from arec_torch.losses import losses

SHAPES = [(8192, 128), (77, 16), (1, 8), (300, 40), (4133, 128),
          (513, 256), (64, 129)]
IDS = [f"N{n}-D{d}" for n, d in SHAPES]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(N, D, dev, seed=0):
    """q, v, b, pos (items repeated: drawn from N // 4 + 1, skewed) and
    pop_probs with an item of probability 0 (clamped to 1e-12) and one
    item past the batch's, which keeps the mass off zero."""
    rng = np.random.default_rng(seed)
    vocab = N // 4 + 1
    pos = np.minimum(rng.zipf(1.3, N) - 1, vocab - 1).astype(np.int64)
    freq = rng.integers(1, 1000, vocab + 1).astype(np.float64)
    freq[pos[0]] = 0.0
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    arrays = [f(N, D) * 0.3, f(N, D) * 0.3, f(N) * 0.2, pos,
              (freq / freq.sum()).astype(np.float32)]
    return [torch.from_numpy(a).to(dev) for a in arrays]


def _library(q, v, b, pos, pop):
    """The library ops on the card: an identity gather_cands keeps
    `batch_bpr_loss` on them."""
    q, v, b = (x.clone().requires_grad_() for x in (q, v, b))
    out = losses.batch_bpr_loss(q, pos, lambda ids: (v, b), torch.bfloat16,
                                gather_cands=lambda i, vv, bb: (i, vv, bb, 0),
                                pop_probs=pop)
    return (out.detach(), *torch.autograd.grad(out, [q, v, b]))


def _kernels(q, v, b, pos, pop):
    q, v, b = (x.clone().requires_grad_() for x in (q, v, b))
    out = losses.batch_bpr_loss(q, pos, lambda ids: (v, b), torch.bfloat16,
                                pop_probs=pop)
    return (out.detach(), *torch.autograd.grad(out, [q, v, b]))


def _close_bf16(got, want, name):
    """dq or dv: each element within one bf16 ulp, few elements apart."""
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=2 ** -7, atol=1e-6 * scale,
                               msg=lambda s: f"{name}: {s}")
    share = float((got != want).float().mean())
    print(f"{name}: {share:.2e} of elements one rounding apart")
    assert share < 5e-3, (name, share)


@pytest.mark.cuda
@pytest.mark.parametrize("ht", [True, False], ids=["ht", "plain"])
@pytest.mark.parametrize("N,D", SHAPES, ids=IDS)
def test_the_kernels_are_the_library_ops(dev, N, D, ht):
    q, v, b, pos, pop = _inputs(N, D, dev, seed=N + D)
    pop = pop if ht else None
    f0, b0 = kbr.batch_rank_fwd.launches, kbr.batch_rank_bwd.launches
    got = _kernels(q, v, b, pos, pop)
    assert (kbr.batch_rank_fwd.launches - f0,
            kbr.batch_rank_bwd.launches - b0) == (1, 1)
    want = _library(q, v, b, pos, pop)
    torch.cuda.synchronize()
    assert np.isfinite(float(got[0]))
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-7)
    _close_bf16(got[1], want[1], f"dq N{N} D{D}")
    _close_bf16(got[2], want[2], f"dv N{N} D{D}")
    torch.testing.assert_close(got[3], want[3], rtol=1e-4,
                               atol=1e-5 * float(want[3].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("ht", [True, False], ids=["ht", "plain"])
@pytest.mark.parametrize("N,D", SHAPES[:4], ids=IDS[:4])
def test_the_kernels_keep_the_plain_versions_contracts(dev, N, D, ht):
    """Row by row: loss, rs and tsum of the forward, and the backward
    under cotangents of mixed sign, against the plain versions on the
    card."""
    q, v, b, pos, pop = _inputs(N, D, dev, seed=7 * N + D)
    pq = pop[pos] if ht else None
    pos32 = pos.int()
    got = kbr.batch_rank_fwd(q, v, b, pos32, pq)
    want = kbr.batch_rank_fwd_plain(q, v, b, pos, pq)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
    g = torch.randn(N, device=dev, generator=torch.Generator(dev)
                    .manual_seed(N))
    dq, dv, db = kbr.batch_rank_bwd(q, v, b, pos32, pq, g, *want[1:])
    wq, wv, wb = kbr.batch_rank_bwd_plain(q, v, b, pos, pq, g, *want[1:])
    _close_bf16(dq, wq, "dq")
    _close_bf16(dv, wv, "dv")
    torch.testing.assert_close(db, wb, rtol=1e-4,
                               atol=1e-5 * float(wb.abs().max()))


@pytest.mark.cuda
def test_a_batch_of_one_item_reads_zero(dev):
    q, v, b, _, pop = _inputs(100, 32, dev)
    pos = torch.full((100,), 3, dtype=torch.int64, device=dev)
    out = _kernels(q, v, b, pos, pop)
    for x in out:
        assert torch.equal(x, torch.zeros_like(x))


@pytest.mark.cuda
def test_runs_repeat_bit_for_bit(dev):
    q, v, b, pos, pop = _inputs(8192, 128, dev, seed=1)
    a, c = _kernels(q, v, b, pos, pop), _kernels(q, v, b, pos, pop)
    for x, y in zip(a, c):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_the_scratch_size_is_checked(dev):
    q, v, b, pos, pop = _inputs(300, 40, dev)
    n = kbr.scratch_bytes(300, 40, False)
    assert n > 0 and kbr.scratch_bytes(300, 40, True) > n
    with pytest.raises(ValueError):
        kbr.scratch_bytes(300, 257, True)
    loss = torch.empty(300, device=dev)
    short = torch.empty(n - 1, dtype=torch.uint8, device=dev)
    rc = kbr._fn("batch_rank_fwd", 9)(
        q.data_ptr(), v.data_ptr(), b.data_ptr(), pos.int().data_ptr(), None,
        loss.data_ptr(), loss.data_ptr(), loss.data_ptr(), short.data_ptr(),
        300, 40, n - 1, torch.cuda.current_stream().cuda_stream)
    assert rc != 0
    info = kbr.kernel_info(128, True)
    print(info)
    for name in ("batch_rank_fwd_kernel", "batch_rank_bwd_rows_kernel",
                 "batch_rank_bwd_cols_kernel"):
        assert info[name]["local_bytes"] == 0, (name, info[name])
        assert info[name]["blocks_per_sm"] >= 2, (name, info[name])


@pytest.mark.cuda
def test_a_captured_sparse_bbpr_step_replays_as_its_eager_steps(dev):
    """K = 4 `bbpr` sparse MF steps with HT weights as one CUDA graph:
    three dispatches (the eager warm-up, then two replays with other step
    keys) against 3K eager steps from the same state, every leaf and metric
    equal, or within the gap two eager runs show between themselves."""
    from arec_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from arec_torch.data.dataset import mf_batches
    from arec_torch.data.synthetic import generate
    from arec_torch.losses.sampling import make_pop
    from arec_torch.models import mf as tmf
    from arec_torch.tables.engine import attrs_to_device
    from arec_torch.train import sparse as tsparse
    from arec_torch.train import step as tstep
    from arec_torch.train.graph import scan_multi
    K = 4
    cfg = Config(data=DataConfig(syn_users=400, syn_items=600,
                                 syn_interactions=20000),
                 model=ModelConfig(model="mf", dim=64, use_attributes=True),
                 train=TrainConfig(batch_size=256, loss="bbpr", batch_ht=True,
                                   compute_dtype="bfloat16",
                                   learning_rate=0.2, sparse_update=True))
    ds = generate(cfg.data)
    spec = tmf.MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    udev = attrs_to_device(ds.user_attrs.restrict(spec.user.schema),
                           spec.user, dev)
    idev = attrs_to_device(ds.item_attrs.restrict(spec.item.schema),
                           spec.item, dev)
    opt = tstep.make_optimizer("adagrad", 0.2)
    pop = make_pop(ds.item_freq, 1.0, dev)

    def fresh():
        params = tmf.init_mf(torch.Generator(device=dev).manual_seed(0), spec)
        return tsparse.init_sparse_state(
            params, tsparse.table_paths(False, spec), opt, "adagrad")
    core = tsparse.make_sparse_step_core(False, spec, udev, idev, opt, 0.2,
                                         "adagrad", pop=pop)
    batches = [{k: torch.from_numpy(x).to(dev) for k, x in b.items()}
               for b in mf_batches(ds, 256, 0, 0)]

    def eager():
        state, ms = fresh(), []
        for i in range(3 * K):
            state, m = core(state, batches[i % len(batches)],
                            tstep.step_generator(0, i))
            ms.append(m)
        return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    def graphed():
        multi, state, ms = scan_multi(core, K), fresh(), []
        f0 = kbr.batch_rank_fwd.launches
        for d in range(3):
            state, m = multi(state, [batches[(d * K + i) % len(batches)]
                                     for i in range(K)],
                             [tstep.step_generator(0, d * K + i)
                              for i in range(K)])
            ms.append(m)
        # the warm-up's K and the capture's K; a replay runs no wrapper
        assert kbr.batch_rank_fwd.launches - f0 == 2 * K
        assert (multi.captures, multi.replays) == (1, 2)
        return state, {k: torch.cat([m[k] for m in ms]) for k in ms[0]}

    a1, a2, g = eager(), eager(), graphed()
    torch.cuda.synchronize()

    def gap(x, y):
        (sx, mx), (sy, my) = x, y
        pairs = list(zip(tstep._leaves(sx._asdict()),
                         tstep._leaves(sy._asdict())))
        pairs += [(mx[k], my[k]) for k in mx]
        return max(float((p.double() - r.double()).abs().max())
                   for p, r in pairs if p.numel())
    eager_gap, graph_gap = gap(a1, a2), gap(a1, g)
    print(f"bbpr sparse: graph vs eager {graph_gap:.3e}, eager vs eager "
          f"{eager_gap:.3e}")
    assert graph_gap <= eager_gap, (graph_gap, eager_gap)
    assert np.isfinite(a1[1]["loss"].cpu().numpy()).all()
