"""arec_torch fused sampled-softmax CE vs arec's: the sums and their
gradients against arec's Pallas `fused_sampled_ce_sums` (interpret mode on
the CPU, as tests/test_fused_softmax.py runs it), in aug and non-aug mode,
weighted and unweighted, with forced accidental hits and N not a multiple
of the TPU kernel's 256-row tile, and at the tile edges of the port's bf16
kernels; the loss's pure path and the full-softmax oracle against arec's;
and the samplers' probabilities.

Inputs come from numpy with a fixed seed and go to both sides. Values at
tests/test_fused_softmax.py's tolerance (rtol 1e-5, atol 1e-6), gradients
at its gradient tolerance (rtol 2e-4, atol 2e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arec.kernels.sampled_softmax import fused_sampled_ce_sums as j_sums
from arec.losses import losses as jl
from arec.losses import sampling as js
from arec_torch.kernels import sampled_softmax as tks
from arec_torch.losses import losses as tl
from arec_torch.losses import sampling as ts

torch.set_num_threads(1)

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=2e-5)
D, S, V = 16, 32, 200


def _inputs(n, aug, seed, d=D, s=S):
    rng = np.random.default_rng(seed)
    true_ids = rng.integers(0, V, n).astype(np.int32)
    sampled_ids = rng.integers(0, V, s).astype(np.int32)
    sampled_ids[: s // 4] = true_ids[: s // 4]         # forced hits
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    return dict(q=f(n, d), v_true=f(n, d + aug) * 0.3, v_samp=f(s, d) * 0.3,
                c_samp=f(s) * 0.5, tl_base=f(n) * 0.5, true_ids=true_ids,
                sampled_ids=sampled_ids,
                weights=rng.integers(0, 2, n).astype(np.float32))


CASES = {
    "aug_weighted": dict(n=48, aug=1, weighted=True),
    "aug_unweighted": dict(n=48, aug=1, weighted=False),
    "plain_weighted": dict(n=48, aug=0, weighted=True),
    "plain_unweighted_300_rows": dict(n=300, aug=0, weighted=False),
}
DIFF = ("q", "v_true", "v_samp", "c_samp", "tl_base")


@pytest.mark.parametrize("name", list(CASES))
def test_sums_and_gradients_match_pallas(name):
    case = CASES[name]
    a = _inputs(case["n"], case["aug"], seed=len(name))
    w = a["weights"] if case["weighted"] else None
    diff = DIFF + (("weights",) if case["weighted"] else ())

    def jfn(*xs):
        kw = dict(a, **dict(zip(diff, xs)))
        num, den = j_sums(kw["q"], kw["v_true"], kw["v_samp"], kw["c_samp"],
                          kw["tl_base"], jnp.asarray(a["true_ids"]),
                          jnp.asarray(a["sampled_ids"]),
                          kw["weights"] if case["weighted"] else None,
                          256, jnp.float32)
        return num, den

    jxs = [jnp.asarray(a[k]) for k in diff]
    want_num, want_den = jfn(*jxs)
    # d/d(inputs) of num + 0.5·den: both cotangents reach the backward
    want_g = jax.grad(lambda *xs: jfn(*xs)[0] + 0.5 * jfn(*xs)[1],
                      argnums=tuple(range(len(diff))))(*jxs)

    t = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    leaves = {k: t[k].requires_grad_() for k in diff}
    num, den = tks.fused_sampled_ce_sums(
        t["q"], t["v_true"], t["v_samp"], t["c_samp"], t["tl_base"],
        t["true_ids"], t["sampled_ids"], t["weights"] if w is not None
        else None, torch.float32)
    np.testing.assert_allclose(num.item(), float(want_num), **VAL)
    np.testing.assert_allclose(den.item(), float(want_den), **VAL)
    (num + 0.5 * den).backward()
    for k, g in zip(diff, want_g):
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(g),
                                   err_msg=k, **GRAD)


@pytest.mark.parametrize("aug", [0, 1])
def test_plain_backward_is_the_autograd_of_the_plain_forward(aug):
    """The plain backward's hand-written gradients equal torch autograd
    through the plain forward (f32, so no cast rounds)."""
    a = _inputs(40, aug, seed=7 + aug)
    t = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    leaves = [t[k].requires_grad_() for k in DIFF]
    num, den, ce, lse = tks.sampled_ce_fwd_plain(*t.values(), torch.float32)
    num.backward()
    got = tks.sampled_ce_bwd_plain(*(x.detach() for x in t.values()),
                                   lse.detach(), torch.tensor(1.0),
                                   torch.float32)
    for k, leaf, g in zip(DIFF, leaves, got):
        torch.testing.assert_close(g, leaf.grad, rtol=1e-4, atol=1e-6,
                                   msg=k)


def _embed_tables(seed):
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((V + 1, D)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(V + 1) * 0.1).astype(np.float32)
    return table, bias


@pytest.mark.parametrize("path", ["pure", "kernel_aug", "kernel"])
@pytest.mark.parametrize("dist", ["log_uniform", "uniform"])
def test_sampled_softmax_loss_matches_arec(path, dist):
    """The whole loss, pre-drawn negatives with hits, weighted: the port's
    fused path (its plain version on CPU) and pure path against arec's
    pure path, value and gradients to q and the table."""
    rng = np.random.default_rng(11)
    n = 40
    q = rng.standard_normal((n, D)).astype(np.float32)
    true_ids = rng.integers(0, V, n).astype(np.int32)
    sampled_ids = np.concatenate([true_ids[:8], rng.integers(0, V, S - 8)]
                                 ).astype(np.int32)
    w = rng.integers(0, 2, n).astype(np.float32)
    table, bias = _embed_tables(12)
    taug = np.concatenate([table, bias[:, None]], axis=1)
    jp = (js.log_uniform_prob(jnp.asarray(sampled_ids), V)
          if dist == "log_uniform" else jnp.full((S,), 1.0 / V))

    def jloss(q, taug):
        return jl.sampled_softmax_loss(
            q, jnp.asarray(true_ids),
            lambda i: (taug[i, :D], taug[i, D]), None, S, V, dist=dist,
            weights=jnp.asarray(w), compute_dtype=jnp.float32,
            sampled=(jnp.asarray(sampled_ids), jp), use_kernel=False)

    want = jloss(jnp.asarray(q), jnp.asarray(taug))
    want_g = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q),
                                             jnp.asarray(taug))
    tq = torch.from_numpy(q).requires_grad_()
    tt = torch.from_numpy(taug).requires_grad_()
    tp = torch.from_numpy(np.array(jp))
    kw = {}
    if path == "kernel_aug":
        kw["embed_raw"] = lambda i: tt[i]
    got = tl.sampled_softmax_loss(
        tq, torch.from_numpy(true_ids), lambda i: (tt[i, :D], tt[i, D]),
        None, S, V, dist=dist, weights=torch.from_numpy(w),
        compute_dtype=torch.float32,
        sampled=(torch.from_numpy(sampled_ids), tp),
        use_kernel=path != "pure", **kw)
    np.testing.assert_allclose(got.item(), float(want), **VAL)
    got.backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(want_g[0]),
                               **GRAD)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want_g[1]),
                               **GRAD)


# the card tests' tile edges of the bf16 kernels, small: N off the 64-row
# tile, S < 64 and off the 64-column tile, D off the MMA depth 16, D = 256,
# and rows that all weigh 0
EDGES = [(65, 63, 17, False), (77, 40, 40, False), (33, 100, 129, False),
         (20, 70, 256, False), (40, 32, 16, True)]


@pytest.mark.parametrize("aug", [0, 1])
@pytest.mark.parametrize("n,s,d,weightless", EDGES)
def test_plain_versions_match_pallas_at_tile_edges(n, s, d, weightless, aug):
    """The plain versions, which the card tests hold the kernels to at these
    edges, against arec's Pallas kernel: (Σ w·ce, Σ w) and the gradients of
    num + 0.5·den to every differentiable input, weighted, with hits."""
    a = _inputs(n, aug, seed=n + d + aug, d=d, s=s)
    if weightless:
        a["weights"][:] = 0.0
    diff = DIFF + ("weights",)

    def jfn(*xs):
        kw = dict(a, **dict(zip(diff, xs)))
        return j_sums(kw["q"], kw["v_true"], kw["v_samp"], kw["c_samp"],
                      kw["tl_base"], jnp.asarray(a["true_ids"]),
                      jnp.asarray(a["sampled_ids"]), kw["weights"], 256,
                      jnp.float32)

    jxs = [jnp.asarray(a[k]) for k in diff]
    want_num, want_den = jfn(*jxs)
    want_g = jax.grad(lambda *xs: jfn(*xs)[0] + 0.5 * jfn(*xs)[1],
                      argnums=tuple(range(len(diff))))(*jxs)
    t = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    leaves = {k: t[k].requires_grad_() for k in diff}
    num, den = tks.fused_sampled_ce_sums(*t.values(), torch.float32)
    np.testing.assert_allclose(num.item(), float(want_num), **VAL)
    np.testing.assert_allclose(den.item(), float(want_den), **VAL)
    (num + 0.5 * den).backward()
    for k, g in zip(diff, want_g):
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(g),
                                   err_msg=k, **GRAD)


def test_loss_under_a_mesh_raises(tmp_path):
    """`sampled_softmax_loss(mesh=)`, which raised until mesh training
    was ported, now runs: on a 2 x 2 mesh of gloo ranks, each rank its
    slab of the rows, the fused path (the sharded fused CE) and the pure
    path (the slabs' weighted means summed over "data") give arec's loss
    on the whole batch, and the gradients of q and of the candidates'
    table summed over the ranks give arec's."""
    from torch_mesh_worker import run_ranks

    rng = np.random.default_rng(17)
    n = 40
    q = rng.standard_normal((n, D)).astype(np.float32)
    true_ids = rng.integers(0, V, n).astype(np.int32)
    sampled_ids = np.concatenate([true_ids[:8], rng.integers(0, V, S - 8)]
                                 ).astype(np.int32)
    w = rng.integers(0, 2, n).astype(np.float32)
    table, bias = _embed_tables(18)
    taug = np.concatenate([table, bias[:, None]], axis=1)
    jp = js.log_uniform_prob(jnp.asarray(sampled_ids), V)

    def jloss(q, taug):
        return jl.sampled_softmax_loss(
            q, jnp.asarray(true_ids),
            lambda i: (taug[i, :D], taug[i, D]), None, S, V,
            weights=jnp.asarray(w), compute_dtype=jnp.float32,
            sampled=(jnp.asarray(sampled_ids), jp), use_kernel=False)

    want = jloss(jnp.asarray(q), jnp.asarray(taug))
    want_g = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q),
                                             jnp.asarray(taug))
    inputs = dict(q=q, true_ids=true_ids, weights=w, taug=taug,
                  sampled_ids=sampled_ids, p=np.asarray(jp))
    cases = [dict(mesh=(2, 2), inputs=inputs, S=S, V=V, dist="log_uniform",
                  use_kernel=k) for k in (True, False)]
    res = run_ranks("ce_loss_mesh", 4, tmp_path, {"cases": cases})
    for i, c in enumerate(cases):
        for r in res:
            np.testing.assert_allclose(r[i]["loss"], float(want), **VAL)
        got_q = np.concatenate([res[0][i]["q"], res[2][i]["q"]])
        np.testing.assert_allclose(got_q, np.asarray(want_g[0]), **GRAD)
        np.testing.assert_allclose(res[0][i]["taug"], np.asarray(want_g[1]),
                                   **GRAD)


def test_full_softmax_loss_matches_arec():
    rng = np.random.default_rng(13)
    q = rng.standard_normal((24, D)).astype(np.float32)
    items = rng.standard_normal((V, D)).astype(np.float32) * 0.3
    bias = rng.standard_normal(V).astype(np.float32) * 0.1
    ids = rng.integers(0, V, 24).astype(np.int32)
    w = rng.integers(0, 2, 24).astype(np.float32)
    want = jl.full_softmax_loss(*map(jnp.asarray, (q, ids, items, bias, w)),
                                compute_dtype=jnp.float32)
    got = tl.full_softmax_loss(*map(torch.from_numpy, (q, ids, items, bias,
                                                       w)),
                               compute_dtype=torch.float32)
    np.testing.assert_allclose(float(got), float(want), **VAL)


def test_sampler_probabilities_match_arec():
    ids = np.array([0, 1, 2, 17, 999, 1299, 1_299_999], np.int32)
    for vocab in (1300, 1_300_000):
        v_ids = np.minimum(ids, vocab - 1)
        np.testing.assert_allclose(
            ts.log_uniform_prob(torch.from_numpy(v_ids), vocab).numpy(),
            np.asarray(js.log_uniform_prob(jnp.asarray(v_ids), vocab)),
            rtol=1e-6)
        np.testing.assert_allclose(
            tl._p_of(torch.from_numpy(v_ids), vocab, "uniform").numpy(),
            np.asarray(jl._p_of(jnp.asarray(v_ids), vocab, "uniform")))
    freq = np.array([50, 20, 20, 5, 0, 1], np.int64)
    jcdf, jprobs = js.make_pop(freq, 0.75)
    tcdf, tprobs = ts.make_pop(freq, 0.75)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=1e-6)
    np.testing.assert_allclose(tcdf.numpy(), np.asarray(jcdf), rtol=1e-6)
    pids = torch.tensor([0, 3, 5])
    np.testing.assert_allclose(
        ts.pop_prob(pids, (tcdf, tprobs)).numpy(),
        np.asarray(js.pop_prob(jnp.asarray(pids.numpy()), (jcdf, jprobs))),
        rtol=1e-6)


@pytest.mark.parametrize("dist", ["log_uniform", "uniform", "pop"])
def test_draws_are_in_range_with_their_probabilities(dist):
    """Draws from a generator: ids in [0, V), p equal to the sampler's own
    probability of each id, the same generator seed drawing the same ids,
    and log-uniform favouring low (frequent) ids."""
    from arec_torch.rng import generator

    pop = ts.make_pop(np.arange(V, 0, -1)) if dist == "pop" else None
    ids, p = ts.draw(generator(3), 4096, V, dist, pop)
    again, _ = ts.draw(generator(3), 4096, V, dist, pop)
    assert torch.equal(ids, again)
    assert ids.dtype == torch.int32 and 0 <= int(ids.min()) <= int(ids.max()) < V
    torch.testing.assert_close(p, tl._p_of(ids, V, dist, pop))
    if dist == "log_uniform":
        assert (ids < V // 10).float().mean() > 0.5
    with pytest.raises(ValueError, match="unknown sampler"):
        ts.draw(generator(3), 4, V, "zipf")
