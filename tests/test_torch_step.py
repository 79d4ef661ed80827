"""arec_torch train step pieces vs arec's: the hand-written optimizers
(adagrad, sgd, adam) against optax through arec's `make_step_core` over 5
updates with an lr decay in between; arec's TrainState carried across by
the bridge; and `seq_batches` / `eval_batches` yielding arec's arrays for
the same (seed, epoch, host)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arec.config import DataConfig
from arec.data import dataset as jds
from arec.data.synthetic import generate
from arec.train import step as jstep
from arec_torch import bridge
from arec_torch.data import dataset as tds
from arec_torch.data.synthetic import generate as tgenerate
from arec_torch.train import step as tstep

torch.set_num_threads(1)


def _params(rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"item_in": {"tables": {"__fused__": f(7, 5)}},
            "rnn": [{"w": f(6, 8), "b": f(8)}], "item_out": f(9, 4)}


@pytest.mark.parametrize("name", ["adagrad", "sgd", "adam"])
def test_optimizer_matches_optax(name):
    """5 steps of a linear loss Σ p·g_k (so the gradient is g_k, some
    entries zero), with lr_scale halved after step 2: params, loss,
    grad_norm and the optimizer state agree with optax's. The state is held
    to atol 1e-5 on O(1) values: XLA fuses adam's chain of divides and
    square roots into other roundings, a few f32 ulps per step."""
    rng = np.random.default_rng(1)
    params = _params(rng)
    gs = [jax.tree.map(lambda p: (rng.standard_normal(p.shape)
                                  * (rng.random(p.shape) > 0.3)
                                  ).astype(np.float32), params)
          for _ in range(5)]
    lr = 0.3

    def jloss(p, batch, rng):
        return sum(jnp.sum(a * b) for a, b in zip(jax.tree.leaves(p),
                                                  jax.tree.leaves(batch)))

    def tloss(p, batch, gen):
        return sum((a * b).sum() for a, b in zip(tstep._leaves(p),
                                                 tstep._leaves(batch)))

    jopt = jstep.make_optimizer(name, lr)
    jstate = jstep.init_state(jax.tree.map(jnp.asarray, params), jopt)
    tstate = bridge.train_state_from_arec(jax.tree.map(np.asarray, jstate))
    jfn = jax.jit(jstep.make_step_core(jloss, jopt, lr))
    tfn = tstep.make_step_core(tloss, tstep.make_optimizer(name, lr), lr)
    for k, g in enumerate(gs):
        jstate, jm = jfn(jstate, jax.tree.map(jnp.asarray, g), None)
        tstate, tm = tfn(tstate, bridge.to_torch(g), None)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
        if k == 1:
            jstate, tstate = jstep.decay_lr(jstate, 0.5), tstep.decay_lr(
                tstate, 0.5)
    want = bridge.train_state_from_arec(jax.tree.map(np.asarray, jstate))
    for a, b in zip(tstep._leaves(tstate), tstep._leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert set(tstate.opt_state) == set(want.opt_state)


def test_bridge_carries_adagrad_state():
    rng = np.random.default_rng(2)
    jopt = jstep.make_optimizer("adagrad", 0.5)
    jstate = jstep.decay_lr(jstep.init_state(
        jax.tree.map(jnp.asarray, _params(rng)), jopt), 0.25)
    st = bridge.train_state_from_arec(jax.tree.map(np.asarray, jstate))
    assert float(st.lr_scale) == 0.25 and int(st.step) == 0
    assert float(st.opt_state["learning_rate"]) == np.float32(0.5)
    for acc, p in zip(tstep._leaves(st.opt_state["sum_of_squares"]),
                      tstep._leaves(st.params)):
        assert acc.shape == p.shape and bool((acc == 0.1).all())
    assert st.params["rnn"][0]["w"].shape == (6, 8)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        tstep.make_optimizer("lamb", 0.1)


def test_step_generator_is_a_pure_function_of_seed_and_step():
    a = tstep.step_generator(3, 17).initial_seed()
    assert a == tstep.step_generator(3, 17).initial_seed()
    assert a != tstep.step_generator(3, 18).initial_seed()
    assert a != tstep.step_generator(4, 17).initial_seed()


DATA = DataConfig(syn_users=90, syn_items=70, syn_interactions=1400)


@pytest.mark.parametrize("seed,epoch,host,hosts", [(0, 0, 0, 1), (3, 2, 1, 2)])
def test_seq_and_eval_batches_match_arec(seed, epoch, host, hosts):
    ds, tds_ = generate(DATA), tgenerate(DATA)
    want = list(jds.seq_batches(ds, 16, 7, seed, epoch, host, hosts))
    got = list(tds.seq_batches(tds_, 16, 7, seed, epoch, host, hosts))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    for L in (0, 9):
        want = list(jds.eval_batches(ds, 32, L, host, hosts))
        got = list(tds.eval_batches(tds_, 32, L, host, hosts))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
