"""arec_torch sequence training vs arec's: `seq_loss` value and gradients
to every parameter on a small syn_lstm model (attribute fusion; LSTM, and
GRU on the kernel path), for the kernel path (arec: Pallas scan + fused CE in interpret mode; the port: its
autograd Functions, taking their plain versions on the CPU) and the plain
path, one and two train segments, tied and untied output, pre-drawn
negatives, keep_prob = 1; and 20 `make_train_step` Adagrad steps from
arec's bridged TrainState leaving the parameters and accumulators allclose
to arec's (its plain scan and plain CE, to keep the JAX side quick).

Weights are arec's init handed over through the bridge; batches are
seq_batches' numpy arrays on both sides; negatives are numpy-drawn.
f32 throughout: values at tests/test_seq.py's forward tolerance (rtol
1e-4, atol 1e-5), gradients at its gradient tolerance (rtol 2e-3, atol
2e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arec.config import Config, DataConfig, ModelConfig, TrainConfig
from arec.data.dataset import seq_batches
from arec.data.synthetic import generate
from arec.losses.sampling import log_uniform_prob
from arec.models import seq as jseq
from arec.tables.engine import attrs_to_device as j_attrs
from arec.train import step as jstep
from arec_torch import bridge
from arec_torch.config import Config as TConfig
from arec_torch.data.synthetic import generate as tgenerate
from arec_torch.models import seq as tseq
from arec_torch.rng import generator
from arec_torch.tables.engine import attrs_to_device as t_attrs
from arec_torch.train import step as tstep

torch.set_num_threads(1)

DATA = DataConfig(syn_users=60, syn_items=90, syn_interactions=1500)
L, B, S = 5, 6, 24
VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-3, atol=2e-4)


def _setup(**model):
    cfg = Config(data=DATA,
                 model=ModelConfig(model="lstm", dim=16, max_seq_len=L,
                                   dense_vocab_threshold=16, **model),
                 train=TrainConfig(compute_dtype="float32", num_sampled=S,
                                   batch_size=B, learning_rate=0.5))
    ds, tds = generate(DATA), tgenerate(DATA)
    jspec = jseq.SeqSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    tspec = tseq.SeqSpec.from_config(TConfig.from_json(cfg.to_json()),
                                     tds.user_schema, tds.item_schema)
    jparams = jseq.init_seq(jax.random.key(5), jspec)
    jdev = j_attrs(ds.item_attrs.restrict(jspec.item_in.schema),
                   jspec.item_in)
    tdev = t_attrs(tds.item_attrs.restrict(tspec.item_in.schema),
                   tspec.item_in)
    return cfg, ds, jspec, tspec, jparams, jdev, tdev


def _negatives(vocab, seed):
    ids = np.random.default_rng(seed).integers(0, vocab, S).astype(np.int32)
    return ids, np.array(log_uniform_prob(jnp.asarray(ids), vocab))


VARIANTS = {
    "kernel_1seg_untied": dict(model=dict(use_pallas_scan=True),
                               use_kernel=True, time_major=True),
    "kernel_2seg_untied": dict(model=dict(use_pallas_scan=True,
                                          train_segments=2),
                               use_kernel=True, time_major=False),
    "kernel_1seg_tied": dict(model=dict(use_pallas_scan=True,
                                        tie_output=True),
                             use_kernel=True, time_major=True),
    "plain_1seg_untied": dict(model=dict(use_pallas_scan=False),
                              use_kernel=False, time_major=False),
    "plain_2seg_tied": dict(model=dict(use_pallas_scan=False,
                                       train_segments=2, tie_output=True),
                            use_kernel=False, time_major=True),
    "gru_kernel_1seg_untied": dict(model=dict(cell="gru",
                                              use_pallas_scan=True),
                                   use_kernel=True, time_major=True),
    "gru_kernel_2seg_tied": dict(model=dict(cell="gru", use_pallas_scan=True,
                                            train_segments=2,
                                            tie_output=True),
                                 use_kernel=True, time_major=False),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_seq_loss_and_gradients_match_arec(name):
    v = VARIANTS[name]
    cfg, ds, jspec, tspec, jparams, jdev, tdev = _setup(**v["model"])
    assert tspec.pack_len == jspec.pack_len
    batch = next(seq_batches(ds, B, jspec.pack_len, seed=1, epoch=0))
    ids, p = _negatives(jspec.vocab, seed=len(name))

    def jloss(params):
        return jseq.seq_loss(params, jspec, jdev, None,
                             {k: jnp.asarray(x) for k, x in batch.items()},
                             jax.random.key(0),
                             sampled=(jnp.asarray(ids), jnp.asarray(p)),
                             use_kernel=v["use_kernel"],
                             time_major=v["time_major"])

    want, want_g = jax.value_and_grad(jloss)(jparams)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    leaves = tstep._leaves(tparams)
    for t in leaves:
        t.requires_grad_()
    got = tseq.seq_loss(tparams, tspec, tdev, None,
                        {k: torch.from_numpy(x) for k, x in batch.items()},
                        generator(0),
                        sampled=(torch.from_numpy(ids), torch.from_numpy(p)),
                        use_kernel=v["use_kernel"],
                        time_major=v["time_major"])
    np.testing.assert_allclose(got.item(), float(want), **VAL)
    got.backward()
    jleaves = jax.tree.leaves(want_g)
    assert len(jleaves) == len(leaves)
    for i, (t, w) in enumerate(zip(leaves, jleaves)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=f"leaf {i}", **GRAD)


def test_twenty_adagrad_steps_match_arec():
    """make_train_step × 20 from arec's bridged TrainState: the port on its
    kernel path (plain versions on the CPU), arec on its plain path, the
    same batches and per-step negatives; an lr decay after step 10."""
    cfg, ds, jspec, tspec, jparams, jdev, tdev = _setup(use_pallas_scan=True)
    batches = list(seq_batches(ds, B, L, seed=2, epoch=0))
    while len(batches) < 20:
        batches += batches
    negs = [_negatives(jspec.vocab, seed=100 + i) for i in range(20)]

    jspec_plain = jspec.__class__(**{**jspec.__dict__,
                                     "use_pallas_scan": False})

    def jloss(params, batch, rng):
        return jseq.seq_loss(params, jspec_plain, jdev, None,
                             {k: batch[k] for k in ("inputs", "targets",
                                                    "mask")},
                             rng, sampled=(batch["neg"], batch["p"]),
                             use_kernel=False, time_major=True)

    def tloss(params, batch, gen):
        return tseq.seq_loss(params, tspec, tdev, None, batch, gen,
                             sampled=(batch["neg"], batch["p"]),
                             use_kernel=True, time_major=True)

    jopt = jstep.make_optimizer("adagrad", cfg.train.learning_rate)
    jstate = jstep.init_state(jparams, jopt)
    tstate = bridge.train_state_from_arec(jax.tree.map(np.asarray, jstate))
    jfn = jstep.make_train_step(jloss, jopt, cfg.train.learning_rate,
                                donate=False)
    tfn = tstep.make_train_step(
        tloss, tstep.make_optimizer("adagrad", cfg.train.learning_rate),
        cfg.train.learning_rate)
    for i, (batch, (ids, p)) in enumerate(zip(batches[:20], negs)):
        jb = {k: jnp.asarray(batch[k]) for k in ("inputs", "targets", "mask")}
        jb.update(neg=jnp.asarray(ids), p=jnp.asarray(p))
        tb = {k: torch.from_numpy(batch[k]) for k in ("inputs", "targets",
                                                      "mask")}
        tb.update(neg=torch.from_numpy(ids), p=torch.from_numpy(p))
        jstate, jm = jfn(jstate, jb, jax.random.key(i))
        tstate, tm = tfn(tstate, tb, tstep.step_generator(0, i))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   **VAL)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-3)
        if i == 9:
            jstate = jstep.decay_lr(jstate, 0.5)
            tstate = tstep.decay_lr(tstate, 0.5)
    assert int(tstate.step) == int(jstate.step) == 20
    np.testing.assert_allclose(float(tstate.opt_state["learning_rate"]),
                               float(jstate.opt_state.hyperparams[
                                   "learning_rate"]))
    jacc = jstate.opt_state.inner_state[0].sum_of_squares
    for name, tree_t, tree_j in (("params", tstate.params, jstate.params),
                                 ("acc", tstate.opt_state["sum_of_squares"],
                                  jacc)):
        for i, (t, w) in enumerate(zip(tstep._leaves(tree_t),
                                       jax.tree.leaves(tree_j))):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name} {i}")
