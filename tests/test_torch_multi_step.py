"""arec_torch's K-step dispatch (`train/graph.py`, `make_multi_step`,
`make_sparse_multi_step`) against arec's.

First the port's multi-steps at K = 4 against arec's `make_multi_step` /
`make_sparse_multi_step` (one jitted `lax.scan` each) over two dispatches
with an lr decay between them: a small c4-like LSTM (attribute fusion,
untied output, Adagrad; the port on its kernel path, plain versions on
the CPU; arec on its plain path) and a small MF with the sparse
touched-rows step. Weights are arec's init through the bridge; batches are
the same numpy arrays; negatives are numpy-drawn and handed to both sides
(the LSTM's in the batch, the sparse step's through each module's `draw`,
which picks the step's draw by its key). Tolerances are those of
tests/test_torch_seq_loss.py (values rtol 1e-4 / atol 1e-5, grad_norm
rtol 1e-3, params and accumulators rtol 1e-4 / atol 1e-5) and
tests/test_torch_sparse.py (loss rtol 1e-5, params rtol 2e-5 / atol
1e-6).

Then the runner's host side on the CPU: `Emulated` stands in for the
card's side of `scan_multi` (a capture runs the K steps' Python and puts
every state leaf back, as a capture runs nothing; a replay runs them again
over the static inputs with the graph's generators as the runner seeded
them, and puts the launch counters back, as a replay runs no Python), so
the keys reaching each slot, the staging into the static inputs, the
cloned [K] metrics, the in-place `step` / `lr_scale`, the refusal of a
leaf replaced after the capture, of a leaf returned at a new address or of
a generator not derived from the key, and the launch counters are all
held here; replays of the LSTM with keep_prob 0.8 and two checkpointed
segments, and of the sparse MF step, equal the eager steps
bit for bit."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arec.train.sparse as jsparse
import arec_torch.train.sparse as tsparse
from arec.config import Config, DataConfig, ModelConfig, TrainConfig
from arec.data.dataset import mf_batches, seq_batches
from arec.data.synthetic import generate
from arec.losses.sampling import log_uniform_prob
from arec.models import mf as jmf
from arec.models import seq as jseq
from arec.tables import engine as je
from arec.train import step as jstep
from arec_torch import bridge, rng
from arec_torch.config import Config as TConfig
from arec_torch.data.synthetic import generate as tgenerate
from arec_torch.kernels import gru_scan as tgru
from arec_torch.kernels import lstm_scan as tk
from arec_torch.kernels import row_scatter as trs
from arec_torch.kernels import sampled_softmax as tsm
from arec_torch.models import mf as tmf
from arec_torch.models import seq as tseq
from arec_torch.tables import engine as te
from arec_torch.train import graph
from arec_torch.train import step as tstep

torch.set_num_threads(1)

DATA = DataConfig(syn_users=120, syn_items=90, syn_interactions=2500)
K = 4
L, B, S = 5, 6, 24
VAL = dict(rtol=1e-4, atol=1e-5)
STATE = dict(rtol=1e-4, atol=1e-5)
SPARSE = dict(rtol=2e-5, atol=1e-6)


def _seq_cfg(**model):
    return Config(data=DATA,
                  model=ModelConfig(model="lstm", dim=16, max_seq_len=L,
                                    dense_vocab_threshold=16, **model),
                  train=TrainConfig(compute_dtype="float32", num_sampled=S,
                                    batch_size=B, learning_rate=0.5))


def _mf_cfg(optimizer="adagrad"):
    return Config(data=DATA,
                  model=ModelConfig(model="mf", dim=16, use_attributes=True,
                                    dense_vocab_threshold=12),
                  train=TrainConfig(batch_size=32, num_sampled=S,
                                    optimizer=optimizer, learning_rate=0.2,
                                    compute_dtype="float32"))


def _seq(cfg):
    ds, tds = generate(cfg.data), tgenerate(cfg.data)
    jspec = jseq.SeqSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    tspec = tseq.SeqSpec.from_config(TConfig.from_json(cfg.to_json()),
                                     tds.user_schema, tds.item_schema)
    jdev = je.attrs_to_device(ds.item_attrs.restrict(jspec.item_in.schema),
                              jspec.item_in)
    tdev = te.attrs_to_device(tds.item_attrs.restrict(tspec.item_in.schema),
                              tspec.item_in)
    return ds, jspec, tspec, jseq.init_seq(jax.random.key(5), jspec), \
        jdev, tdev


def _mf(cfg):
    ds, tds = generate(cfg.data), tgenerate(cfg.data)
    jspec = jmf.MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    tspec = tmf.MFSpec.from_config(TConfig.from_json(cfg.to_json()),
                                   tds.user_schema, tds.item_schema)

    def devs(attrs_to_device, d, spec):
        return (attrs_to_device(d.user_attrs.restrict(spec.user.schema),
                                spec.user),
                attrs_to_device(d.item_attrs.restrict(spec.item.schema),
                                spec.item))
    return ds, jspec, tspec, jmf.init_mf(jax.random.key(0), jspec), \
        devs(je.attrs_to_device, ds, jspec), \
        devs(te.attrs_to_device, tds, tspec)


def _negatives(vocab, seed):
    ids = np.random.default_rng(seed).integers(0, vocab, S).astype(np.int32)
    return ids, np.array(log_uniform_prob(jnp.asarray(ids), vocab))


def _groups(batches, n):
    while len(batches) < n * K:
        batches = batches + batches
    return [batches[i * K:(i + 1) * K] for i in range(n)]


def _close(got, want, err, **tol):
    g, w = tstep._leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), err
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"{err} {i}", **tol)


# ---------------------------------------------------------------------------
# The multi-steps against arec's
# ---------------------------------------------------------------------------

def test_lstm_multi_step_matches_arecs():
    """Two dispatches of K = 4 (the first of K batch dicts, the second of
    one stacked dict), `decay_lr` between them: each step's loss, lr and
    grad_norm, then the params, accumulators, lr and step."""
    cfg = _seq_cfg(use_pallas_scan=True)
    ds, jspec, tspec, jparams, jdev, tdev = _seq(cfg)
    groups = _groups(list(seq_batches(ds, B, L, seed=2, epoch=0)), 2)
    jplain = dataclasses.replace(jspec, use_pallas_scan=False)
    keys = ("inputs", "targets", "mask")

    def jloss(params, batch, key):
        return jseq.seq_loss(params, jplain, jdev, None,
                             {k: batch[k] for k in keys}, key,
                             sampled=(batch["neg"], batch["p"]),
                             use_kernel=False, time_major=True)

    def tloss(params, batch, gen):
        return tseq.seq_loss(params, tspec, tdev, None, batch, gen,
                             sampled=(batch["neg"], batch["p"]),
                             use_kernel=True, time_major=True)

    lr = cfg.train.learning_rate
    jopt = jstep.make_optimizer("adagrad", lr)
    jstate = jstep.init_state(jparams, jopt)
    tstate = bridge.train_state_from_arec(jax.tree.map(np.asarray, jstate))
    jmulti = jstep.make_multi_step(jloss, jopt, lr, donate=False)
    tmulti = tstep.make_multi_step(tloss, tstep.make_optimizer("adagrad", lr),
                                   lr, K)
    for d, group in enumerate(groups):
        host = []
        for i, batch in enumerate(group):
            ids, p = _negatives(jspec.vocab, seed=100 + d * K + i)
            host.append({**{k: batch[k] for k in keys}, "neg": ids, "p": p})
        stacked = {k: np.stack([h[k] for h in host]) for k in host[0]}
        jstate, jm = jmulti(jstate, jax.tree.map(jnp.asarray, stacked),
                            jax.vmap(jax.random.key)(
                                jnp.arange(d * K, (d + 1) * K)))
        tb = ([bridge.to_torch(h) for h in host] if d == 0
              else bridge.to_torch(stacked))
        tstate, tm = tmulti(tstate, tb, [tstep.step_generator(0, d * K + i)
                                         for i in range(K)])
        assert {k: tuple(v.shape) for k, v in tm.items()} == {
            "loss": (K,), "lr": (K,), "grad_norm": (K,)}
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                                   **VAL)
        np.testing.assert_allclose(tm["lr"].numpy(), np.asarray(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]), rtol=1e-3)
        if d == 0:
            jstate = jstep.decay_lr(jstate, 0.5)
            tstate = tstep.decay_lr(tstate, 0.5)
    assert int(tstate.step) == int(jstate.step) == 2 * K
    assert float(tstate.lr_scale) == float(jstate.lr_scale) == 0.5
    np.testing.assert_allclose(
        float(tstate.opt_state["learning_rate"]),
        float(jstate.opt_state.hyperparams["learning_rate"]), rtol=1e-6)
    _close(tstate.params, jstate.params, "params", **STATE)
    _close(tstate.opt_state["sum_of_squares"],
           jstate.opt_state.inner_state[0].sum_of_squares, "acc", **STATE)


def _hand_in_draws(monkeypatch, jkeys, tgens, vocab):
    """Each side's sparse `draw` returns the draw of the step whose key it
    was given: arec's matches the negatives key (split(key)[1]) against the
    steps' in the traced scan, the port's the generator's seed."""
    draws = [_negatives(vocab, seed=200 + i) for i in range(len(jkeys))]
    ids = np.stack([d[0] for d in draws])
    p = np.stack([d[1] for d in draws])
    jneg = jnp.stack([jax.random.key_data(jax.random.split(k)[1])
                      for k in jkeys])
    tneg = [rng.split(g)[1].initial_seed() for g in tgens]

    def jdraw(key, *a, **kw):
        i = jnp.argmax(jnp.all(jax.random.key_data(key) == jneg, axis=1))
        return jnp.asarray(ids)[i], jnp.asarray(p)[i]

    def tdraw(gen, *a, **kw):
        i = tneg.index(gen.initial_seed())
        return torch.from_numpy(ids[i]), torch.from_numpy(p[i])

    monkeypatch.setattr(jsparse, "draw", jdraw)
    monkeypatch.setattr(tsparse, "draw", tdraw)


def test_mf_sparse_multi_step_matches_arecs(monkeypatch):
    cfg = _mf_cfg()
    ds, jspec, tspec, jparams, jdevs, tdevs = _mf(cfg)
    groups = _groups(list(mf_batches(ds, 32, 0, 0)), 2)
    lr = cfg.train.learning_rate
    jkeys = [jax.random.key(i) for i in range(2 * K)]
    tgens = [tstep.step_generator(0, i) for i in range(2 * K)]
    _hand_in_draws(monkeypatch, jkeys, tgens,
                   jspec.item.schema.num_entities)
    jopt = jstep.make_optimizer("adagrad", lr)
    jpaths = jsparse.table_paths(False, jspec)
    jstate = jsparse.init_sparse_state(jparams, jpaths, jopt, "adagrad")
    tstate = bridge.sparse_train_state_from_arec(
        jax.tree.map(np.asarray, jstate))
    jmulti = jsparse.make_sparse_multi_step(False, jspec, *jdevs, jopt, lr,
                                            "adagrad")
    tmulti = tsparse.make_sparse_multi_step(
        False, tspec, *tdevs, tstep.make_optimizer("adagrad", lr), lr,
        "adagrad", k=K)
    for d, group in enumerate(groups):
        stacked = {k: np.stack([b[k] for b in group]) for k in group[0]}
        jstate, jm = jmulti(jstate, jax.tree.map(jnp.asarray, stacked),
                            jnp.stack(jkeys[d * K:(d + 1) * K]))
        tstate, tm = tmulti(tstate, [bridge.to_torch(b) for b in group],
                            tgens[d * K:(d + 1) * K])
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                                   rtol=1e-5)
        if d == 0:
            jstate = jstep.decay_lr(jstate, 0.5)
            tstate = tstep.decay_lr(tstate, 0.5)
    assert int(tstate.step) == int(jstate.step) == 2 * K
    _close(tstate.params, jstate.params, "params", **SPARSE)
    _close(tstate.opt_state["rest"]["sum_of_squares"],
           jstate.opt_state["rest"].inner_state[0].sum_of_squares,
           "rest acc", **SPARSE)


# ---------------------------------------------------------------------------
# The runner's host side, the card's side emulated
# ---------------------------------------------------------------------------

COUNTED = (tk.lstm_layer, tk.lstm_layer_bwd, tgru.gru_layer,
           tgru.gru_layer_bwd, tsm.sampled_ce_fwd, tsm.sampled_ce_bwd,
           trs.row_scatter)                # every wrapper's `launches`


class Emulated(graph.scan_multi):
    """scan_multi with the card's side emulated on the CPU: a capture runs
    the K steps' Python (under the capture's KeyTrace) and puts every state
    leaf back as it was; a replay runs them again over the static inputs
    with the graph's generators, as the runner seeded them, writes the
    metrics into the captured [K] outputs and puts the launch counters
    back (a replay runs no Python)."""

    trace_device = "cpu"

    def _on_card(self, leaf):
        return True

    def _warm_up_stream(self, dev):
        return contextlib.nullcontext()

    def _new_graph(self, pool):
        return {}

    @contextlib.contextmanager
    def _captured(self, g, state):
        leaves = tstep._leaves(state._asdict())
        saved = [t.clone() for t in leaves]
        g["state"] = state
        yield
        for t, s in zip(leaves, saved):
            t.copy_(s)

    def _launch(self, g, roots):
        gens = [torch.Generator().manual_seed(r) for r in roots]
        trace = rng.KeyTrace(roots, "capture", self._paths, self._pool,
                             "cpu")
        counts = [fn.launches for fn in COUNTED]
        _, out = self._steps(g["state"], self._views, gens, trace)
        for fn, n in zip(COUNTED, counts):
            fn.launches = n
        for key, v in out.items():
            self._out[key].copy_(v)


def _port_seq(lr=0.5, sampled=None, **model):
    """A port-only LSTM: (state, core, its epoch's host batches);
    `sampled`: negatives handed to every step."""
    cfg = TConfig.from_json(_seq_cfg(**model).to_json())
    tds = tgenerate(cfg.data)
    spec = tseq.SeqSpec.from_config(cfg, tds.user_schema, tds.item_schema)
    idev = te.attrs_to_device(tds.item_attrs.restrict(spec.item_in.schema),
                              spec.item_in)
    from arec_torch.data.dataset import seq_batches as tseq_batches

    def loss_fn(p, batch, gen):
        return tseq.seq_loss(p, spec, idev, None, batch, gen, sampled=sampled,
                             time_major=True)

    opt = tstep.make_optimizer("adagrad", lr)
    params = tseq.init_seq(torch.Generator().manual_seed(3), spec)
    batches = list(tseq_batches(tds, B, spec.pack_len, 1, 0))
    return (tstep.init_state(params, opt),
            tstep.make_step_core(loss_fn, opt, lr), batches)


def _port_mf():
    cfg = TConfig.from_json(_mf_cfg().to_json())
    tds = tgenerate(cfg.data)
    spec = tmf.MFSpec.from_config(cfg, tds.user_schema, tds.item_schema)
    udev = te.attrs_to_device(tds.user_attrs.restrict(spec.user.schema),
                              spec.user)
    idev = te.attrs_to_device(tds.item_attrs.restrict(spec.item.schema),
                              spec.item)
    from arec_torch.data.dataset import mf_batches as tmf_batches
    opt = tstep.make_optimizer("adagrad", 0.2)
    params = tmf.init_mf(torch.Generator().manual_seed(4), spec)
    paths = tsparse.table_paths(False, spec)
    state = tsparse.init_sparse_state(params, paths, opt, "adagrad")
    core = tsparse.make_sparse_step_core(False, spec, udev, idev, opt, 0.2,
                                         "adagrad")
    return state, core, list(tmf_batches(tds, 32, 0, 0))


def _clone_state(state):
    return type(state)(*(tstep.tree_map(torch.clone, x) for x in state))


def _eager(state, core, batches, steps):
    metrics = []
    for i in range(steps):
        state, m = core(state, bridge.to_torch(batches[i % len(batches)]),
                        tstep.step_generator(0, i))
        metrics.append(m)
    return state, metrics


def _dispatches(multi, state, batches, n):
    out = []
    for d in range(n):
        group = [bridge.to_torch(batches[(d * K + i) % len(batches)])
                 for i in range(K)]
        state, m = multi(state, group, [tstep.step_generator(0, d * K + i)
                                        for i in range(K)])
        out.append(m)
    return state, out


def _assert_equal_runs(state_a, metrics_a, state_b, metrics_b):
    for a, b in zip(tstep._leaves(state_a._asdict()),
                    tstep._leaves(state_b._asdict())):
        assert torch.equal(a, b)
    for i, m in enumerate(metrics_a):
        for key, v in m.items():
            assert torch.equal(metrics_b[i // K][key][i % K], v), (i, key)


@pytest.mark.parametrize("case", ["lstm_dropout_2seg", "mf_sparse"])
def test_replays_equal_eager_steps(case):
    """Three dispatches (warm-up and capture, then two replays) against
    3K eager steps from the same state: every leaf and metric bit for bit,
    so each replay's slots drew from their own step's keys (the LSTM's
    dropout in both checkpointed segments, the MF step's negatives)."""
    if case == "mf_sparse":
        state, core, batches = _port_mf()
    else:
        state, core, batches = _port_seq(keep_prob=0.8, train_segments=2)
    want_state, want = _eager(_clone_state(state), core, batches, 3 * K)
    multi = Emulated(core, K)
    got_state, got = _dispatches(multi, state, batches, 3)
    assert (multi.captures, multi.replays) == (1, 2)
    assert int(got_state.step) == 3 * K
    _assert_equal_runs(want_state, want, got_state, got)


def test_dropout_masks_differ_between_replays():
    """keep_prob 0.8, lr 0 (the params stay as they are), one batch and
    one set of negatives in every step: the losses differ only through the
    dropout masks, and they differ between the slots and the replays."""
    ids, p = _negatives(91, seed=9)
    state, core, batches = _port_seq(
        lr=0.0, sampled=(torch.from_numpy(ids), torch.from_numpy(p)),
        keep_prob=0.8)
    multi = Emulated(core, K)
    _, out = _dispatches(multi, state, [batches[0]] * K, 3)
    losses = torch.cat([m["loss"] for m in out[1:]]).tolist()
    assert len(set(losses)) == 2 * K, losses


def test_each_slot_gets_its_steps_key():
    """A KeyTrace over the roots of steps s..s+K-1: each derived generator
    is logged with (slot, data...) and `derive` rebuilds its seed from the
    roots alone, for other roots too."""
    keys = [tstep.step_generator(3, 40 + i) for i in range(K)]
    roots = [g.initial_seed() for g in keys]
    trace = rng.KeyTrace(roots, "record", device_type="cpu")
    made = []
    with rng.key_trace(trace):
        for key in keys:
            g_drop, g_neg = rng.split(key)
            made += [g_drop, g_neg, rng.fold_in(g_drop, 7)]
    assert trace.paths == [p for i in range(K)
                           for p in ((i, 0), (i, 1), (i, 0, 7))]
    assert rng.derive(roots, trace.paths) == [g.initial_seed() for g in made]
    other = [tstep.step_generator(3, 80 + i) for i in range(K)]
    want = [s for g in other for s in (
        rng.split(g)[0].initial_seed(), rng.split(g)[1].initial_seed(),
        rng.fold_in(rng.split(g)[0], 7).initial_seed())]
    assert rng.derive([g.initial_seed() for g in other], trace.paths) == want


def test_a_generator_not_derived_from_the_key_raises():
    def core(state, batch, gen):
        rng.generator(12345)
        return state, {"loss": torch.zeros(())}

    state, _, batches = _port_mf()
    with pytest.raises(RuntimeError, match="does not derive"):
        _dispatches(Emulated(core, K), state, batches, 1)


def test_static_inputs_and_cloned_metrics():
    """The static inputs hold the dispatch's batches stacked (from K dicts
    or one stacked dict); the metrics handed out are clones that the next
    replay leaves as they were."""
    state, core, batches = _port_mf()
    multi = Emulated(core, K)
    state, _ = _dispatches(multi, state, batches, 1)
    group = [bridge.to_torch(batches[K + i]) for i in range(K)]
    stacked = {k: torch.stack([b[k] for b in group]) for k in group[0]}
    state, m1 = multi(state, stacked, [tstep.step_generator(0, K + i)
                                       for i in range(K)])
    for k, v in stacked.items():
        assert torch.equal(multi._inputs[k], v)
    held = {k: v.clone() for k, v in m1.items()}
    assert all(v.data_ptr() != multi._out[k].data_ptr()
               for k, v in m1.items())
    state, m2 = multi(state, group[::-1], [tstep.step_generator(0, 2 * K + i)
                                           for i in range(K)])
    assert all(torch.equal(m1[k], held[k]) for k in m1)
    assert not torch.equal(m1["loss"], m2["loss"])
    with pytest.raises(ValueError, match="leading axis"):
        multi(state, {k: v[:2] for k, v in stacked.items()},
              [tstep.step_generator(0, i) for i in range(K)])


def test_step_lr_and_learning_rate_update_in_place():
    state, core, batches = _port_seq()
    step, scale = state.step, state.lr_scale
    lr = state.opt_state["learning_rate"]
    state, _ = core(state, bridge.to_torch(batches[0]),
                    tstep.step_generator(0, 0))
    assert state.step is step and int(step) == 1
    assert state.opt_state["learning_rate"] is lr
    state = tstep.decay_lr(state, 0.5)
    assert state.lr_scale is scale and float(scale) == 0.5
    mstate, mcore, mbatches = _port_mf()
    step = mstate.step
    mstate, _ = mcore(mstate, bridge.to_torch(mbatches[0]),
                      tstep.step_generator(0, 0))
    assert mstate.step is step and int(step) == 1


def test_replaced_leaf_raises():
    """A leaf replaced after the capture (lr_scale made anew, as an old
    `decay_lr` did; a restore) or a batch of another shape raises, naming
    it, before anything is staged or replayed; a state updated in place
    (`decay_lr`) replays as eager steps with the same decay do."""
    state, core, batches = _port_mf()
    want_state, want = _eager(_clone_state(state), core, batches, K)
    want_state = tstep.decay_lr(want_state, 0.5)
    want_state, more = _eager_from(want_state, core, batches, K, 2 * K)
    multi = Emulated(core, K)
    state, got = _dispatches(multi, state, batches, 1)
    group = [bridge.to_torch(batches[K + i]) for i in range(K)]
    keys = [tstep.step_generator(0, K + i) for i in range(K)]
    with pytest.raises(ValueError, match="state leaf /lr_scale is not"):
        multi(state._replace(lr_scale=state.lr_scale * 0.5), group, keys)
    short = [{k: v[:-1] for k, v in b.items()} for b in group]
    with pytest.raises(ValueError, match="batch 0 .* is not"):
        multi(state, short, keys)
    assert (multi.captures, multi.replays) == (1, 0)
    state, m = multi(tstep.decay_lr(state, 0.5), group, keys)
    assert (multi.captures, multi.replays) == (1, 1)
    _assert_equal_runs(want_state, want + more, state, got + [m])


def _eager_from(state, core, batches, start, stop):
    metrics = []
    for i in range(start, stop):
        state, m = core(state, bridge.to_torch(batches[i % len(batches)]),
                        tstep.step_generator(0, i))
        metrics.append(m)
    return state, metrics


def test_a_leaf_returned_at_a_new_address_raises():
    state, core, batches = _port_mf()

    def old_core(st, batch, gen):
        st, m = core(st, batch, gen)
        return st._replace(step=st.step + 0), m

    with pytest.raises(RuntimeError, match="new address"):
        _dispatches(Emulated(old_core, K), state, batches, 1)


def test_launch_counters_count_the_warm_up_and_the_capture():
    """Launch counters count in Python: at the eager warm-up and at the
    capture, which records the launches into the graph; a replay runs no
    Python and adds nothing."""
    state, core, batches = _port_mf()

    def counting(st, batch, gen):
        tk.lstm_layer.launches += 2
        return core(st, batch, gen)

    tk.lstm_layer.launches = 0
    multi = Emulated(counting, K)
    state, _ = _dispatches(multi, state, batches, 1)
    assert tk.lstm_layer.launches == 2 * 2 * K   # warm-up and capture
    state, _ = _dispatches(multi, state, batches, 2)
    assert tk.lstm_layer.launches == 2 * 2 * K
    assert (multi.captures, multi.replays) == (1, 2)
    tk.lstm_layer.launches = 0


def test_sgd_write_back_drops_out_of_range_rows_without_a_mask():
    """The sparse SGD write-back adds an exact 0 for sentinel ids where it
    once masked them out (a boolean mask syncs with the host): the same
    table as the masked `index_add_`."""
    rng_ = np.random.default_rng(0)
    table = torch.from_numpy(rng_.standard_normal((20, 3)).astype(np.float32))
    uids = torch.tensor([2, 5, 19, 20, 20], dtype=torch.int32)
    g = torch.from_numpy(rng_.standard_normal((7, 3)).astype(np.float32))
    lr = torch.tensor(0.3)
    want = table.clone()
    idx = torch.cat([torch.arange(2, dtype=torch.int32), uids])
    ok = idx < 20
    want.index_add_(0, idx[ok].long(), (-lr * g)[ok])
    got = tsparse._apply_sgd(table.clone(), g, uids, 2, lr)
    assert torch.equal(got, want)
