"""arec_torch's sparse touched-rows step vs arec's.

First the engine's subset helpers (`gather_row_ids`, `unique_rows`,
`gather_unique_bound`, `build_subset`, `subset_pos_map`,
`make_subset_lookup`) against arec's on the same ids; then the port's
`make_sparse_step_core` against arec's, un-jitted, for MF and the sequence
family, from arec's state carried across by the bridge, over 4 steps on
mf_batches / seq_batches; and the port's sparse step against the port's
dense step.

Negatives are handed to both sides by replacing each step module's `draw`
with one that returns the same numpy-made draw per step (arec/ is not
edited). Cases follow tests/test_sparse.py: Adagrad and SGD;
dense_vocab_threshold 512 (every small field in the dense prefix), 0
(every field on the gather path) and 12 (mixed: dense cat fields, gathered
mulhot fields with invalid slots); for the sequence family tie_output on
(with a user table) and off. f32; the parameters (and, packed, the Adagrad
accumulators) are held at tests/test_sparse.py's rtol 2e-5 / atol 1e-6,
each step's loss at rtol 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arec.train.sparse as jsparse
import arec_torch.train.sparse as tsparse
from arec.config import Config, DataConfig, ModelConfig, TrainConfig
from arec.data import dataset as jds
from arec.data.synthetic import generate
from arec.losses.sampling import log_uniform_prob
from arec.models import mf as jmf
from arec.models import seq as jseq
from arec.tables import engine as je
from arec.train import step as jstep
from arec_torch import bridge
from arec_torch.config import Config as TConfig
from arec_torch.data import dataset as tds
from arec_torch.data.synthetic import generate as tgenerate
from arec_torch.models import mf as tmf
from arec_torch.models import seq as tseq
from arec_torch.tables import engine as te
from arec_torch.train import step as tstep

torch.set_num_threads(1)

DATA = DataConfig(syn_users=120, syn_items=90, syn_interactions=2500)
STEPS = 4
PARAMS = dict(rtol=2e-5, atol=1e-6)


def _cfg(model, optimizer="adagrad", dense_threshold=512, loss="ce",
         **model_kw):
    return Config(
        data=DATA,
        model=ModelConfig(model=model, dim=16, use_attributes=True,
                          max_seq_len=6, use_pallas_scan=False,
                          dense_vocab_threshold=dense_threshold, **model_kw),
        train=TrainConfig(batch_size=32, num_sampled=24, loss=loss,
                          optimizer=optimizer, learning_rate=0.2,
                          compute_dtype="float32"))


def _mf(cfg):
    ds, tds_ = generate(cfg.data), tgenerate(cfg.data)
    jspec = jmf.MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    tspec = tmf.MFSpec.from_config(TConfig.from_json(cfg.to_json()),
                                   tds_.user_schema, tds_.item_schema)
    jdevs = (je.attrs_to_device(ds.user_attrs.restrict(jspec.user.schema),
                                jspec.user),
             je.attrs_to_device(ds.item_attrs.restrict(jspec.item.schema),
                                jspec.item))
    tdevs = (te.attrs_to_device(tds_.user_attrs.restrict(tspec.user.schema),
                                tspec.user),
             te.attrs_to_device(tds_.item_attrs.restrict(tspec.item.schema),
                                tspec.item))
    return ds, jspec, tspec, jmf.init_mf(jax.random.key(0), jspec), jdevs, \
        tdevs


def _seq(cfg):
    ds, tds_ = generate(cfg.data), tgenerate(cfg.data)
    jspec = jseq.SeqSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    tspec = tseq.SeqSpec.from_config(TConfig.from_json(cfg.to_json()),
                                     tds_.user_schema, tds_.item_schema)

    def devs(attrs_to_device, d, spec):
        item = attrs_to_device(d.item_attrs.restrict(spec.item_in.schema),
                               spec.item_in)
        user = (attrs_to_device(d.user_attrs.restrict(spec.user.schema),
                                spec.user) if spec.user is not None else None)
        return user, item

    return (ds, jspec, tspec, jseq.init_seq(jax.random.key(1), jspec),
            devs(je.attrs_to_device, ds, jspec),
            devs(te.attrs_to_device, tds_, tspec))


def _draws(vocab, n, seed):
    """n numpy-made log-uniform draws (ids, p) of 24 negatives."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, 24).astype(np.int32)
        out.append((ids, np.array(log_uniform_prob(jnp.asarray(ids),
                                                   vocab))))
    return out


def _hand_in(monkeypatch, module, draws, to):
    it = iter(draws)
    monkeypatch.setattr(module, "draw",
                        lambda *a, **k: tuple(map(to, next(it))))


def _assert_tree_close(got, want, **tol):
    """torch tree vs jax/numpy tree, leaf by leaf in sorted-key order."""
    g, w = tstep._leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == tuple(np.shape(b)), i
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   err_msg=f"leaf {i}", **tol)


def _run_both(monkeypatch, is_seq, cfg, batches):
    """STEPS steps of arec's and the port's sparse step from one state;
    asserts each step's loss and the final state."""
    _, jspec, tspec, jparams, jdevs, tdevs = (_seq if is_seq else _mf)(cfg)
    opt_name = cfg.train.optimizer
    lr = cfg.train.learning_rate
    vocab = jspec.vocab if is_seq else jspec.item.schema.num_entities
    draws = _draws(vocab, STEPS, seed=len(batches[0]) + int(is_seq))
    _hand_in(monkeypatch, jsparse, draws, jnp.asarray)
    _hand_in(monkeypatch, tsparse, draws, torch.from_numpy)

    jopt = jstep.make_optimizer(opt_name, lr)
    jpaths = jsparse.table_paths(is_seq, jspec)
    jstate = jsparse.init_sparse_state(jparams, jpaths, jopt, opt_name)
    tstate = bridge.sparse_train_state_from_arec(
        jax.tree.map(np.asarray, jstate))
    jfn = jsparse.make_sparse_step_core(is_seq, jspec, *jdevs, jopt, lr,
                                        opt_name)
    tfn = tsparse.make_sparse_train_step(is_seq, tspec, *tdevs,
                                         tstep.make_optimizer(opt_name, lr),
                                         lr, opt_name)
    for i, batch in enumerate(batches[:STEPS]):
        jstate, jm = jfn(jstate, {k: jnp.asarray(v)
                                  for k, v in batch.items()},
                         jax.random.key(i))
        tstate, tm = tfn(tstate, {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                         tstep.step_generator(0, i))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
    assert int(tstate.step) == int(jstate.step) == STEPS
    _assert_tree_close(tstate.params, jstate.params, **PARAMS)
    jrest = jstate.opt_state["rest"]
    if opt_name == "adagrad":
        _assert_tree_close(tstate.opt_state["rest"]["sum_of_squares"],
                           jrest.inner_state[0].sum_of_squares, **PARAMS)
    assert int(tstate.opt_state["rest"]["count"]) == int(jrest.count)
    return tstate


# ---------------------------------------------------------------------------
# Engine subset helpers
# ---------------------------------------------------------------------------

def _encoders(dense_threshold):
    cfg = _cfg("mf", dense_threshold=dense_threshold)
    ds, jspec, tspec, jparams, jdevs, tdevs = _mf(cfg)
    return jspec.item, tspec.item, jparams["item"], jdevs[1], tdevs[1]


@pytest.mark.parametrize("dense_threshold", [512, 0, 12])
def test_gather_row_ids_unique_rows_and_bound_match_arec(dense_threshold):
    jspec, tspec, _, jdev, tdev = _encoders(dense_threshold)
    ids = np.array([3, 89, 3, 90, 0, 41, 41, 7], np.int32)     # 90 = pad
    want = je.gather_row_ids(jspec, jdev, jnp.asarray(ids))
    got = te.gather_row_ids(tspec, tdev, torch.from_numpy(ids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    total = jspec.total_rows
    bound = je.gather_unique_bound(jspec, len(ids))
    assert te.gather_unique_bound(tspec, len(ids)) == bound
    for cap in (None, bound):
        w = je.unique_rows(jnp.asarray(want), total, cap=cap)
        g = te.unique_rows(got, total, cap=cap)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unique_rows_static_shape_and_sentinel_fill():
    ids = np.array([5, 1, 5, 9, 1, 12, 12, 12], np.int32)       # 12 = sentinel
    for cap in (None, 6, 3):
        want = je.unique_rows(jnp.asarray(ids), 12, cap=cap)
        got = te.unique_rows(torch.from_numpy(ids), 12, cap=cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert te.unique_rows(torch.zeros(0, dtype=torch.int32), 5).shape == (0,)


@pytest.mark.parametrize("prefix", [0, 4])
def test_build_subset_and_pos_map_match_arec(prefix):
    rng = np.random.default_rng(prefix)
    table = rng.standard_normal((30, 5)).astype(np.float32)
    uids = np.array([6, 11, 17, 29, 30, 30], np.int32)         # 30 = sentinel
    want = je.build_subset(jnp.asarray(table), jnp.asarray(uids), prefix)
    got = te.build_subset(torch.from_numpy(table), torch.from_numpy(uids),
                          prefix)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[-2:].any()                     # fill, not a clamped row
    want_pos = je.subset_pos_map(jnp.asarray(uids), 30, prefix)
    got_pos = te.subset_pos_map(torch.from_numpy(uids), 30, prefix)
    assert got_pos.shape == (30,) and got_pos.dtype == torch.int32
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    ids = np.array([[max(prefix - 1, 11), 6], [29, 17]], np.int32)
    jl = je.make_subset_lookup(want_pos, prefix)(want, jnp.asarray(ids))
    tl = te.make_subset_lookup(got_pos, prefix)(got, torch.from_numpy(ids))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tl.numpy(), table[ids])


@pytest.mark.parametrize("dense_threshold", [512, 0, 12])
def test_encode_through_a_subset_equals_the_dense_encode(dense_threshold):
    """encode_with_bias over [prefix ++ table[uids]] through the subset
    lookup gives the dense encode's latents and bias, and matches arec's
    subset encode."""
    jspec, tspec, jparams, jdev, tdev = _encoders(dense_threshold)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    ids = np.array([3, 89, 3, 90, 0, 41], np.int32)
    total, prefix = tspec.total_rows, tspec.dense_region_rows
    uids = te.unique_rows(te.gather_row_ids(tspec, tdev,
                                            torch.from_numpy(ids)), total)
    table = tparams["tables"][te.FUSED]
    sub = {**tparams, "tables": {te.FUSED: te.build_subset(table, uids,
                                                           prefix)}}
    lookup = (te.make_subset_lookup(te.subset_pos_map(uids, total, prefix),
                                    prefix)
              if uids.shape[0] else te.dense_lookup)
    got = te.encode_with_bias(sub, tspec, tdev, torch.from_numpy(ids),
                              lookup)
    dense = te.encode_with_bias(tparams, tspec, tdev, torch.from_numpy(ids))
    want = je.encode_with_bias(jparams, jspec, jdev, jnp.asarray(ids))
    for g, d, w in zip(got, dense, want):
        np.testing.assert_array_equal(g.numpy(), d.numpy())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# The sparse step vs arec's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer,dense_threshold",
                         [("adagrad", 512), ("sgd", 512),
                          ("adagrad", 0), ("sgd", 0),
                          ("adagrad", 12), ("sgd", 12)])
def test_mf_sparse_step_matches_arec(monkeypatch, optimizer, dense_threshold):
    cfg = _cfg("mf", optimizer, dense_threshold)
    batches = list(jds.mf_batches(generate(DATA), 32, 0, 0))
    _run_both(monkeypatch, False, cfg, batches)


@pytest.mark.parametrize("loss", ["mw", "bbpr", "warp"])
def test_mf_sparse_step_other_losses_match_arec(monkeypatch, loss):
    cfg = _cfg("mf", "adagrad", 0, loss=loss)
    batches = list(jds.mf_batches(generate(DATA), 32, 0, 0))
    _run_both(monkeypatch, False, cfg, batches)


@pytest.mark.parametrize("tie_output,concat_user,dense_threshold",
                         [(False, False, 512), (True, True, 512),
                          (False, False, 0), (True, True, 0),
                          (False, False, 12), (True, True, 12)])
def test_seq_sparse_step_matches_arec(monkeypatch, tie_output, concat_user,
                                      dense_threshold):
    cfg = _cfg("lstm", "adagrad", dense_threshold, tie_output=tie_output,
               concat_user=concat_user)
    batches = list(jds.seq_batches(generate(DATA), 32, 6, 0, 0))
    batches = (batches * STEPS)[:STEPS]          # the epoch has 3 batches
    _run_both(monkeypatch, True, cfg, batches)


# ---------------------------------------------------------------------------
# The sparse step vs the port's dense step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,dense_threshold",
                         [("mf", 0), ("mf", 12), ("lstm", 12)])
def test_sparse_step_matches_the_dense_step(model, dense_threshold):
    """Same state, same batches, same step keys (so the same negatives
    from the real draw): the unpacked sparse params equal the dense
    step's."""
    is_seq = model != "mf"
    cfg = _cfg(model, "adagrad", dense_threshold)
    tcfg = TConfig.from_json(cfg.to_json())
    tds_ = tgenerate(tcfg.data)
    _, _, spec, jparams, _, (udev, idev) = (_seq if is_seq else _mf)(cfg)
    params = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    lr = cfg.train.learning_rate
    opt = tstep.make_optimizer("adagrad", lr)

    def loss_fn(p, b, g):
        if is_seq:
            return tseq.seq_loss(p, spec, idev, udev, b, g, time_major=True)
        return tmf.mf_loss(p, spec, udev, idev, b, g)

    dense = tstep.make_train_step(loss_fn, opt, lr)
    d_state = tstep.init_state(tstep.tree_map(torch.clone, params), opt)
    paths = tsparse.table_paths(is_seq, spec)
    sparse = tsparse.make_sparse_train_step(is_seq, spec, udev, idev, opt,
                                            lr, "adagrad")
    s_state = tsparse.init_sparse_state(params, paths, opt, "adagrad")
    batches = list(tds.seq_batches(tds_, 32, 6, 0, 0) if is_seq
                   else tds.mf_batches(tds_, 32, 0, 0))
    for i, batch in enumerate((batches * STEPS)[:STEPS]):
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        d_state, dm = dense(d_state, tb, tstep.step_generator(5, i))
        s_state, sm = sparse(s_state, tb, tstep.step_generator(5, i))
        np.testing.assert_allclose(sm["loss"].item(), dm["loss"].item(),
                                   rtol=1e-5)
    got = tsparse.unpack_params(s_state.params, paths)
    for a, b in zip(tstep._leaves(got), tstep._leaves(d_state.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **PARAMS)


def test_sparse_step_rejects_what_it_does_not_take():
    cfg = _cfg("mf")
    _, _, spec, _, _, _ = _mf(cfg)
    opt = tstep.make_optimizer("adagrad", 0.1)
    with pytest.raises(ValueError, match="sparse_update supports"):
        tsparse.make_sparse_train_step(
            False, dataclasses.replace(spec, loss="nope"), None, None, opt,
            0.1, "adagrad")
    with pytest.raises(ValueError, match="adagrad/sgd"):
        tsparse.make_sparse_train_step(False, spec, None, None, opt, 0.1,
                                       "adam")


def test_pack_and_unpack_round_trip():
    rng = np.random.default_rng(0)
    params = {"user": {"tables": {"__fused__": torch.from_numpy(
        rng.standard_normal((7, 3)).astype(np.float32))}},
        "item": {"tables": {"__fused__": torch.from_numpy(
            rng.standard_normal((5, 4)).astype(np.float32))}}}
    paths = [("user", "tables", "__fused__"), ("item", "tables", "__fused__")]
    packed = tsparse.pack_tables(params, paths)
    assert packed["item"]["tables"]["__fused__"].shape == (5, 8)
    assert bool((packed["user"]["tables"]["__fused__"][:, 3:] == 0.1).all())
    back = tsparse.unpack_params(packed, paths)
    for p in paths:
        assert torch.equal(tsparse.get_path(back, p),
                           tsparse.get_path(params, p))
