"""The weight bridge: arec param pytrees (numpy) → torch → numpy round trip,
and the port's own init giving arec's layout, key for key and shape for
shape, for the sequence and MF families."""

import jax
import numpy as np
import pytest
import torch

from arec.config import Config, DataConfig, ModelConfig
from arec.data.synthetic import generate
from arec.models.mf import MFSpec, init_mf
from arec.models.seq import SeqSpec, init_seq
from arec_torch import bridge
from arec_torch.config import Config as TConfig
from arec_torch.data.synthetic import generate as tgenerate
from arec_torch.models import seq as tseq

torch.set_num_threads(1)

DATA = DataConfig(syn_users=60, syn_items=50, syn_interactions=600)
VARIANTS = {
    "lstm_attr": dict(model="lstm", dim=8),
    "lstm_id_2layer": dict(model="lstm", dim=8, use_attributes=False,
                           num_layers=2),
    "lstm_tied_user": dict(model="lstm", dim=8, tie_output=True,
                           concat_user=True, nonlinear=True),
    "gru": dict(model="lstm", cell="gru", dim=8),
    "mf_attr": dict(model="mf", dim=8),
}


def _arec_params(variant):
    cfg = Config(data=DATA, model=ModelConfig(**VARIANTS[variant]))
    ds = generate(DATA)
    if cfg.model.model == "mf":
        spec = MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
        return cfg, init_mf(jax.random.key(0), spec)
    spec = SeqSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    return cfg, init_seq(jax.random.key(0), spec)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_round_trip_is_exact(variant):
    _, params = _arec_params(variant)
    np_params = jax.tree.map(np.asarray, params)
    t = bridge.to_torch(np_params, "cpu")
    assert isinstance(t["rnn" if "rnn" in t else "item"], (list, dict))
    back = bridge.to_numpy(t)
    want, got = list(_leaves(np_params)), list(_leaves(back))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w)
    # copies, not views: writing to the torch side leaves numpy untouched
    first = next(x for _, x in _leaves(t))
    first.add_(1.0)
    np.testing.assert_array_equal(next(x for _, x in _leaves(np_params)),
                                  next(x for _, x in _leaves(back)))


@pytest.mark.parametrize("variant", [v for v in VARIANTS
                                     if VARIANTS[v]["model"] == "lstm"])
def test_port_init_has_arec_layout(variant):
    cfg, params = _arec_params(variant)
    tcfg = TConfig.from_json(cfg.to_json())
    ds = tgenerate(tcfg.data)
    spec = tseq.SeqSpec.from_config(tcfg, ds.user_schema, ds.item_schema)
    tparams = tseq.init_seq(torch.Generator().manual_seed(0), spec)
    want = [(p, tuple(x.shape)) for p, x in _leaves(params)]
    got = [(p, tuple(x.shape)) for p, x in _leaves(tparams)]
    assert got == want
    # PAD rows of the fused input table are exactly zero, as in arec
    offsets = spec.item_in.field_offsets()
    table = tparams["item_in"]["tables"]["__fused__"]
    for f in spec.item_in.schema.fields:
        assert (table[offsets[f.name] + f.pad_index] == 0).all(), f.name


def test_bridge_refuses_other_dtypes():
    with pytest.raises(TypeError):
        bridge.to_torch({"w": np.zeros(3, np.float16)})


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
def test_bridge_carries_the_sparse_state(optimizer):
    """arec's sparse-step state (packed Adagrad tables, the rest's optax
    state under "rest") arrives equal, leaf for leaf, to the port's own
    init_sparse_state of the same weights."""
    from arec.train import sparse as jsparse
    from arec.train import step as jstep
    from arec_torch.models.mf import MFSpec as TMFSpec
    from arec_torch.train import sparse as tsparse
    from arec_torch.train import step as tstep

    cfg, params = _arec_params("mf_attr")
    ds = generate(DATA)
    spec = MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    jopt = jstep.make_optimizer(optimizer, 0.3)
    jstate = jstep.decay_lr(jsparse.init_sparse_state(
        params, jsparse.table_paths(False, spec), jopt, optimizer), 0.5)
    got = bridge.sparse_train_state_from_arec(
        jax.tree.map(np.asarray, jstate))

    tcfg = TConfig.from_json(cfg.to_json())
    tds = tgenerate(tcfg.data)
    tspec = TMFSpec.from_config(tcfg, tds.user_schema, tds.item_schema)
    want = tsparse.init_sparse_state(
        bridge.to_torch(jax.tree.map(np.asarray, params)),
        tsparse.table_paths(False, tspec),
        tstep.make_optimizer(optimizer, 0.3), optimizer)
    assert float(got.lr_scale) == 0.5 and int(got.step) == 0
    table = got.params["item"]["tables"]["__fused__"]
    assert table.shape[1] == (2 if optimizer == "adagrad" else 1) * 9
    assert set(got.opt_state) == {"rest"}
    assert set(got.opt_state["rest"]) == set(want.opt_state["rest"])
    for tree in ("params", "opt_state"):
        g = tstep._leaves(getattr(got, tree))
        w = tstep._leaves(getattr(want, tree))
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b)
