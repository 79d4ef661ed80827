"""arec_torch attribute encoder and fusion vs arec's: the fused-table layout
for every schema the configs and both synthetic generators produce, the
device attribute maps, `encode` on a schema with every field kind, and
`apply_fusion` in all three modes. Inputs and weights come from numpy (or
from arec's init, through numpy) and go to both sides."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arec.config import Config as JConfig, DataConfig as JDataConfig
from arec.data import schema as jschema
from arec.data.synthetic import generate as jgenerate
from arec.fusion.fuse import apply_fusion as japply_fusion
from arec.tables import engine as je
from arec_torch import bridge
from arec_torch.config import Config as TConfig, DataConfig as TDataConfig
from arec_torch.data import schema as tschema
from arec_torch.data.synthetic import generate as tgenerate
from arec_torch.fusion.fuse import apply_fusion as tapply_fusion
from arec_torch.tables import engine as te

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.json")))


def _fields(mod, spec):
    return tuple(mod.AttrField(n, k, v, d) for n, k, v, d in spec)


def _both(entity, n, fields):
    """The same schema built by each package."""
    return (jschema.EntitySchema(entity, n, _fields(jschema, fields)),
            tschema.EntitySchema(entity, n, _fields(tschema, fields)))


def _handmade_schemas():
    """ML-1M- and XING-shaped schemas (their prep needs raw files, so the
    field lists of arec/data/movielens.py and xing.py are built here with
    representative vocab sizes), plus the XING-cardinality synthetic twin's
    schema at full scale (1.5M users, 1.3M items) without its data."""
    cat, mh = "cat", "mulhot"
    ml_user = [("user_id", cat, 6040, 1), ("gender", cat, 2, 1),
               ("age", cat, 7, 1), ("occupation", cat, 21, 1),
               ("zip3", cat, 680, 1)]
    ml_item = [("item_id", cat, 3706, 1), ("genres", mh, 18, 6),
               ("decade", cat, 11, 1)]
    xu = [("user_id", cat, 1_500_000, 1)] + [
        (n, cat, v, 1) for n, v in (("career_level", 7), ("discipline", 24),
                                   ("industry", 24), ("country", 5),
                                   ("region", 17), ("experience_years", 8),
                                   ("edu_degree", 4))] + [
        ("jobroles", mh, 80_000, 30)]
    xi = [("item_id", cat, 1_300_000, 1)] + [
        (n, cat, v, 1) for n, v in (("career_level", 7), ("discipline", 24),
                                   ("industry", 24), ("country", 5),
                                   ("region", 17), ("employment", 6),
                                   ("is_payed", 2))] + [
        ("title", mh, 60_000, 20), ("tags", mh, 90_000, 30)]
    twin_u = [("user_id", cat, 1_500_000, 1), ("group", cat, 16, 1),
              ("age", cat, 7, 1), ("user_tags", mh, 4096, 12)]
    twin_i = [("item_id", cat, 1_300_000, 1), ("category", cat, 16, 1),
              ("year", cat, 10, 1), ("tags", mh, 4096, 12)]
    return [_both("user", 6040, ml_user), _both("item", 3706, ml_item),
            _both("user", 1_500_000, xu), _both("item", 1_300_000, xi),
            _both("user", 1_500_000, twin_u), _both("item", 1_300_000, twin_i)]


SYN = {"small": dict(syn_users=60, syn_items=50, syn_interactions=600),
       "big": dict(syn_users=100, syn_items=400, syn_interactions=2000,
                   syn_mulhot_degree=12, syn_tag_vocab=4096)}


def _datasets(kind):
    return (jgenerate(JDataConfig(**SYN[kind])),
            tgenerate(TDataConfig(**SYN[kind])))


def _specs(cfg_path, js, ts, with_bias):
    with open(cfg_path) as f:
        text = f.read()
    jm, tm = JConfig.from_json(text).model, TConfig.from_json(text).model
    if not jm.use_attributes:
        js, ts = js.id_only(), ts.id_only()
    mk = lambda mod, m, s: mod.EncoderSpec(
        s, m.dim, m.fusion, m.nonlinear, with_bias=with_bias,
        dense_mulhot_threshold=m.dense_vocab_threshold)
    return mk(je, jm, js), mk(te, tm, ts)


def _layout(spec):
    names = lambda fs: [f.name for f in fs]
    return dict(offsets=spec.field_offsets(), total_rows=spec.total_rows,
                width=spec.width, dense=names(spec.dense_fields),
                identity=names(spec.identity_cat_fields),
                gathered=names(spec.gathered_cat_fields),
                mulhot=names(spec.gather_mulhot_fields),
                dense_rows=spec.dense_region_rows,
                needs_proj=spec.needs_proj)


@pytest.mark.parametrize("cfg_path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_encoder_layout_matches_for_every_config(cfg_path):
    pairs = list(_handmade_schemas())
    for kind in SYN:
        jd, td = _datasets(kind)
        pairs += [(jd.user_schema, td.user_schema),
                  (jd.item_schema, td.item_schema)]
    for js, ts in pairs:
        for with_bias in (False, True):
            jspec, tspec = _specs(cfg_path, js, ts, with_bias)
            assert _layout(tspec) == _layout(jspec), (js.entity, with_bias)


@pytest.mark.parametrize("kind", list(SYN))
@pytest.mark.parametrize("threshold", [512, 8])
def test_attrs_to_device_arrays_equal(kind, threshold):
    jd, td = _datasets(kind)
    for side in ("user", "item"):
        ja, ta = getattr(jd, f"{side}_attrs"), getattr(td, f"{side}_attrs")
        jspec = je.EncoderSpec(ja.schema, 4,
                               dense_mulhot_threshold=threshold)
        tspec = te.EncoderSpec(ta.schema, 4,
                               dense_mulhot_threshold=threshold)
        want = je.attrs_to_device(ja, jspec)
        got = te.attrs_to_device(ta, tspec)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


N, DIM = 40, 8
MIXED = [("item_id", "cat", N, 1),     # identity (vocab N > threshold)
         ("brand", "cat", 20, 1),      # gathered cat
         ("tags", "mulhot", 30, 4),    # gathered mulhot
         ("color", "cat", 5, 1),       # dense cat
         ("genres", "mulhot", 6, 3)]   # dense mulhot


def _mixed_attrs(mod):
    rng = np.random.default_rng(0)
    schema = mod.EntitySchema("item", N, _fields(mod, MIXED))
    tags, tags_len = mod.pad_mulhot(
        [sorted(set(rng.integers(0, 30, rng.integers(0, 5)).tolist()))
         for _ in range(N)], 4)
    gen, gen_len = mod.pad_mulhot(
        [sorted(set(rng.integers(0, 6, rng.integers(0, 4)).tolist()))
         for _ in range(N)], 3)
    values = {"item_id": np.arange(N, dtype=np.int32),
              "brand": rng.integers(0, 20, N).astype(np.int32),
              "tags": tags,
              "color": rng.integers(0, 5, N).astype(np.int32),
              "genres": gen}
    attrs = mod.AttributeData(schema, values,
                              {"tags": tags_len, "genres": gen_len})
    attrs.validate()
    return attrs


FUSIONS = {"concat": ("concat", False), "nonlinear": ("concat", True),
           "sum": ("sum", False)}


@pytest.mark.parametrize("fusion", list(FUSIONS))
@pytest.mark.parametrize("with_bias", [False, True])
def test_encode_matches_arec(fusion, with_bias):
    kind, nonlinear = FUSIONS[fusion]
    ja, ta = _mixed_attrs(jschema), _mixed_attrs(tschema)
    jspec = je.EncoderSpec(ja.schema, DIM, kind, nonlinear,
                           with_bias=with_bias, dense_mulhot_threshold=8)
    tspec = te.EncoderSpec(ta.schema, DIM, kind, nonlinear,
                           with_bias=with_bias, dense_mulhot_threshold=8)
    assert [f.name for f in tspec.dense_fields] == ["color", "genres"]
    jparams = je.init_encoder(jax.random.key(1), jspec)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    jdev, tdev = je.attrs_to_device(ja, jspec), te.attrs_to_device(ta, tspec)
    ids = np.array([[0, 5, N, 39], [N, 17, 2, N]], np.int32)  # N = pad
    if with_bias:
        want_v, want_b = je.encode_with_bias(jparams, jspec, jdev,
                                             jnp.asarray(ids))
        got_v, got_b = te.encode_with_bias(tparams, tspec, tdev,
                                           torch.from_numpy(ids))
        np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                                   rtol=1e-5, atol=1e-6)
    else:
        want_v = je.encode(jparams, jspec, jdev, jnp.asarray(ids))
        got_v = te.encode(tparams, tspec, tdev, torch.from_numpy(ids))
    assert got_v.shape == (2, 4, DIM)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=1e-5, atol=1e-6)
    assert (got_v.numpy()[ids == N] == 0.0).all()     # pad → exact zero


def test_encode_all_items_with_bias_matches_arec():
    ja, ta = _mixed_attrs(jschema), _mixed_attrs(tschema)
    jspec = je.EncoderSpec(ja.schema, DIM, with_bias=True,
                           dense_mulhot_threshold=8)
    tspec = te.EncoderSpec(ta.schema, DIM, with_bias=True,
                           dense_mulhot_threshold=8)
    jparams = je.init_encoder(jax.random.key(2), jspec)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    want_v, want_b = je.encode_all_items_with_bias(
        jparams, jspec, je.attrs_to_device(ja, jspec), block=16)
    got_v, got_b = te.encode_all_items_with_bias(
        tparams, tspec, te.attrs_to_device(ta, tspec), block=16)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fusion", list(FUSIONS))
def test_apply_fusion_matches_arec(fusion):
    kind, nonlinear = FUSIONS[fusion]
    rng = np.random.default_rng(4)
    per_attr = [rng.standard_normal((6, DIM)).astype(np.float32)
                for _ in range(3)]
    params = None
    if kind == "concat":
        params = {"w1": rng.standard_normal((3 * DIM, DIM)),
                  "b1": rng.standard_normal(DIM)}
        if nonlinear:
            params |= {"w2": rng.standard_normal((DIM, DIM)),
                       "b2": rng.standard_normal(DIM)}
        params = {k: v.astype(np.float32) for k, v in params.items()}
    want = japply_fusion(
        None if params is None else jax.tree.map(jnp.asarray, params),
        [jnp.asarray(a) for a in per_attr], kind, nonlinear)
    got = tapply_fusion(
        None if params is None else jax.tree.map(torch.from_numpy, params),
        [torch.from_numpy(a) for a in per_attr], kind, nonlinear)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
