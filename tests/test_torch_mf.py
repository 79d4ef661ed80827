"""arec_torch's MF family vs arec's on a small attribute-aware MF model:
`mf_loss` value and gradients to every parameter for every MF loss (ce on
the fused-CE path — arec's Pallas kernel in interpret mode, the port's
autograd Function on its plain versions — and on the pure path; warp and
bpr under log_uniform and uniform; mw and bbpr with and without the
batch_ht correction), `mf_user_latents`, `mf_item_latents` and
`encode_all_items`, and `mf_batches` yielding arec's arrays.

Weights are arec's init handed over through the bridge; batches are
mf_batches' numpy arrays on both sides; negatives are numpy-drawn and
passed as `sampled`. f32 throughout, at tests/test_fused_softmax.py's
tolerances: values rtol 1e-5 / atol 1e-6, gradients rtol 2e-4 / atol
2e-5."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arec.config import Config, DataConfig, ModelConfig, TrainConfig
from arec.data import dataset as jds
from arec.data.synthetic import generate
from arec.losses.sampling import log_uniform_prob
from arec.losses.sampling import make_pop as jmake_pop
from arec.models import mf as jmf
from arec.tables import engine as je
from arec.tables.engine import attrs_to_device as j_attrs
from arec_torch import bridge
from arec_torch.cli.main import load_config, parse_args
from arec_torch.config import Config as TConfig
from arec_torch.data import dataset as tds
from arec_torch.data.synthetic import generate as tgenerate
from arec_torch.losses.sampling import make_pop as tmake_pop
from arec_torch.models import mf as tmf
from arec_torch.rng import generator
from arec_torch.tables import engine as te
from arec_torch.tables.engine import attrs_to_device as t_attrs
from arec_torch.train import step as tstep

torch.set_num_threads(1)

DATA = DataConfig(syn_users=70, syn_items=90, syn_interactions=1500)
B, S = 24, 20
VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=2e-5)


def _setup(loss="ce", sampler="log_uniform", batch_ht=False):
    # threshold 16: item and user ids gather (identity), the tag mulhot
    # gathers, category/year take the dense map
    cfg = Config(data=DATA,
                 model=ModelConfig(model="mf", dim=16,
                                   dense_vocab_threshold=16),
                 train=TrainConfig(compute_dtype="float32", num_sampled=S,
                                   batch_size=B, loss=loss, sampler=sampler,
                                   batch_ht=batch_ht))
    ds, tds_ = generate(DATA), tgenerate(DATA)
    jspec = jmf.MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    tspec = tmf.MFSpec.from_config(TConfig.from_json(cfg.to_json()),
                                   tds_.user_schema, tds_.item_schema)
    jparams = jmf.init_mf(jax.random.key(3), jspec)
    jdevs = (j_attrs(ds.user_attrs.restrict(jspec.user.schema), jspec.user),
             j_attrs(ds.item_attrs.restrict(jspec.item.schema), jspec.item))
    tdevs = (t_attrs(tds_.user_attrs.restrict(tspec.user.schema),
                     tspec.user),
             t_attrs(tds_.item_attrs.restrict(tspec.item.schema),
                     tspec.item))
    return cfg, ds, tds_, jspec, tspec, jparams, jdevs, tdevs


def _negatives(vocab, sampler, seed):
    ids = np.random.default_rng(seed).integers(0, vocab, S).astype(np.int32)
    if sampler == "uniform":
        return ids, np.full(S, 1.0 / vocab, np.float32)
    return ids, np.array(log_uniform_prob(jnp.asarray(ids), vocab))


def _loss_and_grads(loss, sampler="log_uniform", batch_ht=False,
                    use_kernel=None):
    cfg, ds, tds_, jspec, tspec, jparams, jdevs, tdevs = _setup(
        loss, sampler, batch_ht)
    batch = next(jds.mf_batches(ds, B, seed=1, epoch=0))
    ids, p = _negatives(jspec.item.schema.num_entities, sampler,
                        seed=len(loss) + 7 * batch_ht)
    jpop = tpop = None
    if batch_ht:
        jpop = jmake_pop(ds.item_freq, 1.0)
        tpop = tmake_pop(tds_.item_freq, 1.0)

    def jloss(params):
        return jmf.mf_loss(params, jspec, *jdevs,
                           {k: jnp.asarray(x) for k, x in batch.items()},
                           jax.random.key(0),
                           sampled=(jnp.asarray(ids), jnp.asarray(p)),
                           use_kernel=use_kernel, pop=jpop)

    want, want_g = jax.value_and_grad(jloss)(jparams)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    leaves = tstep._leaves(tparams)
    for t in leaves:
        t.requires_grad_()
    got = tmf.mf_loss(tparams, tspec, *tdevs,
                      {k: torch.from_numpy(x) for k, x in batch.items()},
                      generator(0),
                      sampled=(torch.from_numpy(ids), torch.from_numpy(p)),
                      use_kernel=use_kernel, pop=tpop)
    np.testing.assert_allclose(got.item(), float(want), **VAL)
    got.backward()
    jleaves = jax.tree.leaves(want_g)
    assert len(jleaves) == len(leaves)
    for i, (t, w) in enumerate(zip(leaves, jleaves)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=f"leaf {i}", **GRAD)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_ce_loss_and_gradients_match_arec(use_kernel):
    _loss_and_grads("ce", use_kernel=use_kernel)


@pytest.mark.parametrize("sampler", ["log_uniform", "uniform"])
@pytest.mark.parametrize("loss", ["warp", "bpr"])
def test_sampled_pairwise_losses_match_arec(loss, sampler):
    _loss_and_grads(loss, sampler)


@pytest.mark.parametrize("batch_ht", [False, True])
@pytest.mark.parametrize("sampler", ["log_uniform", "uniform"])
@pytest.mark.parametrize("loss", ["mw", "bbpr"])
def test_batch_losses_match_arec(loss, sampler, batch_ht):
    _loss_and_grads(loss, sampler, batch_ht)


def test_ce_kernel_path_takes_the_plain_versions_on_cpu():
    """With use_kernel=True on CPU tensors the fused CE runs its plain
    versions: no kernel launch is counted."""
    from arec_torch.kernels import sampled_softmax as tks
    before = (tks.sampled_ce_fwd.launches, tks.sampled_ce_bwd.launches)
    _loss_and_grads("ce", use_kernel=True)
    assert (tks.sampled_ce_fwd.launches,
            tks.sampled_ce_bwd.launches) == before


def test_batch_ht_requires_pop():
    *_, tspec, jparams, _, tdevs = _setup("mw", batch_ht=True)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    batch = {"user": torch.arange(4, dtype=torch.int32),
             "pos_item": torch.arange(4, dtype=torch.int32)}
    with pytest.raises(ValueError, match="batch_ht"):
        tmf.mf_loss(tparams, tspec, *tdevs, batch, generator(0))


def test_mesh_paths_raise(tmp_path):
    """The mesh paths of `mf_loss`, which raised until mesh training was
    ported, now run: on a 2 x 2 mesh of gloo ranks (`mesh=`, the exchange
    lookups on row-sharded params, each rank its slab of the batch) `ce`
    through the sharded fused CE and `mw` with its candidates gathered
    over "data" (`gather_cands`) give arec's one-device loss and
    gradients on the whole batch."""
    from torch_mesh_worker import run_ranks

    cases, wants = [], []
    for loss in ("ce", "mw"):
        cfg, ds, _, jspec, _, jparams, jdevs, _ = _setup(loss)
        batch = next(jds.mf_batches(ds, B, seed=1, epoch=0))
        sampled = (_negatives(jspec.item.schema.num_entities,
                              "log_uniform", seed=5)
                   if loss == "ce" else None)

        def jloss(params):
            return jmf.mf_loss(
                params, jspec, *jdevs,
                {k: jnp.asarray(x) for k, x in batch.items()},
                jax.random.key(0), pop=None,
                sampled=None if sampled is None else tuple(
                    map(jnp.asarray, sampled)))
        wants.append(jax.value_and_grad(jloss)(jparams))
        cases.append({"mesh": (2, 2), "config": cfg.to_json(),
                      "params": jax.tree.map(np.asarray, jparams),
                      "batch": batch, "sampled": sampled})
    res = run_ranks("mf_loss_mesh", 4, tmp_path, {"cases": cases})
    for i, (want, want_g) in enumerate(wants):
        for r in res:
            np.testing.assert_allclose(r[i]["loss"], float(want), **VAL)
        flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
                for path, g in jax.tree_util.tree_leaves_with_path(want_g)}
        for key, g in flat.items():
            if "tables" in key.split("/"):     # the row blocks, model order
                got = np.concatenate([res[m][i]["grads"][key]
                                      for m in range(2)])[: g.shape[0]]
            else:
                got = res[0][i]["grads"][key]
            np.testing.assert_allclose(got, g, err_msg=key, **GRAD)


@pytest.mark.parametrize("config", ["syn_mf.json", "syn_sharded.json"])
def test_spec_refuses_a_device_mesh(config, tmp_path):
    """`MFSpec.from_config` builds on syn_sharded.json's 2 x 4 mesh, as on
    syn_mf.json's 1 x 1; and training on that mesh, refused until mesh
    training was ported, now runs: `cli.main` trains syn_sharded.json at
    a tiny size on 8 gloo ranks, every rank prints the same summary, and
    a one-device Trainer restores the mesh's checkpoint and evaluates
    to its recall."""
    cfg = load_config(parse_args(["--config", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", config), "--set", f"data.data_dir={tmp_path}"]))
    tds_ = tgenerate(DATA)
    spec = tmf.MFSpec.from_config(cfg, tds_.user_schema, tds_.item_schema)
    assert spec.user.dim == cfg.model.dim
    if cfg.mesh.data * cfg.mesh.model > 1:
        import json
        from arec_torch.data.io import load_or_prepare
        from arec_torch.train.loop import Trainer
        from torch_mesh_worker import run_ranks
        sets = {"data.syn_users": 120, "data.syn_items": 90,
                "data.syn_interactions": 2400, "model.dim": 8,
                "train.batch_size": 32, "train.num_sampled": 16,
                "train.max_steps": 2, "train.eval_batch_size": 32,
                "train.train_dir": str(tmp_path / "t")}
        argv = ["--config", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "configs", config),
                "--set", f"data.data_dir={tmp_path}"] + [
            a for k, v in sets.items() for a in ("--set", f"{k}={v}")]
        cfg = load_config(parse_args(argv))
        load_or_prepare(cfg.data)
        world = cfg.mesh.data * cfg.mesh.model
        res = run_ranks("train", world, tmp_path, {"cases": [{
            "argv": argv, "train_dir": cfg.train.train_dir}]})
        outs = [json.loads(r[0]["stdout"].strip().splitlines()[-1])
                for r in res]
        assert all(o == outs[0] for o in outs) and outs[0]["steps"] == 2
        one = Trainer(cfg.override({"mesh.data": 1, "mesh.model": 1}),
                      serve_only=True, device="cpu")
        assert one.evaluate() == pytest.approx(outs[0]["recall_at_k"],
                                               abs=1e-6)


def test_latents_match_arec():
    _, ds, _, jspec, tspec, jparams, jdevs, tdevs = _setup()
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    users = np.array([0, 5, 69, 70, 3], np.int32)      # 70 = pad user
    want = jmf.mf_user_latents(jparams, jspec, jdevs[0], jnp.asarray(users))
    got = tmf.mf_user_latents(tparams, tspec, tdevs[0],
                              torch.from_numpy(users))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)
    assert not got[3].any()
    want_all = je.encode_all_items(jparams["user"], jspec.user, jdevs[0],
                                   block=32)
    got_all = te.encode_all_items(tparams["user"], tspec.user, tdevs[0],
                                  block=32)
    assert got_all.shape == (70, 16)
    np.testing.assert_allclose(got_all.numpy(), np.asarray(want_all), **VAL)
    want_v, want_b = jmf.mf_item_latents(jparams, jspec, jdevs[1], block=32)
    got_v, got_b = tmf.mf_item_latents(tparams, tspec, tdevs[1], block=32)
    assert got_v.shape == (90, 16) and got_b.shape == (90,)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **VAL)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), **VAL)


def test_spec_matches_arec():
    *_, jspec, tspec, _, _, _ = _setup("bbpr", "uniform", True)
    for f in dataclasses.fields(jspec):
        if f.name not in ("user", "item"):
            assert getattr(tspec, f.name) == getattr(jspec, f.name), f.name
    assert tspec.item.with_bias and not tspec.user.with_bias
    assert tspec.item.width == jspec.item.width == 17
    assert tspec.dtype == torch.float32 and tspec.act_dt is None


@pytest.mark.parametrize("seed,epoch,host,hosts,drop",
                         [(0, 0, 0, 1, True), (3, 2, 1, 2, False)])
def test_mf_batches_match_arec(seed, epoch, host, hosts, drop):
    ds, tds_ = generate(DATA), tgenerate(DATA)
    want = list(jds.mf_batches(ds, 64, seed, epoch, host, hosts, drop))
    got = list(tds.mf_batches(tds_, 64, seed, epoch, host, hosts, drop))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
