"""arec_torch sequence model vs arec's, end to end below the serving layer:
the final query state over a two-segment history (`seq_final_state_full`,
carried state) and the item latents (`seq_item_latents`), for the model
variants the configs allow — attributes or ids only, the kernel path
(`use_pallas_scan`: arec's Pallas kernel in interpret mode, the port's
wrapper taking its plain version on the CPU) or the plain scan, two
layers with the user embedding, a tied output table, GRU (plain and
kernel path), and bf16 train-path activations. Weights are arec's init, handed over through the
bridge; inputs are numpy-seeded."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arec.config import Config, DataConfig, ModelConfig, TrainConfig
from arec.data.synthetic import generate
from arec.models import seq as jseq
from arec.tables.engine import attrs_to_device as j_attrs
from arec_torch import bridge
from arec_torch.cli.main import load_config, parse_args
from arec_torch.config import Config as TConfig
from arec_torch.data.synthetic import generate as tgenerate
from arec_torch.models import seq as tseq
from arec_torch.tables.engine import attrs_to_device as t_attrs

torch.set_num_threads(1)

DATA = DataConfig(syn_users=80, syn_items=120, syn_interactions=1500)
L, B = 6, 5
VARIANTS = {
    "attr_kernel": dict(use_pallas_scan=True),
    "id_plain": dict(use_attributes=False, use_pallas_scan=False),
    "user_2layer_kernel": dict(concat_user=True, num_layers=2,
                               use_pallas_scan=True),
    "tied_nonlinear_plain": dict(tie_output=True, nonlinear=True,
                                 use_pallas_scan=False),
    "gru_plain": dict(cell="gru", use_pallas_scan=False),
    "gru_kernel": dict(cell="gru", use_pallas_scan=True),
    "act_bf16_kernel": dict(use_pallas_scan=True),
}
# f32 everywhere: tests/test_seq.py's forward tolerance. bf16 train-path
# activations round every encode intermediate to bf16 on both sides, but
# the two frameworks sum a bf16 mulhot mean and a bf16 fusion product in
# different orders, so one bf16 ulp (2^-8 relative) may differ.
TOL = {False: dict(rtol=1e-4, atol=1e-5), True: dict(rtol=3e-2, atol=3e-2)}


def _setup(variant):
    bf16 = variant.startswith("act_bf16")
    cfg = Config(
        data=DATA,
        model=ModelConfig(model="lstm", dim=16, max_seq_len=L,
                          dense_vocab_threshold=16, **VARIANTS[variant]),
        train=TrainConfig(compute_dtype="float32",
                          act_dtype="bfloat16" if bf16 else "float32"))
    ds, tds = generate(DATA), tgenerate(DATA)
    jspec = jseq.SeqSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    tspec = tseq.SeqSpec.from_config(TConfig.from_json(cfg.to_json()),
                                     tds.user_schema, tds.item_schema)
    jparams = jseq.init_seq(jax.random.key(3), jspec)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    dev = {}
    for side, jenc, tenc in (("item", jspec.item_in, tspec.item_in),
                             ("user", jspec.user, tspec.user)):
        if jenc is None:
            dev[side] = (None, None)
            continue
        ja = getattr(ds, f"{side}_attrs").restrict(jenc.schema)
        ta = getattr(tds, f"{side}_attrs").restrict(tenc.schema)
        dev[side] = (j_attrs(ja, jenc), t_attrs(ta, tenc))
    return jspec, tspec, jparams, tparams, dev, TOL[bf16]


def _batch(vocab, n_users, segments=2, seed=0):
    rng = np.random.default_rng(seed)
    T = segments * L
    lengths = rng.integers(1, T + 1, B)
    lengths[0], lengths[-1] = 0, T
    mask = (np.arange(T)[None, :] >= (T - lengths)[:, None]).astype(
        np.float32)
    inputs = np.where(mask > 0, rng.integers(0, vocab, (B, T)),
                      vocab).astype(np.int32)
    user = rng.integers(0, n_users + 1, B).astype(np.int32)
    return {"inputs": inputs, "mask": mask, "user": user}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_final_state_over_segments_matches_arec(variant):
    jspec, tspec, jparams, tparams, dev, tol = _setup(variant)
    batch = _batch(jspec.vocab, DATA.syn_users)
    want = jseq.seq_final_state_full(
        jparams, jspec, dev["item"][0], dev["user"][0],
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = tseq.seq_final_state_full(
        tparams, tspec, dev["item"][1], dev["user"][1],
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("variant", ["attr_kernel", "tied_nonlinear_plain"])
def test_item_latents_match_arec(variant):
    jspec, tspec, jparams, tparams, dev, tol = _setup(variant)
    want_v, want_b = jseq.seq_item_latents(jparams, jspec, dev["item"][0])
    got_v, got_b = tseq.seq_item_latents(tparams, tspec, dev["item"][1])
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **tol)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), **tol)
    assert got_b.is_contiguous()


def test_segmented_state_equals_unsegmented():
    """The carried-state segments give the one-pass scan's final state."""
    _, tspec, _, tparams, dev, tol = _setup("attr_kernel")
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(tspec.vocab, DATA.syn_users, segments=3).items()}
    seg = tseq.seq_final_state_full(tparams, tspec, dev["item"][1], None,
                                    batch)
    one = tseq.seq_final_state(
        tparams, dataclasses.replace(tspec, max_seq_len=3 * L),
        dev["item"][1], None, batch)
    torch.testing.assert_close(seg, one, **tol)


@pytest.mark.parametrize("mesh_data", [1, 2])
def test_spec_refuses_a_device_mesh(mesh_data, tmp_path):
    """`SeqSpec.from_config` builds on a mesh that spans more than one
    device (mesh.data = 2), as on the 1 x 1 config; and training on that
    mesh, refused until mesh training was ported, now runs: `cli.main`
    trains syn_lstm.json at a tiny size on 2 gloo ranks (the dense mesh
    step, the scan on each rank's slab), both print the same summary, and
    a one-device Trainer restores the checkpoint and evaluates to its
    recall."""
    config = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "syn_lstm.json")
    cfg = load_config(parse_args([
        "--config", config, "--set", f"mesh.data={mesh_data}",
        "--set", f"data.data_dir={tmp_path}"]))
    tds = tgenerate(DATA)
    spec = tseq.SeqSpec.from_config(cfg, tds.user_schema, tds.item_schema)
    assert spec.dim == 64
    if mesh_data > 1:
        import json
        from arec_torch.data.io import load_or_prepare
        from arec_torch.train.loop import Trainer
        from torch_mesh_worker import run_ranks
        sets = {"mesh.data": mesh_data, "data.data_dir": tmp_path,
                "data.syn_users": 120, "data.syn_items": 90,
                "data.syn_interactions": 2400, "model.dim": 8,
                "model.max_seq_len": 6, "train.batch_size": 16,
                "train.num_sampled": 16, "train.max_steps": 2,
                "train.eval_batch_size": 32,
                "train.train_dir": tmp_path / "t"}
        argv = ["--config", config] + [a for k, v in sets.items()
                                       for a in ("--set", f"{k}={v}")]
        cfg = load_config(parse_args(argv))
        load_or_prepare(cfg.data)
        res = run_ranks("train", mesh_data, tmp_path, {"cases": [{
            "argv": argv, "train_dir": cfg.train.train_dir}]})
        outs = [json.loads(r[0]["stdout"].strip().splitlines()[-1])
                for r in res]
        assert outs[0] == outs[1] and outs[0]["steps"] == 2
        one = Trainer(cfg.override({"mesh.data": 1}), serve_only=True,
                      device="cpu")
        assert int(one.state.step) == 2
        assert one.evaluate() == pytest.approx(outs[0]["recall_at_k"],
                                               abs=1e-6)
