"""train.compact_table_grads: the port serves it with `engine.dense_lookup`
(its `embedding` backward already groups duplicate ids), held against
arec's `make_compact_lookup` on the same ids: forward and table gradient
equal (f32, rtol 1e-6), with duplicate ids, the pad row and the ids that
fill arec's static-shape sentinel slots."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arec.tables.engine import make_compact_lookup as jmake_compact_lookup
from arec_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from arec_torch.tables.engine import dense_lookup
from arec_torch.train.loop import Trainer
from arec_torch.train.step import _leaves

torch.set_num_threads(1)

ROWS, WIDTH = 37, 5


def _ids(shape, seed):
    """Ids over a small range (so most repeat), with the pad row (the
    last) and row 0 forced in."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 9, size=shape).astype(np.int32)
    flat = ids.reshape(-1)
    flat[::3] = ROWS - 1
    flat[1::5] = 0
    return ids


@pytest.mark.parametrize("shape", [(1,), (23,), (6, 7), (3, 4, 5)])
def test_forward_and_gradient_match_arec(shape):
    rng = np.random.default_rng(sum(shape))
    table = rng.standard_normal((ROWS, WIDTH)).astype(np.float32)
    ids = _ids(shape, seed=len(shape))
    cot = rng.standard_normal(shape + (WIDTH,)).astype(np.float32)

    jlk = jmake_compact_lookup()
    want = np.asarray(jlk(jnp.asarray(table), jnp.asarray(ids)))
    want_g = np.asarray(jax.grad(
        lambda t: jnp.sum(jlk(t, jnp.asarray(ids)) * cot))(
            jnp.asarray(table)))

    t = torch.from_numpy(table).requires_grad_()
    got = dense_lookup(t, torch.from_numpy(ids))
    assert got.shape == shape + (WIDTH,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=0)
    got_g, = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), t)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-6, atol=1e-6)
    untouched = np.setdiff1d(np.arange(ROWS), ids)
    assert torch.equal(got_g[untouched], torch.zeros_like(got_g[untouched]))


def test_empty_ids():
    t = torch.randn(4, 3)
    assert dense_lookup(t, torch.zeros((0,), dtype=torch.int64)) \
        .shape == (0, 3)


def test_trainer_honours_compact_table_grads(tmp_path):
    """compact_table_grads is accepted and served by dense_lookup: a few
    steps with it equal a few steps without it, bit for bit."""
    def run(compact):
        cfg = Config(
            data=DataConfig(syn_users=120, syn_items=90,
                            syn_interactions=2400,
                            data_dir=str(tmp_path / "data")),
            model=ModelConfig(model="mf", dim=8),
            train=TrainConfig(batch_size=32, max_steps=6,
                              steps_per_checkpoint=100,
                              compute_dtype="float32",
                              compact_table_grads=compact,
                              train_dir=str(tmp_path / f"t{compact}")))
        tr = Trainer(cfg, device="cpu")
        tr.train()
        return tr
    plain, compact = run(False), run(True)
    assert plain.lookup is dense_lookup
    assert compact.lookup is dense_lookup
    for a, b in zip(_leaves(compact.state.params),
                    _leaves(plain.state.params)):
        assert torch.equal(a, b)
