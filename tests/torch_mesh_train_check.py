"""arec's side of the mesh-training parity tests, and the comparisons.

`arec_run(case)` builds arec's Trainer on the case's config and mesh (its
8 fake CPU devices), takes its initial state in the natural layout
(`_canonical_state`), and runs `steps` steps of its own step function,
dense GSPMD or sparse-mesh, on the first global batches with the case's
draw handed in; it returns the initial state, the batches, the losses
and the final state, all numpy. The port's side runs the same state and
batches on gloo ranks (`torch_mesh_train_cases.mesh_steps`).

Configs are small: MF or the sequence family at dim 16 over a synthetic
dataset, dense_vocab_threshold 12 (the id fields on the gather path, so
the exchange and the RowPerm see real rows), f32, keep_prob 1."""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np

import arec.losses.losses as jl
import arec.train.sparse_mesh as jsm
from arec.config import (
    Config, DataConfig, MeshConfig, ModelConfig, TrainConfig,
)
from arec.losses.sampling import log_uniform_prob
from arec.tables.sharded import EXCHANGE_DROPS as J_DROPS
from arec.train.loop import Trainer as JTrainer

LOSS = dict(rtol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-6)
SPARSE_DENSE = dict(rtol=1e-5, atol=1e-6)


def config(tmp, name, model="mf", mesh=(2, 4), row_shard="contiguous",
           sparse=False, loss="ce", batch_ht=False, cell="lstm",
           capacity_factor=0.0, dedup=True, **train_kw):
    return Config(
        data=DataConfig(dataset="synthetic", data_dir=str(tmp / "data"),
                        syn_users=300, syn_items=250, syn_interactions=8000),
        model=ModelConfig(model=model, dim=16, use_attributes=True,
                          max_seq_len=8, use_pallas_scan=False, cell=cell,
                          dense_vocab_threshold=12),
        train=TrainConfig(**{
            "batch_size": 64, "num_sampled": 32, "n_epoch": 1, "loss": loss,
            "steps_per_checkpoint": 1000, "sparse_update": sparse,
            "compute_dtype": "float32", "batch_ht": batch_ht,
            "learning_rate": 0.2, "train_dir": str(tmp / f"train_{name}"),
            **train_kw}),
        mesh=MeshConfig(data=mesh[0], model=mesh[1], lookup="alltoall",
                        row_shard=row_shard, capacity_factor=capacity_factor,
                        dedup=dedup))


def port_json(cfg) -> str:
    """The port's config: the same, with the scan through the kernel
    wrappers (their plain versions on the CPU)."""
    from arec_torch.config import Config as TConfig
    return TConfig.from_json(cfg.to_json()).override(
        {"model.use_pallas_scan": "true"}).to_json()


def make_draw(vocab: int, seed: int, s: int = 32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, s).astype(np.int32)
    return ids, np.asarray(log_uniform_prob(jnp.asarray(ids), vocab))


def hand_in(monkeypatch, draw):
    fixed = tuple(jnp.asarray(x) for x in draw)
    for m in (jl, jsm):
        monkeypatch.setattr(m, "draw", lambda *a, **k: fixed)


def numpy_state(tr):
    """arec's state in the natural layout, carried into the port's state
    format (`bridge`), as a numpy dict tree. arec's `_canonical_state`
    also runs the sparse state's (1, 1) rest-optimizer placeholders of
    shuffled tables through the RowPerm, whose clipping gather widens
    them to [rows, 1] copies of their one value: they are cut back."""
    from arec.train.sparse import table_paths
    from arec_torch import bridge
    st = jax.tree.map(np.asarray, tr._canonical_state(tr.state))
    conv = (bridge.sparse_train_state_from_arec if tr.sparse
            else bridge.train_state_from_arec)
    out = bridge.to_numpy(conv(st)._asdict())
    if tr.sparse and "sum_of_squares" in out["opt_state"]["rest"]:
        acc = out["opt_state"]["rest"]["sum_of_squares"]
        for path in table_paths(tr.is_seq, tr.spec):
            node = acc
            for k in path[:-1]:
                node = node[k]
            node[path[-1]] = node[path[-1]][:1, :1]
    return out


def arec_run(monkeypatch, cfg, steps: int, seed: int):
    """(state0, batches, losses, final state, draw, exchange drops) of
    arec's mesh step."""
    tr = JTrainer(cfg)
    J_DROPS.read_and_reset()
    vocab = (tr.spec.vocab if tr.is_seq
             else tr.spec.item.schema.num_entities)
    draw = make_draw(vocab, seed)
    hand_in(monkeypatch, draw)
    state0 = numpy_state(tr)
    batches = list(itertools.islice(tr._batches(0), steps))
    losses = []
    for i, b in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tr.state, m = tr.step_fn(tr.state, jb,
                                 jax.random.fold_in(jax.random.key(777), i))
        losses.append(float(m["loss"]))
    jax.effects_barrier()
    return (state0, batches, losses, numpy_state(tr), draw,
            J_DROPS.read_and_reset())


def leaves(tree, path=""):
    """(path, array) of every leaf, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


def assert_params_close(got: dict, want, tol, rows_of=None):
    """The port's natural params (`got`) against arec's (natural, tables
    row-padded on a mesh: cut to the port's rows)."""
    g = dict(leaves(got))
    w = dict(leaves(want))
    assert set(g) == set(w), (sorted(g), sorted(w))
    for k, a in g.items():
        b = w[k]
        if a.ndim and b.shape[0] != a.shape[0]:
            b = b[: a.shape[0]]
        np.testing.assert_allclose(a, b, err_msg=k, **tol)
