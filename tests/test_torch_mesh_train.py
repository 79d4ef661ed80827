"""Training on a device mesh, part 1: the exchange's backward and the
sharded fused CE, arec_torch on gloo ranks (tests/torch_mesh_worker.py)
against arec on its 8 fake devices.

  * The table gradient through `make_sharded_lookup` on (1, 4), (2, 2)
    and (2, 4), duplicate ids, dedup on and off, the shuffle layout
    (prefix 0 and 5) and the contiguous one, equals arec's through its
    own sharded lookup on the same stored table
    (tests/test_sharded.py:66; rtol 1e-5, atol 1e-6).
  * `fused_sampled_ce_sums_sharded`: (num, den) and the gradient of
    num + 0.5·den to q, v_true, v_samp, c_samp and tl_base equal arec's
    `fused_sampled_ce_sums_sharded` (its Pallas kernel in interpret mode
    under shard_map) at N that no mesh size divides, aug and not,
    weighted and not (tests/test_fused_softmax.py's rtol 1e-5 for
    values, 2e-4 / atol 2e-5 for gradients).

The steps and the Trainer are in test_torch_mesh_steps.py and
test_torch_mesh_trainer.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arec.dist.mesh import make_mesh as jmake_mesh
from arec.kernels.sampled_softmax import (
    fused_sampled_ce_sums_sharded as j_sums_sharded,
)
from arec.tables.layout import RowPerm as JRowPerm
from arec.tables.sharded import make_sharded_lookup as jmake_sharded
from arec_torch.tables.sharded import round_up_rows
from torch_mesh_worker import run_ranks

torch.set_num_threads(1)

V, D, N = 37, 16, 48
GRAD = dict(rtol=1e-5, atol=1e-6)
CE_VAL = dict(rtol=1e-5, atol=1e-6)
CE_GRAD = dict(rtol=2e-4, atol=2e-5)
MESHES = ((1, 4), (2, 2), (2, 4))


def _exchange_cases(mesh):
    rng = np.random.default_rng(sum(mesh))
    cases = []
    for _ in (0,):
        for prefix in (None, 0, 5):
            for dedup in (False, True):
                table = rng.normal(size=(V, D)).astype(np.float32)
                ids = np.minimum(rng.zipf(1.5, N) - 1, V - 1).astype(
                    np.int32)
                cot = rng.normal(size=(N, D)).astype(np.float32)
                cases.append(dict(mesh=mesh, table=table, rows=V,
                                  prefix=prefix, ids=ids, dedup=dedup,
                                  cot=cot))
    return cases


def _arec_exchange_grad(c):
    """arec's d/d(stored table) of Σ lookup·cot on its own mesh."""
    data, model = c["mesh"]
    mesh = jmake_mesh(data, model)
    table = c["table"]
    perm = None
    if c["prefix"] is not None:
        perm = JRowPerm.for_rows(c["rows"], c["prefix"])
        table = perm.permute_table(table)
    pad = round_up_rows(V, model) - V
    table = jnp.asarray(np.concatenate([table, np.zeros((pad, D),
                                                        np.float32)]))
    lookup = jmake_sharded(mesh, dedup=c["dedup"], perm=perm)
    cot = jnp.asarray(c["cot"])
    return np.asarray(jax.jit(jax.grad(
        lambda t: jnp.sum(lookup(t, jnp.asarray(c["ids"])) * cot)))(table))


@pytest.mark.parametrize("mesh", MESHES)
def test_exchange_backward_matches_arec(tmp_path, mesh):
    cases = _exchange_cases(mesh)
    res = run_ranks("exchange_grads", mesh[0] * mesh[1], tmp_path,
                    {"cases": cases})
    nonzero = 0
    for i, c in enumerate(cases):
        data, model = c["mesh"]
        world = data * model
        got = [r[i]["grad"] for r in res[:world]]
        # every data replica of a shard holds the same gradient
        for r in range(world):
            np.testing.assert_array_equal(got[r], got[r % model])
        whole = np.concatenate(got[:model])
        want = _arec_exchange_grad(c)
        np.testing.assert_allclose(whole, want, err_msg=str(
            {k: c[k] for k in ("mesh", "prefix", "dedup")}), **GRAD)
        nonzero += int(np.abs(want).sum() > 0)
    assert nonzero == len(cases)


def _ce_inputs(n, aug, seed, s=24):
    rng = np.random.default_rng(seed)
    true_ids = rng.integers(0, 200, n).astype(np.int32)
    sampled_ids = rng.integers(0, 200, s).astype(np.int32)
    sampled_ids[: s // 4] = true_ids[: s // 4]         # forced hits
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    return dict(q=f(n, D), v_true=f(n, D + aug) * 0.3, v_samp=f(s, D) * 0.3,
                c_samp=f(s) * 0.5, tl_base=f(n) * 0.5, true_ids=true_ids,
                sampled_ids=sampled_ids,
                weights=rng.integers(0, 2, n).astype(np.float32))


def _ce_cases(mesh):
    """N = 26 on (2, 4) and (2, 2) (slabs of 13, which no model size
    divides), 13 on (1, 4)."""
    cases = []
    n = 13 * mesh[0]
    for _ in (0,):
        for aug in (0, 1):
            for weighted in (False, True):
                cases.append(dict(mesh=mesh, weighted=weighted, aug=aug,
                                  inputs=_ce_inputs(n, aug,
                                                    seed=n + 2 * aug
                                                    + weighted)))
    return cases


DIFF = ("q", "v_true", "v_samp", "c_samp", "tl_base")


def _arec_ce(c):
    mesh = jmake_mesh(*c["mesh"])
    a = c["inputs"]

    def fn(*xs):
        kw = dict(a, **dict(zip(DIFF, xs)))
        return j_sums_sharded(
            mesh, kw["q"], kw["v_true"], kw["v_samp"], kw["c_samp"],
            kw["tl_base"], jnp.asarray(a["true_ids"]),
            jnp.asarray(a["sampled_ids"]),
            jnp.asarray(a["weights"]) if c["weighted"] else None, 256,
            jnp.float32)

    @jax.jit
    def sums_and_grads(*xs):
        (num, den), vjp = jax.vjp(fn, *xs)
        return num, den, vjp((jnp.float32(1.0), jnp.float32(0.5)))

    num, den, grads = sums_and_grads(*[jnp.asarray(a[k]) for k in DIFF])
    return float(num), float(den), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_ce_matches_arec(tmp_path, mesh):
    cases = _ce_cases(mesh)
    res = run_ranks("sharded_ce", mesh[0] * mesh[1], tmp_path,
                    {"cases": cases})
    for i, c in enumerate(cases):
        data, model = c["mesh"]
        world = data * model
        got = [r[i] for r in res[:world]]
        num, den, grads = _arec_ce(c)
        msg = str({k: c[k] for k in ("mesh", "aug", "weighted")})
        for r in got:
            np.testing.assert_allclose(r["num"], num, err_msg=msg, **CE_VAL)
            np.testing.assert_allclose(r["den"], den, err_msg=msg, **CE_VAL)
        for k, want in zip(DIFF, grads):
            if k in ("v_samp", "c_samp"):
                whole = got[0][k]
            else:       # the slabs, data-major, from model rank 0 of each
                whole = np.concatenate([got[d * model][k]
                                        for d in range(data)])
            np.testing.assert_allclose(whole, want, err_msg=f"{msg} {k}",
                                       **CE_GRAD)
