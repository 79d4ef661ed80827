"""Training on a device mesh, part 3: the sparse mesh step
(`train/sparse_mesh.py`) on gloo ranks against arec's
`make_sparse_mesh_step_core` on its 8 fake devices, from the same packed
state, on the same global batches, with the same negatives; and against
the port's own dense mesh step.

Cases (tests/test_sparse_mesh.py:43, :75): MF and the LSTM, contiguous
and shuffled, on (2, 4); `warp`, `bpr`, `mw`, `bbpr`, and `mw` / `bbpr`
with batch_ht, shuffled, on (2, 4). Two steps each: the losses at rtol
1e-5, every packed table (parameters and Adagrad accumulators) and
every other parameter at rtol 1e-4, atol 1e-6. The port's sparse mesh
step equals its dense mesh step from the same state on MF and the LSTM
(tests/test_sparse_mesh.py:49; rtol 1e-5, atol 1e-6). One spawn of 8
ranks runs every case."""

import numpy as np
import pytest
import torch

from torch_mesh_train_check import (
    LOSS, PARAMS, SPARSE_DENSE, arec_run, assert_params_close, config,
    port_json,
)
from torch_mesh_worker import run_ranks

torch.set_num_threads(1)

STEPS = 2
CASES = {
    "mf_contiguous": dict(),
    "mf_shuffle": dict(row_shard="shuffle"),
    "lstm_contiguous": dict(model="lstm"),
    "lstm_shuffle": dict(model="lstm", row_shard="shuffle"),
    "mf_warp": dict(loss="warp", row_shard="shuffle"),
    "mf_bpr": dict(loss="bpr", row_shard="shuffle"),
    "mf_mw": dict(loss="mw", row_shard="shuffle"),
    "mf_bbpr": dict(loss="bbpr", row_shard="shuffle"),
    "mf_mw_ht": dict(loss="mw", row_shard="shuffle", batch_ht=True),
    "mf_bbpr_ht": dict(loss="bbpr", row_shard="shuffle", batch_ht=True),
}
# the port's dense mesh step from the same state as its sparse one
DENSE_TWINS = ("mf_contiguous", "mf_shuffle", "lstm_contiguous",
               "lstm_shuffle")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_sparse")
    mp = pytest.MonkeyPatch()
    arec, port_cases = {}, []
    try:
        for i, (name, kw) in enumerate(CASES.items()):
            cfg = config(tmp, name, sparse=True, **kw)
            state0, batches, losses, final, draw, drops = arec_run(
                mp, cfg, STEPS, seed=i)
            arec[name] = {"losses": losses, "state": final, "drops": drops}
            port_cases.append({"config": port_json(cfg), "state": state0,
                               "batches": batches, "draw": draw})
            if name in DENSE_TWINS:
                dcfg = config(tmp, name + "_dense", **kw)
                dstate0 = arec_run(mp, dcfg, 0, seed=i)[0]
                port_cases.append({"config": port_json(dcfg),
                                   "state": dstate0, "batches": batches,
                                   "draw": draw})
    finally:
        mp.undo()
    res = run_ranks("mesh_steps", 8, tmp, {"cases": port_cases})
    names = [n for name in CASES for n in (
        (name, name + "_dense") if name in DENSE_TWINS else (name,))]
    return arec, {n: [r[i] for r in res] for i, n in enumerate(names)}


def _unpack(params, d=16):
    """Packed [V, 2D] tables → their param halves."""
    if isinstance(params, dict):
        return {k: _unpack(v, d) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_unpack(v, d) for v in params)
    if params.ndim == 2 and params.shape[1] in (2 * d, 2 * (d + 1)):
        return params[:, : params.shape[1] // 2]
    return params


@pytest.mark.parametrize("name", list(CASES))
def test_sparse_mesh_step_matches_arec(runs, name):
    arec, port = runs
    want = arec[name]
    for r in port[name]:
        np.testing.assert_allclose(r["losses"], want["losses"], **LOSS)
    got = port[name][0]["state"]
    assert int(got["step"]) == STEPS
    assert_params_close(got["params"], want["state"]["params"], PARAMS)
    assert_params_close(got["opt_state"], want["state"]["opt_state"],
                        PARAMS)


@pytest.mark.parametrize("name", DENSE_TWINS)
def test_sparse_mesh_step_equals_dense_mesh_step(runs, name):
    _, port = runs
    sparse, dense = port[name][0], port[name + "_dense"][0]
    np.testing.assert_allclose(sparse["losses"], dense["losses"],
                               **SPARSE_DENSE)
    assert_params_close(_unpack(sparse["state"]["params"]),
                        dense["state"]["params"], SPARSE_DENSE)
