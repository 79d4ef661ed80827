"""Training on a device mesh, part 2: the dense mesh step
(`train.step.make_mesh_step_core` through the Trainer's set-up) on gloo
ranks against arec's GSPMD mesh step (`Trainer._make_sharded_step`) on
its 8 fake devices, from the same state, on the same global batches,
with the same negatives handed to both sides.

Cases (tests/test_dist_e2e.py:42, :69, :175): MF `ce` on (2, 4),
contiguous and shuffled, and on (1, 8) and (8, 1); `warp`, `bpr`, `mw`
and `bbpr` on (2, 4); the LSTM and the GRU on (2, 4); MF `mw` at
capacity_factor 1.0, dedup on and off, where the exchange's buckets
overflow: the requests dropped over every rank equal arec's
`EXCHANGE_DROPS` count (the Trainer's `exchange_dropped`). (`mw` looks
up only batch-split lists; a list every data rank holds, like `ce`'s
negatives, arec splits over data × model and the port over model
within each data row, so at capacity_factor > 0 their drops differ.)
Two steps
each: the losses at rtol 1e-5, every parameter and optimizer
accumulator after them at rtol 1e-4, atol 1e-6. One spawn of 8 ranks
runs every case."""

import numpy as np
import pytest
import torch

from torch_mesh_train_check import (
    LOSS, PARAMS, arec_run, assert_params_close, config, port_json,
)
from torch_mesh_worker import run_ranks

torch.set_num_threads(1)

STEPS = 2
CASES = {
    "mf_ce_2x4": dict(),
    "mf_ce_2x4_shuffle": dict(row_shard="shuffle"),
    "mf_ce_1x8": dict(mesh=(1, 8)),
    "mf_ce_8x1": dict(mesh=(8, 1)),
    "mf_warp": dict(loss="warp", row_shard="shuffle"),
    "mf_bpr": dict(loss="bpr"),
    "mf_mw": dict(loss="mw", row_shard="shuffle"),
    "mf_bbpr": dict(loss="bbpr"),
    "lstm": dict(model="lstm", row_shard="shuffle"),
    "gru": dict(model="lstm", cell="gru"),
    # overflowing exchange buckets: the drops counted as arec counts them
    # (mw: every list looked up is split over "data" as arec splits it)
    "mf_mw_capacity": dict(loss="mw", capacity_factor=1.0),
    "mf_mw_capacity_nodedup": dict(loss="mw", capacity_factor=1.0,
                                   dedup=False),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_steps")
    mp = pytest.MonkeyPatch()
    arec, port_cases = {}, []
    try:
        for i, (name, kw) in enumerate(CASES.items()):
            cfg = config(tmp, name, **kw)
            state0, batches, losses, final, draw, drops = arec_run(
                mp, cfg, STEPS, seed=i)
            arec[name] = {"losses": losses, "state": final, "drops": drops}
            port_cases.append({"config": port_json(cfg), "state": state0,
                               "batches": batches, "draw": draw})
    finally:
        mp.undo()
    res = run_ranks("mesh_steps", 8, tmp, {"cases": port_cases})
    return arec, {name: [r[i] for r in res] for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_dense_mesh_step_matches_arec(runs, name):
    arec, port = runs
    want = arec[name]
    for r in port[name]:                      # every rank's loss is global
        np.testing.assert_allclose(r["losses"], want["losses"], **LOSS)
    assert all(r["state"] is None for r in port[name][1:])
    got = port[name][0]["state"]
    assert int(got["step"]) == STEPS
    assert_params_close(got["params"], want["state"]["params"], PARAMS)
    assert_params_close(got["opt_state"], want["state"]["opt_state"],
                        PARAMS)
    assert port[name][0]["drops"] == want["drops"]
    if "capacity" in name:
        assert want["drops"] > 0
