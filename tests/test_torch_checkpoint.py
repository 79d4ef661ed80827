"""arec_torch's checkpoints (torch-native, one directory per step): round
trip bit for bit, keep-N, atomic publish, row adaptation, async saves, and
the Trainer's exact resume (after arec's tests/test_checkpoint.py)."""

import json
import os

import pytest
import torch

from arec_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from arec_torch.train.checkpoint import Checkpointer, abstract_like
from arec_torch.train.loop import Trainer
from arec_torch.train.step import (
    TrainState, _leaves, init_state, make_optimizer, tree_map,
)

torch.set_num_threads(1)


def _state(seed=0, rows=6):
    g = torch.Generator().manual_seed(seed)
    params = {"tables": {"__fused__": torch.randn(rows, 3, generator=g)},
              "rnn": [{"w": torch.randn(4, 8, generator=g),
                       "b": torch.zeros(8)}],
              "bias": torch.ones(3)}
    state = init_state(params, make_optimizer("adagrad", 0.1))
    return state._replace(step=torch.tensor(5, dtype=torch.int32))


def _assert_equal(a: TrainState, b: TrainState):
    la, lb = _leaves(a._asdict()), _leaves(b._asdict())
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_roundtrip_bit_for_bit(tmp_path):
    state = _state()
    ck = Checkpointer(str(tmp_path))
    ck.save(5, state, {"epoch": 2, "window": [1.5]}, '{"a": 1}')
    assert ck.latest_step() == 5
    assert sorted(os.listdir(tmp_path / "ckpt" / "5")) == ["meta.json",
                                                          "state.pt"]
    target = abstract_like(state)
    assert all(t.is_meta for t in _leaves(target._asdict()))
    restored, data_pos, cfg_json = ck.restore(target, "cpu")
    assert data_pos == {"epoch": 2, "window": [1.5]} and cfg_json == '{"a": 1}'
    assert isinstance(restored.params["rnn"], list)
    _assert_equal(restored, state)
    assert all(t.device.type == "cpu" for t in _leaves(restored._asdict()))


def test_no_checkpoint_restores_none(tmp_path):
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() is None
    assert ck.restore(abstract_like(_state())) is None


def test_keeps_the_newest_n(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        ck.save(step, _state()._replace(
            step=torch.tensor(step, dtype=torch.int32)), {}, "{}")
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["3", "4"]
    restored, _, _ = ck.restore(abstract_like(_state()))
    assert int(restored.step) == 4
    with pytest.raises(FileExistsError):
        ck.save(4, _state(), {}, "{}")


def test_leftover_temporary_directory_is_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, _state(), {}, "{}")
    # a write cut off before its publish, and a stray non-step entry
    os.makedirs(tmp_path / "ckpt" / ".tmp-9-abcd")
    torch.save({"junk": torch.zeros(1)},
               tmp_path / "ckpt" / ".tmp-9-abcd" / "state.pt")
    os.makedirs(tmp_path / "ckpt" / "notes")
    assert ck.latest_step() == 3
    restored, _, _ = ck.restore(abstract_like(_state()))
    _assert_equal(restored, _state())
    ck.save(4, _state(), {}, "{}")
    assert ck.latest_step() == 4


@pytest.mark.parametrize("saved_rows,target_rows", [(6, 4), (4, 6)])
def test_row_count_adaptation(tmp_path, saved_rows, target_rows):
    """A table (and its accumulator) whose row count differs is sliced or
    zero-padded on axis 0, as arec's _adapt_leaf; the rest restores as
    saved."""
    saved = _state(rows=saved_rows)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, saved, {}, "{}")
    restored, _, _ = ck.restore(abstract_like(_state(rows=target_rows)))
    n = min(saved_rows, target_rows)
    for got, want in (
            (restored.params["tables"]["__fused__"],
             saved.params["tables"]["__fused__"]),
            (restored.opt_state["sum_of_squares"]["tables"]["__fused__"],
             saved.opt_state["sum_of_squares"]["tables"]["__fused__"])):
        assert got.shape == (target_rows, 3)
        assert torch.equal(got[:n], want[:n])
        assert torch.equal(got[n:], torch.zeros_like(got[n:]))
    assert torch.equal(restored.params["rnn"][0]["w"],
                       saved.params["rnn"][0]["w"])


@pytest.mark.parametrize("change", ["columns", "ndim", "dtype", "key",
                                    "layers"])
def test_other_mismatches_raise(tmp_path, change):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state(), {}, "{}")
    target = _state()
    p = target.params
    if change == "columns":
        p["bias"] = torch.ones(4)
        p["tables"]["__fused__"] = torch.zeros(6, 4)
        match = "beyond row padding"
    elif change == "ndim":
        p["tables"]["__fused__"] = torch.zeros(6, 3, 1)
        match = "beyond row padding"
    elif change == "dtype":
        p["bias"] = torch.ones(3, dtype=torch.float64)
        match = "dtype"
    elif change == "key":
        p["extra"] = torch.ones(1)
        match = "structure"
    else:
        p["rnn"] = p["rnn"] * 2
        match = "structure"
    with pytest.raises(ValueError, match=match):
        ck.restore(abstract_like(target))


def test_async_equals_sync_and_snapshots_before_returning(tmp_path):
    """save() returns after its host snapshot: mutating the state in place
    right after (as the next train step does) leaves the checkpoint with
    the pre-mutation values, and the async files equal the sync ones."""
    state = _state(seed=3)
    want = tree_map(torch.clone, state._asdict())
    sync = Checkpointer(str(tmp_path / "sync"))
    sync.save(7, state, {"epoch": 1}, "{}")
    ck = Checkpointer(str(tmp_path / "async"), async_save=True)
    ck.save(7, state, {"epoch": 1}, "{}")
    for t in _leaves(state._asdict()):        # the next step, in place
        t.add_(1)
    ck.drain()
    assert ck.latest_step() == 7
    for c in (ck, sync):
        restored, data_pos, _ = c.restore(abstract_like(state))
        assert data_pos == {"epoch": 1}
        _assert_equal(restored, TrainState(**want))
    for name in ("state.pt", "meta.json"):
        assert (tmp_path / "sync" / "ckpt" / "7" / name).read_bytes() == (
            tmp_path / "async" / "ckpt" / "7" / name).read_bytes()


def test_failed_async_write_raises_at_drain(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path), async_save=True)

    def broken(obj, path):
        raise OSError("disk full")
    monkeypatch.setattr(torch, "save", broken)
    ck.save(1, _state(), {}, "{}")
    with pytest.raises(OSError, match="disk full"):
        ck.drain()
    assert ck.latest_step() is None
    assert os.listdir(tmp_path / "ckpt") == []   # its temporary is gone


# ---------------------------------------------------------------------------
# Exact resume through the Trainer (arec: tests/test_checkpoint.py:188, :224)
# ---------------------------------------------------------------------------

# family → (model, train overrides, interrupt step, final step). The
# interrupt is a tail checkpoint mid-window (plateau state in flight) and
# the resumed part crosses an epoch boundary (MF: 71 batches an epoch,
# LSTM: 7).
RESUME = {
    "mf_dense": (dict(model="mf", dim=8),
                 dict(batch_size=32, steps_per_checkpoint=25), 30, 75),
    "mf_sparse_async": (dict(model="mf", dim=8),
                        dict(batch_size=32, steps_per_checkpoint=25,
                             sparse_update=True, async_ckpt=True), 30, 75),
    "lstm": (dict(model="lstm", dim=8, max_seq_len=6),
             dict(batch_size=16, num_sampled=32, steps_per_checkpoint=4),
             10, 20),
}


@pytest.mark.parametrize("family", sorted(RESUME))
def test_resume_is_exact_bit_for_bit(tmp_path, family):
    model, train, stop_at, final = RESUME[family]

    def cfg(train_dir, max_steps):
        return Config(
            data=DataConfig(syn_users=120, syn_items=90,
                            syn_interactions=2400,
                            data_dir=str(tmp_path / "data")),
            model=ModelConfig(**model),
            train=TrainConfig(n_epoch=4, max_steps=max_steps, lr_decay=0.5,
                              compute_dtype="float32",
                              train_dir=str(train_dir), **train))

    full = Trainer(cfg(tmp_path / "full", final), device="cpu")
    full.train()

    first = Trainer(cfg(tmp_path / "resume", stop_at), device="cpu")
    first.train()
    resumed = Trainer(cfg(tmp_path / "resume", final), device="cpu")
    spc = train["steps_per_checkpoint"]
    assert int(resumed.state.step) == stop_at
    assert resumed.start_step_in_epoch == stop_at % (71 if spc == 25 else 7)
    assert len(resumed._resume["window"]) == stop_at % spc
    assert resumed._resume["prev_loss"] is not None
    resumed.train()
    _assert_equal(resumed.state, full.state)

    def steps(d):
        with open(d / "metrics.jsonl") as f:
            return [json.loads(x)["step"] for x in f]
    # the interrupted run's cadence: its evals, a final record at the
    # interrupt, then the resumed run's evals and final record
    full_steps = steps(tmp_path / "full")
    assert steps(tmp_path / "resume") == (
        [s for s in full_steps[:-1] if s <= stop_at] + [stop_at]
        + [s for s in full_steps if s > stop_at])
