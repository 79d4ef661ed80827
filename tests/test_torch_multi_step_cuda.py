"""The K-step dispatch on the card (`train/graph.py`): one CUDA graph
replay for K steps against K eager steps, at small shapes.

- a c4-like LSTM (bf16, attribute fusion, untied output: B1's training
  launch, B2, B5, B6), the same with the GRU cell (B3's training launch,
  B4) and the MF sparse step (B5, B6, B7): three
  dispatches of K (the eager warm-up, then two replays with other step
  keys) against 3K eager steps from the same state, every leaf and metric
  bit for bit, or within the gap two eager runs show between themselves
  where the card sums with atomics (printed with -s);
- keep_prob 0.8 with two checkpointed segments: the replays equal the
  eager steps, and with lr 0 and fixed negatives the dropout masks of the
  slots and of two replays differ (their losses do);
- a `decay_lr` between replays takes effect in the next one;
- no op of one eager step of either kind syncs with the host
  (`torch.cuda.set_sync_debug_mode("error")`).

Marked `cuda`: they skip where no CUDA device is present. On a machine with
one (and no jax), run them without the jax-loading conftest:

    python -m pytest tests/test_torch_multi_step_cuda.py --noconftest -q -s
"""

import numpy as np
import pytest
import torch

from arec_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from arec_torch.data.dataset import mf_batches, seq_batches
from arec_torch.data.synthetic import generate
from arec_torch.models import mf as tmf
from arec_torch.models import seq as tseq
from arec_torch.tables.engine import attrs_to_device
from arec_torch.train import sparse as tsparse
from arec_torch.train import step as tstep
from arec_torch.train.graph import scan_multi

K = 4
DATA = DataConfig(syn_users=400, syn_items=600, syn_interactions=20000)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _lstm(dev, lr=0.5, sampled=None, **model):
    """(state, core, host batches) of a c4-like LSTM on the card."""
    cfg = Config(data=DATA,
                 model=ModelConfig(model="lstm", dim=64, max_seq_len=10,
                                   use_attributes=True, use_pallas_scan=True,
                                   dense_vocab_threshold=16, **model),
                 train=TrainConfig(batch_size=32, num_sampled=128,
                                   compute_dtype="bfloat16",
                                   learning_rate=lr))
    ds = generate(cfg.data)
    spec = tseq.SeqSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    idev = attrs_to_device(ds.item_attrs.restrict(spec.item_in.schema),
                           spec.item_in, dev)

    def loss_fn(p, batch, gen):
        return tseq.seq_loss(p, spec, idev, None, batch, gen, sampled=sampled,
                             time_major=True)

    opt = tstep.make_optimizer("adagrad", lr)
    params = tseq.init_seq(torch.Generator(device=dev).manual_seed(0), spec)
    return (tstep.init_state(params, opt),
            tstep.make_step_core(loss_fn, opt, lr),
            list(seq_batches(ds, 32, spec.pack_len, 0, 0)), spec)


def _mf(dev):
    cfg = Config(data=DATA,
                 model=ModelConfig(model="mf", dim=64, use_attributes=True),
                 train=TrainConfig(batch_size=256, num_sampled=256,
                                   compute_dtype="bfloat16",
                                   learning_rate=0.2, sparse_update=True))
    ds = generate(cfg.data)
    spec = tmf.MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    udev = attrs_to_device(ds.user_attrs.restrict(spec.user.schema),
                           spec.user, dev)
    idev = attrs_to_device(ds.item_attrs.restrict(spec.item.schema),
                           spec.item, dev)
    opt = tstep.make_optimizer("adagrad", 0.2)
    params = tmf.init_mf(torch.Generator(device=dev).manual_seed(0), spec)
    state = tsparse.init_sparse_state(
        params, tsparse.table_paths(False, spec), opt, "adagrad")
    core = tsparse.make_sparse_step_core(False, spec, udev, idev, opt, 0.2,
                                         "adagrad")
    return state, core, list(mf_batches(ds, 256, 0, 0)), spec


def _clone(state):
    return type(state)(*(tstep.tree_map(torch.clone, x) for x in state))


def _on(batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _eager(state, core, batches, dev, steps, decay_at=None):
    ms = []
    for i in range(steps):
        if i == decay_at:
            state = tstep.decay_lr(state, 0.5)
        state, m = core(state, _on(batches[i % len(batches)], dev),
                        tstep.step_generator(0, i))
        ms.append(m)
    return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}


def _graphed(state, core, batches, dev, n, decay_at=None):
    multi = scan_multi(core, K)
    ms = []
    for d in range(n):
        if d * K == decay_at:
            state = tstep.decay_lr(state, 0.5)
        group = [_on(batches[(d * K + i) % len(batches)], dev)
                 for i in range(K)]
        state, m = multi(state, group, [tstep.step_generator(0, d * K + i)
                                        for i in range(K)])
        ms.append(m)
    assert (multi.captures, multi.replays) == (1, n - 1)
    return state, {k: torch.cat([m[k] for m in ms]) for k in ms[0]}


def _gap(a, b):
    (sa, ma), (sb, mb) = a, b
    pairs = list(zip(tstep._leaves(sa._asdict()),
                     tstep._leaves(sb._asdict())))
    pairs += [(ma[k], mb[k]) for k in ma]
    return max(float((x.double() - y.double()).abs().max()) for x, y in pairs
               if x.numel())


def _check(name, make, dev, decay_at=None):
    state, core, batches, _ = make(dev)
    a1 = _eager(_clone(state), core, batches, dev, 3 * K, decay_at)
    a2 = _eager(_clone(state), core, batches, dev, 3 * K, decay_at)
    b = _graphed(state, core, batches, dev, 3, decay_at)
    torch.cuda.synchronize()
    eager_gap, graph_gap = _gap(a1, a2), _gap(a1, b)
    print(f"{name}: graph vs eager max|d| {graph_gap:.3e}, eager vs eager "
          f"{eager_gap:.3e}")
    assert graph_gap <= eager_gap, (graph_gap, eager_gap)
    return a1, b


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lstm", "gru", "mf_sparse"])
def test_replays_equal_eager_steps(dev, case):
    make = {"lstm": lambda d: _lstm(d), "gru": lambda d: _lstm(d, cell="gru"),
            "mf_sparse": _mf}[case]
    _check(case, make, dev)


@pytest.mark.cuda
def test_decay_between_replays_takes_effect(dev):
    _, b = _check("mf_sparse, decay before the second replay", _mf, dev,
                  decay_at=2 * K)
    assert float(b[1]["lr"][2 * K]) == float(b[1]["lr"][0]) * 0.5


@pytest.mark.cuda
def test_dropout_replays_equal_eager_and_draw_new_masks(dev):
    _check("lstm keep_prob 0.8, 2 segments",
           lambda d: _lstm(d, keep_prob=0.8, train_segments=2), dev)
    spec = _lstm(dev, keep_prob=0.8)[3]
    g = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, spec.vocab, (128,), generator=g, device=dev,
                        dtype=torch.int32)
    sampled = (ids, torch.full((128,), 1.0 / spec.vocab, device=dev))
    state, core, batches, _ = _lstm(dev, lr=0.0, sampled=sampled,
                                    keep_prob=0.8)
    _, m = _graphed(state, core, [batches[0]] * K, dev, 3)
    losses = m["loss"][K:].tolist()
    assert len(set(losses)) == 2 * K, losses


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lstm", "mf_sparse"])
def test_a_step_does_not_sync_with_the_host(dev, case):
    state, core, batches, _ = (_lstm(dev) if case == "lstm" else _mf(dev))
    state, _ = core(state, _on(batches[0], dev), tstep.step_generator(0, 0))
    b = _on(batches[1], dev)
    gen = tstep.step_generator(0, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = core(state, b, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert np.isfinite(float(m["loss"]))
