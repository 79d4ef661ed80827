"""The mesh paths' collectives on the card.

  * A one-rank NCCL group (a 1 x 1 mesh handed to the sharded functions)
    takes the port's dtypes and shapes through `all_to_all_single` (the
    exchange), `all_gather` (the exchange's reassembly, the top-k's
    candidates, `gather_rows`) and `all_reduce` (the masked lookup): each
    result equals the single-device function's, rows bit for bit, the
    top-k up to ties.
  * Two gloo ranks sharing the card take CUDA tensors through the same
    three collectives (the card run of `chip_smoke.py` serves its 2 x 4
    and 2 x 2 meshes on gloo ranks sharing one card, since NCCL refuses
    two ranks on one GPU).
  * A rank whose local rank has no card raises, and a bring-up that
    cannot reach its master raises with its coordinates.
  * Training on the one-rank NCCL group: the table gradient through the
    exchange (its reverse all-to-all and the all_gather's backward)
    equals `dense_lookup`'s; the sparse mesh step and the dense mesh step
    (the Trainer's mesh set-up on a 1 x 1 mesh, the kernels on the card)
    from a one-card Trainer's state equal its one-card steps: the sparse
    one bit for bit, the dense one at tests/test_sparse.py's rtol 2e-5,
    atol 1e-6 (the exchange's backward sums duplicate rows in another
    order than `embedding`'s).

Marked `cuda`: they skip where no CUDA device is present. On a machine with
one (and no jax), run them without the jax-loading conftest:

    python -m pytest tests/test_torch_mesh_cuda.py --noconftest -q
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_failed_nccl_bring_up_raises_with_its_coordinates(dev, monkeypatch):
    from arec_torch.dist.mesh import multihost_init

    assert not dist.is_initialized()
    port = _free_port()
    for k, v in {"WORLD_SIZE": "2", "RANK": "1", "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(port), "AREC_INIT_TIMEOUT_S": "3"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match=(
            rf"backend=nccl, master=localhost:{port}, rank=1/2, "
            rf"timeout=3s")):
        multihost_init(dev)
    assert not dist.is_initialized()


@pytest.mark.cuda
def test_rank_without_a_card_raises(dev, monkeypatch):
    from arec_torch import resolve_device

    n = torch.cuda.device_count()
    monkeypatch.setenv("LOCAL_RANK", str(n))
    with pytest.raises(RuntimeError, match=f"local rank {n} has no card"):
        resolve_device()
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert resolve_device() == torch.device("cuda:0")


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A one-rank NCCL process group and its 1 x 1 mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from arec_torch.dist.mesh import make_mesh

    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    # `cuda` with no index, as `resolve_device()` gives a single process
    yield torch.device("cuda:0"), make_mesh(1, 1, torch.device("cuda"))
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("width", [16, 129])
@pytest.mark.parametrize("prefix", [None, 0, 5])
@pytest.mark.parametrize("dedup", [False, True])
def test_lookups_on_an_nccl_rank(mesh, width, prefix, dedup):
    from arec_torch.dist.specs import shard_rows
    from arec_torch.tables.engine import dense_lookup
    from arec_torch.tables.layout import RowPerm
    from arec_torch.tables.sharded import (
        gather_rows, make_masked_lookup, make_perm_dense_lookup,
        make_sharded_lookup,
    )

    dev, m = mesh
    rows = 5000
    g = torch.Generator(device=dev).manual_seed(width)
    table = torch.randn(rows, width, generator=g, device=dev)
    ids = torch.from_numpy(np.minimum(
        np.random.default_rng(width).zipf(1.3, 4096) - 1, rows - 1).astype(
            np.int32)).to(dev).reshape(64, 64)
    perm = None if prefix is None else RowPerm.for_rows(rows, prefix)
    stored = table if perm is None else perm.permute_table(table)
    shard = shard_rows(stored, m)
    want = dense_lookup(table, ids)
    with torch.inference_mode():
        assert torch.equal(make_sharded_lookup(m, dedup=dedup, perm=perm)(
            shard, ids), want)
        assert torch.equal(make_masked_lookup(m, perm)(shard, ids), want)
        whole = gather_rows(shard, m)
        assert torch.equal(whole, stored)
        if perm is not None:
            assert torch.equal(make_perm_dense_lookup(perm)(whole, ids), want)


@pytest.mark.cuda
def test_exchange_counts_its_drops_on_an_nccl_rank(mesh):
    from arec_torch.tables.sharded import EXCHANGE_DROPS, make_sharded_lookup

    dev, m = mesh
    table = torch.arange(1, 101, dtype=torch.float32, device=dev)[:, None]
    ids = torch.arange(64, dtype=torch.int32, device=dev)
    EXCHANGE_DROPS.read_and_reset()
    with torch.inference_mode():
        got = make_sharded_lookup(m, capacity_factor=0.25, dedup=False)(
            table, ids)
    # one shard: capacity 16 of 64 requests, the rest dropped and zero
    assert EXCHANGE_DROPS.read_and_reset() == 48
    assert int((got[:, 0] == 0).sum()) == 48


@pytest.mark.cuda
@pytest.mark.parametrize("recall_target", [1.0, 0.95])
def test_sharded_topk_on_an_nccl_rank(mesh, recall_target):
    from arec_torch.retrieval.mips import make_sharded_topk
    from arec_torch.train.evalu import topk_with_mask
    from torch_topk_check import assert_topk_equal_up_to_ties, ref_scores

    dev, m = mesh
    g = torch.Generator(device=dev).manual_seed(0)
    v = torch.randn(200_003, 64, generator=g, device=dev)
    b = torch.randn(200_003, generator=g, device=dev) * 0.1
    q = torch.randn(64, 64, generator=g, device=dev)
    seen = torch.randint(-1, 200_003, (64, 40), generator=g, device=dev,
                         dtype=torch.int32)
    with torch.inference_mode():
        got = make_sharded_topk(m, k=30, recall_target=recall_target)(
            q, v, b, seen)
        want = topk_with_mask(q, v, b, seen, k=30,
                              recall_target=recall_target)
    # one shard: the same selection as one device (the approximate one
    # too: the same bins, then an exact merge)
    scores = ref_scores(q.cpu().numpy(), v.cpu().numpy(), b.cpu().numpy(),
                        seen.cpu().numpy())
    assert_topk_equal_up_to_ties(*(x.cpu().numpy() for x in got),
                                 *(x.cpu().numpy() for x in want), scores)


@pytest.mark.cuda
def test_gloo_ranks_share_the_card_with_cuda_tensors(dev, tmp_path):
    from torch_mesh_worker import run_ranks

    res = run_ranks("gloo_cuda", 2, tmp_path, {"device": "cuda:0"})
    for r, out in enumerate(res):
        assert out["all_to_all"] == [[0, 1, 100, 101], [2, 3, 102, 103]][r]
        assert out["all_gather"] == [0.0, 1.0]
        assert out["all_reduce"] == [1.0, 1.0]
        assert out["rows_all_to_all"] == out["rows_want"]
        assert out["device"] == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("dedup", [False, True])
def test_exchange_backward_on_an_nccl_rank(mesh, dedup):
    from arec_torch.dist.specs import shard_rows
    from arec_torch.tables.engine import dense_lookup
    from arec_torch.tables.layout import RowPerm
    from arec_torch.tables.sharded import make_sharded_lookup

    dev, m = mesh
    rows, width = 5000, 129
    g = torch.Generator(device=dev).manual_seed(3)
    table = torch.randn(rows, width, generator=g, device=dev)
    ids = torch.from_numpy(np.minimum(
        np.random.default_rng(3).zipf(1.3, 4096) - 1, rows - 1).astype(
            np.int32)).to(dev)
    cot = torch.randn(4096, width, generator=g, device=dev)
    perm = RowPerm.for_rows(rows, 5)
    shard = shard_rows(perm.permute_table(table), m).clone().requires_grad_()
    (make_sharded_lookup(m, dedup=dedup, perm=perm)(shard, ids) * cot
     ).sum().backward()
    # each row's gradient is a sum of its requests' cotangent rows, added
    # in an order the card's atomics choose: held to the f64 sum within
    # n·2^-23·Σ|terms| for a row of n requests
    long = ids.long()
    exact = torch.zeros(rows, width, dtype=torch.float64, device=dev)
    exact.index_add_(0, long, cot.double())
    mass = torch.zeros_like(exact).index_add_(0, long, cot.double().abs())
    n = torch.bincount(long, minlength=rows).double()[:, None]
    bound = perm.permute_table(n * 2.0 ** -23 * mass)
    err = (shard.grad.double() - perm.permute_table(exact)).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy(v) for v in tree)
    return tree.clone()


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [True, False])
def test_train_step_on_an_nccl_rank(mesh, sparse, tmp_path):
    from arec_torch import bridge
    from arec_torch.config import (
        Config, DataConfig, MeshConfig, ModelConfig, TrainConfig,
    )
    from arec_torch.dist.global_io import shard_from_hosts
    from arec_torch.train.loop import Trainer, _MeshServing
    from arec_torch.train.step import TrainState, step_generator

    dev, _ = mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config(
        data=DataConfig(data_dir=str(tmp_path / "d"), syn_users=3000,
                        syn_items=2500, syn_interactions=40000),
        model=ModelConfig(model="mf", dim=32, dense_vocab_threshold=12),
        train=TrainConfig(batch_size=512, num_sampled=256,
                          sparse_update=sparse, compute_dtype="bfloat16",
                          train_dir=str(tmp_path / "t")),
        mesh=MeshConfig(row_shard="shuffle"))
    tr = Trainer(cfg, device=dev)
    batch = shard_from_hosts(next(tr._batches(0)), None, dev)
    state0 = TrainState(**_copy(tr.state._asdict()))
    one, m_one = tr.step_fn(TrainState(**_copy(state0._asdict())), batch,
                            step_generator(0, 0))
    tr.sh = _MeshServing(cfg, tr.spec, tr.is_seq, dev)
    step = tr._make_step()
    got, m_mesh = step(bridge.shard_state(state0._asdict(), tr.sh, sparse,
                                          dev), batch, step_generator(0, 0))
    got = tr.sh.canonical(got, sparse, tr._natural_rows)
    for (k, a), (_, b) in zip(_leaves(one._asdict()),
                              _leaves(got._asdict())):
        a, b = a.cpu(), b.cpu()     # the gathered tables are on the host
        if sparse:
            assert torch.equal(a, b), k
        else:
            torch.testing.assert_close(b, a, rtol=2e-5, atol=1e-6,
                                       msg=lambda msg: f"{k}: {msg}")
    if sparse:
        assert float(m_one["loss"]) == float(m_mesh["loss"])
    else:
        assert float(m_mesh["loss"]) == pytest.approx(float(m_one["loss"]),
                                                      rel=1e-5)
