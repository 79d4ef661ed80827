"""arec_torch's row-sharded lookups (`tables/sharded.py`) on gloo ranks
against arec's on its 8 fake devices and against `dense_lookup`:

  * `_bucket_by_owner` and `_dedup_ids` equal arec's on the same ids;
  * on meshes (1, 4), (2, 2), (4, 1) and (2, 4) the all-to-all exchange
    and the masked lookup return `dense_lookup`'s rows bit for bit: dedup
    on and off, 1-D and 2-D ids, the shuffle placement with prefix 0 and
    5, and the contiguous one;
  * at capacity_factor 1.0 the overflow count on zipf(1.3) ids equals
    arec's `EXCHANGE_DROPS` on the same ids and (2, 4) mesh, dedup on and
    off, contiguous and shuffled (tests/test_sharded.py's regression).

Each world size is one spawn (tests/torch_mesh_worker.py) running all of
its cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arec.dist.mesh import make_mesh as jmake_mesh
from arec.tables.layout import RowPerm as JRowPerm
from arec.tables.sharded import (
    EXCHANGE_DROPS as J_DROPS, _bucket_by_owner as j_bucket,
    _dedup_ids as j_dedup, make_sharded_lookup as jmake_sharded,
)
from arec_torch.tables.sharded import (
    _bucket_by_owner, _dedup_ids, pad_table_rows, round_up_rows,
    shard_row_index,
)
from torch_mesh_worker import run_ranks

torch.set_num_threads(1)

V, D = 37, 16                      # a vocabulary no mesh divides


def _cases(meshes, seed):
    rng = np.random.default_rng(seed)
    cases = []
    for mesh in meshes:
        for prefix in (None, 0, 5):
            for dedup in (False, True):
                for shape in ((48,), (8, 6)):
                    table = rng.normal(size=(V, D)).astype(np.float32)
                    ids = np.minimum(rng.zipf(1.5, int(np.prod(shape))) - 1,
                                     V - 1).astype(np.int32).reshape(shape)
                    cases.append(dict(mesh=mesh, table=table, rows=V,
                                      prefix=prefix, ids=ids, dedup=dedup,
                                      capacity_factor=0.0))
    return cases


def _drop_cases():
    """tests/test_sharded.py's overflow batch: 2048 zipf(1.3) ids over 4096
    rows on (2, 4) at capacity_factor 1.0."""
    rng = np.random.default_rng(7)
    vb = 4096
    table = rng.normal(size=(vb, D)).astype(np.float32)
    ids = np.minimum(rng.zipf(1.3, 2048) - 1, vb - 1).astype(np.int32)
    return [dict(mesh=(2, 4), table=table, rows=vb, prefix=prefix, ids=ids,
                 dedup=dedup, capacity_factor=1.0)
            for prefix in (None, 0) for dedup in (False, True)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    four = _cases([(1, 4), (2, 2), (4, 1)], 0)
    eight = _cases([(2, 4)], 1) + _drop_cases()
    return {4: (four, run_ranks("lookups", 4, tmp, {"cases": four})),
            8: (eight, run_ranks("lookups", 8, tmp, {"cases": eight}))}


def _slab(ids, mesh, rank):
    d, m = mesh
    n = ids.shape[0] // d
    return ids[(rank // m) * n:(rank // m + 1) * n]


def _check_rows(ranks, world, kind):
    cases, results = ranks[world]
    n = 0
    for i, c in enumerate(cases):
        if c["capacity_factor"]:
            continue
        for r in range(world):
            want = c["table"][_slab(c["ids"], c["mesh"], r)]
            got = results[r][i][kind]
            assert got.shape == want.shape, (c["mesh"], c["ids"].shape)
            assert np.array_equal(got, want), (
                c["mesh"], c["prefix"], c["dedup"], c["ids"].shape, r)
            n += 1
    assert n


@pytest.mark.parametrize("world", [4, 8])
def test_exchange_equals_dense_lookup(ranks, world):
    _check_rows(ranks, world, "exchange")


@pytest.mark.parametrize("world", [4, 8])
def test_masked_lookup_equals_dense_lookup(ranks, world):
    _check_rows(ranks, world, "masked")


def test_drop_count_equals_arecs(ranks):
    cases, results = ranks[8]
    jmesh = jmake_mesh(2, 4)
    counts = []
    for i, c in enumerate(cases):
        if not c["capacity_factor"]:
            continue
        table = c["table"]
        perm = (JRowPerm.for_rows(c["rows"], c["prefix"])
                if c["prefix"] is not None else None)
        if perm is not None:
            table = perm.permute_table(table)
        J_DROPS.read_and_reset()
        got_rows = jax.jit(jmake_sharded(
            jmesh, 1.0, dedup=c["dedup"], perm=perm))(
                jnp.asarray(table), jnp.asarray(c["ids"]))
        jax.effects_barrier()
        want = J_DROPS.read_and_reset()
        got = sum(results[r][i]["drops"] for r in range(8))
        assert got == want, (c["prefix"], c["dedup"], got, want)
        counts.append(got)
        # every dropped request came back as a zero row, on both sides
        port = np.concatenate([results[r][i]["exchange"] for r in (0, 4)])
        zeros = int((np.abs(port).sum(1) == 0).sum())
        assert zeros == got
        np.testing.assert_array_equal(port, np.asarray(got_rows))
        # masked lookups never drop
        masked = np.concatenate([results[r][i]["masked"] for r in (0, 4)])
        np.testing.assert_array_equal(masked, c["table"][c["ids"]])
    # contiguous without dedup overflows heavily (arec's regression); the
    # shuffle and dedup cut it
    assert counts[0] > 0.25 * 2048 and counts[0] > max(counts[1:]), counts


@pytest.mark.parametrize("capacity", [3, 8, 40])
@pytest.mark.parametrize("with_valid", [False, True])
def test_bucket_by_owner_matches_arec(capacity, with_valid):
    rng = np.random.default_rng(capacity)
    n, t, rows_per = 40, 4, 10
    ids = rng.integers(0, t * rows_per, n).astype(np.int32)
    valid = rng.random(n) < 0.7 if with_valid else None
    want = j_bucket(jnp.asarray(ids),
                    None if valid is None else jnp.asarray(valid), t,
                    rows_per, capacity)
    got = _bucket_by_owner(torch.from_numpy(ids),
                           None if valid is None else torch.from_numpy(valid),
                           t, rows_per, capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [1, 7, 64])
def test_dedup_ids_matches_arec(n):
    ids = np.random.default_rng(n).integers(0, 9, n).astype(np.int32)
    want = j_dedup(jnp.asarray(ids))
    got = _dedup_ids(torch.from_numpy(ids))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    uniq, _, inv = got
    np.testing.assert_array_equal(uniq[inv.long()].numpy(), ids)


def test_padding_and_shard_rows():
    t = torch.ones(37, 3)
    assert round_up_rows(37, 4) == 40 and pad_table_rows(t, 4).shape == (40, 3)
    assert pad_table_rows(t, 1) is t
    # the stored rows of every shard, together, are a permutation of the
    # padded table's rows; natural rows past 37 are the pad
    for perm in (None, JRowPerm.for_rows(37, 5)):
        from arec_torch.tables.layout import RowPerm
        p = None if perm is None else RowPerm(perm.prefix, perm.r, perm.a)
        idx = np.concatenate([shard_row_index(37, 4, s, p)
                              for s in range(4)])
        assert sorted(idx.tolist()) == list(range(40))
        if p is not None:
            np.testing.assert_array_equal(idx[:37], p.inv_index())
