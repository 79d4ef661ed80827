"""arec_torch's row scatter-set (`kernels/row_scatter.py`) vs arec's: the
plain version against the XLA scatter that `tools/ab_row_update.py:129`
and `arec/train/sparse.py:126` run (`.at[ids].set(rows, mode="drop",
unique_indices=True, indices_are_sorted=True)`), bit for bit, on the same
numpy-made tables, ids and rows; and the wrapper's dispatch: CPU tensors
take the plain version with use_kernel=True, use_kernel=False is the oracle
branch, and a tensor the kernel cannot run on raises."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arec_torch.kernels import row_scatter as trs

torch.set_num_threads(1)


def _case(V, W, N, n_valid, seed):
    """table [V, W], ids: n_valid sorted unique in-range ids, then a
    suffix of sentinels V; rows [N, W]."""
    rng = np.random.default_rng(seed)
    valid = np.sort(rng.choice(V, size=n_valid, replace=False))
    ids = np.concatenate([valid, np.full(N - n_valid, V)]).astype(np.int32)
    table = rng.standard_normal((V, W)).astype(np.float32)
    rows = rng.standard_normal((N, W)).astype(np.float32)
    return table, ids, rows


def _xla(table, ids, rows):
    return np.asarray(jnp.asarray(table).at[jnp.asarray(ids)].set(
        jnp.asarray(rows), mode="drop", unique_indices=True,
        indices_are_sorted=True))


KINDS = {"sentinel_suffix": (300, 180), "no_sentinel": (200, 200),
         "all_sentinel": (64, 0), "empty": (0, 0)}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("W", [129, 256, 258])
def test_plain_matches_xla_scatter_bit_for_bit(W, kind):
    N, n_valid = KINDS[kind]
    table, ids, rows = _case(1000, W, N, n_valid, seed=W + N)
    want = _xla(table, ids, rows)
    t = torch.from_numpy(table.copy())
    got = trs.scatter_rows_set_plain(t, torch.from_numpy(ids),
                                     torch.from_numpy(rows))
    assert got is t                                   # in place
    np.testing.assert_array_equal(got.numpy(), want)
    if n_valid == 0:
        np.testing.assert_array_equal(got.numpy(), table)


@pytest.mark.parametrize("W", [1, 2, 3, 4, 5])
def test_plain_matches_xla_scatter_at_narrow_widths(W):
    """The widths the kernel's vector paths treat apart: odd (4-byte
    path), 2 (head or tail only), 4 (one vector or head and tail)."""
    table, ids, rows = _case(700, W, 250, 200, seed=100 + W)
    t = torch.from_numpy(table.copy())
    got = trs.scatter_rows_set_plain(t, torch.from_numpy(ids),
                                     torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), _xla(table, ids, rows))


def _serial(table, ids, rows):
    """The serial copy: for i in order, table[ids[i]] = rows[i] where
    0 <= ids[i] < V."""
    out = table.copy()
    for i, r in zip(ids, rows):
        if 0 <= i < out.shape[0]:
            out[i] = r
    return out


@pytest.mark.parametrize("W", [3, 258])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_serial_copy_with_interleaved_sentinels(W, seed):
    """Unsorted in-range ids with sentinels >= V and negative ids between
    them (XLA's indices_are_sorted promise does not hold, so the oracle is
    a numpy loop)."""
    rng = np.random.default_rng(seed)
    V, N = 400, 300
    ids = np.where(rng.random(N) < 0.5, V + rng.integers(0, 3, N),
                   -1 - rng.integers(0, 3, N))
    valid = rng.random(N) < 0.6
    ids[valid] = rng.choice(V, size=int(valid.sum()), replace=False)
    ids = ids.astype(np.int32)
    assert (ids < 0).any() and (ids >= V).any()
    table = rng.standard_normal((V, W)).astype(np.float32)
    rows = rng.standard_normal((N, W)).astype(np.float32)
    t = torch.from_numpy(table.copy())
    got = trs.scatter_rows_set(t, torch.from_numpy(ids),
                               torch.from_numpy(rows), use_kernel=True)
    assert got is t
    np.testing.assert_array_equal(got.numpy(), _serial(table, ids, rows))


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    table, ids, rows = _case(500, 258, 120, 100, seed=1)
    want = _xla(table, ids, rows)
    before = trs.row_scatter.launches
    t = torch.from_numpy(table.copy())
    got = trs.scatter_rows_set(t, torch.from_numpy(ids),
                               torch.from_numpy(rows), use_kernel=True)
    assert got is t and trs.row_scatter.launches == before
    np.testing.assert_array_equal(got.numpy(), want)


def test_use_kernel_false_is_the_oracle_branch():
    table, ids, rows = _case(500, 129, 90, 77, seed=2)
    t = torch.from_numpy(table.copy())
    got = trs.scatter_rows_set(t, torch.from_numpy(ids),
                               torch.from_numpy(rows), use_kernel=False)
    np.testing.assert_array_equal(got.numpy(), _xla(table, ids, rows))


def test_kernel_wrapper_raises_off_cuda():
    """A tensor that is neither on the CPU nor on a CUDA device is refused
    by the kernel wrapper, not copied to the plain version."""
    t = torch.empty(10, 4, device="meta")
    ids = torch.zeros(2, dtype=torch.int32, device="meta")
    rows = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError, match="runs on cuda"):
        trs.scatter_rows_set(t, ids, rows, use_kernel=True)
