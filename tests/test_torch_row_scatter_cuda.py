"""row_scatter CUDA kernel vs its plain PyTorch version, on the card, bit
for bit: the MF sparse step's main-path shapes (the packed item and user
tables of configs/syn_xing_full.json), odd and narrow widths, a base that
is only 8-byte aligned, sentinel suffixes, all-sentinel and empty id
vectors, and the in-place contract; and the kernel's own edges: every
(source phase, destination phase) pair of a 258-wide row on a 16- and an
8-byte aligned table base, widths 1 to 1000, id counts below 32, off a
multiple of 32 and past one wave of blocks, sentinels and negative ids
interleaved, repeated launches, and its launch plan at the main path.

Marked `cuda`: they skip where no CUDA device is present. On a machine with
one (and no jax), run them without the jax-loading conftest:

    python -m pytest tests/test_torch_row_scatter_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from arec_torch.kernels import row_scatter as trs


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(V, W, N, n_valid, dev, seed=0):
    """table [V, W], sorted unique ids (n_valid in range, then sentinels
    V), rows [N, W]."""
    rng = np.random.default_rng(seed)
    valid = np.sort(rng.choice(V, size=n_valid, replace=False))
    ids = np.concatenate([valid, np.full(N - n_valid, V)]).astype(np.int32)
    table = torch.randn(V, W, generator=torch.Generator(device=dev)
                        .manual_seed(seed), device=dev)
    rows = torch.from_numpy(rng.standard_normal((N, W)).astype(np.float32))
    return table, torch.from_numpy(ids).to(dev), rows.to(dev)


CASES = {
    "item_main_path": (1_304_126, 258, 14_365, 14_000),
    "user_main_path": (1_504_123, 256, 12_314, 12_000),
    "odd_width": (5_000, 129, 700, 650),
    "narrow": (100, 3, 40, 40),
    "all_sentinel": (1_000, 258, 64, 0),
    "one_row": (10, 256, 1, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_bit_for_bit(dev, name):
    V, W, N, n_valid = CASES[name]
    table, ids, rows = _case(V, W, N, n_valid, dev)
    want = trs.scatter_rows_set_plain(table.clone(), ids, rows)
    before = trs.row_scatter.launches
    ptr = table.data_ptr()
    got = trs.scatter_rows_set(table, ids, rows, use_kernel=True)
    torch.cuda.synchronize()
    assert trs.row_scatter.launches == before + 1
    assert got.data_ptr() == ptr                      # in place
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_untouched_rows_keep_their_bits(dev):
    table, ids, rows = _case(20_000, 258, 3_000, 2_500, dev, seed=3)
    orig = table.clone()
    trs.row_scatter(table, ids, rows)
    torch.cuda.synchronize()
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device=dev)
    touched[ids[ids < table.shape[0]].long()] = True
    assert torch.equal(table[~touched], orig[~touched])
    assert torch.equal(table[ids[:2_500].long()], rows[:2_500])


@pytest.mark.cuda
def test_base_aligned_to_8_bytes_only(dev):
    """A view that starts at an odd row of a 258-wide table: its base is
    8- but not 16-byte aligned, so the kernel must take 8-byte vectors."""
    big, ids, rows = _case(4_001, 258, 900, 850, dev, seed=5)
    view = big[1:]
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    want = trs.scatter_rows_set_plain(view.clone(), ids, rows)
    trs.row_scatter(view, ids, rows)
    torch.cuda.synchronize()
    assert torch.equal(view, want)


@pytest.mark.cuda
def test_empty_ids_launch_nothing(dev):
    table = torch.randn(50, 256, device=dev)
    orig = table.clone()
    before = trs.row_scatter.launches
    ids = torch.zeros(0, dtype=torch.int32, device=dev)
    trs.scatter_rows_set(table, ids, torch.zeros(0, 256, device=dev),
                         use_kernel=True)
    assert trs.row_scatter.launches == before
    assert torch.equal(table, orig)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    table = torch.randn(50, 8, device=dev)
    ids = torch.zeros(3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        trs.row_scatter(table, ids.long(), torch.zeros(3, 8, device=dev))
    with pytest.raises(ValueError, match="must be"):
        trs.row_scatter(table, ids, torch.zeros(3, 9, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        trs.row_scatter(table, ids, torch.zeros(8, 3, device=dev).T)


def _scatter_ids(V, N, rng, valid):
    """ids [N] int32: distinct in-range ids at the rows `valid` (a bool
    mask), sentinels elsewhere, half of them V and above, half negative."""
    ids = np.where(rng.random(N) < 0.5, V + rng.integers(0, 5, N),
                   -1 - rng.integers(0, 5, N)).astype(np.int64)
    ids[valid] = rng.choice(V, size=int(valid.sum()), replace=False)
    return torch.from_numpy(ids.astype(np.int32))


def _check(table, ids, rows):
    """One launch against the plain version, bit for bit, in place, and
    the rows no id names unchanged."""
    want = trs.scatter_rows_set_plain(table.clone(), ids, rows)
    orig = table.clone()
    before = trs.row_scatter.launches
    trs.row_scatter(table, ids, rows)
    torch.cuda.synchronize()
    assert trs.row_scatter.launches == before + 1
    assert torch.equal(table, want)
    V = table.shape[0]
    touched = torch.zeros(V, dtype=torch.bool, device=table.device)
    ok = (ids >= 0) & (ids < V)
    touched[ids[ok].long()] = True
    assert torch.equal(table[~touched], orig[~touched])


@pytest.mark.cuda
@pytest.mark.parametrize("table_base", [16, 8])
@pytest.mark.parametrize("src_phase", [0, 8])
@pytest.mark.parametrize("dst_phase", [0, 8])
def test_phase_pairs_of_a_258_wide_row(dev, table_base, src_phase,
                                       dst_phase):
    """W = 258 (a 1,032-byte pitch): a row's base is 0 or 8 mod 16 by its
    index. Only the rows with the given source phase carry in-range ids,
    and those only to table rows with the given destination phase, so
    each launch takes one of the four paths; for table_base 8 the table
    and the rows are views that start 8 bytes off a 16-byte boundary."""
    V, W, N = 6_001, 258, 1_000
    rng = np.random.default_rng(table_base + 2 * src_phase + dst_phase)
    big = torch.from_numpy(rng.standard_normal((V + 1, W)).astype(
        np.float32)).to(dev)
    table = big[1:] if table_base == 8 else big[:V]
    assert table.data_ptr() % 16 == table_base % 16
    rows_big = torch.from_numpy(rng.standard_normal((N + 1, W)).astype(
        np.float32)).to(dev)
    rows = rows_big[1:] if table_base == 8 else rows_big[:N]
    r_phase = (rows.data_ptr() + np.arange(N) * W * 4) % 16
    valid = r_phase == src_phase
    cand = np.flatnonzero((table.data_ptr() + np.arange(V) * W * 4) % 16
                          == dst_phase)
    ids = np.full(N, V, dtype=np.int64)
    ids[valid] = rng.choice(cand, size=int(valid.sum()), replace=False)
    ids[~valid & (np.arange(N) % 4 == 1)] = -3
    outside = 0 if table_base == 8 else V      # the row of `big` off the view
    kept = big[outside].clone()
    _check(table, torch.from_numpy(ids.astype(np.int32)).to(dev), rows)
    assert torch.equal(big[outside], kept)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 2, 3, 4, 5, 129, 256, 258, 1000])
def test_widths(dev, W):
    V, N = 3_000, 777
    rng = np.random.default_rng(W)
    table = torch.from_numpy(rng.standard_normal((V, W)).astype(
        np.float32)).to(dev)
    rows = torch.from_numpy(rng.standard_normal((N, W)).astype(
        np.float32)).to(dev)
    ids = _scatter_ids(V, N, rng, rng.random(N) < 0.8).to(dev)
    _check(table, ids, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 5, 31, 32, 33, 97, 4_100])
@pytest.mark.parametrize("W", [258, 256, 7])
def test_id_counts(dev, N, W):
    """N below 32, off a multiple of 32 and off a whole block of rows."""
    V = 10_000
    rng = np.random.default_rng(N * 1000 + W)
    table = torch.from_numpy(rng.standard_normal((V, W)).astype(
        np.float32)).to(dev)
    rows = torch.from_numpy(rng.standard_normal((N, W)).astype(
        np.float32)).to(dev)
    ids = _scatter_ids(V, N, rng, rng.random(N) < 0.7).to(dev)
    _check(table, ids, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [6, 5])
def test_more_ids_than_one_wave(dev, W):
    """More blocks than the card holds at once: the grid runs in several
    waves."""
    V, N = 600_000, 300_001
    rng = np.random.default_rng(W)
    table = torch.from_numpy(rng.standard_normal((V, W)).astype(
        np.float32)).to(dev)
    rows = torch.from_numpy(rng.standard_normal((N, W)).astype(
        np.float32)).to(dev)
    plan = trs.launch_plan(table, rows)
    assert plan["grid"] > 4 * plan["sms"] * plan["blocks_per_sm"], plan
    ids = _scatter_ids(V, N, rng, rng.random(N) < 0.9).to(dev)
    _check(table, ids, rows)


@pytest.mark.cuda
def test_sentinels_and_negative_ids_interleaved(dev):
    """Unsorted in-range ids with sentinels >= V and negative ids between
    them, at the item table's width."""
    V, W, N = 50_000, 258, 5_000
    rng = np.random.default_rng(11)
    table = torch.from_numpy(rng.standard_normal((V, W)).astype(
        np.float32)).to(dev)
    rows = torch.from_numpy(rng.standard_normal((N, W)).astype(
        np.float32)).to(dev)
    ids = _scatter_ids(V, N, rng, rng.random(N) < 0.5).to(dev)
    assert bool((ids < 0).any()) and bool((ids >= V).any())
    _check(table, ids, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [258, 256])
def test_repeated_launch_is_bit_for_bit(dev, W):
    """Two launches of the same write-back into two copies of the same
    table give the same bits."""
    table, ids, rows = _case(200_000, W, 14_365, 13_468, dev, seed=W)
    a, b = table.clone(), table
    trs.row_scatter(a, ids, rows)
    trs.row_scatter(b, ids, rows)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["item_main_path", "user_main_path"])
def test_launch_plan_at_the_main_path(dev, name):
    """16-byte vectors, a warp for every row and no spills at the two
    write-back shapes."""
    V, W, N, _ = CASES[name]
    table = torch.empty(V, W, device=dev)
    rows = torch.empty(N, W, device=dev)
    plan = trs.launch_plan(table, rows)
    assert plan["vector_bytes"] == 16 and plan["local_bytes"] == 0, plan
    assert plan["grid"] * plan["threads"] // 32 >= N, plan
    assert plan["blocks_per_sm"] >= 1, plan
