"""row_scatter CUDA kernel vs its plain PyTorch version, on the card, bit
for bit: the MF sparse step's main-path shapes (the packed item and user
tables of configs/syn_xing_full.json), odd and narrow widths, a base that
is only 8-byte aligned, sentinel suffixes, all-sentinel and empty id
vectors, and the in-place contract.

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
