"""arec_torch's RowPerm (the row_shard = "shuffle" placement) against
arec's, bit for bit: the multiplier, `perm_index`, `inv_index`,
`apply_ids` (arec's uint32 double-and-add against the port's int64
product, the sentinel id prefix + R included) and `permute_table` both
ways, over R up to syn_xing_full's user table and prefixes 0 and 5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arec.tables.layout import RowPerm as JRowPerm
from arec_torch.tables.layout import RowPerm

torch.set_num_threads(1)

ROWS = [3, 4, 7, 37, 1000, 4096, 65_537, 1_304_126, 1_504_123]


@pytest.mark.parametrize("prefix", [0, 5])
@pytest.mark.parametrize("rows", ROWS)
def test_rowperm_matches_arec(rows, prefix):
    total = rows + prefix
    want = JRowPerm.for_rows(total, prefix)
    got = RowPerm.for_rows(total, prefix)
    assert (got.prefix, got.r, got.a) == (want.prefix, want.r, want.a)
    np.testing.assert_array_equal(got.perm_index(), want.perm_index())
    np.testing.assert_array_equal(got.inv_index(), want.inv_index())
    rng = np.random.default_rng(rows)
    ids = np.concatenate([
        np.arange(min(total, 64)), [total, total - 1, prefix, prefix + 1],
        rng.integers(0, total, 4096)]).astype(np.int32)
    j = np.asarray(want.apply_ids(jnp.asarray(ids)))
    t = got.apply_ids(torch.from_numpy(ids))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), j)
    # the stored ids are a permutation of the natural ones
    np.testing.assert_array_equal(got.perm_index()[ids[ids < total]],
                                  t.numpy()[ids < total])


@pytest.mark.parametrize("prefix", [0, 5])
@pytest.mark.parametrize("pad", [0, 3])
def test_permute_table_matches_arec(prefix, pad):
    rows, width = 37, 6
    rng = np.random.default_rng(1)
    natural = rng.normal(size=(rows + pad, width)).astype(np.float32)
    p = RowPerm.for_rows(rows, prefix)
    jp = JRowPerm.for_rows(rows, prefix)
    for inverse in (False, True):
        want = np.asarray(jp.permute_table(jnp.asarray(natural), inverse))
        np.testing.assert_array_equal(
            p.permute_table(torch.from_numpy(natural), inverse).numpy(),
            want)
        np.testing.assert_array_equal(p.permute_table(natural, inverse),
                                      want)
    stored = p.permute_table(natural)
    np.testing.assert_array_equal(p.permute_table(stored, inverse=True),
                                  natural)
    # a lookup through apply_ids on the stored table reads natural rows
    ids = torch.arange(rows, dtype=torch.int32)
    np.testing.assert_array_equal(stored[p.apply_ids(ids).numpy()],
                                  natural[:rows])


def test_tiny_tables_have_no_perm():
    assert RowPerm.for_rows(2, 0) is None and JRowPerm.for_rows(2, 0) is None
    assert RowPerm.for_rows(7, 5) is None and JRowPerm.for_rows(7, 5) is None
