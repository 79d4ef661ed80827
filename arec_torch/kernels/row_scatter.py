"""Row scatter-set into a table (port of `tools/ab_row_update.py`'s
`scatter_rows_set`): `table[ids] = rows` in place, ids outside [0, V)
dropped.

The contract is that of the XLA scatter arec's sparse step runs for its
packed-table write-back (`table.at[ids].set(rows, mode="drop",
unique_indices=True, indices_are_sorted=True)`, `arec/train/sparse.py:126`):
table f32 [V, W], ids int32 [N], rows f32 [N, W]; the in-range ids are
unique (and, on the sparse step's path, sorted, forming a prefix followed by
a suffix of sentinel ids >= V). Rows no id names keep their bits.

`scatter_rows_set(..., use_kernel=True)` launches the hand-written kernel of
`arec_torch/csrc/row_scatter.cu` (sm_90a; replaces
`tools/ab_row_update.py:_kernel`) for CUDA tensors, or raises; for CPU
tensors it takes the plain version. `use_kernel=False` is the tool's oracle
branch, the plain version on any device. The tool's `_MIN_ROWS` (a TPU
crossover) is not inherited: the caller chooses.

The plain version `scatter_rows_set_plain` masks the ids and uses
`index_copy_`; its boolean mask costs a host sync on CUDA, which the kernel
does not (each row's warp reads its own id and drops it there).
`launch_plan` reports what the kernel would launch (grid, registers,
resident blocks, vector width) without launching it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from arec_torch.kernels import _build

KERNEL = "row_scatter"


@torch.no_grad()
def scatter_rows_set_plain(table: torch.Tensor, ids: torch.Tensor,
                           rows: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: table[ids] = rows in place for the ids
    in [0, V); returns `table`."""
    ok = (ids >= 0) & (ids < table.shape[0])
    table.index_copy_(0, ids[ok].long(), rows[ok])
    return table


@functools.cache
def _fn():
    fn = _build.load(KERNEL).row_scatter
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _plan_fn():
    fn = _build.load(KERNEL).row_scatter_plan
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


PLAN_KEYS = ("grid", "threads", "sms", "blocks_per_sm", "registers",
             "local_bytes", "vector_bytes")


def launch_plan(table: torch.Tensor, rows: torch.Tensor) -> dict:
    """What `row_scatter(table, ids, rows)` launches on this card for
    N = rows.shape[0] ids (no launch): grid and threads a block (one warp a
    row), the card's SMs and the kernel's resident blocks an SM, its
    registers and local bytes a thread, and its vector width (16: 16-byte
    vectors with each row's phase handled; 4: floats)."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    with torch.cuda.device(table.device):
        rc = _plan_fn()(table.data_ptr(), rows.data_ptr(), table.shape[1],
                        rows.shape[0], out)
    if rc != 0:
        raise RuntimeError(f"row_scatter_plan failed: CUDA error {rc}")
    return dict(zip(PLAN_KEYS, out))


@torch.no_grad()
def row_scatter(table: torch.Tensor, ids: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors: the contract of `scatter_rows_set_plain`,
    with no host sync. N = 0 launches nothing. Raises on anything the kernel
    does not take."""
    if table.device.type != "cuda":
        raise ValueError(f"row_scatter runs on cuda, not {table.device}")
    if table.dim() != 2:
        raise ValueError(f"table must be [V, W], got {tuple(table.shape)}")
    V, W = table.shape
    N = ids.shape[0]
    want = {"table": (table, (V, W), torch.float32),
            "ids": (ids, (N,), torch.int32),
            "rows": (rows, (N, W), torch.float32)}
    for name, (t, shape, dt) in want.items():
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, not {table.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if N == 0:
        return table
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        rc = _fn()(table.data_ptr(), ids.data_ptr(), rows.data_ptr(), V, W,
                   N, stream)
    if rc != 0:
        raise RuntimeError(f"row_scatter launch failed: CUDA error {rc}")
    row_scatter.launches += 1
    return table


row_scatter.launches = 0   # kernel launches since the caller last reset it


def scatter_rows_set(table: torch.Tensor, ids: torch.Tensor,
                     rows: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """table[ids] = rows in place (ids outside [0, V) dropped); returns
    `table`. use_kernel=True: the kernel for CUDA tensors (or a raise), the
    plain version for CPU tensors; use_kernel=False: the plain version."""
    if use_kernel and table.device.type != "cpu":
        return row_scatter(table, ids, rows)
    return scatter_rows_set_plain(table, ids, rows)
