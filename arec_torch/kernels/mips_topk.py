"""The exact seen-masked top-k of serving and evaluation as hand-written
CUDA kernels (`arec_torch/csrc/mips_topk.cu`): for each query row, the k
best of bf16(query)·bf16(items)ᵀ + bias over every item, −1e9 added for
each entry of the row's seen slab that names an item, descending.

It replaces no TPU kernel: arec's top-k is `lax.top_k` over scores that
XLA computes. It is added because the port's chain of library ops for it
(operand casts, an f32 product, the bias add, the `index_put_` penalty,
`torch.topk`) took 9.4 ms of device time a call at MF's serving shape
(B 256, V 1,304,126, D 128, k 30), about 90 times its bound: the bf16
item matrix and its f32 bias, 339 MB, take 0.101 ms at 3.35 TB/s, and the
85.5 GFLOP of products 0.086 ms at 989 TFLOP/s. The kernels stream the
item matrix through the tensor cores, keep only the scores that reach a
floor sampled from every slab, and select from those, so no score matrix
reaches device memory (the source's note says how). A call is four
launches on the current stream and one scratch allocation.

`mips_topk` launches the kernels for CUDA tensors, or raises: there is
no fallback. `mips_topk_plain` is the plain version, the one-device exact
top-k that `train/evalu.topk_with_mask` takes for CPU tensors:
`retrieval/mips.score_and_select` over the seen slab as
`retrieval/mips.seen_rule` reads it at V (an id ≥ V dropped up to
BLOCKED_EVAL_MIN_V items, clamped to V − 1 above). The kernels apply that
rule to each id as they read the slab, so the answer is the plain
version's at every V. `launch_plan` reports what the kernels would
launch, without launching.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from arec_torch.kernels import _build
from arec_torch.retrieval.mips import clamps, score_and_select, seen_rule

KERNEL = "mips_topk"
MAX_K = 64       # the kernel's widest list
MAX_D = 256      # its deepest row; D is a multiple of 16
MAX_V = 1 << 29  # its most items (an item's offset fits a 32-bit tag)


@torch.no_grad()
def mips_topk_plain(query, items, bias, seen, k: int = 30,
                    compute_dtype=torch.bfloat16, score_mem_mb: int = 512):
    """Plain version: (scores [B, k], ids [B, k]), the query-blocked loop
    over `seen_rule(seen, V)` (operands rounded to `compute_dtype`,
    products summed in f32, peak score memory bounded by
    `score_mem_mb`)."""
    return score_and_select(query, items, bias,
                            seen_rule(seen, items.shape[0]), k,
                            compute_dtype, score_mem_mb=score_mem_mb)


@functools.cache
def _fn():
    fn = _build.load(KERNEL).mips_topk
    fn.argtypes = ([ctypes.c_void_p] * 4
                   + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


PLAN_KEYS = ("splits", "query_tiles", "threads", "smem_bytes",
             "blocks_per_sm", "registers", "local_bytes", "kept_per_row",
             "sms", "final_smem_bytes", "scratch_bytes")


@functools.cache
def _plan(device_index: int, B: int, V: int, D: int, k: int) -> dict:
    fn = _build.load(KERNEL).mips_topk_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    with torch.cuda.device(device_index):
        rc = fn(B, V, D, k, out)
    if rc != 0:
        raise RuntimeError(f"mips_topk_plan failed: CUDA error {rc}")
    return dict(zip(PLAN_KEYS, out))


def launch_plan(query: torch.Tensor, items: torch.Tensor, k: int) -> dict:
    """What `mips_topk(query, items, ...)` launches on this card (no
    launch): the split count (item slabs, one select CTA each a query
    tile), the query tiles, the select CTA's threads, dynamic shared bytes,
    resident CTAs a SM, registers and local bytes a thread, the scores it
    keeps a row before it cuts them to k, the card's SMs, the final pass's
    shared bytes and the scratch bytes a call."""
    return dict(_plan(query.device.index or 0, query.shape[0],
                      items.shape[0], items.shape[1], k))


def _check(query, items, bias, seen, k, compute_dtype):
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"mips_topk computes with bf16 operands, not "
                         f"{compute_dtype}")
    if query.dim() != 2 or items.dim() != 2:
        raise ValueError(f"query [B, D] and items [V, D], got "
                         f"{tuple(query.shape)} and {tuple(items.shape)}")
    B, D = query.shape
    V = items.shape[0]
    if D % 16 or not 16 <= D <= MAX_D:
        raise ValueError(f"D must be a multiple of 16 up to {MAX_D}, not {D}")
    if V > MAX_V:
        raise ValueError(f"V must be at most {MAX_V}, not {V}")
    if not 1 <= k <= min(MAX_K, V):
        raise ValueError(f"k must lie in [1, min({MAX_K}, V = {V})], not {k}")
    want = {"query": (query, (B, D), torch.float32),
            "items": (items, (V, D), torch.bfloat16),
            "bias": (bias, (V,), torch.float32),
            "seen": (seen, (B, seen.shape[-1]), torch.int32)}
    for name, (t, shape, dt) in want.items():
        if t.device != query.device:
            raise ValueError(f"{name} is on {t.device}, not {query.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if query.device.type != "cuda":
        raise ValueError(f"mips_topk runs on cuda, not {query.device}")
    for name, t in (("items", items), ("bias", bias)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


@torch.no_grad()
def mips_topk(query, items, bias, seen, k: int = 30,
              compute_dtype=torch.bfloat16):
    """The kernels on CUDA tensors: (scores [B, k] f32, ids [B, k]
    int64), best first, the contract of `mips_topk_plain` up to the order
    of the f32 sums and of ties. query [B, D] f32, items [V, D]
    bf16 (an f32 matrix is rounded to bf16 here, a copy a call), bias [V]
    f32, seen [B, S] int32 (PAD −1). Raises on anything the kernel does
    not take."""
    if items.dtype == torch.float32 and items.device.type == "cuda":
        items = items.to(torch.bfloat16)
    _check(query, items, bias, seen, k, compute_dtype)
    B, D = query.shape
    V = items.shape[0]
    vals = torch.empty((B, k), dtype=torch.float32, device=query.device)
    ids = torch.empty((B, k), dtype=torch.int64, device=query.device)
    if B == 0:
        return vals, ids
    plan = _plan(query.device.index or 0, B, V, D, k)
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8,
                          device=query.device)
    stream = torch.cuda.current_stream(query.device).cuda_stream
    with torch.cuda.device(query.device):
        rc = _fn()(query.data_ptr(), items.data_ptr(), bias.data_ptr(), seen.data_ptr(), B, V,
                   D, seen.shape[1], k, int(clamps(V)), plan["splits"],
                   scratch.data_ptr(), scratch.numel(), vals.data_ptr(),
                   ids.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"mips_topk launch failed: CUDA error {rc}")
    mips_topk.launches += 1
    return vals, ids


mips_topk.launches = 0   # calls that launched the kernels since the last reset
