"""One bf16 tensor-core product on the card, as the kernels issue it.

`mma_probe(a, b, c)` runs `csrc/mma_probe.cu`: one warp, `mma.sync`
m16n8k16 with bf16 operands and f32 accumulators chained over K / 16
k-steps, d = c + a·bᵀ for a [16, K], b [8, K] (bf16) and c [16, 8] (f32).
It is the instruction every bf16 product of `sampled_ce.cu` and of the
scan backwards runs on, so a test can hold its sum to the error bound that
`sampled_ce.cu`'s rounding window assumes. It replaces no TPU kernel.

For CUDA tensors it launches the kernel or raises; the plain version
`mma_probe_plain` (an f32 product) is taken only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from arec_torch.kernels import _build

KERNEL = "mma_probe"


def mma_probe_plain(a, b, c):
    """Plain PyTorch version: c + a·bᵀ summed in f32."""
    return c + a.float() @ b.float().T


def mma_probe(a, b, c):
    """d [16, 8] = c + a·bᵀ, a [16, K] and b [8, K] bf16 (K a multiple of
    16), c [16, 8] f32; on the tensor cores for CUDA tensors."""
    if a.device.type == "cpu":
        return mma_probe_plain(a, b, c)
    K = a.shape[1]
    want = {"a": (a, (16, K), torch.bfloat16), "b": (b, (8, K), torch.bfloat16),
            "c": (c, (16, 8), torch.float32)}
    for name, (t, shape, dt) in want.items():
        if (t.device != a.device or tuple(t.shape) != shape or t.dtype != dt
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} {shape} on "
                             f"{a.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if K < 16 or K % 16:
        raise ValueError(f"K must be a positive multiple of 16, not {K}")
    d = torch.empty((16, 8), dtype=torch.float32, device=a.device)
    fn = getattr(_build.load(KERNEL), "mma_probe")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(), K,
                torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mma_probe launch failed: CUDA error {rc}")
    mma_probe.launches += 1
    return d


mma_probe.launches = 0   # launches since the last reset
