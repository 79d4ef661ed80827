"""The fused in-batch BPR loss (`bbpr`) of A-Recsys's batch-ranking MF.

`batch_bpr_rows` gives the [N] row losses of `losses.batch_bpr_loss` (whose
mean is the loss), differentiable in q, v and b. Per row i and in-batch
column j, with sᵢⱼ = cast(qᵢ)·cast(vⱼ) + bⱼ (bf16 operands, f32 sums, as
`tables.engine.mm_f32`), ownᵢ = sᵢᵢ and the row's live columns those whose
positive is not the row's own (posⱼ ≠ posᵢ):

    lossᵢ = Σ_live wᵢⱼ·(−log σ(ownᵢ − sᵢⱼ)) / Σ_live wᵢⱼ

with wᵢⱼ ≡ 1 (the row's mean over its live columns) or, with `pop_probs`
(the Horvitz–Thompson weights), wᵢⱼ = (1 − pqᵢ) / (nᵢ·max(pqⱼ, 1e-12)),
pq = pop_probs[pos] and nᵢ the row's live count, the row's sum of weights
clamped at 1e-12 (the count at 1). The backward takes the rows'
cotangents, forms ∂L/∂s in f32 and gives dq and dv rounded to bf16 (what
the autodiff of the operands' cast gives) and db in f32.

For CUDA tensors it launches the hand-written kernels of
`arec_torch/csrc/batch_rank.cu` (sm_90a), `batch_rank_fwd` and
`batch_rank_bwd`, or raises; the scores never reach device memory. The
plain PyTorch versions `batch_rank_fwd_plain` / `batch_rank_bwd_plain` have
the same contracts and are taken only for CPU tensors. The kernels take
bf16 products only (the mode training runs in): the f32 parity mode, and
the mesh's gathered candidates, stay with the library ops of
`losses.batch_bpr_loss`, which routes. Only the plain versions take
another `dtype`, for the f32 tests.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from arec_torch.kernels import _build

KERNEL = "batch_rank"


def _rounded(x, dtype):
    return x.to(dtype).float()


def _pairs_plain(q, v, b, pos, pq, dtype):
    """(y = s − own [N, N], live mask, u [N]) of the contract."""
    s = _rounded(q, dtype) @ _rounded(v, dtype).T + b[None, :]
    y = s - s.diagonal()[:, None]
    live = pos[None, :] != pos[:, None]
    u = (torch.ones_like(b) if pq is None
         else 1.0 / torch.clamp(pq, min=1e-12))
    return y, live, u


def batch_rank_fwd_plain(q, v, b, pos, pq=None, dtype=torch.bfloat16):
    """Plain version of the forward kernels → (loss [N], rs [N], tsum [N]):
    the row losses, each row's scale rs (its weights' a / max(a·Σu, 1e-12),
    or 1 / max(n, 1)) and tsum = Σ_live u·σ(s − own), which the backward
    takes. pq: the positives' probabilities [N], or None (no HT)."""
    y, live, u = _pairs_plain(q, v, b, pos, pq, dtype)
    w = torch.where(live, u[None, :], 0.0)
    n = live.sum(dim=1).float()
    sp = (w * F.softplus(y)).sum(dim=1)
    tsum = (w * torch.sigmoid(y)).sum(dim=1)
    if pq is None:
        den = torch.clamp(n, min=1.0)
        return sp / den, 1.0 / den, tsum
    a = (1.0 - pq) / torch.clamp(n, min=1.0)
    den = torch.clamp(a * w.sum(dim=1), min=1e-12)
    return a * sp / den, a / den, tsum


def batch_rank_bwd_plain(q, v, b, pos, pq, g, rs, tsum,
                         dtype=torch.bfloat16):
    """Plain version of the backward kernels: the rows' cotangents g [N]
    → (dq [N, D], dv [N, D], db [N]), dq and dv rounded to `dtype` (held in
    f32), db in f32."""
    y, live, u = _pairs_plain(q, v, b, pos, pq, dtype)
    rg = g * rs
    p = torch.where(live, rg[:, None] * u[None, :] * torch.sigmoid(y), 0.0)
    p = p - torch.diag_embed(rg * tsum)        # own's share: never live
    dq = _rounded(p @ _rounded(v, dtype), dtype)
    dv = _rounded(p.T @ _rounded(q, dtype), dtype)
    return dq, dv, p.sum(dim=0)


def scratch_bytes(N: int, D: int, backward: bool) -> int:
    """The bytes of scratch one call of the forward (or backward) kernels
    takes, from batch_rank.cu's own layout (`batch_rank_scratch_bytes`,
    which the entry points check their scratch against). Loads the
    library; raises for dimensions the kernels do not take."""
    fn = getattr(_build.load(KERNEL), "batch_rank_scratch_bytes")
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    nbytes = fn(N, D, int(backward))
    if nbytes < 0:
        raise ValueError(f"batch_rank does not take N={N}, D={D}")
    return nbytes


def _fn(symbol: str, n_ptr: int):
    """The C entry point: n_ptr pointers, N and D, the scratch's size
    (int64) and the stream."""
    fn = getattr(_build.load(KERNEL), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 2 + [
        ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


KERNEL_INFO = ("batch_rank_prep_kernel", "batch_rank_fwd_kernel",
               "batch_rank_merge_kernel", "batch_rank_bwd_rows_kernel",
               "batch_rank_rows_combine_kernel", "batch_rank_bwd_cols_kernel",
               "batch_rank_cols_reduce_kernel")


def kernel_info(D: int, ht: bool) -> dict[str, dict[str, int]]:
    """{kernel: registers, local (spilled) bytes per thread, dynamic shared
    memory per block, resident blocks per SM} as they launch for width D
    (on the current CUDA device)."""
    out = (ctypes.c_int * (4 * len(KERNEL_INFO)))()
    fn = getattr(_build.load(KERNEL), "batch_rank_kernel_info")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(D, int(ht), ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"batch_rank_kernel_info failed: CUDA error {rc}")
    keys = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm")
    return {name: dict(zip(keys, out[4 * k:4 * k + 4]))
            for k, name in enumerate(KERNEL_INFO)}


def _check(kernel, tensors: dict):
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    with the shape and dtype the kernel takes (None: left out)."""
    dev = tensors["q"][0].device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda, not {dev}")
    for name, (t, shape, dt) in tensors.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def _inputs(q, v, b, pos, pq):
    N, D = q.shape
    if min(N, D) < 1:
        raise ValueError(f"batch_rank takes N, D >= 1; got q "
                         f"{tuple(q.shape)}")
    f32 = torch.float32
    return N, D, {"q": (q, (N, D), f32), "v": (v, (N, D), f32),
                  "b": (b, (N,), f32), "pos": (pos, (N,), torch.int32),
                  "pq": (pq, (N,), f32)}


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(symbol, ptrs, scratch, nbytes, N, D, dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _fn(symbol, len(ptrs) + 1)(*ptrs, scratch.data_ptr(), N, D,
                                        nbytes, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")


def batch_rank_fwd(q, v, b, pos, pq=None):
    """The forward kernels on CUDA tensors → (loss, rs, tsum), the contract
    of `batch_rank_fwd_plain` in bf16. Raises on anything they do not take."""
    N, D, want = _inputs(q, v, b, pos, pq)
    dev = _check("batch_rank_fwd", want)
    loss, rs, tsum = (torch.empty(N, dtype=torch.float32, device=dev)
                      for _ in range(3))
    nbytes = scratch_bytes(N, D, False)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    _launch("batch_rank_fwd", [_ptr(t) for t, _, _ in want.values()]
            + [loss.data_ptr(), rs.data_ptr(), tsum.data_ptr()], scratch,
            nbytes, N, D, dev)
    batch_rank_fwd.launches += 1
    return loss, rs, tsum


def batch_rank_bwd(q, v, b, pos, pq, g, rs, tsum):
    """The backward kernels on CUDA tensors → (dq, dv, db), the contract of
    `batch_rank_bwd_plain` in bf16; g, rs, tsum are read on the device (no
    host sync)."""
    N, D, want = _inputs(q, v, b, pos, pq)
    f32 = torch.float32
    dev = _check("batch_rank_bwd", {
        **want, "g": (g, (N,), f32), "rs": (rs, (N,), f32),
        "tsum": (tsum, (N,), f32)})
    dq = torch.empty((N, D), dtype=f32, device=dev)
    dv = torch.empty((N, D), dtype=f32, device=dev)
    db = torch.empty(N, dtype=f32, device=dev)
    nbytes = scratch_bytes(N, D, True)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    _launch("batch_rank_bwd", [_ptr(t) for t, _, _ in want.values()]
            + [g.data_ptr(), rs.data_ptr(), tsum.data_ptr(), dq.data_ptr(),
               dv.data_ptr(), db.data_ptr()], scratch, nbytes, N, D, dev)
    batch_rank_bwd.launches += 1
    return dq, dv, db


batch_rank_fwd.launches = 0   # kernel launches since the caller last reset it
batch_rank_bwd.launches = 0


class BatchBPRRows(torch.autograd.Function):
    """The row losses with the kernels' backward; `batch_bpr_rows` is the
    entry point."""

    @staticmethod
    def forward(ctx, q, v, b, pos, pq):
        f32 = torch.float32
        args = [q.to(f32), v.to(f32), b.to(f32), pos.to(torch.int32),
                None if pq is None else pq.to(f32)]
        args = [None if a is None else a.contiguous() for a in args]
        fwd = (batch_rank_fwd_plain if q.device.type == "cpu"
               else batch_rank_fwd)
        loss, rs, tsum = fwd(*args)
        ctx.save_for_backward(*args[:4], rs, tsum)
        ctx.pq = args[4]
        ctx.primal_dtypes = (q.dtype, v.dtype, b.dtype)
        return loss

    @staticmethod
    def backward(ctx, g):
        q, v, b, pos, rs, tsum = ctx.saved_tensors
        bwd = (batch_rank_bwd_plain if q.device.type == "cpu"
               else batch_rank_bwd)
        grads = bwd(q, v, b, pos, ctx.pq, g.to(torch.float32).contiguous(),
                    rs, tsum)
        grads = [x.to(dt) for x, dt in zip(grads, ctx.primal_dtypes)]
        return (*grads, None, None)


def batch_bpr_rows(q, v, b, pos, pop_probs=None):
    """The [N] row losses of `bbpr` in bf16 over q [N, D] (the users),
    v [N, D] and b [N] (their positives' latents and biases) and pos [N]
    (the positives' ids), with HT weights from pop_probs [V] (None:
    without). Differentiable in q, v and b."""
    pq = None if pop_probs is None else pop_probs[pos.long()]
    return BatchBPRRows.apply(q, v, b, pos, pq)
