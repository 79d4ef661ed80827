"""Fused sampled-softmax CE sums (port of `arec/kernels/sampled_softmax.py`).

`fused_sampled_ce_sums` is the training entry of arec's kernel: it returns
(Σ wᵢ·ceᵢ, Σ wᵢ) of the sampled-softmax CE with the reduction inside the
kernel, and the caller divides (by max(den, 1)), so autograd applies the
quotient rule. Per row i and sampled column j:

    tlᵢ     = tl_baseᵢ + [aug: v_true[i, D]] + qᵢ·v_trueᵢ         (f32)
    logitᵢⱼ = cast(qᵢ)·cast(v_sampⱼ) + c_sampⱼ, −1e9 on an accidental hit
    ceᵢ     = logsumexp(tlᵢ, logitᵢ·) − tlᵢ

with c_samp = b_samp − log(S·P). AUG mode (v_true.shape[1] == D + 1): v_true
is the raw [N, D+1] output-table row with the item bias in lane D, tl_base
carries only −log(S·P), and d(v_true) comes back [N, D+1] with the bias
gradient in lane D. It is differentiable in q, v_true, v_samp, c_samp,
tl_base and weights, as arec's custom VJP is.

For CUDA tensors it launches the hand-written kernels of
`arec_torch/csrc/sampled_ce.cu` (sm_90a): `sampled_ce_fwd` (the forward
sums, replacing `_sums_fwd_kernel`) and `sampled_ce_bwd` (the gradients,
replacing `_sums_bwd_kernel`), or raises. The plain PyTorch versions
`sampled_ce_fwd_plain` / `sampled_ce_bwd_plain` have the same contracts and
are taken only for CPU tensors.

`dtype` picks the kernels. bf16, the mode training runs in, takes the
tensor-core kernels: a FlashAttention-style fused softmax with K = V =
v_samp, where bf16 tiles of q and v_samp meet in `mma.sync` products with
f32 accumulators, the online log-sum-exp (forward) and the softmax residue
wp (backward) are formed on the accumulator registers, and the logits
never reach device memory. They are bound by the per-logit work beside
the products (mask, exp, residue) and their tile loops' latency, far
below the cost of materialising the [N, 1+S] logits. Every residue above
|g·w|·2^-8 rounds to bf16 as the contract has it, from the logit summed in
d order: the kernels re-form those that a bound on the tensor cores' sum
order error (from the norms of the bf16 rows) cannot clear. A smaller
residue rounded apart moves a gradient term by < 2^-15·|g·w|·|operand|.
f32, the parity mode, takes CUDA-core kernels with no tensor cores.
Neither falls back to the other. `scratch_bytes` asks the kernels'
library how much scratch a call takes; the kernels refuse less.

The kernels read q, v_true and v_samp in f32 (the wrapper casts bf16
activations up and casts dq / d(v_true) back to their primal's dtype). The
true side stays in f32 in both modes, as arec's pure path does; arec's TPU
kernel rounds v_true to the compute dtype in aug mode as a side effect of
its lane-selection workaround, which is not carried over. Nor are the other
Mosaic workarounds: the lane-packed `[N, 3]` row input, `_sel`, `_pad_rows`
and `_folded`; tl_base, true_ids and weights are plain [N] tensors.
"""

from __future__ import annotations

import ctypes

import torch

from arec_torch.kernels import _build

KERNEL = "sampled_ce"
NEG = -1e9


def _logits_plain(q, v_samp, c_samp, true_ids, sampled_ids, dtype):
    raw = q.to(dtype).float() @ v_samp.to(dtype).float().T
    hit = sampled_ids[None, :] == true_ids[:, None]
    return torch.where(hit, NEG, raw + c_samp[None, :])


def _true_logit_plain(q, v_true, tl_base):
    d = q.shape[1]
    tl = tl_base + (q * v_true[:, :d]).sum(dim=1)
    if v_true.shape[1] == d + 1:
        tl = tl + v_true[:, d]
    return tl


def sampled_ce_fwd_plain(q, v_true, v_samp, c_samp, tl_base, true_ids,
                         sampled_ids, weights, dtype=torch.bfloat16):
    """Plain version of the forward kernel → (num, den, ce [N], lse [N])."""
    logits = _logits_plain(q, v_samp, c_samp, true_ids, sampled_ids, dtype)
    tl = _true_logit_plain(q, v_true, tl_base)
    m = torch.maximum(logits.max(dim=1).values, tl)
    lse = m + torch.log(torch.exp(tl - m)
                        + torch.exp(logits - m[:, None]).sum(dim=1))
    ce = lse - tl
    return (ce * weights).sum(), weights.sum(), ce, lse


def sampled_ce_bwd_plain(q, v_true, v_samp, c_samp, tl_base, true_ids,
                         sampled_ids, weights, lse, g_num,
                         dtype=torch.bfloat16):
    """Plain version of the backward kernel: the cotangent g_num of Σ w·ce
    → (dq [N, D], d(v_true) [N, Dt], d(v_samp) [S, D], d(c_samp) [S],
    d(tl_base) [N]), all f32."""
    d = q.shape[1]
    logits = _logits_plain(q, v_samp, c_samp, true_ids, sampled_ids, dtype)
    tl = _true_logit_plain(q, v_true, tl_base)
    g = g_num * weights                                   # [N]
    wt = g * (torch.exp(tl - lse) - 1.0)                  # [N]
    wp = g[:, None] * torch.exp(logits - lse[:, None])    # [N, S]
    wpq = wp.to(dtype).float()
    dq = wt[:, None] * v_true[:, :d] + wpq @ v_samp.to(dtype).float()
    dvt = wt[:, None] * q
    if v_true.shape[1] == d + 1:
        dvt = torch.cat([dvt, wt[:, None]], dim=1)
    dvs = wpq.T @ q.to(dtype).float()
    return dq, dvt, dvs, wp.sum(dim=0), wt


def scratch_bytes(N: int, S: int, D: int, dtype, backward: bool) -> int:
    """The bytes of scratch one call of the forward (or backward) kernels
    takes, from sampled_ce.cu's own layout (`sampled_ce_scratch_bytes`,
    which the entry points check their scratch against). Loads the
    library; raises for dimensions or a dtype the kernels do not take."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"sampled_ce takes dtype float32 or bfloat16, not "
                         f"{dtype}")
    fn = getattr(_build.load(KERNEL), "sampled_ce_scratch_bytes")
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    nbytes = fn(N, S, D, int(dtype == torch.bfloat16), int(backward))
    if nbytes < 0:
        raise ValueError(f"sampled_ce does not take N={N}, S={S}, D={D}")
    return nbytes


def _scratch(N, S, D, dtype, backward, dev):
    nbytes = scratch_bytes(N, S, D, dtype, backward)
    return torch.empty(nbytes, dtype=torch.uint8, device=dev), nbytes


def _fn(symbol: str, n_ptr: int, n_int: int):
    """The C entry point: n_ptr pointers, n_int ints, the scratch's size
    (int64) and the stream."""
    fn = getattr(_build.load(KERNEL), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


KERNEL_INFO = ("sampled_ce_prep_kernel", "sampled_ce_fwd_mma_kernel",
               "sampled_ce_fwd_merge_kernel", "sampled_ce_bwd_rows_mma_kernel",
               "sampled_ce_bwd_rows_combine_kernel",
               "sampled_ce_bwd_cols_mma_kernel",
               "sampled_ce_cols_reduce_kernel")


def kernel_info(D: int) -> dict[str, dict[str, int]]:
    """{kernel: registers, local (spilled) bytes per thread, dynamic shared
    memory per block, resident blocks per SM} of the bf16 kernels as they
    launch for width D (on the current CUDA device)."""
    out = (ctypes.c_int * (4 * len(KERNEL_INFO)))()
    fn = getattr(_build.load(KERNEL), "sampled_ce_kernel_info")
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(D, ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"sampled_ce_kernel_info failed: CUDA error {rc}")
    keys = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm")
    return {name: dict(zip(keys, out[4 * k:4 * k + 4]))
            for k, name in enumerate(KERNEL_INFO)}


def _check(kernel, dtype, tensors: dict):
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    with the shape and dtype the kernel takes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{kernel} takes dtype float32 or bfloat16, "
                         f"not {dtype}")
    dev = next(iter(tensors.values()))[0].device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda, not {dev}")
    for name, (t, shape, dt) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def _dims(kernel, q, v_true, v_samp):
    N, D = q.shape
    S, Dt = v_samp.shape[0], v_true.shape[1]
    if Dt not in (D, D + 1) or min(N, S, D) < 1:
        raise ValueError(f"{kernel} takes N, S, D >= 1 and v_true of "
                         f"width D or D+1; got q {tuple(q.shape)}, "
                         f"v_true {tuple(v_true.shape)}, v_samp "
                         f"{tuple(v_samp.shape)}")
    return N, D, Dt, S


def _inputs(q, v_true, v_samp, c_samp, tl_base, true_ids, sampled_ids,
            weights):
    N, D, Dt, S = _dims("sampled_ce", q, v_true, v_samp)
    f32, i32 = torch.float32, torch.int32
    return N, D, Dt, S, {
        "q": (q, (N, D), f32), "v_true": (v_true, (N, Dt), f32),
        "v_samp": (v_samp, (S, D), f32), "c_samp": (c_samp, (S,), f32),
        "tl_base": (tl_base, (N,), f32), "true_ids": (true_ids, (N,), i32),
        "sampled_ids": (sampled_ids, (S,), i32),
        "weights": (weights, (N,), f32)}


def sampled_ce_fwd(q, v_true, v_samp, c_samp, tl_base, true_ids,
                   sampled_ids, weights, dtype=torch.bfloat16):
    """The forward kernel on CUDA tensors → (num, den, ce [N], lse [N]),
    the contract of `sampled_ce_fwd_plain`. Raises on anything it does not
    take."""
    N, D, Dt, S, want = _inputs(q, v_true, v_samp, c_samp, tl_base,
                                true_ids, sampled_ids, weights)
    dev = _check("sampled_ce_fwd", dtype, want)
    f32 = torch.float32
    ce = torch.empty(N, dtype=f32, device=dev)
    lse = torch.empty(N, dtype=f32, device=dev)
    sums = torch.empty(2, dtype=f32, device=dev)
    scratch, nbytes = _scratch(N, S, D, dtype, False, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _fn("sampled_ce_fwd", 12, 5)(
            *(t.data_ptr() for t, _, _ in want.values()), ce.data_ptr(),
            lse.data_ptr(), sums.data_ptr(), scratch.data_ptr(), N, D, Dt, S,
            int(dtype == torch.bfloat16), nbytes, stream)
    if rc != 0:
        raise RuntimeError(f"sampled_ce_fwd launch failed: CUDA error {rc}")
    sampled_ce_fwd.launches += 1
    return sums[0], sums[1], ce, lse


def sampled_ce_bwd(q, v_true, v_samp, c_samp, tl_base, true_ids,
                   sampled_ids, weights, lse, g_num, dtype=torch.bfloat16):
    """The backward kernels on CUDA tensors → (dq, d(v_true), d(v_samp),
    d(c_samp), d(tl_base)), the contract of `sampled_ce_bwd_plain`. g_num
    is a 0-d f32 tensor on the device (read there: no host sync)."""
    N, D, Dt, S, want = _inputs(q, v_true, v_samp, c_samp, tl_base,
                                true_ids, sampled_ids, weights)
    f32 = torch.float32
    g_num = g_num.reshape(())
    dev = _check("sampled_ce_bwd", dtype, {
        **want, "lse": (lse, (N,), f32), "g_num": (g_num, (), f32)})
    dq = torch.empty((N, D), dtype=f32, device=dev)
    dvt = torch.empty((N, Dt), dtype=f32, device=dev)
    dvs = torch.empty((S, D), dtype=f32, device=dev)
    dcs = torch.empty(S, dtype=f32, device=dev)
    dtl = torch.empty(N, dtype=f32, device=dev)
    scratch, nbytes = _scratch(N, S, D, dtype, True, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _fn("sampled_ce_bwd", 16, 5)(
            *(t.data_ptr() for t, _, _ in want.values()), lse.data_ptr(),
            g_num.data_ptr(), dq.data_ptr(), dvt.data_ptr(), dvs.data_ptr(),
            dcs.data_ptr(), dtl.data_ptr(), scratch.data_ptr(), N, D, Dt, S,
            int(dtype == torch.bfloat16), nbytes, stream)
    if rc != 0:
        raise RuntimeError(f"sampled_ce_bwd launch failed: CUDA error {rc}")
    sampled_ce_bwd.launches += 1
    return dq, dvt, dvs, dcs, dtl


sampled_ce_fwd.launches = 0   # kernel launches since the caller last reset it
sampled_ce_bwd.launches = 0


class SampledCESums(torch.autograd.Function):
    """(num, den) with arec's custom VJP; `fused_sampled_ce_sums` is the
    entry point."""

    @staticmethod
    def forward(ctx, q, v_true, v_samp, c_samp, tl_base, true_ids,
                sampled_ids, weights, dtype):
        f32 = torch.float32
        w = (torch.ones(q.shape[0], dtype=f32, device=q.device)
             if weights is None else weights.to(f32))
        args = [q.to(f32), v_true.to(f32), v_samp.to(f32), c_samp.to(f32),
                tl_base.to(f32), true_ids.to(torch.int32),
                sampled_ids.to(torch.int32), w]
        args = [a.contiguous() for a in args]
        fwd = (sampled_ce_fwd_plain if q.device.type == "cpu"
               else sampled_ce_fwd)
        num, den, ce, lse = fwd(*args, dtype)
        ctx.save_for_backward(*args, ce, lse)
        ctx.dtype = dtype
        ctx.primal_dtypes = (q.dtype, v_true.dtype, v_samp.dtype,
                             c_samp.dtype, tl_base.dtype)
        ctx.has_weights = weights is not None
        return num, den

    @staticmethod
    def backward(ctx, g_num, g_den):
        *args, ce, lse = ctx.saved_tensors
        bwd = (sampled_ce_bwd_plain if args[0].device.type == "cpu"
               else sampled_ce_bwd)
        grads = bwd(*args, lse, g_num.to(torch.float32), ctx.dtype)
        grads = [g.to(dt) for g, dt in zip(grads, ctx.primal_dtypes)]
        dw = None
        if ctx.has_weights and ctx.needs_input_grad[7]:
            dw = g_num * ce + g_den            # num = Σ w·ce, den = Σ w
        return (*grads, None, None, dw, None)


def fused_sampled_ce_sums(q, v_true, v_samp, c_samp, tl_base, true_ids,
                          sampled_ids, weights=None, dtype=torch.bfloat16):
    """(Σ wᵢ·ceᵢ, Σ wᵢ) of the sampled-softmax CE (weights=None: w ≡ 1):
    arec's `fused_sampled_ce_sums` (without its TPU tile size `nt`).
    Differentiable in q, v_true, v_samp, c_samp, tl_base and weights."""
    return SampledCESums.apply(q, v_true, v_samp, c_samp, tl_base, true_ids,
                               sampled_ids, weights, dtype)


def fused_sampled_ce_sums_sharded(mesh, q, v_true, v_samp, c_samp, tl_base,
                                  true_ids, sampled_ids, weights=None,
                                  dtype=torch.bfloat16):
    """arec's `fused_sampled_ce_sums_sharded` on the port's mesh: GLOBAL
    (Σ wᵢ·ceᵢ, Σ wᵢ) over every rank's rows, w ≡ 1 for weights=None.

    A rank holds its "data" slab, the same on each "model" rank of its
    data row, so the slab's N rows split T ways: model rank m runs the
    kernels (`fused_sampled_ce_sums`, B5 forward, B6 in the backward) on
    the m-th of T equal row blocks, N padded to a multiple of T with pad
    rows of weight 0 and true id −1. One all_reduce sums (num, den) over
    every rank. arec splits the global rows over ("data", "model"),
    data-major, which is the same split. The sum's backward is the
    identity (`dist.collectives.sum_partials`), so each rank's gradients
    are the partials of its own rows: the gradient of q (zero outside
    this rank's block) and of the replicated v_samp / c_samp each count
    every row once when the train step sums them over the ranks."""
    from arec_torch.dist.collectives import sum_partials
    from arec_torch.dist.specs import mesh_coords

    _, _, m, t = mesh_coords(mesh)
    n = q.shape[0]
    w = (torch.ones(n, dtype=torch.float32, device=q.device)
         if weights is None else weights.to(torch.float32))
    c = -(-n // t)
    pad = c * t - n
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad))
        v_true = torch.nn.functional.pad(v_true, (0, 0, 0, pad))
        tl_base = torch.nn.functional.pad(tl_base, (0, pad))
        true_ids = torch.nn.functional.pad(true_ids, (0, pad), value=-1)
        w = torch.nn.functional.pad(w, (0, pad))          # pad rows weigh 0
    rows = slice(m * c, (m + 1) * c)
    num, den = fused_sampled_ce_sums(
        q[rows], v_true[rows], v_samp, c_samp, tl_base[rows],
        true_ids[rows], sampled_ids, w[rows], dtype)
    sums = sum_partials(torch.stack([num, den]))
    return sums[0], sums[1]
