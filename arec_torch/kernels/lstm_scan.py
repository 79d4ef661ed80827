"""LSTM layer scan (port of `arec/kernels/lstm_scan.py`).

`lstm_layer` is the contract of arec's `lstm_layer_pallas`: one recurrent
layer over time-major xw = x·Wx + b [L, B, 4H], the recurrent weight Wh
[H, 4H], the left-padding mask [B, L] and the carried-in state (h0, c0)
[B, H] → (h_all [L, B, H], cT [B, H]), all f32. Per step:
gates = xw_t + cast(h, dtype)·cast(Wh, dtype) summed in f32, gate order
i|f|g|o, and h, c = m·new + (1−m)·old, so pad steps are exact no-ops.

Gradients flow to xw, Wh, h0 and c0 through both h_all and cT (arec's
custom VJP), so a segmented scan has exactly the gradient of the one-pass
scan. When autograd records (grad mode on and an input requires grad) the
layer runs as `LSTMLayer`, a `torch.autograd.Function`: its forward is the
training launch of `csrc/lstm_scan_fwd.cu` (which also writes the residuals
hp, cp: the state before each step) and its backward is
`csrc/lstm_scan_bwd.cu` (in bf16: a gate pass over all steps at once, the
reverse sweep and dWh, on the tensor cores).
Otherwise (serving, `inference_mode`) the serving launch writes h_all and
cT only.

For CUDA tensors the wrappers launch the hand-written kernels (sm_90a) or
raise; the plain PyTorch versions `lstm_layer_plain` and
`lstm_layer_bwd_plain` are taken only for CPU tensors. The TPU workarounds
(the [L, B, H] mask broadcast, `_pick_tiles`, `padded_seq_len`) do not
exist here: the kernels read the [B, L] mask and take any L and B. The
forward picks its kernel by dtype and width (`fwd_route`): bf16 with H a
multiple of 16 (the tensor cores' depth) takes the tensor-core kernel;
f32, the parity mode, and bf16 at any other width take the CUDA-core
kernel. The bf16 backward (tensor cores) takes H a multiple of 16 and
raises on any other; the f32 one takes any H.
"""

from __future__ import annotations

import ctypes

import torch

from arec_torch.kernels import _build

KERNEL = "lstm_scan_fwd"
KERNEL_BWD = "lstm_scan_bwd"
_DTYPES = (torch.float32, torch.bfloat16)
_BT_CHOICES = (1, 2, 4, 8)
_DWH_SPLITS = 8    # row ranges of the backwards' dWh passes (RS there)
# f32 words of shared memory per batch row of a CTA: h, c, cast h [H] and
# the gates [4H] (forward); h, dh, dc, dh_skip [H] and the gates [4H] (the
# f32 backward)
_STATE_WORDS = {KERNEL: 7, KERNEL_BWD: 8}
# the bf16 backward's kernels, in the order of `bwd_kernel_info`: the gate
# pass, the sweep, the dWh product and the sum of its row-range partials
BWD_STAGES = ("gates", "sweep", "dwh_mma", "dwh_reduce")
# the bf16 forward's launches, in the order of `fwd_kernel_info`
FWD_LAUNCHES = ("serving", "training")


def lstm_layer_plain(xw_tm, wh, mask_bm, h0, c0, dtype=torch.bfloat16,
                     residuals: bool = False):
    """Plain PyTorch version of the forward kernel: the same arithmetic, one
    step at a time. residuals=True also returns hp, cp [L, B, H], the state
    before each step (the training launch's extra outputs)."""
    H = wh.shape[0]
    w = wh.to(dtype).float()
    h, c = h0, c0
    hs, hps, cps = [], [], []
    for t in range(xw_tm.shape[0]):
        hps.append(h)
        cps.append(c)
        gates = xw_tm[t] + h.to(dtype).float() @ w
        i, f, g, o = gates.split(H, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask_bm[:, t, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        hs.append(h)
    if residuals:
        return torch.stack(hs), c, torch.stack(hps), torch.stack(cps)
    return torch.stack(hs), c


def lstm_layer_bwd_plain(xw_tm, wh, mask_bm, hp, cp, dh_out, dcT,
                         dtype=torch.bfloat16):
    """Plain PyTorch version of the backward kernel (arec's `_backward`):
    reverse sweep with the gates recomputed from (xw, cast(h_prev)) →
    (dxw [L, B, 4H], dWh [H, 4H], dh0 [B, H], dc0 [B, H]), all f32."""
    L, B, G = xw_tm.shape
    H = G // 4
    w = wh.to(dtype).float()
    dh = torch.zeros(B, H, dtype=torch.float32, device=xw_tm.device)
    dc = dcT
    dwh = torch.zeros(H, G, dtype=torch.float32, device=xw_tm.device)
    dxw = torch.empty_like(xw_tm)
    for t in range(L - 1, -1, -1):
        hq = hp[t].to(dtype).float()
        gates = xw_tm[t] + hq @ w
        si = torch.sigmoid(gates[:, :H])
        sf = torch.sigmoid(gates[:, H:2 * H])
        tg = torch.tanh(gates[:, 2 * H:3 * H])
        so = torch.sigmoid(gates[:, 3 * H:])
        c_new = sf * cp[t] + si * tg
        tc = torch.tanh(c_new)
        m = mask_bm[:, t, None]
        dh_total = dh_out[t] + dh
        dh_new = m * dh_total
        dh_skip = (1.0 - m) * dh_total
        dc_new = m * dc
        dc_skip = (1.0 - m) * dc
        do_pre = dh_new * tc * so * (1.0 - so)
        dc_new = dc_new + dh_new * so * (1.0 - tc * tc)
        df_pre = dc_new * cp[t] * sf * (1.0 - sf)
        di_pre = dc_new * tg * si * (1.0 - si)
        dg_pre = dc_new * si * (1.0 - tg * tg)
        dgates = torch.cat([di_pre, df_pre, dg_pre, do_pre], dim=1)
        dxw[t] = dgates
        dgq = dgates.to(dtype).float()
        dwh += hq.T @ dgq
        dh = dgq @ w.T + dh_skip
        dc = dc_new * sf + dc_skip
    return dxw, dwh, dh, dc


def _fn(source: str, symbol: str, n_ptr: int, n_int: int = 6):
    """Entry point `symbol` of kernel library `source`: n_ptr pointers,
    n_int ints, the stream."""
    fn = getattr(_build.load(source), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(kernel: str, dtype, xw_tm, tensors: dict):
    """Raise unless every tensor is contiguous, on xw_tm's device, with the
    shape and dtype the kernel takes: {name: (tensor, shape, dtype)}."""
    if dtype not in _DTYPES:
        raise ValueError(f"{kernel} takes dtype float32 or bfloat16, "
                         f"not {dtype}")
    for name, (t, shape, dt) in tensors.items():
        if t.device != xw_tm.device:
            raise ValueError(f"{name} is on {t.device}, xw_tm on "
                             f"{xw_tm.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _dims(kernel: str, xw_tm, gates: int):
    """(L, B, G, H) of xw_tm [L, B, G = gates·H]; raises on another shape."""
    if xw_tm.dim() != 3 or xw_tm.shape[2] % gates:
        raise ValueError(f"xw_tm must be [L, B, {gates}H], got "
                         f"{tuple(xw_tm.shape)}")
    L, B, G = xw_tm.shape
    if L < 1 or B < 1:
        raise ValueError(f"{kernel} needs L, B >= 1, got L={L}, B={B}")
    return L, B, G, G // gates


def _mma_width(kernel: str, H: int):
    """Raise unless the bf16 tensor-core backward takes width H."""
    if H % 16:
        raise ValueError(f"{kernel} in bfloat16 runs on the tensor cores "
                         f"and takes H a multiple of 16, not H={H}")


def fwd_route(dtype, H: int) -> str:
    """The forward kernel that a CUDA launch at `dtype` and width H takes:
    "mma", the tensor-core kernel, for bf16 with H a multiple of 16 (the
    MMA's depth); "cuda_core", the first version's kernel, for f32 (the
    parity mode) and for bf16 at any other width. A dispatch on dtype and
    width, not a fallback: a launch takes its route's kernel or raises."""
    return "mma" if dtype == torch.bfloat16 and H % 16 == 0 else "cuda_core"


def _kernel_info(kernel: str, H: int, names) -> dict[str, dict[str, int]]:
    """{name: registers, local (spilled) bytes per thread, dynamic shared
    memory per block, resident blocks per SM} of the bf16 kernels `names`
    of library `kernel` (`<kernel>_bf16_kernel_info` gives them in that
    order), as they launch at width H on the current CUDA device."""
    out = (ctypes.c_int * (4 * len(names)))()
    symbol = f"{kernel}_bf16_kernel_info"
    fn = getattr(_build.load(kernel), symbol)
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(H, ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {rc}")
    keys = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm")
    return {name: dict(zip(keys, out[4 * k:4 * k + 4]))
            for k, name in enumerate(names)}


def bwd_kernel_info(kernel: str, H: int) -> dict[str, dict[str, int]]:
    """The launch resources (`_kernel_info`) of the bf16 backward `kernel`'s
    stages (KERNEL_BWD here or in gru_scan) at width H."""
    return _kernel_info(kernel, H, BWD_STAGES)


def fwd_kernel_info(kernel: str, H: int) -> dict[str, dict[str, int]]:
    """The launch resources (`_kernel_info`) of the bf16 tensor-core forward
    `kernel` (KERNEL here or in gru_scan), serving and training launches,
    at width H (a multiple of 16)."""
    return _kernel_info(kernel, H, FWD_LAUNCHES)


def _launch_config(kernel: str, B: int, H: int, G: int, state_words: int,
                   dtype, device) -> tuple[int, bool]:
    """(rows per CTA, Wh [H, G] resident in shared memory): the fewest rows
    per CTA that keep the grid within one wave of SMs, and Wh in shared
    memory when it fits beside the state tiles of `state_words`·H f32 words
    per row."""
    props = torch.cuda.get_device_properties(device)
    bt = next((b for b in _BT_CHOICES
               if -(-B // b) <= props.multi_processor_count), _BT_CHOICES[-1])
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    state = bt * state_words * H * 4
    if state > limit:
        raise ValueError(f"{kernel}: H={H} needs {state} bytes of shared "
                         f"memory for its state, over the {limit} a block has")
    wh_bytes = H * G * (2 if dtype == torch.bfloat16 else 4)
    return bt, state + wh_bytes <= limit


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _device_of(xw_tm, kernel: str):
    if xw_tm.device.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda, not {xw_tm.device}")
    return xw_tm.device


def _fwd_weight(wh, dtype, H: int, G: int):
    """(route, name, weight, shape): the forward kernel's route
    (`fwd_route`) and Wh as that kernel takes it, cast to dtype, under the
    name and with the shape `_check` holds it to: Wh [H, G] for the
    CUDA-core kernel; Whᵀ [G, H] for the tensor-core one, cast and
    transposed in one copy."""
    route = fwd_route(dtype, H)
    if route == "mma":
        return (route, "wh (transposed)", wh.detach().t().to(
            dtype, memory_format=torch.contiguous_format), (G, H))
    return route, "wh", wh.detach().to(dtype), (H, G)


def _fwd_launch(kernel: str, route: str, residuals: bool, ptrs, L: int,
                B: int, H: int, G: int, dtype, dev, state_words: int):
    """Launch the forward `kernel` (KERNEL here or in gru_scan) of `route`
    on the pointers `ptrs` (inputs, then outputs) on the current stream:
    the serving entry point or, with residuals, the training one. Raises
    unless it launched."""
    symbol = kernel + ("_bf16" if route == "mma" else "") + (
        "_resid" if residuals else "")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if route == "mma":
            rc = _fn(kernel, symbol, len(ptrs), 3)(*ptrs, L, B, H, stream)
        else:
            bt, wh_in_smem = _launch_config(kernel, B, H, G, state_words,
                                            dtype, dev)
            rc = _fn(kernel, symbol, len(ptrs))(
                *ptrs, L, B, H, int(dtype == torch.bfloat16), bt,
                int(wh_in_smem), stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")


def lstm_scan_fwd(xw_tm, wh, mask_bm, h0, c0, dtype=torch.bfloat16,
                  residuals: bool = False):
    """The forward kernel on CUDA tensors → (h_all, cT), and with
    residuals=True also (hp, cp): the tensor-core kernel or the CUDA-core
    one by `fwd_route`. Raises on anything it does not take."""
    dev = _device_of(xw_tm, KERNEL)
    L, B, G, H = _dims(KERNEL, xw_tm, 4)
    route, name, w, shape = _fwd_weight(wh, dtype, H, G)
    f32 = torch.float32
    _check(KERNEL, dtype, xw_tm, {
        "xw_tm": (xw_tm, (L, B, G), f32), name: (w, shape, dtype),
        "mask_bm": (mask_bm, (B, L), f32), "h0": (h0, (B, H), f32),
        "c0": (c0, (B, H), f32)})
    outs = [torch.empty((L, B, H), dtype=f32, device=dev),
            torch.empty((B, H), dtype=f32, device=dev)]
    if residuals:
        outs += [torch.empty((L, B, H), dtype=f32, device=dev)
                 for _ in range(2)]
    _fwd_launch(KERNEL, route, residuals,
                _ptrs(xw_tm, w, mask_bm, h0, c0, *outs), L, B, H, G, dtype,
                dev, _STATE_WORDS[KERNEL])
    lstm_layer.launches += 1
    return tuple(outs)


def lstm_layer_bwd(xw_tm, wh, mask_bm, hp, cp, dh_out, dcT,
                   dtype=torch.bfloat16):
    """The backward kernel on CUDA tensors → (dxw, dWh, dh0, dc0), the
    contract of `lstm_layer_bwd_plain`. bf16: the three tensor-core stages
    (gate pass, sweep, dWh; H a multiple of 16); f32: the CUDA-core sweep
    and dWh. Raises on anything it does not take."""
    dev = _device_of(xw_tm, KERNEL_BWD)
    wh = wh.detach().to(dtype)
    L, B, G, H = _dims(KERNEL_BWD, xw_tm, 4)
    f32 = torch.float32
    _check(KERNEL_BWD, dtype, xw_tm, {
        "xw_tm": (xw_tm, (L, B, G), f32), "wh": (wh, (H, G), dtype),
        "mask_bm": (mask_bm, (B, L), f32), "hp": (hp, (L, B, H), f32),
        "cp": (cp, (L, B, H), f32), "dh_out": (dh_out, (L, B, H), f32),
        "dcT": (dcT, (B, H), f32)})
    bf16 = dtype == torch.bfloat16
    if bf16:
        _mma_width(KERNEL_BWD, H)
    else:
        bt, wh_in_smem = _launch_config(KERNEL_BWD, B, H, G,
                                        _STATE_WORDS[KERNEL_BWD], dtype, dev)
    dxw = torch.empty((L, B, G), dtype=f32, device=dev)
    dwh = torch.empty((H, G), dtype=f32, device=dev)
    dh0 = torch.empty((B, H), dtype=f32, device=dev)
    dc0 = torch.empty((B, H), dtype=f32, device=dev)
    part = torch.empty((_DWH_SPLITS, H, G), dtype=f32, device=dev)
    ptrs = _ptrs(xw_tm, wh, mask_bm, hp, cp, dh_out, dcT, dxw, dwh, dh0, dc0,
                 part)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if bf16:
            rc = _fn(KERNEL_BWD, "lstm_scan_bwd_bf16", 12, 3)(
                *ptrs, L, B, H, stream)
        else:
            rc = _fn(KERNEL_BWD, "lstm_scan_bwd", 12, 5)(
                *ptrs, L, B, H, bt, int(wh_in_smem), stream)
    if rc != 0:
        raise RuntimeError(f"lstm_scan_bwd launch failed: CUDA error {rc}")
    lstm_layer_bwd.launches += 1
    return dxw, dwh, dh0, dc0


class LSTMLayer(torch.autograd.Function):
    """One layer with arec's custom VJP: gradients to xw, Wh, h0 and c0
    through h_all and cT (mask and dtype take none)."""

    @staticmethod
    def forward(ctx, xw_tm, wh, mask_bm, h0, c0, dtype):
        if xw_tm.device.type == "cpu":
            h_all, cT, hp, cp = lstm_layer_plain(xw_tm, wh, mask_bm, h0, c0,
                                                 dtype, residuals=True)
        else:
            h_all, cT, hp, cp = lstm_scan_fwd(xw_tm, wh, mask_bm, h0, c0,
                                              dtype, residuals=True)
        ctx.save_for_backward(xw_tm, wh, mask_bm, hp, cp)
        ctx.dtype = dtype
        return h_all, cT

    @staticmethod
    def backward(ctx, dh_out, dcT):
        xw_tm, wh, mask_bm, hp, cp = ctx.saved_tensors
        # autograd hands over zeros for an unused output (materialized
        # grads); they arrive contiguous for the kernel
        dh_out, dcT = dh_out.contiguous(), dcT.contiguous()
        bwd = (lstm_layer_bwd_plain if xw_tm.device.type == "cpu"
               else lstm_layer_bwd)
        dxw, dwh, dh0, dc0 = bwd(xw_tm, wh, mask_bm, hp, cp, dh_out, dcT,
                                 ctx.dtype)
        return dxw, dwh.to(wh.dtype), None, dh0, dc0, None


def lstm_layer(xw_tm, wh, mask_bm, h0, c0, dtype=torch.bfloat16):
    """One recurrent layer → (h_all [L, B, H], cT [B, H]). Differentiable
    (through `LSTMLayer`) when autograd records; CPU tensors take the plain
    versions, CUDA tensors launch the kernels or raise."""
    if xw_tm.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm_layer runs on cuda or cpu, not "
                         f"{xw_tm.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xw_tm, wh, h0, c0)):
        return LSTMLayer.apply(xw_tm, wh, mask_bm, h0, c0, dtype)
    if xw_tm.device.type == "cpu":
        return lstm_layer_plain(xw_tm, wh, mask_bm, h0, c0, dtype)
    return lstm_scan_fwd(xw_tm, wh, mask_bm, h0, c0, dtype)


lstm_layer.launches = 0       # lstm_scan_fwd launches since the last reset
lstm_layer_bwd.launches = 0   # lstm_scan_bwd launches since the last reset


def scan_layers(layer, layers: list[dict], x, mask, dtype, states,
                return_states: bool, time_major: bool, dropout_gen,
                keep_prob: float):
    """The stacked scan around one layer kernel `layer(xw_tm, wh, mask_bm,
    h0, c0, dtype) → (h_all, cT)`: per layer the input projection outside
    the kernel, the kernel, and output dropout outside it (layer li drawing
    from `fold_in(dropout_gen, li)`); the carries stay undropped. Arguments
    as in `lstm_scan`."""
    from arec_torch.models.seq import input_projection, output_dropout
    from arec_torch.rng import fold_in

    b = x.shape[1] if time_major else x.shape[0]
    mask_bm = (mask.T if time_major else mask).float().contiguous()
    h = x
    new_states = []
    for li, p in enumerate(layers):
        d_in = h.shape[-1]
        d = p["w"].shape[0] - d_in
        xw = input_projection(p, h, dtype)                 # [..., G·H]
        if states is not None:
            h0, c0 = states[li]
        else:
            h0 = c0 = torch.zeros(b, d, device=x.device)
        xw_tm = xw if time_major else xw.transpose(0, 1)
        h_all, cT = layer(xw_tm.contiguous(), p["w"][d_in:], mask_bm,
                          h0.contiguous(), c0.contiguous(), dtype)
        new_states.append((h_all[-1], cT))                 # pre-dropout
        h = h_all if time_major else h_all.transpose(0, 1)
        if dropout_gen is not None:
            h = output_dropout(h, fold_in(dropout_gen, li, h.device),
                               keep_prob)
    if return_states:
        return h, new_states
    return h


def lstm_scan(layers: list[dict], x, mask, dtype=torch.bfloat16,
              states: list | None = None, return_states: bool = False,
              time_major: bool = False, dropout_gen=None,
              keep_prob: float = 1.0):
    """Counterpart of arec's `pallas_lstm_scan` (and a drop-in for the
    plain `rnn_scan` with cell="lstm"): x [B, L, D], mask [B, L] → top-layer
    hidden states [B, L, H]; time_major: x [L, B, D], mask [L, B] →
    [L, B, H]. `states`: optional per-layer (h0, c0) carries;
    `return_states=True` also returns the per-layer final (hT, cT).
    `dropout_gen`/`keep_prob`: per-layer output dropout applied outside the
    kernel (`output_dropout`, layer li drawing from
    `fold_in(dropout_gen, li)`); the carries stay undropped."""
    return scan_layers(lstm_layer, layers, x, mask, dtype, states,
                       return_states, time_major, dropout_gen, keep_prob)
