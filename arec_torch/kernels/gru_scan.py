"""GRU layer scan (port of `arec/kernels/gru_scan.py`).

`gru_layer` is the contract of arec's `gru_layer_pallas`: one recurrent
layer over time-major xw = x·[Wx_r|Wx_u|Wx_n] + b [L, B, 3H], the recurrent
weight Wh [H, 3H] (gate order r|u|n), the left-padding mask [B, L] and the
carried-in state h0 [B, H] → h_all [L, B, H], all f32. Per step, with the
products' operands cast to `dtype` and their sums in f32:

    r, u  = σ(xw_{r,u} + cast(h)·Wh[:, :2H])
    n     = tanh(xw_n + cast(r⊙h)·Wh[:, 2H:])       (reset before the product)
    h_new = (1−u)·n + u·h;   h = m·h_new + (1−m)·h  (pad steps are no-ops)

Gradients flow to xw, Wh and h0 (arec's custom VJP), so a segmented scan
has exactly the gradient of the one-pass scan. When autograd records the
layer runs as `GRULayer`, a `torch.autograd.Function`: its forward is the
training launch of `csrc/gru_scan_fwd.cu` (which also writes the residual
hp, the state before each step) and its backward is `csrc/gru_scan_bwd.cu`
(in bf16: a gate pass over all steps at once, the reverse sweep and dWh, on
the tensor cores; H a multiple of 16). Otherwise (serving,
`inference_mode`) the serving launch writes h_all only. The forward picks
its kernel as the LSTM's does (`lstm_scan.fwd_route`): bf16 with H a
multiple of 16 takes the tensor-core kernel, f32 and bf16 at any other
width the CUDA-core one.

For CUDA tensors the wrappers launch the hand-written kernels (sm_90a) or
raise; the plain PyTorch versions `gru_layer_plain` and
`gru_layer_bwd_plain` are taken only for CPU tensors. The launch helpers
and the stacked scan around the layer are the LSTM scan's
(`kernels/lstm_scan.py`).
"""

from __future__ import annotations

import torch

from arec_torch.kernels.lstm_scan import (_DWH_SPLITS, _check, _device_of,
                                          _dims, _fn, _fwd_launch,
                                          _fwd_weight, _launch_config,
                                          _mma_width, _ptrs, scan_layers)

KERNEL = "gru_scan_fwd"
KERNEL_BWD = "gru_scan_bwd"
# f32 words of shared memory per batch row of a CTA, in units of H: h, cast
# h, cast r⊙h and the r|u gates [2H] (forward); h_prev, its copy, r⊙h_prev,
# dh, dh_new·u (+ drh·r), dh_skip, the r|u gates [2H] and the gate
# derivatives [3H] (the f32 backward)
_STATE_WORDS = {KERNEL: 5, KERNEL_BWD: 11}


def gru_layer_plain(xw_tm, wh, mask_bm, h0, dtype=torch.bfloat16,
                    residuals: bool = False):
    """Plain PyTorch version of the forward kernel: the same arithmetic, one
    step at a time → h_all [L, B, H]; residuals=True also returns hp
    [L, B, H], the state before each step (the training launch's extra
    output)."""
    H = wh.shape[0]
    w = wh.to(dtype).float()
    w_ru, w_n = w[:, :2 * H], w[:, 2 * H:]
    h = h0
    hs, hps = [], []
    for t in range(xw_tm.shape[0]):
        hps.append(h)
        xw_t = xw_tm[t]
        hw = h.to(dtype).float() @ w_ru
        r = torch.sigmoid(xw_t[:, :H] + hw[:, :H])
        u = torch.sigmoid(xw_t[:, H:2 * H] + hw[:, H:])
        n = torch.tanh(xw_t[:, 2 * H:] + (r * h).to(dtype).float() @ w_n)
        h_new = (1.0 - u) * n + u * h
        m = mask_bm[:, t, None]
        h = m * h_new + (1.0 - m) * h
        hs.append(h)
    if residuals:
        return torch.stack(hs), torch.stack(hps)
    return torch.stack(hs)


def gru_layer_bwd_plain(xw_tm, wh, mask_bm, hp, dh_out,
                        dtype=torch.bfloat16):
    """Plain PyTorch version of the backward kernel (arec's `_backward`):
    reverse sweep with the gates recomputed from (xw, hp) → (dxw [L, B, 3H],
    dWh [H, 3H], dh0 [B, H]), all f32; dxw is left unrounded."""
    L, B, G = xw_tm.shape
    H = G // 3
    w = wh.to(dtype).float()
    w_ru, w_n = w[:, :2 * H], w[:, 2 * H:]
    q = lambda a: a.to(dtype).float()
    dh = torch.zeros(B, H, dtype=torch.float32, device=xw_tm.device)
    dwh = torch.zeros(H, G, dtype=torch.float32, device=xw_tm.device)
    dxw = torch.empty_like(xw_tm)
    for t in range(L - 1, -1, -1):
        h_prev, xw_t = hp[t], xw_tm[t]
        hw = q(h_prev) @ w_ru
        r = torch.sigmoid(xw_t[:, :H] + hw[:, :H])
        u = torch.sigmoid(xw_t[:, H:2 * H] + hw[:, H:])
        rh = r * h_prev
        n = torch.tanh(xw_t[:, 2 * H:] + q(rh) @ w_n)
        m = mask_bm[:, t, None]
        dh_total = dh_out[t] + dh
        dh_new = m * dh_total
        dh_skip = (1.0 - m) * dh_total
        dn = dh_new * (1.0 - u)
        du = dh_new * (h_prev - n)
        da_n = dn * (1.0 - n * n)
        drh = q(da_n) @ w_n.T
        dr = drh * h_prev
        dh_prev = dh_new * u + drh * r
        da_r = dr * r * (1.0 - r)
        da_u = du * u * (1.0 - u)
        da_ru = torch.cat([da_r, da_u], dim=1)
        dh_prev = dh_prev + q(da_ru) @ w_ru.T
        dxw[t] = torch.cat([da_ru, da_n], dim=1)
        dwh[:, :2 * H] += q(h_prev).T @ q(da_ru)
        dwh[:, 2 * H:] += q(rh).T @ q(da_n)
        dh = dh_prev + dh_skip
    return dxw, dwh, dh


def gru_scan_fwd(xw_tm, wh, mask_bm, h0, dtype=torch.bfloat16,
                 residuals: bool = False):
    """The forward kernel on CUDA tensors → (h_all,), and with
    residuals=True (h_all, hp): the tensor-core kernel or the CUDA-core one
    by `lstm_scan.fwd_route`. Raises on anything it does not take."""
    dev = _device_of(xw_tm, KERNEL)
    L, B, G, H = _dims(KERNEL, xw_tm, 3)
    route, name, w, shape = _fwd_weight(wh, dtype, H, G)
    f32 = torch.float32
    _check(KERNEL, dtype, xw_tm, {
        "xw_tm": (xw_tm, (L, B, G), f32), name: (w, shape, dtype),
        "mask_bm": (mask_bm, (B, L), f32), "h0": (h0, (B, H), f32)})
    outs = [torch.empty((L, B, H), dtype=f32, device=dev)
            for _ in range(2 if residuals else 1)]
    _fwd_launch(KERNEL, route, residuals, _ptrs(xw_tm, w, mask_bm, h0, *outs),
                L, B, H, G, dtype, dev, _STATE_WORDS[KERNEL])
    gru_layer.launches += 1
    return tuple(outs)


def gru_layer_bwd(xw_tm, wh, mask_bm, hp, dh_out, dtype=torch.bfloat16):
    """The backward kernel on CUDA tensors → (dxw, dWh, dh0), the contract
    of `gru_layer_bwd_plain`. bf16: the three tensor-core stages (gate
    pass, sweep, dWh; H a multiple of 16); f32: the CUDA-core sweep and
    dWh. Raises on anything it does not take."""
    dev = _device_of(xw_tm, KERNEL_BWD)
    wh = wh.detach().to(dtype)
    L, B, G, H = _dims(KERNEL_BWD, xw_tm, 3)
    f32 = torch.float32
    _check(KERNEL_BWD, dtype, xw_tm, {
        "xw_tm": (xw_tm, (L, B, G), f32), "wh": (wh, (H, G), dtype),
        "mask_bm": (mask_bm, (B, L), f32), "hp": (hp, (L, B, H), f32),
        "dh_out": (dh_out, (L, B, H), f32)})
    bf16 = dtype == torch.bfloat16
    if bf16:
        _mma_width(KERNEL_BWD, H)
    else:
        bt, wh_in_smem = _launch_config(KERNEL_BWD, B, H, G,
                                        _STATE_WORDS[KERNEL_BWD], dtype, dev)
    dxw = torch.empty((L, B, G), dtype=f32, device=dev)
    dwh = torch.empty((H, G), dtype=f32, device=dev)
    dh0 = torch.empty((B, H), dtype=f32, device=dev)
    # cast(r⊙h_prev) of every (t, b), written for the dWh pass (by the gate
    # pass in bf16, by the sweep in f32)
    rh = torch.empty((L, B, H), dtype=f32, device=dev)
    part = torch.empty((_DWH_SPLITS, H, G), dtype=f32, device=dev)
    ptrs = _ptrs(xw_tm, wh, mask_bm, hp, dh_out, dxw, dwh, dh0, rh, part)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if bf16:
            rc = _fn(KERNEL_BWD, "gru_scan_bwd_bf16", 10, 3)(
                *ptrs, L, B, H, stream)
        else:
            rc = _fn(KERNEL_BWD, "gru_scan_bwd", 10, 5)(
                *ptrs, L, B, H, bt, int(wh_in_smem), stream)
    if rc != 0:
        raise RuntimeError(f"gru_scan_bwd launch failed: CUDA error {rc}")
    gru_layer_bwd.launches += 1
    return dxw, dwh, dh0


class GRULayer(torch.autograd.Function):
    """One layer with arec's custom VJP: gradients to xw, Wh and h0 through
    h_all (mask and dtype take none)."""

    @staticmethod
    def forward(ctx, xw_tm, wh, mask_bm, h0, dtype):
        if xw_tm.device.type == "cpu":
            h_all, hp = gru_layer_plain(xw_tm, wh, mask_bm, h0, dtype,
                                        residuals=True)
        else:
            h_all, hp = gru_scan_fwd(xw_tm, wh, mask_bm, h0, dtype,
                                     residuals=True)
        ctx.save_for_backward(xw_tm, wh, mask_bm, hp)
        ctx.dtype = dtype
        return h_all

    @staticmethod
    def backward(ctx, dh_out):
        xw_tm, wh, mask_bm, hp = ctx.saved_tensors
        bwd = (gru_layer_bwd_plain if xw_tm.device.type == "cpu"
               else gru_layer_bwd)
        dxw, dwh, dh0 = bwd(xw_tm, wh, mask_bm, hp, dh_out.contiguous(),
                            ctx.dtype)
        return dxw, dwh.to(wh.dtype), None, dh0, None


def gru_layer(xw_tm, wh, mask_bm, h0, dtype=torch.bfloat16):
    """One recurrent layer → h_all [L, B, H]; the final state is h_all[-1].
    Differentiable (through `GRULayer`) when autograd records; CPU tensors
    take the plain versions, CUDA tensors launch the kernels or raise."""
    if xw_tm.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gru_layer runs on cuda or cpu, not "
                         f"{xw_tm.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xw_tm, wh, h0)):
        return GRULayer.apply(xw_tm, wh, mask_bm, h0, dtype)
    if xw_tm.device.type == "cpu":
        return gru_layer_plain(xw_tm, wh, mask_bm, h0, dtype)
    return gru_scan_fwd(xw_tm, wh, mask_bm, h0, dtype)[0]


gru_layer.launches = 0       # gru_scan_fwd launches since the last reset
gru_layer_bwd.launches = 0   # gru_scan_bwd launches since the last reset


def _gru_layer_carry(xw_tm, wh, mask_bm, h0, c0, dtype):
    """`gru_layer` in the LSTM layer's form: the c slot passes through."""
    return gru_layer(xw_tm, wh, mask_bm, h0, dtype), c0


def gru_scan(layers: list[dict], x, mask, dtype=torch.bfloat16,
             states: list | None = None, return_states: bool = False,
             time_major: bool = False, dropout_gen=None,
             keep_prob: float = 1.0):
    """Counterpart of arec's `pallas_gru_scan` (and a drop-in for the plain
    `rnn_scan` with cell="gru"): x [B, L, D], mask [B, L] → top-layer hidden
    states [B, L, H]; time_major: x [L, B, D], mask [L, B] → [L, B, H].
    `states`: optional per-layer (h0, c0) carries, the c slot riding along
    untouched so the state structure matches the LSTM path;
    `return_states=True` also returns the per-layer (hT, c0).
    `dropout_gen`/`keep_prob`: per-layer output dropout applied outside the
    kernel, as in `lstm_scan`; the carries stay undropped."""
    return scan_layers(_gru_layer_carry, layers, x, mask, dtype, states,
                       return_states, time_major, dropout_gen, keep_prob)
