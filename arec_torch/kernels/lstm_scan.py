"""LSTM layer scan (port of `arec/kernels/lstm_scan.py`, forward).

`lstm_layer` is the forward contract of arec's `lstm_layer_pallas`: one
recurrent layer over time-major xw = x·Wx + b [L, B, 4H], the recurrent
weight Wh [H, 4H], the left-padding mask [B, L] and the carried-in state
(h0, c0) [B, H] → (h_all [L, B, H], cT [B, H]), all f32. Per step:
gates = xw_t + cast(h, dtype)·cast(Wh, dtype) summed in f32, gate order
i|f|g|o, and h, c = m·new + (1−m)·old, so pad steps are exact no-ops.

For CUDA tensors it launches the hand-written kernel
`arec_torch/csrc/lstm_scan_fwd.cu` (sm_90a) or raises; the plain PyTorch
version `lstm_layer_plain` is taken only for CPU tensors. The TPU
workarounds (the [L, B, H] mask broadcast, `_pick_tiles`,
`padded_seq_len`) do not exist here: the kernel reads the [B, L] mask and
takes any L and B. The backward kernel comes with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from arec_torch.kernels import _build

KERNEL = "lstm_scan_fwd"
_DTYPES = (torch.float32, torch.bfloat16)
_BT_CHOICES = (1, 2, 4, 8)


def lstm_layer_plain(xw_tm, wh, mask_bm, h0, c0, dtype=torch.bfloat16):
    """Plain PyTorch version of the kernel: the same arithmetic, one step
    at a time."""
    H = wh.shape[0]
    w = wh.to(dtype).float()
    h, c = h0, c0
    hs = []
    for t in range(xw_tm.shape[0]):
        gates = xw_tm[t] + h.to(dtype).float() @ w
        i, f, g, o = gates.split(H, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask_bm[:, t, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        hs.append(h)
    return torch.stack(hs), c


def _fn():
    fn = _build.load(KERNEL).lstm_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(xw_tm, wh, mask_bm, h0, c0, dtype):
    if dtype not in _DTYPES:
        raise ValueError(f"lstm_scan_fwd takes dtype float32 or bfloat16, "
                         f"not {dtype}")
    if xw_tm.dim() != 3 or xw_tm.shape[2] % 4:
        raise ValueError(f"xw_tm must be [L, B, 4H], got {tuple(xw_tm.shape)}")
    L, B, G = xw_tm.shape
    H = G // 4
    if L < 1 or B < 1:
        raise ValueError(f"lstm_scan_fwd needs L, B >= 1, got L={L}, B={B}")
    want = {"xw_tm": (xw_tm, (L, B, G), torch.float32),
            "wh": (wh, (H, G), dtype),
            "mask_bm": (mask_bm, (B, L), torch.float32),
            "h0": (h0, (B, H), torch.float32),
            "c0": (c0, (B, H), torch.float32)}
    for name, (t, shape, dt) in want.items():
        if t.device != xw_tm.device:
            raise ValueError(f"{name} is on {t.device}, xw_tm on "
                             f"{xw_tm.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch_config(B: int, H: int, dtype, device) -> tuple[int, bool]:
    """(rows per CTA, Wh resident in shared memory): the fewest rows per
    CTA that keep the grid within one wave of SMs, and Wh in shared memory
    when it fits beside the state tiles."""
    props = torch.cuda.get_device_properties(device)
    bt = next((b for b in _BT_CHOICES
               if -(-B // b) <= props.multi_processor_count), _BT_CHOICES[-1])
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    state = bt * 7 * H * 4               # h, c, cast h [BT, H]; gates [BT, 4H]
    if state > limit:
        raise ValueError(f"lstm_scan_fwd: H={H} needs {state} bytes of shared "
                         f"memory for its state, over the {limit} a block has")
    wh_bytes = 4 * H * H * (2 if dtype == torch.bfloat16 else 4)
    return bt, state + wh_bytes <= limit


def lstm_layer(xw_tm, wh, mask_bm, h0, c0, dtype=torch.bfloat16):
    """One recurrent layer → (h_all [L, B, H], cT [B, H]). CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if xw_tm.device.type == "cpu":
        return lstm_layer_plain(xw_tm, wh, mask_bm, h0, c0, dtype)
    if xw_tm.device.type != "cuda":
        raise ValueError(f"lstm_layer runs on cuda or cpu, not "
                         f"{xw_tm.device}")
    wh = wh.to(dtype)
    _check(xw_tm, wh, mask_bm, h0, c0, dtype)
    L, B, G = xw_tm.shape
    H = G // 4
    bt, wh_in_smem = _launch_config(B, H, dtype, xw_tm.device)
    h_all = torch.empty((L, B, H), dtype=torch.float32, device=xw_tm.device)
    cT = torch.empty((B, H), dtype=torch.float32, device=xw_tm.device)
    stream = torch.cuda.current_stream(xw_tm.device).cuda_stream
    with torch.cuda.device(xw_tm.device):
        rc = _fn()(xw_tm.data_ptr(), wh.data_ptr(), mask_bm.data_ptr(),
                   h0.data_ptr(), c0.data_ptr(), h_all.data_ptr(),
                   cT.data_ptr(), L, B, H, int(dtype == torch.bfloat16), bt,
                   int(wh_in_smem), stream)
    if rc != 0:
        raise RuntimeError(f"lstm_scan_fwd launch failed: CUDA error {rc}")
    lstm_layer.launches += 1
    return h_all, cT


lstm_layer.launches = 0   # kernel launches since the caller last reset it


def lstm_scan(layers: list[dict], x, mask, dtype=torch.bfloat16,
              states: list | None = None, return_states: bool = False,
              time_major: bool = False):
    """Counterpart of arec's `pallas_lstm_scan` (and a drop-in for the
    plain `rnn_scan` with cell="lstm"): x [B, L, D], mask [B, L] → top-layer
    hidden states [B, L, H]; time_major: x [L, B, D], mask [L, B] →
    [L, B, H]. `states`: optional per-layer (h0, c0) carries;
    `return_states=True` also returns the per-layer final (hT, cT)."""
    from arec_torch.models.seq import input_projection

    b = x.shape[1] if time_major else x.shape[0]
    mask_bm = (mask.T if time_major else mask).float().contiguous()
    h = x
    new_states = []
    for li, p in enumerate(layers):
        d_in = h.shape[-1]
        d = p["w"].shape[0] - d_in
        xw = input_projection(p, h, dtype)                 # [..., 4H]
        if states is not None:
            h0, c0 = states[li]
        else:
            h0 = c0 = torch.zeros(b, d, device=x.device)
        xw_tm = xw if time_major else xw.transpose(0, 1)
        h_all, cT = lstm_layer(xw_tm.contiguous(), p["w"][d_in:], mask_bm,
                               h0.contiguous(), c0.contiguous(), dtype)
        new_states.append((h_all[-1], cT))
        h = h_all if time_major else h_all.transpose(0, 1)
    if return_states:
        return h, new_states
    return h
