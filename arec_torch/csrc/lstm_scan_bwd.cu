// lstm_scan_bwd: one LSTM layer, backward, over a whole left-padded sequence.
//
// Replaces the TPU kernel arec/kernels/lstm_scan.py:_bwd_kernel (:182, the
// Pallas backward of lstm_layer_pallas's custom VJP, called from
// `_backward` :249). Inputs are the forward's operands (xw [L, B, 4H], Wh
// [H, 4H], mask [B, L]), its residuals hp, cp [L, B, H] (the state BEFORE
// step t, from lstm_scan_fwd_resid) and the cotangents dh_out [L, B, H] (of
// h_all) and dcT [B, H] (of cT). Reverse time sweep, per step t (gate order
// i|f|g|o), with the TPU kernel's arithmetic (q = cast to the product
// dtype, round to nearest even; sums in f32):
//   gates  = xw[t] + q(hp[t]) · q(Wh)           recomputed
//   dh_tot = dh_out[t] + dh;  dh_new = m·dh_tot;  dh_skip = (1-m)·dh_tot
//   dc_new = m·dc;  dc_skip = (1-m)·dc
//   do = dh_new·tanh(c')·σo(1-σo);  dc_new += dh_new·σo·(1-tanh²(c'))
//   df = dc_new·cp[t]·σf(1-σf);  di = dc_new·tanh(g)·σi(1-σi);
//   dg = dc_new·σi·(1-tanh²(g))
//   dxw[t] = [di | df | dg | do]                 (unrounded)
//   dh = q(dxw[t]) · q(Wh)ᵀ + dh_skip;  dc = dc_new·σf + dc_skip
// starting from dh = 0, dc = dcT; after step 0 (dh, dc) are (dh0, dc0).
// dWh = Σ_{t,b} q(hp[t,b])ᵀ · q(dxw[t,b]). Pad steps have dxw = 0 and add
// nothing. dWh's terms are summed in one fixed order and its row-range
// partials added in range order, with no atomics: runs repeat bit for bit.
//
// bf16 (the main path's dtype): three stages, one C entry point, on the
// caller's stream (shared pieces in scan_mma.cuh).
//  1. Gate pass over all N = L·B rows at once. The gates depend on xw[t]
//     and hp[t] only, nothing the sweep carries, so they leave the serial
//     chain: a tensor-core product of q(hp) [N, H] by Wh [H, 4H] with the
//     activations in its epilogue, written into the dxw buffer itself (the
//     sweep reads each slot and overwrites it with its derivative: no
//     scratch). Bound by bytes: xw in, the stash out, ~30 MB at c4's
//     training shape (L = 50, B = 128, H = 128), ~9 µs of HBM time. One CTA
//     per 64 rows × 64 columns (800 at that shape), so enough are in flight
//     to cover the latency of their loads.
//  2. The sweep, the only sequential part: L dependent steps, each an
//     elementwise pass and one product q(dgates) [BT, 4H] by Whᵀ. Bound by
//     the latency of that chain. A CTA owns BT = 8 batch rows (16 CTAs at
//     B = 128), one warp per 16 units. The product is computed transposed,
//     dhᵀ = Wh · q(dgates)ᵀ, so the 8 batch rows are the mma's n and the
//     accumulator's (unit, row) positions are the ones each thread owns in
//     the elementwise pass: the carries stay with their thread. At the
//     configs' widths (H = 64, 128) Wh stays in registers for the whole
//     sweep as each warp's A fragments (the persistent-RNN layout of
//     Diamos et al., 2016: 128 words a thread at H = 128), with the
//     carries; q(dgates) goes through shared memory, double-buffered by
//     step, so one barrier a step, and the step inputs (stash, cp, dh_out,
//     mask rows) come in coalesced by cp.async two steps ahead. What is
//     left per step is mostly the SM's load/store and shared-memory pipe
//     (the elementwise reads, the dxw stores, each warp's ldmatrix of all
//     of q(dgates)) and the barrier. At other widths a general kernel
//     keeps Wh in shared memory (or, past ~140 units, reads it from L2),
//     the state in shared memory and the next step's inputs coming in by
//     cp.async: two barriers a step.
//  3. dWh [H, 4H] = q(hp)ᵀ · q(dxw) over the N rows on the tensor cores:
//     64 × 64 output tiles, the rows split into 8 ranges (128 CTAs at
//     c4's shape), each summed in row order; a last pass adds the ranges
//     in order.
// Takes H a multiple of 16 (the MMA's depth), any B and L; ragged B is
// masked here.
//
// f32, the parity mode, keeps the CUDA-core kernels of the first version
// (namespace f32 below; their casts are identities): one CTA per BT rows
// for the whole sweep, the gate recompute and the carry product as
// block-wide FMA products each step, and a shared-memory tiled dWh.

#include "scan_mma.cuh"

namespace {

// ----------------------------------------------------------------- bf16 ----

// Stage 2 at the configs' widths (HT = 64 or 128): the reverse sweep over
// the CTA's BT batch rows, one warp per 16 units. Per step t the thread of
// accumulator position (unit j, row b) of the carry product forms the gate
// derivatives of its four (j, b) pairs from the stashed gates, cp[t],
// dh_out[t], the mask and its carries (dh, dc), overwrites the stash slots
// in dxw with them (unrounded) and puts q(them) into the product's B
// operand; then dh = q(dgates)·Whᵀ + dh_skip on the tensor cores lands in
// the same thread's pairs. Wh stays in registers as each warp's mma A
// fragments (HT/4 k-steps × 4 words a thread) and the carries with their
// threads; q(dgates) goes through shared memory, double-buffered by step,
// so one barrier a step. The step inputs come into shared memory by
// cp.async two steps ahead (three buffers).
template <int HT>
__global__ void __launch_bounds__(2 * HT) lstm_sweep_reg_kernel(
    const bf16* __restrict__ wh, const float* __restrict__ mask, const float* __restrict__ cp,
    const float* __restrict__ dh_out, const float* __restrict__ dcT, float* __restrict__ dxw,
    float* __restrict__ dh0, float* __restrict__ dc0, int L, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int H = HT;
  constexpr int G = 4 * H;
  constexpr int KS = G / KSTEP;
  constexpr int ldq = G + PADB, ldg = G + PADF, ldh = H + PADF;
  constexpr Sweep l = reg_layout(H, G);
  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  uint32_t a[KS][4];
  load_a_frags<KS>(a, wh, G, 16 * warp);

  // pair e: unit 16·warp + g + 8(e>>1), row 2tq + (e&1)
  float dh[4], dc[4];          // carries
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = 16 * warp + g + 8 * (e >> 1);
    const int b = 2 * tq + (e & 1);
    dh[e] = 0.0f;
    dc[e] = b < nrows ? dcT[static_cast<size_t>(b0 + b) * H + j] : 0.0f;
  }
  sweep_init(smem, l, wh, H, G);
  __syncthreads();
  sweep_prefetch(smem, l, (L - 1) % 3, L - 1, dxw, cp, dh_out, mask, b0, nrows, L, B, H, G);
  cp_async_commit();
  if (L > 1)
    sweep_prefetch(smem, l, (L - 2) % 3, L - 2, dxw, cp, dh_out, mask, b0, nrows, L, B, H, G);
  cp_async_commit();
  cp_async_wait_prev();        // step L-1's inputs are in
  __syncthreads();

  for (int t = L - 1; t >= 0; --t) {
    const int buf = t % 3;
    if (t > 1)
      sweep_prefetch(smem, l, (t - 2) % 3, t - 2, dxw, cp, dh_out, mask, b0, nrows, L, B, H, G);
    cp_async_commit();
    bf16* q = reinterpret_cast<bf16*>(smem + l.qd) + (t & 1) * BT * ldq;
    const float* g_s = reinterpret_cast<const float*>(smem + l.g) + buf * BT * ldg;
    const float* c_s = reinterpret_cast<const float*>(smem + l.x) + buf * BT * ldh;
    const float* o_s = reinterpret_cast<const float*>(smem + l.o) + buf * BT * ldh;
    const float* m_s = reinterpret_cast<const float*>(smem + l.m) + buf * BT;
    float* dxw_t = dxw + (static_cast<size_t>(t) * B + b0) * G;
    float sk[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 16 * warp + g + 8 * (e >> 1);
      const int b = 2 * tq + (e & 1);
      const float* gr = g_s + b * ldg;
      const float si = gr[j];
      const float sf = gr[H + j];
      const float tg = gr[2 * H + j];
      const float so = gr[3 * H + j];
      const float c_prev = c_s[b * ldh + j];
      const float m = m_s[b];
      const float c_new = sf * c_prev + si * tg;
      const float tc = tanhf(c_new);
      const float dh_total = o_s[b * ldh + j] + dh[e];
      const float dh_new = m * dh_total;
      const float dc_total = dc[e];
      float d_c = m * dc_total;
      const float d_o = dh_new * tc * so * (1.0f - so);
      d_c = d_c + dh_new * so * (1.0f - tc * tc);
      const float d_f = d_c * c_prev * sf * (1.0f - sf);
      const float d_i = d_c * tg * si * (1.0f - si);
      const float d_g = d_c * si * (1.0f - tg * tg);
      if (b < nrows) {
        float* out = dxw_t + static_cast<size_t>(b) * G;
        out[j] = d_i;
        out[H + j] = d_f;
        out[2 * H + j] = d_g;
        out[3 * H + j] = d_o;
      }
      bf16* qr = q + b * ldq;
      qr[j] = __float2bfloat16(d_i);
      qr[H + j] = __float2bfloat16(d_f);
      qr[2 * H + j] = __float2bfloat16(d_g);
      qr[3 * H + j] = __float2bfloat16(d_o);
      sk[e] = (1.0f - m) * dh_total;
      dc[e] = d_c * sf + (1.0f - m) * dc_total;
    }
    cp_async_wait_prev();      // step t-1's inputs are in
    __syncthreads();
    float acc[4];
    carry_product_reg<0, KS>(a, q, ldq, acc);
#pragma unroll
    for (int e = 0; e < 4; ++e) dh[e] = acc[e] + sk[e];
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = 16 * warp + g + 8 * (e >> 1);
    const int b = 2 * tq + (e & 1);
    if (b < nrows) {
      dh0[static_cast<size_t>(b0 + b) * H + j] = dh[e];
      dc0[static_cast<size_t>(b0 + b) * H + j] = dc[e];
    }
  }
}

// Stage 2 at any other width (a multiple of 16), as lstm_sweep_reg_kernel
// but general: the (j, b) state in shared memory, the step inputs copied in
// by cp.async one step ahead, Wh read from shared memory (W_SMEM, when it
// fits beside the buffers) or from global memory. Two barriers a step.
template <bool W_SMEM>
__global__ void __launch_bounds__(MAX_WARPS * 32) lstm_sweep_kernel(
    const bf16* __restrict__ wh, const float* __restrict__ mask, const float* __restrict__ cp,
    const float* __restrict__ dh_out, const float* __restrict__ dcT, float* __restrict__ dxw,
    float* __restrict__ dh0, float* __restrict__ dc0, int L, int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = 4 * H;
  const int ldq = G + PADB, ldg = G + PADF, ldh = H + PADF;
  const Sweep l = general_layout(H, G, W_SMEM);
  const bf16* W = W_SMEM ? reinterpret_cast<const bf16*>(smem + l.w) : wh;
  const int ldw = W_SMEM ? ldq : G;
  bf16* qd_s = reinterpret_cast<bf16*>(smem + l.qd);   // [BT][ldq] q(dgates)
  float* dh_s = reinterpret_cast<float*>(smem + l.s);  // [BT][ldh] carry dh
  float* dc_s = dh_s + BT * ldh;                       // carry dc
  float* sk_s = dc_s + BT * ldh;                       // dh_skip of this step
  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;

  sweep_init(smem, l, wh, H, G);
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x) {
    const int r = idx / H;
    const int j = idx - r * H;
    dc_s[r * ldh + j] = dcT[static_cast<size_t>(b0 + r) * H + j];
  }
  sweep_prefetch(smem, l, (L - 1) & 1, L - 1, dxw, cp, dh_out, mask, b0, nrows, L, B, H, G);
  cp_async_wait_all();
  __syncthreads();

  for (int t = L - 1; t >= 0; --t) {
    const int buf = t & 1;
    if (t > 0) {
      sweep_prefetch(smem, l, buf ^ 1, t - 1, dxw, cp, dh_out, mask, b0, nrows, L, B, H, G);
      cp_async_commit();
    }
    const float* g_s = reinterpret_cast<const float*>(smem + l.g) + buf * BT * ldg;
    const float* c_s = reinterpret_cast<const float*>(smem + l.x) + buf * BT * ldh;
    const float* o_s = reinterpret_cast<const float*>(smem + l.o) + buf * BT * ldh;
    const float* m_s = reinterpret_cast<const float*>(smem + l.m) + buf * BT;
    float* dxw_t = dxw + (static_cast<size_t>(t) * B + b0) * G;

    for (int mt = warp; mt < H / 16; mt += nw) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * mt + g + 8 * (e >> 1);
        const int b = 2 * tq + (e & 1);
        const float* gr = g_s + b * ldg;
        const float si = gr[j];
        const float sf = gr[H + j];
        const float tg = gr[2 * H + j];
        const float so = gr[3 * H + j];
        const int s = b * ldh + j;
        const float c_prev = c_s[s];
        const float m = m_s[b];
        const float c_new = sf * c_prev + si * tg;
        const float tc = tanhf(c_new);
        const float dh_total = o_s[s] + dh_s[s];
        const float dh_new = m * dh_total;
        const float dc_total = dc_s[s];
        float dc = m * dc_total;
        const float d_o = dh_new * tc * so * (1.0f - so);
        dc = dc + dh_new * so * (1.0f - tc * tc);
        const float d_f = dc * c_prev * sf * (1.0f - sf);
        const float d_i = dc * tg * si * (1.0f - si);
        const float d_g = dc * si * (1.0f - tg * tg);
        if (b < nrows) {
          float* out = dxw_t + static_cast<size_t>(b) * G;
          out[j] = d_i;
          out[H + j] = d_f;
          out[2 * H + j] = d_g;
          out[3 * H + j] = d_o;
        }
        bf16* q = qd_s + b * ldq;
        q[j] = __float2bfloat16(d_i);
        q[H + j] = __float2bfloat16(d_f);
        q[2 * H + j] = __float2bfloat16(d_g);
        q[3 * H + j] = __float2bfloat16(d_o);
        sk_s[s] = (1.0f - m) * dh_total;
        dc_s[s] = dc * sf + (1.0f - m) * dc_total;
      }
    }
    __syncthreads();

    for (int mt = warp; mt < H / 16; mt += nw) {
      float acc[4];
      carry_product<W_SMEM>(W, ldw, 16 * mt, 0, qd_s, ldq, 0, G, acc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = (2 * tq + (e & 1)) * ldh + 16 * mt + g + 8 * (e >> 1);
        dh_s[s] = acc[e] + sk_s[s];
      }
    }
    cp_async_wait_all();        // step t-1's inputs are in
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x) {
    const int r = idx / H;
    const int j = idx - r * H;
    dh0[static_cast<size_t>(b0 + r) * H + j] = dh_s[r * ldh + j];
    dc0[static_cast<size_t>(b0 + r) * H + j] = dc_s[r * ldh + j];
  }
}

// The sweep kernel for width H and how it launches: the register-resident
// one at the configs' widths, else the general one with Wh in shared
// memory when it fits beside the sweep's buffers.
struct Bf16Plan {
  const void* sweep;
  int threads;
  size_t smem;
  bool w_smem;
};

bool plan_bf16(int H, Bf16Plan* p) {
  const size_t limit = static_cast<size_t>(smem_optin());
  if (H == 128 || H == 64) {
    p->sweep = H == 128 ? reinterpret_cast<const void*>(lstm_sweep_reg_kernel<128>)
                        : reinterpret_cast<const void*>(lstm_sweep_reg_kernel<64>);
    p->threads = 2 * H;
    p->smem = reg_layout(H, 4 * H).total;
    p->w_smem = false;
  } else {
    const int G = 4 * H;
    p->w_smem = general_layout(H, G, true).total <= limit;
    p->smem = general_layout(H, G, p->w_smem).total;
    p->sweep = p->w_smem ? reinterpret_cast<const void*>(lstm_sweep_kernel<true>)
                         : reinterpret_cast<const void*>(lstm_sweep_kernel<false>);
    p->threads = (H / 16 < MAX_WARPS ? H / 16 : MAX_WARPS) * 32;
  }
  return gates_smem(H) <= limit && p->smem <= limit;
}

// the three stages: gate pass, sweep, dWh
cudaError_t bwd_bf16(const float* xw, const bf16* wh, const float* mask, const float* hp,
                     const float* cp, const float* dh_out, const float* dcT, float* dxw,
                     float* dwh, float* dh0, float* dc0, float* part, int L, int B, int H,
                     cudaStream_t s) {
  Bf16Plan p;
  if (!plan_bf16(H, &p)) return cudaErrorInvalidConfiguration;
  const int G = 4 * H;
  const int N = L * B;
  cudaError_t e = launch_gates(xw, wh, hp, dxw, nullptr, N, H, G, 0, G, 2 * H, 3 * H, s);
  if (e != cudaSuccess) return e;
  const int grid = cdiv(B, BT);
  e = set_smem(p.sweep, p.smem);
  if (e != cudaSuccess) return e;
  if (H == 128) {
    lstm_sweep_reg_kernel<128><<<grid, p.threads, p.smem, s>>>(wh, mask, cp, dh_out, dcT, dxw,
                                                               dh0, dc0, L, B);
  } else if (H == 64) {
    lstm_sweep_reg_kernel<64><<<grid, p.threads, p.smem, s>>>(wh, mask, cp, dh_out, dcT, dxw,
                                                              dh0, dc0, L, B);
  } else {
    auto sweep = p.w_smem ? lstm_sweep_kernel<true> : lstm_sweep_kernel<false>;
    sweep<<<grid, p.threads, p.smem, s>>>(wh, mask, cp, dh_out, dcT, dxw, dh0, dc0, L, B, H);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_dwh(hp, hp, dxw, part, dwh, N, H, G, G, s);
}

// ------------------------------------------------------------------ f32 ----

namespace f32 {

template <int BT, bool WH_SMEM>
__global__ void lstm_scan_bwd_kernel(const float* __restrict__ xw,      // [L, B, 4H]
                                     const float* __restrict__ wh,         // [H, 4H]
                                     const float* __restrict__ mask,    // [B, L]
                                     const float* __restrict__ hp,      // [L, B, H]
                                     const float* __restrict__ cp,      // [L, B, H]
                                     const float* __restrict__ dh_out,  // [L, B, H]
                                     const float* __restrict__ dcT,     // [B, H]
                                     float* __restrict__ dxw,           // [L, B, 4H]
                                     float* __restrict__ dh0,           // [B, H]
                                     float* __restrict__ dc0,           // [B, H]
                                     int L, int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = 4 * H;
  const size_t wh_elems = WH_SMEM ? static_cast<size_t>(H) * G : 0;
  float* wh_s = reinterpret_cast<float*>(smem);                        // [H][G]
  float* hq_s = reinterpret_cast<float*>(smem + wh_elems * sizeof(float));
  float* dh_s = hq_s + BT * H;   // [BT][H] carry dh
  float* dc_s = dh_s + BT * H;   // [BT][H] carry dc
  float* sk_s = dc_s + BT * H;   // [BT][H] dh_skip of this step
  float* g_s = sk_s + BT * H;    // [BT][G] gates, then cast(dgates)

  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  if constexpr (WH_SMEM) {
    const size_t bytes = wh_elems * sizeof(float);
    if (bytes % 16 == 0 && reinterpret_cast<uintptr_t>(wh) % 16 == 0) {
      const uint4* src = reinterpret_cast<const uint4*>(wh);
      uint4* dst = reinterpret_cast<uint4*>(wh_s);
      for (size_t i = tid; i < bytes / 16; i += nt) dst[i] = src[i];
    } else {
      for (size_t i = tid; i < wh_elems; i += nt) wh_s[i] = wh[i];
    }
  }
  const float* W = WH_SMEM ? wh_s : wh;

  for (int idx = tid; idx < BT * H; idx += nt) {
    const int r = idx / H;
    const int j = idx - r * H;
    hq_s[idx] = 0.0f;
    dh_s[idx] = 0.0f;
    sk_s[idx] = 0.0f;
    dc_s[idx] = r < nrows ? dcT[static_cast<size_t>(b0 + r) * H + j] : 0.0f;
  }
  for (int idx = tid; idx < BT * G; idx += nt) g_s[idx] = 0.0f;
  __syncthreads();

  for (int t = L - 1; t >= 0; --t) {
    for (int idx = tid; idx < nrows * H; idx += nt) {
      const int r = idx / H;
      const int j = idx - r * H;
      hq_s[idx] = hp[(static_cast<size_t>(t) * B + b0 + r) * H + j];
    }
    __syncthreads();

    // phase 1: recompute gate column `col` for every row of the tile
    for (int col = tid; col < G; col += nt) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float w = W[static_cast<size_t>(k) * G + col];
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(hq_s[r * H + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        if (r < nrows) {
          g_s[r * G + col] =
              xw[(static_cast<size_t>(t) * B + b0 + r) * G + col] + acc[r];
        }
      }
    }
    __syncthreads();

    // phase 2: gate derivatives, one (row, unit) per thread; each thread
    // overwrites exactly the four gate slots it read
    for (int idx = tid; idx < nrows * H; idx += nt) {
      const int r = idx / H;
      const int j = idx - r * H;
      float* g = g_s + r * G;
      const float si = sigmoid(g[j]);
      const float sf = sigmoid(g[H + j]);
      const float tg = tanhf(g[2 * H + j]);
      const float so = sigmoid(g[3 * H + j]);
      const size_t st = (static_cast<size_t>(t) * B + b0 + r) * H + j;
      const float c_prev = cp[st];
      const float c_new = sf * c_prev + si * tg;
      const float tc = tanhf(c_new);
      const float m = mask[static_cast<size_t>(b0 + r) * L + t];
      const float dh_total = dh_out[st] + dh_s[idx];
      const float dh_new = m * dh_total;
      const float dc_total = dc_s[idx];
      float dc = m * dc_total;
      const float d_o = dh_new * tc * so * (1.0f - so);
      dc = dc + dh_new * so * (1.0f - tc * tc);
      const float d_f = dc * c_prev * sf * (1.0f - sf);
      const float d_i = dc * tg * si * (1.0f - si);
      const float d_g = dc * si * (1.0f - tg * tg);
      float* out = dxw + (static_cast<size_t>(t) * B + b0 + r) * G;
      out[j] = d_i;
      out[H + j] = d_f;
      out[2 * H + j] = d_g;
      out[3 * H + j] = d_o;
      g[j] = d_i;
      g[H + j] = d_f;
      g[2 * H + j] = d_g;
      g[3 * H + j] = d_o;
      sk_s[idx] = (1.0f - m) * dh_total;
      dc_s[idx] = dc * sf + (1.0f - m) * dc_total;
    }
    __syncthreads();

    // phase 3: dh = cast(dgates) · Whᵀ + dh_skip, one warp per unit j
    for (int j = warp; j < H; j += nwarps) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
      const float* wrow = W + static_cast<size_t>(j) * G;
      for (int k = lane; k < G; k += 32) {
        const float w = wrow[k];
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(g_s[r * G + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          if (r < nrows) dh_s[r * H + j] = acc[r] + sk_s[r * H + j];
        }
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < nrows * H; idx += nt) {
    const int r = idx / H;
    const int j = idx - r * H;
    dh0[static_cast<size_t>(b0 + r) * H + j] = dh_s[idx];
    dc0[static_cast<size_t>(b0 + r) * H + j] = dc_s[idx];
  }
}

// dWh [H, G] = Σ_n cast(hp[n, :])ᵀ · cast(dxw[n, :]) over the N = L·B rows.
// Block tile: TI rows of H × TC columns of G, over the rows
// [z·split, (z+1)·split) of split z = blockIdx.z; each of the 256 threads
// owns TI·TC/256 = 2 outputs and sums its terms in increasing n into the
// partial part[z] [H, G].
constexpr int TI = 16;
constexpr int TC = 32;
constexpr int TN = 32;
constexpr int RS = 8;

__global__ void lstm_dwh_kernel(const float* __restrict__ hp,    // [N, H]
                                const float* __restrict__ dxw,   // [N, G]
                                float* __restrict__ part,        // [RS, H, G]
                                int N, int H, int split) {
  __shared__ float h_t[TN][TI];
  __shared__ float d_t[TN][TC];
  const int G = 4 * H;
  const int i0 = blockIdx.y * TI;
  const int c0 = blockIdx.x * TC;
  const int z = static_cast<int>(blockIdx.z);
  const int n_end = min(N, (z + 1) * split);
  const int tid = threadIdx.x;
  const int tc = tid % TC;
  const int ti = tid / TC;            // 0..7: rows ti and ti + 8
  float acc0 = 0.0f, acc1 = 0.0f;
  float* dwh = part + static_cast<size_t>(z) * H * G;
  for (int n0 = z * split; n0 < n_end; n0 += TN) {
    for (int idx = tid; idx < TN * TI; idx += blockDim.x) {
      const int n = idx / TI;
      const int i = idx - n * TI;
      h_t[n][i] = (n0 + n < n_end && i0 + i < H)
                      ? hp[static_cast<size_t>(n0 + n) * H + i0 + i]
                      : 0.0f;
    }
    for (int idx = tid; idx < TN * TC; idx += blockDim.x) {
      const int n = idx / TC;
      const int c = idx - n * TC;
      d_t[n][c] = (n0 + n < n_end && c0 + c < G)
                      ? dxw[static_cast<size_t>(n0 + n) * G + c0 + c]
                      : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int n = 0; n < TN; ++n) {
      const float d = d_t[n][tc];
      acc0 = fmaf(h_t[n][ti], d, acc0);
      acc1 = fmaf(h_t[n][ti + 8], d, acc1);
    }
    __syncthreads();
  }
  if (c0 + tc < G) {
    if (i0 + ti < H) dwh[static_cast<size_t>(i0 + ti) * G + c0 + tc] = acc0;
    if (i0 + ti + 8 < H) dwh[static_cast<size_t>(i0 + ti + 8) * G + c0 + tc] = acc1;
  }
}

// dWh = the RS partials added in split order
__global__ void lstm_dwh_reduce_kernel(const float* __restrict__ part,
                                       float* __restrict__ dwh, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) {
    float a = 0.0f;
    for (int r = 0; r < RS; ++r) a += part[static_cast<size_t>(r) * n + idx];
    dwh[idx] = a;
  }
}

template <int BT, bool WH_SMEM>
cudaError_t launch(const void* xw, const void* wh, const void* mask,
                   const void* hp, const void* cp, const void* dh_out,
                   const void* dcT, void* dxw, void* dwh, void* dh0, void* dc0,
                   void* part, int L, int B, int H, size_t smem,
                   cudaStream_t stream) {
  auto kernel = lstm_scan_bwd_kernel<BT, WH_SMEM>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int G = 4 * H;
  const int threads = G < 1024 ? ((G + 31) / 32) * 32 : 1024;
  kernel<<<(B + BT - 1) / BT, threads, smem, stream>>>(
      static_cast<const float*>(xw), static_cast<const float*>(wh),
      static_cast<const float*>(mask), static_cast<const float*>(hp),
      static_cast<const float*>(cp), static_cast<const float*>(dh_out),
      static_cast<const float*>(dcT), static_cast<float*>(dxw),
      static_cast<float*>(dh0), static_cast<float*>(dc0), L, B, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int N = L * B;
  const int split = ((N + TN * RS - 1) / (TN * RS)) * TN;
  const dim3 grid((G + TC - 1) / TC, (H + TI - 1) / TI, RS);
  lstm_dwh_kernel<<<grid, 256, 0, stream>>>(
      static_cast<const float*>(hp), static_cast<const float*>(dxw),
      static_cast<float*>(part), N, H, split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  lstm_dwh_reduce_kernel<<<(H * G + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dwh), H * G);
  return cudaGetLastError();
}

template <bool WH_SMEM>
cudaError_t dispatch_bt(int bt, const void* xw, const void* wh,
                        const void* mask, const void* hp, const void* cp,
                        const void* dh_out, const void* dcT, void* dxw,
                        void* dwh, void* dh0, void* dc0, void* part, int L,
                        int B, int H, size_t smem, cudaStream_t s) {
  switch (bt) {
    case 1: return launch<1, WH_SMEM>(xw, wh, mask, hp, cp, dh_out, dcT, dxw, dwh, dh0, dc0, part, L, B, H, smem, s);
    case 2: return launch<2, WH_SMEM>(xw, wh, mask, hp, cp, dh_out, dcT, dxw, dwh, dh0, dc0, part, L, B, H, smem, s);
    case 4: return launch<4, WH_SMEM>(xw, wh, mask, hp, cp, dh_out, dcT, dxw, dwh, dh0, dc0, part, L, B, H, smem, s);
    case 8: return launch<8, WH_SMEM>(xw, wh, mask, hp, cp, dh_out, dcT, dxw, dwh, dh0, dc0, part, L, B, H, smem, s);
    default: return cudaErrorInvalidValue;
  }
}


}  // namespace f32

}  // namespace

// Plain C entry points, loaded with ctypes. Every pointer is a device
// pointer to a contiguous tensor; `part` is scratch of 8·H·4H floats;
// `stream` is the caller's cudaStream_t. Each launches its kernels on that
// stream and returns the first cudaError_t (0 = all launched).

// f32: Wh f32; `bt` rows per CTA, Wh in shared memory when `wh_in_smem`.
extern "C" int lstm_scan_bwd(const void* xw, const void* wh, const void* mask,
                             const void* hp, const void* cp,
                             const void* dh_out, const void* dcT, void* dxw,
                             void* dwh, void* dh0, void* dc0, void* part,
                             int L, int B, int H, int bt, int wh_in_smem,
                             void* stream) {
  if (L < 1 || B < 1 || H < 1) return cudaErrorInvalidValue;
  const size_t G = 4 * static_cast<size_t>(H);
  const size_t state = static_cast<size_t>(bt) * (4 * H + G) * sizeof(float);
  const size_t smem = (wh_in_smem ? H * G * sizeof(float) : 0) + state;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      wh_in_smem ? f32::dispatch_bt<true>(bt, xw, wh, mask, hp, cp, dh_out, dcT, dxw, dwh, dh0, dc0, part, L, B, H, smem, s)
                 : f32::dispatch_bt<false>(bt, xw, wh, mask, hp, cp, dh_out, dcT, dxw, dwh, dh0, dc0, part, L, B, H, smem, s);
  return static_cast<int>(e);
}

// bf16: Wh bf16 [H, 4H], H a multiple of 16.
extern "C" int lstm_scan_bwd_bf16(const void* xw, const void* wh, const void* mask,
                                  const void* hp, const void* cp, const void* dh_out,
                                  const void* dcT, void* dxw, void* dwh, void* dh0, void* dc0,
                                  void* part, int L, int B, int H, void* stream) {
  if (L < 1 || B < 1 || H < 16 || H % 16) return cudaErrorInvalidValue;
  return static_cast<int>(bwd_bf16(
      static_cast<const float*>(xw), static_cast<const bf16*>(wh),
      static_cast<const float*>(mask), static_cast<const float*>(hp),
      static_cast<const float*>(cp), static_cast<const float*>(dh_out),
      static_cast<const float*>(dcT), static_cast<float*>(dxw), static_cast<float*>(dwh),
      static_cast<float*>(dh0), static_cast<float*>(dc0), static_cast<float*>(part), L, B, H,
      static_cast<cudaStream_t>(stream)));
}

// What the bf16 stages' kernels use as they launch at width H, four ints
// each in `out` (registers per thread, local bytes per thread, dynamic
// shared memory per block, resident blocks per SM), in the order gates,
// sweep, dwh_mma, dwh_reduce: 16 ints.
extern "C" int lstm_scan_bwd_bf16_kernel_info(int H, int* out) {
  Bf16Plan p;
  if (H < 16 || H % 16 || !plan_bf16(H, &p)) return cudaErrorInvalidValue;
  const void* fns[4] = {reinterpret_cast<const void*>(gates_kernel<false>), p.sweep,
                        reinterpret_cast<const void*>(dwh_mma_kernel),
                        reinterpret_cast<const void*>(dwh_reduce_kernel)};
  const int threads[4] = {128, p.threads, 128, 256};
  const size_t smem[4] = {gates_smem(H), p.smem, 0, 0};
  for (int k = 0; k < 4; ++k) {
    const cudaError_t e = kernel_info(fns[k], threads[k], smem[k], out + 4 * k);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return cudaSuccess;
}
