// gru_scan_bwd: one GRU layer, backward, over a whole left-padded sequence.
//
// Replaces the TPU kernel arec/kernels/gru_scan.py:_bwd_kernel (:117, the
// Pallas backward of gru_layer_pallas's custom VJP, called from
// `_backward` :194). Inputs are the forward's operands (xw [L, B, 3H], Wh
// [H, 3H], mask [B, L]), its residual hp [L, B, H] (the state BEFORE step
// t, from gru_scan_fwd_resid) and the cotangent dh_out [L, B, H] of h_all.
// Reverse time sweep, per step t (gate order r|u|n), with the TPU kernel's
// arithmetic (h = hp[t]; q = cast to the product dtype, round to nearest
// even; sums in f32):
//   r, u = σ(xw_{r,u} + q(h)·Wh[:, :2H]);  n = tanh(xw_n + q(r⊙h)·Wh[:, 2H:])
//   dh_tot = dh_out[t] + dh;  dh_new = m·dh_tot;  dh_skip = (1-m)·dh_tot
//   dn = dh_new·(1-u);  du = dh_new·(h-n);  da_n = dn·(1-n²)
//   drh = q(da_n)·Wh[:, 2H:]ᵀ;  da_r = drh·h·r(1-r);  da_u = du·u(1-u)
//   dh = dh_new·u + drh·r + q([da_r|da_u])·Wh[:, :2H]ᵀ + dh_skip
//   dxw[t] = [da_r | da_u | da_n]   (unrounded)
// starting from dh = 0; after step 0, dh is dh0. Then
//   dWh[:, :2H] = Σ_{t,b} q(hp)ᵀ·q([da_r|da_u]);  dWh[:, 2H:] = Σ q(r⊙hp)ᵀ·q(da_n)
// summed in one fixed order, the row-range partials added in range order,
// with no atomics: runs repeat bit for bit. Pad steps have dxw = 0 and add
// nothing.
//
// bf16 (the main path's dtype): three stages, one C entry point, on the
// caller's stream (shared pieces in scan_mma.cuh), as in lstm_scan_bwd.cu.
//  1. Gate pass over all N = L·B rows at once. r, u and n depend on xw[t]
//     and hp[t] only (n through q(r⊙hp), r through hp), nothing the sweep
//     carries, so two of the four products a step leave the serial chain.
//     Two launches of the tensor-core gate tile: q(hp)·W_ru with σ, whose r
//     columns also write q(r⊙hp) to the rh scratch [L, B, H] (which the dWh
//     stage reads), then q(r⊙hp)·W_n with tanh. The activated r | u | n go
//     into the dxw buffer (the sweep overwrites each slot with its
//     derivative). Bound by bytes: ~30 MB at c4's training shape (L = 50,
//     B = 128, H = 128), ~9 µs of HBM time.
//  2. The sweep: L dependent steps, each an elementwise pass and two
//     dependent products, q(da_n) [BT, H] by W_nᵀ and then q([da_r|da_u])
//     [BT, 2H] by W_ruᵀ. Bound by the latency of that chain. A CTA owns BT
//     = 8 batch rows, one warp per 16 units; the products are computed
//     transposed (the batch rows are the mma's n), so each thread's (unit,
//     row) accumulator positions are the pairs it owns in the elementwise
//     passes and the carry stays with it. At the configs' widths (64, 128)
//     Wh stays in registers as each warp's A fragments (96 words a thread
//     at H = 128) with the carry, the cast derivatives go through shared
//     memory, double-buffered by step (two barriers a step), and the step
//     inputs come in by cp.async two steps ahead. At other widths a
//     general kernel keeps Wh in shared
//     memory (read from L2 past ~170 units), the state in shared memory
//     and the inputs coming in by cp.async: three barriers a step.
//  3. dWh on the tensor cores: q(hp)ᵀ·q(dxw[:, :2H]) and rhᵀ·q(dxw[:, 2H:])
//     in 64 × 64 tiles over 8 row ranges, added in order.
// Takes H a multiple of 16, any B and L; ragged B is masked here.
//
// f32, the parity mode, keeps the CUDA-core kernels of the first version
// (namespace f32 below; their casts are identities): one CTA per BT rows,
// four block-wide FMA products a step, and a shared-memory tiled dWh.

#include "scan_mma.cuh"

namespace {

// ----------------------------------------------------------------- bf16 ----

// Stage 2 at the configs' widths (HT = 64 or 128), as lstm_scan_bwd's
// register-resident sweep: per step the thread of accumulator position
// (unit j, row b) forms, from the stashed r, u, n, hp[t], dh_out[t], the
// mask and its carry dh, the derivatives that need no product (da_u, da_n,
// dh_new·u, dh_skip) for its four (j, b) pairs; then drh = q(da_n)·W_nᵀ on
// the tensor cores and in its epilogue da_r; then dh = (dh_new·u + drh·r)
// + q([da_r|da_u])·W_ruᵀ + dh_skip. Wh's fragments (3·HT/16 k-steps × 4
// words a thread) and the carry live in registers, the cast derivatives in
// shared memory, double-buffered by step (two barriers a step), and the
// step inputs come in by cp.async two steps ahead.
template <int HT>
__global__ void __launch_bounds__(2 * HT) gru_sweep_reg_kernel(
    const bf16* __restrict__ wh, const float* __restrict__ mask, const float* __restrict__ hp,
    const float* __restrict__ dh_out, float* __restrict__ dxw, float* __restrict__ dh0, int L,
    int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int H = HT;
  constexpr int H2 = 2 * H;
  constexpr int G = 3 * H;
  constexpr int KS = G / KSTEP;
  constexpr int KRU = H2 / KSTEP;   // k-steps of the r|u columns; W_n's follow
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
  float dh[4] = {0.0f, 0.0f, 0.0f, 0.0f};      // carry
  sweep_init(smem, l, wh, H, G);
  __syncthreads();
  sweep_prefetch(smem, l, (L - 1) % 3, L - 1, dxw, hp, dh_out, mask, b0, nrows, L, B, H, G);
  cp_async_commit();
  if (L > 1)
    sweep_prefetch(smem, l, (L - 2) % 3, L - 2, dxw, hp, dh_out, mask, b0, nrows, L, B, H, G);
  cp_async_commit();
  cp_async_wait_prev();        // step L-1's inputs are in
  __syncthreads();

  for (int t = L - 1; t >= 0; --t) {
    const int buf = t % 3;
    if (t > 1)
      sweep_prefetch(smem, l, (t - 2) % 3, t - 2, dxw, hp, dh_out, mask, b0, nrows, L, B, H, G);
    cp_async_commit();
    bf16* q = reinterpret_cast<bf16*>(smem + l.qd) + (t & 1) * BT * ldq;
    const float* g_s = reinterpret_cast<const float*>(smem + l.g) + buf * BT * ldg;
    const float* h_s = reinterpret_cast<const float*>(smem + l.x) + buf * BT * ldh;
    const float* o_s = reinterpret_cast<const float*>(smem + l.o) + buf * BT * ldh;
    const float* m_s = reinterpret_cast<const float*>(smem + l.m) + buf * BT;
    float* dxw_t = dxw + (static_cast<size_t>(t) * B + b0) * G;
    float ac[4], sk[4], rg[4], hv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 16 * warp + g + 8 * (e >> 1);
      const int b = 2 * tq + (e & 1);
      const float* gr = g_s + b * ldg;
      rg[e] = gr[j];
      hv[e] = h_s[b * ldh + j];
      const float u = gr[H + j];
      const float n = gr[H2 + j];
      const float m = m_s[b];
      const float dh_total = o_s[b * ldh + j] + dh[e];
      const float dh_new = m * dh_total;
      const float dn = dh_new * (1.0f - u);
      const float du = dh_new * (hv[e] - n);
      const float da_n = dn * (1.0f - n * n);
      const float da_u = du * u * (1.0f - u);
      if (b < nrows) {
        float* out = dxw_t + static_cast<size_t>(b) * G;
        out[H + j] = da_u;
        out[H2 + j] = da_n;
      }
      q[b * ldq + H + j] = __float2bfloat16(da_u);
      q[b * ldq + H2 + j] = __float2bfloat16(da_n);
      ac[e] = dh_new * u;
      sk[e] = (1.0f - m) * dh_total;
    }
    cp_async_wait_prev();      // step t-1's inputs are in
    __syncthreads();

    // drh = q(da_n)·W_nᵀ, then da_r = drh·h·r(1-r)
    float acc[4];
    carry_product_reg<KRU, KS - KRU>(a, q, ldq, acc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 16 * warp + g + 8 * (e >> 1);
      const int b = 2 * tq + (e & 1);
      const float da_r = acc[e] * hv[e] * rg[e] * (1.0f - rg[e]);
      if (b < nrows) dxw_t[static_cast<size_t>(b) * G + j] = da_r;
      q[b * ldq + j] = __float2bfloat16(da_r);
      ac[e] += acc[e] * rg[e];
    }
    __syncthreads();

    // dh = (dh_new·u + drh·r) + q([da_r|da_u])·W_ruᵀ + dh_skip
    carry_product_reg<0, KRU>(a, q, ldq, acc);
#pragma unroll
    for (int e = 0; e < 4; ++e) dh[e] = (ac[e] + acc[e]) + sk[e];
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = 16 * warp + g + 8 * (e >> 1);
    const int b = 2 * tq + (e & 1);
    if (b < nrows) dh0[static_cast<size_t>(b0 + b) * H + j] = dh[e];
  }
}

// Stage 2 at any other width (a multiple of 16), as gru_sweep_reg_kernel
// but general: the (j, b) state in shared memory, the step inputs copied in
// by cp.async one step ahead, Wh read from shared memory (W_SMEM, when it
// fits beside the buffers) or from global memory. Three barriers a step.
template <bool W_SMEM>
__global__ void __launch_bounds__(MAX_WARPS * 32) gru_sweep_kernel(
    const bf16* __restrict__ wh, const float* __restrict__ mask, const float* __restrict__ hp,
    const float* __restrict__ dh_out, float* __restrict__ dxw, float* __restrict__ dh0, int L,
    int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = 3 * H;
  const int H2 = 2 * H;
  const int ldq = G + PADB, ldg = G + PADF, ldh = H + PADF;
  const Sweep l = general_layout(H, G, W_SMEM);
  const bf16* W = W_SMEM ? reinterpret_cast<const bf16*>(smem + l.w) : wh;
  const int ldw = W_SMEM ? ldq : G;
  bf16* qd_s = reinterpret_cast<bf16*>(smem + l.qd);   // [BT][ldq] q([da_r|da_u|da_n])
  float* dh_s = reinterpret_cast<float*>(smem + l.s);  // [BT][ldh] carry dh
  float* ac_s = dh_s + BT * ldh;                       // dh_new·u, then + drh·r
  float* sk_s = ac_s + BT * ldh;                       // dh_skip of this step
  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;

  sweep_init(smem, l, wh, H, G);
  __syncthreads();
  sweep_prefetch(smem, l, (L - 1) & 1, L - 1, dxw, hp, dh_out, mask, b0, nrows, L, B, H, G);
  cp_async_wait_all();
  __syncthreads();

  for (int t = L - 1; t >= 0; --t) {
    const int buf = t & 1;
    if (t > 0) {
      sweep_prefetch(smem, l, buf ^ 1, t - 1, dxw, hp, dh_out, mask, b0, nrows, L, B, H, G);
      cp_async_commit();
    }
    const float* g_s = reinterpret_cast<const float*>(smem + l.g) + buf * BT * ldg;
    const float* h_s = reinterpret_cast<const float*>(smem + l.x) + buf * BT * ldh;
    const float* o_s = reinterpret_cast<const float*>(smem + l.o) + buf * BT * ldh;
    const float* m_s = reinterpret_cast<const float*>(smem + l.m) + buf * BT;
    float* dxw_t = dxw + (static_cast<size_t>(t) * B + b0) * G;

    for (int mt = warp; mt < H / 16; mt += nw) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * mt + g + 8 * (e >> 1);
        const int b = 2 * tq + (e & 1);
        const float* gr = g_s + b * ldg;
        const float u = gr[H + j];
        const float n = gr[H2 + j];
        const int s = b * ldh + j;
        const float h_prev = h_s[s];
        const float m = m_s[b];
        const float dh_total = o_s[s] + dh_s[s];
        const float dh_new = m * dh_total;
        const float dn = dh_new * (1.0f - u);
        const float du = dh_new * (h_prev - n);
        const float da_n = dn * (1.0f - n * n);
        const float da_u = du * u * (1.0f - u);
        if (b < nrows) {
          float* out = dxw_t + static_cast<size_t>(b) * G;
          out[H + j] = da_u;
          out[H2 + j] = da_n;
        }
        bf16* q = qd_s + b * ldq;
        q[H + j] = __float2bfloat16(da_u);
        q[H2 + j] = __float2bfloat16(da_n);
        ac_s[s] = dh_new * u;
        sk_s[s] = (1.0f - m) * dh_total;
      }
    }
    __syncthreads();

    // drh = q(da_n)·W_nᵀ, then da_r = drh·h·r(1-r)
    for (int mt = warp; mt < H / 16; mt += nw) {
      float acc[4];
      carry_product<W_SMEM>(W, ldw, 16 * mt, H2, qd_s, ldq, H2, H, acc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * mt + g + 8 * (e >> 1);
        const int b = 2 * tq + (e & 1);
        const int s = b * ldh + j;
        const float r = g_s[b * ldg + j];
        const float da_r = acc[e] * h_s[s] * r * (1.0f - r);
        if (b < nrows) dxw_t[static_cast<size_t>(b) * G + j] = da_r;
        qd_s[b * ldq + j] = __float2bfloat16(da_r);
        ac_s[s] += acc[e] * r;
      }
    }
    __syncthreads();

    // dh = (dh_new·u + drh·r) + q([da_r|da_u])·W_ruᵀ + dh_skip
    for (int mt = warp; mt < H / 16; mt += nw) {
      float acc[4];
      carry_product<W_SMEM>(W, ldw, 16 * mt, 0, qd_s, ldq, 0, H2, acc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = (2 * tq + (e & 1)) * ldh + 16 * mt + g + 8 * (e >> 1);
        dh_s[s] = (ac_s[s] + acc[e]) + sk_s[s];
      }
    }
    cp_async_wait_all();        // step t-1's inputs are in
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x) {
    const int r = idx / H;
    const int j = idx - r * H;
    dh0[static_cast<size_t>(b0 + r) * H + j] = dh_s[r * ldh + j];
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
    p->sweep = H == 128 ? reinterpret_cast<const void*>(gru_sweep_reg_kernel<128>)
                        : reinterpret_cast<const void*>(gru_sweep_reg_kernel<64>);
    p->threads = 2 * H;
    p->smem = reg_layout(H, 3 * H).total;
    p->w_smem = false;
  } else {
    const int G = 3 * H;
    p->w_smem = general_layout(H, G, true).total <= limit;
    p->smem = general_layout(H, G, p->w_smem).total;
    p->sweep = p->w_smem ? reinterpret_cast<const void*>(gru_sweep_kernel<true>)
                         : reinterpret_cast<const void*>(gru_sweep_kernel<false>);
    p->threads = (H / 16 < MAX_WARPS ? H / 16 : MAX_WARPS) * 32;
  }
  return gates_smem(H) <= limit && p->smem <= limit;
}

// the three stages: gate pass (r|u with q(r⊙hp) into rh, then n from rh),
// sweep, dWh
cudaError_t bwd_bf16(const float* xw, const bf16* wh, const float* mask, const float* hp,
                     const float* dh_out, float* dxw, float* dwh, float* dh0, float* rh,
                     float* part, int L, int B, int H, cudaStream_t s) {
  Bf16Plan p;
  if (!plan_bf16(H, &p)) return cudaErrorInvalidConfiguration;
  const int G = 3 * H;
  const int N = L * B;
  cudaError_t e = launch_gates(xw, wh, hp, dxw, rh, N, H, G, 0, 2 * H, 0, 0, s);
  if (e != cudaSuccess) return e;
  e = launch_gates(xw, wh, rh, dxw, nullptr, N, H, G, 2 * H, G, 2 * H, G, s);
  if (e != cudaSuccess) return e;
  const int grid = cdiv(B, BT);
  e = set_smem(p.sweep, p.smem);
  if (e != cudaSuccess) return e;
  if (H == 128) {
    gru_sweep_reg_kernel<128><<<grid, p.threads, p.smem, s>>>(wh, mask, hp, dh_out, dxw, dh0, L,
                                                              B);
  } else if (H == 64) {
    gru_sweep_reg_kernel<64><<<grid, p.threads, p.smem, s>>>(wh, mask, hp, dh_out, dxw, dh0, L,
                                                             B);
  } else {
    auto sweep = p.w_smem ? gru_sweep_kernel<true> : gru_sweep_kernel<false>;
    sweep<<<grid, p.threads, p.smem, s>>>(wh, mask, hp, dh_out, dxw, dh0, L, B, H);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // r|u columns against q(hp), n columns against q(r⊙hp)
  return launch_dwh(hp, rh, dxw, part, dwh, N, H, G, 2 * H, s);
}

// ------------------------------------------------------------------ f32 ----

namespace f32 {

// f32 words of shared memory per batch row, in units of H: h_prev, its
// cast, cast r⊙h_prev, dh, dh_new·u (+ drh·r), dh_skip [H each], σ(r)|σ(u)
// [2H] and the cast gate derivatives [3H]
constexpr int kStateWords = 11;

template <int BT, bool WH_SMEM>
__global__ void gru_scan_bwd_kernel(const float* __restrict__ xw,      // [L, B, 3H]
                                    const float* __restrict__ wh,         // [H, 3H]
                                    const float* __restrict__ mask,    // [B, L]
                                    const float* __restrict__ hp,      // [L, B, H]
                                    const float* __restrict__ dh_out,  // [L, B, H]
                                    float* __restrict__ dxw,           // [L, B, 3H]
                                    float* __restrict__ dh0,           // [B, H]
                                    float* __restrict__ rh,            // [L, B, H]
                                    int L, int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = 3 * H;
  const int H2 = 2 * H;
  const size_t wh_elems = WH_SMEM ? static_cast<size_t>(H) * G : 0;
  float* wh_s = reinterpret_cast<float*>(smem);                        // [H][3H]
  float* hp_s = reinterpret_cast<float*>(smem + wh_elems * sizeof(float));
  float* hq_s = hp_s + BT * H;   // [BT][H] cast h_prev
  float* rq_s = hq_s + BT * H;   // [BT][H] cast r⊙h_prev
  float* dh_s = rq_s + BT * H;   // [BT][H] carry dh
  float* ac_s = dh_s + BT * H;   // [BT][H] dh_new·u, then + drh·r
  float* sk_s = ac_s + BT * H;   // [BT][H] dh_skip of this step
  float* g_s = sk_s + BT * H;    // [BT][2H] σ(r) | σ(u)
  float* d_s = g_s + BT * H2;    // [BT][3H] cast [da_r | da_u | da_n]

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

  // all state zero (rows past the batch edge stay so), then h_prev of the
  // last step
  for (int idx = tid; idx < BT * kStateWords * H; idx += nt) hp_s[idx] = 0.0f;
  __syncthreads();
  for (int idx = tid; idx < nrows * H; idx += nt) {
    const int r = idx / H;
    const int j = idx - r * H;
    const float h = hp[(static_cast<size_t>(L - 1) * B + b0 + r) * H + j];
    hp_s[idx] = h;
    hq_s[idx] = h;
  }
  __syncthreads();

  for (int t = L - 1; t >= 0; --t) {
    const size_t row0 = static_cast<size_t>(t) * B + b0;   // (t, b0)
    const float* xw_t = xw + row0 * G;
    float* dxw_t = dxw + row0 * G;

    // phase 1: recompute r|u gate column `col` for every row of the tile;
    // an r column also forms q(r⊙h_prev) of its unit
    for (int col = tid; col < H2; col += nt) {
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
          const float s = sigmoid(xw_t[static_cast<size_t>(r) * G + col] + acc[r]);
          g_s[r * H2 + col] = s;
          if (col < H) {
            const float v = s * hp_s[r * H + col];
            rq_s[r * H + col] = v;
            rh[(row0 + r) * H + col] = v;
          }
        }
      }
    }
    __syncthreads();

    // phase 2: recompute candidate column j, then unit j's derivatives that
    // need no further product
    for (int j = tid; j < H; j += nt) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float w = W[static_cast<size_t>(k) * G + H2 + j];
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(rq_s[r * H + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        if (r < nrows) {
          const float n = tanhf(xw_t[static_cast<size_t>(r) * G + H2 + j] + acc[r]);
          const float u = g_s[r * H2 + H + j];
          const float h_prev = hp_s[r * H + j];
          const float m = mask[static_cast<size_t>(b0 + r) * L + t];
          const float dh_total = dh_out[(row0 + r) * H + j] + dh_s[r * H + j];
          const float dh_new = m * dh_total;
          const float dn = dh_new * (1.0f - u);
          const float du = dh_new * (h_prev - n);
          const float da_n = dn * (1.0f - n * n);
          const float da_u = du * u * (1.0f - u);
          float* out = dxw_t + static_cast<size_t>(r) * G;
          out[H + j] = da_u;
          out[H2 + j] = da_n;
          d_s[r * G + H + j] = da_u;
          d_s[r * G + H2 + j] = da_n;
          ac_s[r * H + j] = dh_new * u;
          sk_s[r * H + j] = (1.0f - m) * dh_total;
        }
      }
    }
    __syncthreads();

    // phase 3: drh = q(da_n)·Wh[:, 2H:]ᵀ, one warp per unit j; then da_r
    for (int j = warp; j < H; j += nwarps) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
      const float* wrow = W + static_cast<size_t>(j) * G + H2;
      for (int k = lane; k < H; k += 32) {
        const float w = wrow[k];
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(d_s[r * G + H2 + k], w, acc[r]);
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
          if (r < nrows) {
            const float rg = g_s[r * H2 + j];
            const float da_r = acc[r] * hp_s[r * H + j] * rg * (1.0f - rg);
            dxw_t[static_cast<size_t>(r) * G + j] = da_r;
            d_s[r * G + j] = da_r;
            ac_s[r * H + j] += acc[r] * rg;
          }
        }
      }
    }
    __syncthreads();

    // phase 4: h_prev of step t-1 (nothing reads it in this phase), and
    // dh = (dh_new·u + drh·r) + q([da_r|da_u])·Wh[:, :2H]ᵀ + dh_skip, one
    // warp per unit j
    if (t > 0) {
      for (int idx = tid; idx < nrows * H; idx += nt) {
        const int r = idx / H;
        const int j = idx - r * H;
        const float h = hp[(row0 - B + r) * H + j];
        hp_s[idx] = h;
        hq_s[idx] = h;
      }
    }
    for (int j = warp; j < H; j += nwarps) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
      const float* wrow = W + static_cast<size_t>(j) * G;
      for (int k = lane; k < H2; k += 32) {
        const float w = wrow[k];
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(d_s[r * G + k], w, acc[r]);
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
          if (r < nrows) {
            dh_s[r * H + j] = (ac_s[r * H + j] + acc[r]) + sk_s[r * H + j];
          }
        }
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < nrows * H; idx += nt) {
    const int r = idx / H;
    const int j = idx - r * H;
    dh0[static_cast<size_t>(b0 + r) * H + j] = dh_s[idx];
  }
}

// part[z][:, col0 + c] = Σ_n q(a[n, :])ᵀ · q(d[n, col0 + c]) for c < ncols,
// over the rows [z·split, (z+1)·split) of split z = blockIdx.z of the
// N = L·B rows. a [N, H]; d [N, G]; part [RS, H, G]. Block tile: TI rows of
// H × TC columns; each of the 256 threads owns TI·TC/256 = 2 outputs and
// sums its terms in increasing n.
constexpr int TI = 16;
constexpr int TC = 32;
constexpr int TN = 32;
constexpr int RS = 8;

__global__ void gru_dwh_kernel(const float* __restrict__ a,     // [N, H]
                               const float* __restrict__ d,     // [N, G]
                               float* __restrict__ part,        // [RS, H, G]
                               int N, int H, int col0, int ncols,
                               int split) {
  __shared__ float a_t[TN][TI];
  __shared__ float d_t[TN][TC];
  const int G = 3 * H;
  const int i0 = blockIdx.y * TI;
  const int c0 = blockIdx.x * TC;
  const int z = static_cast<int>(blockIdx.z);
  const int n_end = min(N, (z + 1) * split);
  const int tid = threadIdx.x;
  const int tc = tid % TC;
  const int ti = tid / TC;            // 0..7: rows ti and ti + 8
  float acc0 = 0.0f, acc1 = 0.0f;
  float* dwh = part + static_cast<size_t>(z) * H * G + col0;
  const float* dc = d + col0;
  for (int n0 = z * split; n0 < n_end; n0 += TN) {
    for (int idx = tid; idx < TN * TI; idx += blockDim.x) {
      const int n = idx / TI;
      const int i = idx - n * TI;
      a_t[n][i] = (n0 + n < n_end && i0 + i < H)
                      ? a[static_cast<size_t>(n0 + n) * H + i0 + i]
                      : 0.0f;
    }
    for (int idx = tid; idx < TN * TC; idx += blockDim.x) {
      const int n = idx / TC;
      const int c = idx - n * TC;
      d_t[n][c] = (n0 + n < n_end && c0 + c < ncols)
                      ? dc[static_cast<size_t>(n0 + n) * G + c0 + c]
                      : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int n = 0; n < TN; ++n) {
      const float v = d_t[n][tc];
      acc0 = fmaf(a_t[n][ti], v, acc0);
      acc1 = fmaf(a_t[n][ti + 8], v, acc1);
    }
    __syncthreads();
  }
  if (c0 + tc < ncols) {
    if (i0 + ti < H) dwh[static_cast<size_t>(i0 + ti) * G + c0 + tc] = acc0;
    if (i0 + ti + 8 < H) dwh[static_cast<size_t>(i0 + ti + 8) * G + c0 + tc] = acc1;
  }
}

// dWh = the RS partials added in split order
__global__ void gru_dwh_reduce_kernel(const float* __restrict__ part,
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
                   const void* hp, const void* dh_out, void* dxw, void* dwh,
                   void* dh0, void* rh, void* part, int L, int B, int H,
                   size_t smem, cudaStream_t stream) {
  auto kernel = gru_scan_bwd_kernel<BT, WH_SMEM>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  // 4H threads: the column phases use 2H and H of them, the one-warp-per-
  // unit phases 4H / 32 warps
  const int want = 4 * H;
  const int threads = want < 1024 ? ((want + 31) / 32) * 32 : 1024;
  kernel<<<(B + BT - 1) / BT, threads, smem, stream>>>(
      static_cast<const float*>(xw), static_cast<const float*>(wh),
      static_cast<const float*>(mask), static_cast<const float*>(hp),
      static_cast<const float*>(dh_out), static_cast<float*>(dxw),
      static_cast<float*>(dh0), static_cast<float*>(rh), L, B, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int N = L * B;
  const int split = ((N + TN * RS - 1) / (TN * RS)) * TN;
  // r|u columns against q(hp), n columns against q(r⊙hp)
  const int cols[2][2] = {{0, 2 * H}, {2 * H, H}};
  const float* as[2] = {static_cast<const float*>(hp),
                        static_cast<const float*>(rh)};
  for (int p = 0; p < 2; ++p) {
    const dim3 grid((cols[p][1] + TC - 1) / TC, (H + TI - 1) / TI, RS);
    gru_dwh_kernel<<<grid, 256, 0, stream>>>(
        as[p], static_cast<const float*>(dxw), static_cast<float*>(part), N,
        H, cols[p][0], cols[p][1], split);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int n = 3 * H * H;
  gru_dwh_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dwh), n);
  return cudaGetLastError();
}

template <bool WH_SMEM>
cudaError_t dispatch_bt(int bt, const void* xw, const void* wh,
                        const void* mask, const void* hp, const void* dh_out,
                        void* dxw, void* dwh, void* dh0, void* rh, void* part,
                        int L, int B, int H, size_t smem, cudaStream_t s) {
  switch (bt) {
    case 1: return launch<1, WH_SMEM>(xw, wh, mask, hp, dh_out, dxw, dwh, dh0, rh, part, L, B, H, smem, s);
    case 2: return launch<2, WH_SMEM>(xw, wh, mask, hp, dh_out, dxw, dwh, dh0, rh, part, L, B, H, smem, s);
    case 4: return launch<4, WH_SMEM>(xw, wh, mask, hp, dh_out, dxw, dwh, dh0, rh, part, L, B, H, smem, s);
    case 8: return launch<8, WH_SMEM>(xw, wh, mask, hp, dh_out, dxw, dwh, dh0, rh, part, L, B, H, smem, s);
    default: return cudaErrorInvalidValue;
  }
}


}  // namespace f32

}  // namespace

// Plain C entry points, loaded with ctypes. Every pointer is a device
// pointer to a contiguous tensor; `rh` is scratch of L·B·H floats and
// `part` of 8·H·3H floats; `stream` is the caller's cudaStream_t. Each
// launches its kernels on that stream and returns the first cudaError_t
// (0 = all launched).

// f32: Wh f32; `bt` rows per CTA, Wh in shared memory when `wh_in_smem`.
extern "C" int gru_scan_bwd(const void* xw, const void* wh, const void* mask,
                            const void* hp, const void* dh_out, void* dxw,
                            void* dwh, void* dh0, void* rh, void* part,
                            int L, int B, int H, int bt, int wh_in_smem,
                            void* stream) {
  if (L < 1 || B < 1 || H < 1) return cudaErrorInvalidValue;
  const size_t G = 3 * static_cast<size_t>(H);
  const size_t state = static_cast<size_t>(bt) * f32::kStateWords * H * sizeof(float);
  const size_t smem = (wh_in_smem ? H * G * sizeof(float) : 0) + state;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      wh_in_smem ? f32::dispatch_bt<true>(bt, xw, wh, mask, hp, dh_out, dxw, dwh, dh0, rh, part, L, B, H, smem, s)
                 : f32::dispatch_bt<false>(bt, xw, wh, mask, hp, dh_out, dxw, dwh, dh0, rh, part, L, B, H, smem, s);
  return static_cast<int>(e);
}

// bf16: Wh bf16 [H, 3H], H a multiple of 16.
extern "C" int gru_scan_bwd_bf16(const void* xw, const void* wh, const void* mask,
                                 const void* hp, const void* dh_out, void* dxw, void* dwh,
                                 void* dh0, void* rh, void* part, int L, int B, int H,
                                 void* stream) {
  if (L < 1 || B < 1 || H < 16 || H % 16) return cudaErrorInvalidValue;
  return static_cast<int>(bwd_bf16(
      static_cast<const float*>(xw), static_cast<const bf16*>(wh),
      static_cast<const float*>(mask), static_cast<const float*>(hp),
      static_cast<const float*>(dh_out), static_cast<float*>(dxw), static_cast<float*>(dwh),
      static_cast<float*>(dh0), static_cast<float*>(rh), static_cast<float*>(part), L, B, H,
      static_cast<cudaStream_t>(stream)));
}

// What the bf16 stages' kernels use as they launch at width H, four ints
// each in `out` (registers per thread, local bytes per thread, dynamic
// shared memory per block, resident blocks per SM), in the order gates,
// sweep, dwh_mma, dwh_reduce: 16 ints.
extern "C" int gru_scan_bwd_bf16_kernel_info(int H, int* out) {
  Bf16Plan p;
  if (H < 16 || H % 16 || !plan_bf16(H, &p)) return cudaErrorInvalidValue;
  const void* fns[4] = {reinterpret_cast<const void*>(gates_kernel<true>), p.sweep,
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
