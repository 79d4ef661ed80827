// gru_scan_fwd: one GRU layer, forward, over a whole left-padded sequence.
//
// Replaces the TPU kernel arec/kernels/gru_scan.py:_fwd_kernel (:38, the
// Pallas forward of gru_layer_pallas, called from `_forward` :72).
// Contract, per step t (gate order r|u|n):
//   r, u = σ(xw[t]_{r,u} + cast(h, WT) · Wh[:, :2H])     products summed in f32
//   n    = tanh(xw[t]_n + cast(r⊙h, WT) · Wh[:, 2H:])    (reset before the
//                                                       product)
//   h'   = (1-u)·n + u·h;  h = m·h' + (1-m)·h   (m = mask[b, t]; a pad step
//                                              is an exact no-op)
// with h carried in from h0, so segment n's final state can seed segment
// n+1. Output: h_all [L, B, H] f32. The training entries (`*_resid`) also
// write the backward sweep's residual hp [L, B, H]: the state BEFORE step t
// (pad steps included), as the TPU kernel's hp_out does; serving does not
// need it and the serving entries do not write it.
//
// What bounds it: the L steps are dependent, so the kernel is latency-bound.
// Its bytes are xw in ([L, B, 3H] f32) and h_all out ([L, B, H] f32); its
// arithmetic is 2·3H·H per valid (row, step). At serving shapes (B = 256,
// L = 50, H = 128) both bounds are a few microseconds, far below what 50
// steps of two DEPENDENT block-wide products (n needs r) cost.
//
// bf16 with H a multiple of 16 (the main path; pieces shared with the
// other scans in scan_mma.cuh), as lstm_scan_fwd.cu's: a CTA owns BT = 8
// batch rows for the whole sequence, one warp per 16 units (32 CTAs at
// B = 256, 16 at B = 128); the products run transposed on the tensor cores,
// warp w taking units 16w..16w+15 in each of the three gate blocks (r, u, n:
// three m-tiles), so each thread's accumulators hold all three gates of its
// own (unit, row) pairs and h stays in its registers, in f32, for all L
// steps. The n product needs q(r⊙h) of every unit, so a step has two
// barriers, as in gru_scan_bwd's sweep: the r|u product of q(h) → q(r⊙h)
// into shared memory → barrier → the n product → the update → q(h) into
// shared memory → barrier. Each B operand is read before the barrier that
// precedes its next write, so one buffer of each does. xw[t] (12 KB of f32
// a CTA at H = 128) and the mask come into shared memory by cp.async two
// steps ahead. At H = 64 and 128 Whᵀ stays in registers (96 words a thread
// at H = 128); at other widths a general kernel reads it from shared memory
// (or global memory) and keeps h and u in shared memory. σ and tanh are
// scan_mma.cuh's fast_sigmoid and fast_tanh (within a few f32 ulps), as in
// lstm_scan_fwd.cu. The wrapper hands over Whᵀ [3H, H] bf16, cast and
// transposed in one copy. No atomics.
//
// f32, the parity mode, and bf16 at a width off the mma's depth keep the
// CUDA-core kernel of the first version (gru_scan_fwd_kernel below), with h
// resident in shared memory; one CTA owns a tile of BT batch rows (BT is
// picked so the grid roughly covers the SMs). Each step has two phases, one
// barrier each:
//   1. thread `col` forms r|u gate column `col` (of 2H) for all BT rows;
//      the threads of the r columns also form cast(r⊙h) for their unit;
//   2. thread `j` forms candidate column j for all BT rows and applies the
//      masked update of unit j right there (it owns every input of it).
// Wh [H, 3H] is copied once into dynamic shared memory when it fits beside
// the state (bf16 at H = 128 is 96 KB, f32 192 KB: both fit under the 227
// KB a block may hold); otherwise every step reads it from global memory,
// where it stays L2-resident. Both kernels read the mask as [B, L] and take
// any L and B: the ragged batch edge is masked here, not padded by the
// caller.

#include "scan_mma.cuh"

namespace {

// ----------------------------------------------------------------- bf16 ----

// The bf16 forward at the configs' widths (HT = 64 or 128): Whᵀ's three
// m-tiles in registers, h with its threads (pair e: unit 16·warp + g +
// 8(e>>1), row 2tq + (e&1)). H is HT (the argument keeps the general
// kernel's signature).
template <int HT, bool RESID>
__global__ void __launch_bounds__(2 * HT) gru_fwd_mma_reg_kernel(
    const float* __restrict__ xw, const bf16* __restrict__ wt, const float* __restrict__ mask,
    const float* __restrict__ h0, float* __restrict__ h_all, float* __restrict__ hp, int L,
    int B, int) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int H = HT;
  constexpr int H2 = 2 * H;
  constexpr int G = 3 * H;
  constexpr int KS = H / KSTEP;
  constexpr int ldq = H + PADB, ldx = G + PADF;
  constexpr Fwd l = fwd_layout(H, G, false, 2, 0);
  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  uint32_t a[3][KS][4];
#pragma unroll
  for (int gb = 0; gb < 3; ++gb) load_a_frags<KS>(a[gb], wt, H, gb * H + 16 * warp);

  bf16* qh_s = reinterpret_cast<bf16*>(smem + l.q);   // q(h) [BT][ldq]
  bf16* qr_s = qh_s + BT * ldq;                       // q(r⊙h) [BT][ldq]
  smem_init(smem, l.q, l.total, nullptr, nullptr, 0, 0);
  __syncthreads();
  float h[4];                  // carry
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = 16 * warp + g + 8 * (e >> 1);
    const int b = 2 * tq + (e & 1);
    h[e] = b < nrows ? h0[static_cast<size_t>(b0 + b) * H + j] : 0.0f;
    qh_s[b * ldq + j] = __float2bfloat16(h[e]);
  }
  fwd_prefetch(smem, l, 0, 0, xw, mask, b0, nrows, L, B, G);
  cp_async_commit();
  if (L > 1) fwd_prefetch(smem, l, 1, 1, xw, mask, b0, nrows, L, B, G);
  cp_async_commit();
  cp_async_wait_prev();        // step 0's inputs are in
  __syncthreads();

  for (int t = 0; t < L; ++t) {
    if (t + 2 < L) fwd_prefetch(smem, l, (t + 2) % NBUF, t + 2, xw, mask, b0, nrows, L, B, G);
    cp_async_commit();
    const float* x_s = reinterpret_cast<const float*>(smem + l.x) + (t % NBUF) * BT * ldx;
    const float* m_s = reinterpret_cast<const float*>(smem + l.m) + (t % NBUF) * BT;
    // r|u = σ(xw_{r,u} + Whᵀ_{r,u}·q(h)ᵀ), then q(r⊙h)
    uint32_t bq[KS / 2][4];
    load_b_frags<KS>(bq, qh_s, ldq);
    float acc[2][4];
    mtile_products<0, 2>(a, bq, acc);
    float u[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 16 * warp + g + 8 * (e >> 1);
      const int b = 2 * tq + (e & 1);
      const float* xr = x_s + b * ldx;
      const float r = fast_sigmoid(xr[j] + acc[0][e]);
      u[e] = fast_sigmoid(xr[H + j] + acc[1][e]);
      qr_s[b * ldq + j] = __float2bfloat16(r * h[e]);
    }
    __syncthreads();

    // n = tanh(xw_n + Whᵀ_n·q(r⊙h)ᵀ), then the masked update and q(h)
    load_b_frags<KS>(bq, qr_s, ldq);
    float an[1][4];
    mtile_products<2, 1>(a, bq, an);
    const size_t row0 = static_cast<size_t>(t) * B + b0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 16 * warp + g + 8 * (e >> 1);
      const int b = 2 * tq + (e & 1);
      const float n = fast_tanh(x_s[b * ldx + H2 + j] + an[0][e]);
      const float h_new = (1.0f - u[e]) * n + u[e] * h[e];
      const float m = m_s[b];
      const float hn = m * h_new + (1.0f - m) * h[e];
      if (b < nrows) {
        const size_t out = (row0 + b) * H + j;
        h_all[out] = hn;
        if constexpr (RESID) hp[out] = h[e];
      }
      h[e] = hn;
      qh_s[b * ldq + j] = __float2bfloat16(hn);
    }
    cp_async_wait_prev();      // step t+1's inputs are in
    __syncthreads();
  }
}

// The bf16 forward at any other width (a multiple of 16), as
// gru_fwd_mma_reg_kernel but general: Whᵀ read from shared memory (W_SMEM,
// when it fits beside the buffers) or from global memory, h and u in shared
// memory, warp w taking the m-tiles w, w + nw, ... of units.
template <bool W_SMEM, bool RESID>
__global__ void __launch_bounds__(MAX_WARPS * 32) gru_fwd_mma_kernel(
    const float* __restrict__ xw, const bf16* __restrict__ wt, const float* __restrict__ mask,
    const float* __restrict__ h0, float* __restrict__ h_all, float* __restrict__ hp, int L,
    int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H2 = 2 * H;
  const int G = 3 * H;
  const int ldq = H + PADB, ldx = G + PADF, lds = H + PADF;
  const Fwd l = fwd_layout(H, G, W_SMEM, 2, 2);
  const bf16* W = W_SMEM ? reinterpret_cast<const bf16*>(smem + l.w) : wt;
  const int ldw = W_SMEM ? ldq : H;
  bf16* qh_s = reinterpret_cast<bf16*>(smem + l.q);   // q(h) [BT][ldq]
  bf16* qr_s = qh_s + BT * ldq;                       // q(r⊙h) [BT][ldq]
  float* h_s = reinterpret_cast<float*>(smem + l.s);  // [BT][lds] carry h
  float* u_s = h_s + BT * lds;                        // σ(u) of this step
  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;

  smem_init(smem, l.q, l.total, W_SMEM ? reinterpret_cast<bf16*>(smem + l.w) : nullptr, wt, G,
            H);
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x) {
    const int r = idx / H;
    const int j = idx - r * H;
    const float v = h0[static_cast<size_t>(b0 + r) * H + j];
    h_s[r * lds + j] = v;
    qh_s[r * ldq + j] = __float2bfloat16(v);
  }
  fwd_prefetch(smem, l, 0, 0, xw, mask, b0, nrows, L, B, G);
  cp_async_commit();
  if (L > 1) fwd_prefetch(smem, l, 1, 1, xw, mask, b0, nrows, L, B, G);
  cp_async_commit();
  cp_async_wait_prev();        // Whᵀ and step 0's inputs are in
  __syncthreads();

  for (int t = 0; t < L; ++t) {
    if (t + 2 < L) fwd_prefetch(smem, l, (t + 2) % NBUF, t + 2, xw, mask, b0, nrows, L, B, G);
    cp_async_commit();
    const float* x_s = reinterpret_cast<const float*>(smem + l.x) + (t % NBUF) * BT * ldx;
    const float* m_s = reinterpret_cast<const float*>(smem + l.m) + (t % NBUF) * BT;
    for (int mt = warp; mt < H / 16; mt += nw) {
      float acc[2][4];
      carry_product<W_SMEM>(W, ldw, 16 * mt, 0, qh_s, ldq, 0, H, acc[0]);
      carry_product<W_SMEM>(W, ldw, H + 16 * mt, 0, qh_s, ldq, 0, H, acc[1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * mt + g + 8 * (e >> 1);
        const int b = 2 * tq + (e & 1);
        const int s = b * lds + j;
        const float* xr = x_s + b * ldx;
        const float r = fast_sigmoid(xr[j] + acc[0][e]);
        u_s[s] = fast_sigmoid(xr[H + j] + acc[1][e]);
        qr_s[b * ldq + j] = __float2bfloat16(r * h_s[s]);
      }
    }
    __syncthreads();

    const size_t row0 = static_cast<size_t>(t) * B + b0;
    for (int mt = warp; mt < H / 16; mt += nw) {
      float an[4];
      carry_product<W_SMEM>(W, ldw, H2 + 16 * mt, 0, qr_s, ldq, 0, H, an);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * mt + g + 8 * (e >> 1);
        const int b = 2 * tq + (e & 1);
        const int s = b * lds + j;
        const float n = fast_tanh(x_s[b * ldx + H2 + j] + an[e]);
        const float u = u_s[s];
        const float h_old = h_s[s];
        const float h_new = (1.0f - u) * n + u * h_old;
        const float m = m_s[b];
        const float hn = m * h_new + (1.0f - m) * h_old;
        if (b < nrows) {
          const size_t out = (row0 + b) * H + j;
          h_all[out] = hn;
          if constexpr (RESID) hp[out] = h_old;
        }
        h_s[s] = hn;
        qh_s[b * ldq + j] = __float2bfloat16(hn);
      }
    }
    cp_async_wait_prev();      // step t+1's inputs are in
    __syncthreads();
  }
}

// the bf16 forward's plan at width H: the register-resident kernel at the
// configs' widths, else the general one
template <bool RESID>
bool plan_bf16(int H, FwdPlan* p) {
  const int G = 3 * H;
  if (H == 128 || H == 64) {
    p->fn = H == 128 ? reinterpret_cast<const void*>(gru_fwd_mma_reg_kernel<128, RESID>)
                     : reinterpret_cast<const void*>(gru_fwd_mma_reg_kernel<64, RESID>);
    p->threads = 2 * H;
    p->smem = fwd_layout(H, G, false, 2, 0).total;
    p->w_smem = false;
    return true;
  }
  return plan_general(H, G, 2, 2, [](bool w_smem) {
    return w_smem ? reinterpret_cast<const void*>(gru_fwd_mma_kernel<true, RESID>)
                  : reinterpret_cast<const void*>(gru_fwd_mma_kernel<false, RESID>);
  }, p);
}

template <bool RESID>
int fwd_bf16(const float* xw, const bf16* wt, const float* mask, const float* h0,
             float* h_all, float* hp, int L, int B, int H, void* stream) {
  FwdPlan p;
  if (L < 1 || B < 1 || H < 16 || H % 16) return cudaErrorInvalidValue;
  if (!plan_bf16<RESID>(H, &p)) return cudaErrorInvalidConfiguration;
  void* args[] = {&xw, &wt, &mask, &h0, &h_all, &hp, &L, &B, &H};
  return static_cast<int>(launch_fwd(p, B, args, static_cast<cudaStream_t>(stream)));
}

// ------------------------------------------------------------ CUDA cores ----

template <typename WT>
__device__ __forceinline__ float to_f32(WT x);

template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// cast to the product dtype (round to nearest even, as jax's astype and
// torch's .to do), kept as the f32 value of the rounded number
template <typename WT>
__device__ __forceinline__ float round_to(float x);

template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// f32 words of shared memory per batch row, in units of H: h, cast h,
// cast r⊙h, and σ(r)|σ(u) [2H]
constexpr int kStateWords = 5;

template <typename WT, int BT, bool WH_SMEM, bool RESID>
__global__ void gru_scan_fwd_kernel(const float* __restrict__ xw,    // [L, B, 3H]
                                    const WT* __restrict__ wh,       // [H, 3H]
                                    const float* __restrict__ mask,  // [B, L]
                                    const float* __restrict__ h0,    // [B, H]
                                    float* __restrict__ h_all,       // [L, B, H]
                                    float* __restrict__ hp,          // [L, B, H] if RESID
                                    int L, int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = 3 * H;
  const int H2 = 2 * H;
  const size_t wh_elems = WH_SMEM ? static_cast<size_t>(H) * G : 0;
  WT* wh_s = reinterpret_cast<WT*>(smem);                        // [H][3H]
  float* h_s = reinterpret_cast<float*>(smem + wh_elems * sizeof(WT));
  float* hq_s = h_s + BT * H;    // [BT][H] cast h: operand of the r|u product
  float* rq_s = hq_s + BT * H;   // [BT][H] cast r⊙h: operand of the n product
  float* g_s = rq_s + BT * H;    // [BT][2H] σ(r) | σ(u)

  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  if constexpr (WH_SMEM) {
    const size_t bytes = wh_elems * sizeof(WT);
    if (bytes % 16 == 0 && reinterpret_cast<uintptr_t>(wh) % 16 == 0) {
      const uint4* src = reinterpret_cast<const uint4*>(wh);
      uint4* dst = reinterpret_cast<uint4*>(wh_s);
      for (size_t i = tid; i < bytes / 16; i += nt) dst[i] = src[i];
    } else {
      for (size_t i = tid; i < wh_elems; i += nt) wh_s[i] = wh[i];
    }
  }
  const WT* W = WH_SMEM ? wh_s : wh;

  for (int idx = tid; idx < BT * H; idx += nt) {
    const int r = idx / H;
    const int j = idx - r * H;
    // rows past the batch edge stay zero
    const float h = r < nrows ? h0[static_cast<size_t>(b0 + r) * H + j] : 0.0f;
    h_s[idx] = h;
    hq_s[idx] = round_to<WT>(h);
    rq_s[idx] = 0.0f;
  }
  for (int idx = tid; idx < BT * H2; idx += nt) g_s[idx] = 0.0f;
  __syncthreads();

  for (int t = 0; t < L; ++t) {
    const float* xw_t = xw + (static_cast<size_t>(t) * B + b0) * G;

    // phase 1: r|u gate column `col` for every row of the tile; an r
    // column also forms cast(r⊙h) of its unit
    for (int col = tid; col < H2; col += nt) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float w = to_f32<WT>(W[static_cast<size_t>(k) * G + col]);
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(hq_s[r * H + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        if (r < nrows) {
          const float s = sigmoid(xw_t[static_cast<size_t>(r) * G + col] + acc[r]);
          g_s[r * H2 + col] = s;
          if (col < H) rq_s[r * H + col] = round_to<WT>(s * h_s[r * H + col]);
        }
      }
    }
    __syncthreads();

    // phase 2: candidate column j for every row, then the masked update of
    // unit j (one thread owns all of its inputs)
    for (int j = tid; j < H; j += nt) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float w = to_f32<WT>(W[static_cast<size_t>(k) * G + H2 + j]);
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(rq_s[r * H + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        if (r < nrows) {
          const float n = tanhf(xw_t[static_cast<size_t>(r) * G + H2 + j] + acc[r]);
          const float u = g_s[r * H2 + H + j];
          const float h_old = h_s[r * H + j];
          const float h_new = (1.0f - u) * n + u * h_old;
          const float m = mask[static_cast<size_t>(b0 + r) * L + t];
          const float h = m * h_new + (1.0f - m) * h_old;
          h_s[r * H + j] = h;
          hq_s[r * H + j] = round_to<WT>(h);
          const size_t out = (static_cast<size_t>(t) * B + b0 + r) * H + j;
          h_all[out] = h;
          if constexpr (RESID) hp[out] = h_old;
        }
      }
    }
    __syncthreads();
  }
}

template <typename WT, int BT, bool WH_SMEM, bool RESID>
cudaError_t launch(const float* xw, const WT* wh, const float* mask,
                   const float* h0, float* h_all, float* hp, int L, int B,
                   int H, size_t smem, cudaStream_t stream) {
  auto kernel = gru_scan_fwd_kernel<WT, BT, WH_SMEM, RESID>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int cols = 2 * H;
  const int threads = cols < 1024 ? ((cols + 31) / 32) * 32 : 1024;
  const int grid = (B + BT - 1) / BT;
  kernel<<<grid, threads, smem, stream>>>(xw, wh, mask, h0, h_all, hp, L, B,
                                          H);
  return cudaGetLastError();
}

template <typename WT, bool WH_SMEM, bool RESID>
cudaError_t dispatch_bt(int bt, const void* xw, const void* wh,
                        const void* mask, const void* h0, void* h_all,
                        void* hp, int L, int B, int H, size_t smem,
                        cudaStream_t s) {
  const float* x = static_cast<const float*>(xw);
  const WT* w = static_cast<const WT*>(wh);
  const float* m = static_cast<const float*>(mask);
  const float* hi = static_cast<const float*>(h0);
  float* ho = static_cast<float*>(h_all);
  float* hr = static_cast<float*>(hp);
  switch (bt) {
    case 1: return launch<WT, 1, WH_SMEM, RESID>(x, w, m, hi, ho, hr, L, B, H, smem, s);
    case 2: return launch<WT, 2, WH_SMEM, RESID>(x, w, m, hi, ho, hr, L, B, H, smem, s);
    case 4: return launch<WT, 4, WH_SMEM, RESID>(x, w, m, hi, ho, hr, L, B, H, smem, s);
    case 8: return launch<WT, 8, WH_SMEM, RESID>(x, w, m, hi, ho, hr, L, B, H, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool RESID>
int run(const void* xw, const void* wh, const void* mask, const void* h0,
        void* h_all, void* hp, int L, int B, int H, int wh_bf16, int bt,
        int wh_in_smem, void* stream) {
  if (L < 1 || B < 1 || H < 1) return cudaErrorInvalidValue;
  const size_t G = 3 * static_cast<size_t>(H);
  const size_t state = static_cast<size_t>(bt) * kStateWords * H * sizeof(float);
  const size_t welt = wh_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const size_t smem = (wh_in_smem ? H * G * welt : 0) + state;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (wh_bf16) {
    e = wh_in_smem ? dispatch_bt<__nv_bfloat16, true, RESID>(bt, xw, wh, mask, h0, h_all, hp, L, B, H, smem, s)
                   : dispatch_bt<__nv_bfloat16, false, RESID>(bt, xw, wh, mask, h0, h_all, hp, L, B, H, smem, s);
  } else {
    e = wh_in_smem ? dispatch_bt<float, true, RESID>(bt, xw, wh, mask, h0, h_all, hp, L, B, H, smem, s)
                   : dispatch_bt<float, false, RESID>(bt, xw, wh, mask, h0, h_all, hp, L, B, H, smem, s);
  }
  return static_cast<int>(e);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Every pointer is a device
// pointer to a contiguous tensor; `stream` is the caller's cudaStream_t.
// Each returns the cudaError_t of the launch (0 = launched).
//
// The CUDA-core kernel (f32; bf16 at any width), Wh [H, 3H]. Serving: h_all
// only.
extern "C" int gru_scan_fwd(const void* xw, const void* wh, const void* mask,
                            const void* h0, void* h_all, int L, int B, int H,
                            int wh_bf16, int bt, int wh_in_smem,
                            void* stream) {
  return run<false>(xw, wh, mask, h0, h_all, nullptr, L, B, H, wh_bf16, bt,
                    wh_in_smem, stream);
}

// Training: also the residual hp [L, B, H] for gru_scan_bwd.
extern "C" int gru_scan_fwd_resid(const void* xw, const void* wh,
                                  const void* mask, const void* h0,
                                  void* h_all, void* hp, int L, int B, int H,
                                  int wh_bf16, int bt, int wh_in_smem,
                                  void* stream) {
  return run<true>(xw, wh, mask, h0, h_all, hp, L, B, H, wh_bf16, bt,
                   wh_in_smem, stream);
}

// The bf16 tensor-core kernel, Whᵀ [3H, H] bf16, H a multiple of 16.
// Serving: h_all only.
extern "C" int gru_scan_fwd_bf16(const void* xw, const void* wt, const void* mask,
                                 const void* h0, void* h_all, int L, int B, int H,
                                 void* stream) {
  return fwd_bf16<false>(static_cast<const float*>(xw), static_cast<const bf16*>(wt),
                         static_cast<const float*>(mask), static_cast<const float*>(h0),
                         static_cast<float*>(h_all), nullptr, L, B, H, stream);
}

// Training: also hp.
extern "C" int gru_scan_fwd_bf16_resid(const void* xw, const void* wt, const void* mask,
                                       const void* h0, void* h_all, void* hp, int L, int B,
                                       int H, void* stream) {
  return fwd_bf16<true>(static_cast<const float*>(xw), static_cast<const bf16*>(wt),
                        static_cast<const float*>(mask), static_cast<const float*>(h0),
                        static_cast<float*>(h_all), static_cast<float*>(hp), L, B, H,
                        stream);
}

// What the bf16 kernel uses as it launches at width H, four ints each in
// `out` (registers per thread, local bytes per thread, dynamic shared
// memory per block, resident blocks per SM), serving launch then training
// launch: 8 ints.
extern "C" int gru_scan_fwd_bf16_kernel_info(int H, int* out) {
  FwdPlan p[2];
  if (H < 16 || H % 16 || !plan_bf16<false>(H, &p[0]) || !plan_bf16<true>(H, &p[1]))
    return cudaErrorInvalidValue;
  for (int k = 0; k < 2; ++k) {
    const cudaError_t e = kernel_info(p[k].fn, p[k].threads, p[k].smem, out + 4 * k);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return cudaSuccess;
}
