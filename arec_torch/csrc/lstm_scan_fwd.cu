// lstm_scan_fwd: one LSTM layer, forward, over a whole left-padded sequence.
//
// Replaces the TPU kernel arec/kernels/lstm_scan.py:_fwd_kernel (:89, the
// Pallas forward of lstm_layer_pallas, called from `_forward` :128).
// Contract, per step t (gate order i|f|g|o):
//   gates = xw[t] + cast(h, WT) · Wh          products summed in f32
//   c'    = σ(f)·c + σ(i)·tanh(g);  h' = σ(o)·tanh(c')
//   h     = m·h' + (1-m)·h;  c = m·c' + (1-m)·c   (m = mask[b, t]; a pad
//                                                  step is an exact no-op)
// with (h, c) carried in from (h0, c0), so segment n's final state can seed
// segment n+1. Outputs: h_all [L, B, H] and cT [B, H], both f32. The
// training entries (`*_resid`) also write the backward sweep's residuals
// hp, cp [L, B, H]: the state BEFORE step t (pad steps included), as the
// TPU kernel's hp_out/cp_out do.
//
// What bounds it: the L steps are dependent, so the kernel is latency-bound.
// Its bytes are xw in ([L, B, 4H] f32) and h_all out ([L, B, H] f32); its
// arithmetic is 2·4H·H per valid (row, step). At serving shapes (B = 256,
// L = 50, H = 128) both bounds are a few microseconds, far below what 50
// dependent steps of a block-wide product cost.
//
// bf16 with H a multiple of 16 (the main path; pieces shared with the
// other scans in scan_mma.cuh): the forward of lstm_scan_bwd's sweep. A CTA
// owns BT = 8 batch rows (the mma's n) for the whole sequence, one warp per
// 16 units: 32 CTAs at B = 256, 16 at B = 128; the ragged edge's rows are
// zero and never stored. Each step's product runs transposed on the tensor
// cores, gatesᵀ [4H, 8] = Whᵀ · q(h)ᵀ (mma.sync m16n8k16, f32 sums), warp w
// taking units 16w..16w+15 in each of the four gate blocks (four m-tiles),
// so each thread's accumulators hold all four gates of its own four (unit,
// row) pairs: the cell update runs in its registers, and h and c stay
// there, in f32, for all L steps. Only q(h) goes to shared memory, as the
// next step's B operand, double-buffered by step parity: one barrier a
// step. xw[t] (16 KB of f32 a CTA at H = 128) and the mask come into shared
// memory by cp.async two steps ahead, off the chain. At the configs' widths
// (H = 64, 128) Whᵀ stays in registers as each warp's A fragments (128
// words a thread at H = 128); at other widths a general kernel reads it
// from shared memory (or, where it does not fit, from global memory) and
// keeps h and c in shared memory. σ and tanh are scan_mma.cuh's
// fast_sigmoid and fast_tanh (within a few f32 ulps): with expf and an
// IEEE division they took more of the step than the products did. The
// wrapper hands over Whᵀ [4H, H] bf16, cast and transposed in one copy.
// No atomics: runs repeat bit for bit.
//
// f32, the parity mode, and bf16 at a width off the mma's depth keep the
// CUDA-core kernel of the first version (lstm_scan_fwd_kernel below): the
// time loop inside the block, h and c in shared memory; one CTA owns a tile
// of BT rows (BT picked so the grid roughly covers the SMs); thread `col`
// forms gate column `col` for all BT rows (one Wh read serves BT products),
// then the threads apply the cell update per (row, unit), one barrier after
// each phase. Wh is copied once into dynamic shared memory when it fits
// (bf16 at H = 128 is 128 KB); otherwise (f32 at H = 128 is 256 KB, over
// the 227 KB a block may hold) every step reads it from global memory,
// where it stays L2-resident. Both kernels read the mask as [B, L] and take
// any L and B: the ragged batch edge is masked here, not padded by the
// caller.

#include "scan_mma.cuh"

namespace {

// ----------------------------------------------------------------- bf16 ----

// The bf16 forward at the configs' widths (HT = 64 or 128): Whᵀ's four
// m-tiles in registers, the carries with their threads. Per step: the gate
// products, then the masked cell update and the stores of the thread's four
// (unit, row) pairs (pair e: unit 16·warp + g + 8(e>>1), row 2tq + (e&1)),
// and q(h) into the other B buffer. H is HT (the argument keeps the general
// kernel's signature).
template <int HT, bool RESID>
__global__ void __launch_bounds__(2 * HT) lstm_fwd_mma_reg_kernel(
    const float* __restrict__ xw, const bf16* __restrict__ wt, const float* __restrict__ mask,
    const float* __restrict__ h0, const float* __restrict__ c0, float* __restrict__ h_all,
    float* __restrict__ cT, float* __restrict__ hp, float* __restrict__ cp, int L, int B, int) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int H = HT;
  constexpr int G = 4 * H;
  constexpr int KS = H / KSTEP;
  constexpr int ldq = H + PADB, ldx = G + PADF;
  constexpr Fwd l = fwd_layout(H, G, false, 2, 0);
  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  uint32_t a[4][KS][4];
#pragma unroll
  for (int gb = 0; gb < 4; ++gb) load_a_frags<KS>(a[gb], wt, H, gb * H + 16 * warp);

  bf16* q_s = reinterpret_cast<bf16*>(smem + l.q);   // q(h) [2][BT][ldq]
  smem_init(smem, l.q, l.total, nullptr, nullptr, 0, 0);
  __syncthreads();
  float h[4], c[4];            // carries
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = 16 * warp + g + 8 * (e >> 1);
    const int b = 2 * tq + (e & 1);
    const size_t s = static_cast<size_t>(b0 + b) * H + j;
    h[e] = b < nrows ? h0[s] : 0.0f;
    c[e] = b < nrows ? c0[s] : 0.0f;
    q_s[b * ldq + j] = __float2bfloat16(h[e]);
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
    uint32_t bq[KS / 2][4];
    load_b_frags<KS>(bq, q_s + (t & 1) * BT * ldq, ldq);
    float acc[4][4];
    mtile_products<0, 4>(a, bq, acc);
    const float* x_s = reinterpret_cast<const float*>(smem + l.x) + (t % NBUF) * BT * ldx;
    const float* m_s = reinterpret_cast<const float*>(smem + l.m) + (t % NBUF) * BT;
    bf16* qn = q_s + ((t + 1) & 1) * BT * ldq;
    const size_t row0 = static_cast<size_t>(t) * B + b0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 16 * warp + g + 8 * (e >> 1);
      const int b = 2 * tq + (e & 1);
      const float* xr = x_s + b * ldx;
      const float ig = fast_sigmoid(xr[j] + acc[0][e]);
      const float fg = fast_sigmoid(xr[H + j] + acc[1][e]);
      const float gg = fast_tanh(xr[2 * H + j] + acc[2][e]);
      const float og = fast_sigmoid(xr[3 * H + j] + acc[3][e]);
      const float c_new = fg * c[e] + ig * gg;
      const float h_new = og * fast_tanh(c_new);
      const float m = m_s[b];
      const float hn = m * h_new + (1.0f - m) * h[e];
      const float cn = m * c_new + (1.0f - m) * c[e];
      if (b < nrows) {
        const size_t out = (row0 + b) * H + j;
        h_all[out] = hn;
        if constexpr (RESID) {
          hp[out] = h[e];
          cp[out] = c[e];
        }
      }
      h[e] = hn;
      c[e] = cn;
      qn[b * ldq + j] = __float2bfloat16(hn);
    }
    cp_async_wait_prev();      // step t+1's inputs are in
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = 16 * warp + g + 8 * (e >> 1);
    const int b = 2 * tq + (e & 1);
    if (b < nrows) cT[static_cast<size_t>(b0 + b) * H + j] = c[e];
  }
}

// The bf16 forward at any other width (a multiple of 16), as
// lstm_fwd_mma_reg_kernel but general: Whᵀ read from shared memory (W_SMEM,
// when it fits beside the buffers) or from global memory, h and c in shared
// memory, warp w taking the m-tiles w, w + nw, ... of units.
template <bool W_SMEM, bool RESID>
__global__ void __launch_bounds__(MAX_WARPS * 32) lstm_fwd_mma_kernel(
    const float* __restrict__ xw, const bf16* __restrict__ wt, const float* __restrict__ mask,
    const float* __restrict__ h0, const float* __restrict__ c0, float* __restrict__ h_all,
    float* __restrict__ cT, float* __restrict__ hp, float* __restrict__ cp, int L, int B,
    int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = 4 * H;
  const int ldq = H + PADB, ldx = G + PADF, lds = H + PADF;
  const Fwd l = fwd_layout(H, G, W_SMEM, 2, 2);
  const bf16* W = W_SMEM ? reinterpret_cast<const bf16*>(smem + l.w) : wt;
  const int ldw = W_SMEM ? ldq : H;
  bf16* q_s = reinterpret_cast<bf16*>(smem + l.q);    // q(h) [2][BT][ldq]
  float* h_s = reinterpret_cast<float*>(smem + l.s);  // [BT][lds] carry h
  float* c_s = h_s + BT * lds;                        // carry c
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
    const size_t s = static_cast<size_t>(b0 + r) * H + j;
    h_s[r * lds + j] = h0[s];
    c_s[r * lds + j] = c0[s];
    q_s[r * ldq + j] = __float2bfloat16(h0[s]);
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
    const bf16* q = q_s + (t & 1) * BT * ldq;
    bf16* qn = q_s + ((t + 1) & 1) * BT * ldq;
    const float* x_s = reinterpret_cast<const float*>(smem + l.x) + (t % NBUF) * BT * ldx;
    const float* m_s = reinterpret_cast<const float*>(smem + l.m) + (t % NBUF) * BT;
    const size_t row0 = static_cast<size_t>(t) * B + b0;
    for (int mt = warp; mt < H / 16; mt += nw) {
      float acc[4][4];
#pragma unroll
      for (int gb = 0; gb < 4; ++gb)
        carry_product<W_SMEM>(W, ldw, gb * H + 16 * mt, 0, q, ldq, 0, H, acc[gb]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * mt + g + 8 * (e >> 1);
        const int b = 2 * tq + (e & 1);
        const int s = b * lds + j;
        const float* xr = x_s + b * ldx;
        const float ig = fast_sigmoid(xr[j] + acc[0][e]);
        const float fg = fast_sigmoid(xr[H + j] + acc[1][e]);
        const float gg = fast_tanh(xr[2 * H + j] + acc[2][e]);
        const float og = fast_sigmoid(xr[3 * H + j] + acc[3][e]);
        const float h_old = h_s[s];
        const float c_old = c_s[s];
        const float c_new = fg * c_old + ig * gg;
        const float h_new = og * fast_tanh(c_new);
        const float m = m_s[b];
        const float hn = m * h_new + (1.0f - m) * h_old;
        if (b < nrows) {
          const size_t out = (row0 + b) * H + j;
          h_all[out] = hn;
          if constexpr (RESID) {
            hp[out] = h_old;
            cp[out] = c_old;
          }
        }
        h_s[s] = hn;
        c_s[s] = m * c_new + (1.0f - m) * c_old;
        qn[b * ldq + j] = __float2bfloat16(hn);
      }
    }
    cp_async_wait_prev();      // step t+1's inputs are in
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x) {
    const int r = idx / H;
    const int j = idx - r * H;
    cT[static_cast<size_t>(b0 + r) * H + j] = c_s[r * lds + j];
  }
}

// the bf16 forward's plan at width H: the register-resident kernel at the
// configs' widths, else the general one
template <bool RESID>
bool plan_bf16(int H, FwdPlan* p) {
  const int G = 4 * H;
  if (H == 128 || H == 64) {
    p->fn = H == 128 ? reinterpret_cast<const void*>(lstm_fwd_mma_reg_kernel<128, RESID>)
                     : reinterpret_cast<const void*>(lstm_fwd_mma_reg_kernel<64, RESID>);
    p->threads = 2 * H;
    p->smem = fwd_layout(H, G, false, 2, 0).total;
    p->w_smem = false;
    return true;
  }
  return plan_general(H, G, 2, 2, [](bool w_smem) {
    return w_smem ? reinterpret_cast<const void*>(lstm_fwd_mma_kernel<true, RESID>)
                  : reinterpret_cast<const void*>(lstm_fwd_mma_kernel<false, RESID>);
  }, p);
}

template <bool RESID>
int fwd_bf16(const float* xw, const bf16* wt, const float* mask, const float* h0,
             const float* c0, float* h_all, float* cT, float* hp, float* cp, int L, int B, int H,
             void* stream) {
  FwdPlan p;
  if (L < 1 || B < 1 || H < 16 || H % 16) return cudaErrorInvalidValue;
  if (!plan_bf16<RESID>(H, &p)) return cudaErrorInvalidConfiguration;
  void* args[] = {&xw, &wt, &mask, &h0, &c0, &h_all, &cT, &hp, &cp, &L, &B, &H};
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

// h cast to the product dtype (round to nearest even, as jax's astype and
// torch's .to do), kept as the f32 value of the rounded number
template <typename WT>
__device__ __forceinline__ float round_to(float x);

template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename WT, int BT, bool WH_SMEM, bool RESID>
__global__ void lstm_scan_fwd_kernel(const float* __restrict__ xw,    // [L, B, 4H]
                                     const WT* __restrict__ wh,       // [H, 4H]
                                     const float* __restrict__ mask,  // [B, L]
                                     const float* __restrict__ h0,    // [B, H]
                                     const float* __restrict__ c0,    // [B, H]
                                     float* __restrict__ h_all,       // [L, B, H]
                                     float* __restrict__ cT,          // [B, H]
                                     float* __restrict__ hp,          // [L, B, H] if RESID
                                     float* __restrict__ cp,          // [L, B, H] if RESID
                                     int L, int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = 4 * H;
  const size_t wh_elems = WH_SMEM ? static_cast<size_t>(H) * G : 0;
  WT* wh_s = reinterpret_cast<WT*>(smem);                        // [H][G]
  float* h_s = reinterpret_cast<float*>(smem + wh_elems * sizeof(WT));
  float* c_s = h_s + BT * H;    // [BT][H] cell state
  float* hq_s = c_s + BT * H;   // [BT][H] h rounded to WT: the product operand
  float* g_s = hq_s + BT * H;   // [BT][G] gate pre-activations

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
    float h = 0.0f, c = 0.0f;  // rows past the batch edge stay zero
    if (r < nrows) {
      h = h0[static_cast<size_t>(b0 + r) * H + j];
      c = c0[static_cast<size_t>(b0 + r) * H + j];
    }
    h_s[idx] = h;
    c_s[idx] = c;
    hq_s[idx] = round_to<WT>(h);
  }
  __syncthreads();

  for (int t = 0; t < L; ++t) {
    // phase 1: gate column `col` for every row of the tile
    for (int col = tid; col < G; col += nt) {
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
          g_s[r * G + col] =
              xw[(static_cast<size_t>(t) * B + b0 + r) * G + col] + acc[r];
        }
      }
    }
    __syncthreads();

    // phase 2: masked cell update, one (row, unit) per thread
    for (int idx = tid; idx < nrows * H; idx += nt) {
      const int r = idx / H;
      const int j = idx - r * H;
      const float* g = g_s + r * G;
      const float ig = sigmoid(g[j]);
      const float fg = sigmoid(g[H + j]);
      const float gg = tanhf(g[2 * H + j]);
      const float og = sigmoid(g[3 * H + j]);
      const float c_old = c_s[idx];
      const float h_old = h_s[idx];
      const float c_new = fg * c_old + ig * gg;
      const float h_new = og * tanhf(c_new);
      const float m = mask[static_cast<size_t>(b0 + r) * L + t];
      const float h = m * h_new + (1.0f - m) * h_old;
      const float c = m * c_new + (1.0f - m) * c_old;
      h_s[idx] = h;
      c_s[idx] = c;
      hq_s[idx] = round_to<WT>(h);
      const size_t out = (static_cast<size_t>(t) * B + b0 + r) * H + j;
      h_all[out] = h;
      if constexpr (RESID) {
        hp[out] = h_old;
        cp[out] = c_old;
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < nrows * H; idx += nt) {
    const int r = idx / H;
    const int j = idx - r * H;
    cT[static_cast<size_t>(b0 + r) * H + j] = c_s[idx];
  }
}

template <typename WT, int BT, bool WH_SMEM, bool RESID>
cudaError_t launch(const float* xw, const WT* wh, const float* mask,
                   const float* h0, const float* c0, float* h_all, float* cT,
                   float* hp, float* cp, int L, int B, int H, size_t smem,
                   cudaStream_t stream) {
  auto kernel = lstm_scan_fwd_kernel<WT, BT, WH_SMEM, RESID>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int G = 4 * H;
  const int threads = G < 1024 ? ((G + 31) / 32) * 32 : 1024;
  const int grid = (B + BT - 1) / BT;
  kernel<<<grid, threads, smem, stream>>>(xw, wh, mask, h0, c0, h_all, cT, hp,
                                          cp, L, B, H);
  return cudaGetLastError();
}

template <typename WT, bool WH_SMEM, bool RESID>
cudaError_t dispatch_bt(int bt, const void* xw, const void* wh,
                        const void* mask, const void* h0, const void* c0,
                        void* h_all, void* cT, void* hp, void* cp, int L,
                        int B, int H, size_t smem, cudaStream_t s) {
  const float* x = static_cast<const float*>(xw);
  const WT* w = static_cast<const WT*>(wh);
  const float* m = static_cast<const float*>(mask);
  const float* hi = static_cast<const float*>(h0);
  const float* ci = static_cast<const float*>(c0);
  float* ho = static_cast<float*>(h_all);
  float* co = static_cast<float*>(cT);
  float* hr = static_cast<float*>(hp);
  float* cr = static_cast<float*>(cp);
  switch (bt) {
    case 1: return launch<WT, 1, WH_SMEM, RESID>(x, w, m, hi, ci, ho, co, hr, cr, L, B, H, smem, s);
    case 2: return launch<WT, 2, WH_SMEM, RESID>(x, w, m, hi, ci, ho, co, hr, cr, L, B, H, smem, s);
    case 4: return launch<WT, 4, WH_SMEM, RESID>(x, w, m, hi, ci, ho, co, hr, cr, L, B, H, smem, s);
    case 8: return launch<WT, 8, WH_SMEM, RESID>(x, w, m, hi, ci, ho, co, hr, cr, L, B, H, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool RESID>
int run(const void* xw, const void* wh, const void* mask, const void* h0,
        const void* c0, void* h_all, void* cT, void* hp, void* cp, int L,
        int B, int H, int wh_bf16, int bt, int wh_in_smem, void* stream) {
  if (L < 1 || B < 1 || H < 1) return cudaErrorInvalidValue;
  const size_t G = 4 * static_cast<size_t>(H);
  const size_t state = static_cast<size_t>(bt) * (3 * H + G) * sizeof(float);
  const size_t welt = wh_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const size_t smem = (wh_in_smem ? H * G * welt : 0) + state;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (wh_bf16) {
    e = wh_in_smem ? dispatch_bt<__nv_bfloat16, true, RESID>(bt, xw, wh, mask, h0, c0, h_all, cT, hp, cp, L, B, H, smem, s)
                   : dispatch_bt<__nv_bfloat16, false, RESID>(bt, xw, wh, mask, h0, c0, h_all, cT, hp, cp, L, B, H, smem, s);
  } else {
    e = wh_in_smem ? dispatch_bt<float, true, RESID>(bt, xw, wh, mask, h0, c0, h_all, cT, hp, cp, L, B, H, smem, s)
                   : dispatch_bt<float, false, RESID>(bt, xw, wh, mask, h0, c0, h_all, cT, hp, cp, L, B, H, smem, s);
  }
  return static_cast<int>(e);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Every pointer is a device
// pointer to a contiguous tensor; `stream` is the caller's cudaStream_t.
// Each returns the cudaError_t of the launch (0 = launched).
//
// The CUDA-core kernel (f32; bf16 at any width), Wh [H, 4H]. Serving: h_all
// and cT only.
extern "C" int lstm_scan_fwd(const void* xw, const void* wh, const void* mask,
                             const void* h0, const void* c0, void* h_all,
                             void* cT, int L, int B, int H, int wh_bf16,
                             int bt, int wh_in_smem, void* stream) {
  return run<false>(xw, wh, mask, h0, c0, h_all, cT, nullptr, nullptr, L, B,
                    H, wh_bf16, bt, wh_in_smem, stream);
}

// Training: also the residuals hp, cp [L, B, H] for lstm_scan_bwd.
extern "C" int lstm_scan_fwd_resid(const void* xw, const void* wh,
                                   const void* mask, const void* h0,
                                   const void* c0, void* h_all, void* cT,
                                   void* hp, void* cp, int L, int B, int H,
                                   int wh_bf16, int bt, int wh_in_smem,
                                   void* stream) {
  return run<true>(xw, wh, mask, h0, c0, h_all, cT, hp, cp, L, B, H, wh_bf16,
                   bt, wh_in_smem, stream);
}

// The bf16 tensor-core kernel, Whᵀ [4H, H] bf16, H a multiple of 16.
// Serving: h_all and cT.
extern "C" int lstm_scan_fwd_bf16(const void* xw, const void* wt, const void* mask,
                                  const void* h0, const void* c0, void* h_all, void* cT, int L,
                                  int B, int H, void* stream) {
  return fwd_bf16<false>(static_cast<const float*>(xw), static_cast<const bf16*>(wt),
                         static_cast<const float*>(mask), static_cast<const float*>(h0),
                         static_cast<const float*>(c0), static_cast<float*>(h_all),
                         static_cast<float*>(cT), nullptr, nullptr, L, B, H, stream);
}

// Training: also hp, cp.
extern "C" int lstm_scan_fwd_bf16_resid(const void* xw, const void* wt, const void* mask,
                                        const void* h0, const void* c0, void* h_all, void* cT,
                                        void* hp, void* cp, int L, int B, int H, void* stream) {
  return fwd_bf16<true>(static_cast<const float*>(xw), static_cast<const bf16*>(wt),
                        static_cast<const float*>(mask), static_cast<const float*>(h0),
                        static_cast<const float*>(c0), static_cast<float*>(h_all),
                        static_cast<float*>(cT), static_cast<float*>(hp),
                        static_cast<float*>(cp), L, B, H, stream);
}

// What the bf16 kernel uses as it launches at width H, four ints each in
// `out` (registers per thread, local bytes per thread, dynamic shared
// memory per block, resident blocks per SM), serving launch then training
// launch: 8 ints.
extern "C" int lstm_scan_fwd_bf16_kernel_info(int H, int* out) {
  FwdPlan p[2];
  if (H < 16 || H % 16 || !plan_bf16<false>(H, &p[0]) || !plan_bf16<true>(H, &p[1]))
    return cudaErrorInvalidValue;
  for (int k = 0; k < 2; ++k) {
    const cudaError_t e = kernel_info(p[k].fn, p[k].threads, p[k].smem, out + 4 * k);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return cudaSuccess;
}
