// lstm_scan_fwd: one LSTM layer, forward, over a whole left-padded sequence.
//
// Replaces the TPU kernel arec/kernels/lstm_scan.py:_fwd_kernel (the Pallas
// forward of lstm_layer_pallas). Contract, per step t (gate order i|f|g|o):
//   gates = xw[t] + cast(h, WT) · Wh          products summed in f32
//   c'    = σ(f)·c + σ(i)·tanh(g);  h' = σ(o)·tanh(c')
//   h     = m·h' + (1-m)·h;  c = m·c' + (1-m)·c   (m = mask[b, t]; a pad
//                                                  step is an exact no-op)
// with (h, c) carried in from (h0, c0), so segment n's final state can seed
// segment n+1. Outputs: h_all [L, B, H] and cT [B, H], both f32. The
// training entry `lstm_scan_fwd_resid` also writes the backward sweep's
// residuals hp, cp [L, B, H]: the state BEFORE step t (pad steps
// included), as the TPU kernel's hp_out/cp_out do.
//
// What bounds it: the L steps are dependent, so the kernel is latency-bound.
// Its bytes are xw in ([L, B, 4H] f32) and h_all out ([L, B, H] f32); its
// arithmetic is 2·4H·H per valid (row, step). At serving shapes (B = 256,
// L = 50, H = 128) both bounds are a few microseconds, far below what 50
// dependent steps of a block-wide product followed by a barrier cost.
//
// What the design does about it: the time loop runs inside the block, with
// h and c resident in shared memory for the whole sequence, so no state
// makes a round trip through device memory between steps. One CTA owns a
// tile of BT batch rows (BT is picked so the grid roughly covers the SMs);
// thread `col` forms gate column `col` for all BT rows (one Wh read serves
// BT products), then the threads apply the cell update per (row, unit),
// with one barrier after each phase. Wh is copied once into dynamic shared
// memory when it fits (bf16 at H = 128 is 128 KB); otherwise (f32 at
// H = 128 is 256 KB, over the 227 KB a block may hold) every step reads it
// from global memory, where it stays L2-resident. The mask is read as
// [B, L] directly, and any L and B are taken: the ragged batch edge is
// masked here, not padded by the caller. Known limit: at B = 256 only
// ceil(B / BT) = 128 CTAs of 4H threads each are busy, one per SM, so each
// SM runs a few warps and the step latency is exposed; tensor cores and a
// finer split of the gate columns are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
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
// Serving: h_all and cT only.
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
