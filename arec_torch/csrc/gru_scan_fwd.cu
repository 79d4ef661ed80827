// gru_scan_fwd: one GRU layer, forward, over a whole left-padded sequence.
//
// Replaces the TPU kernel arec/kernels/gru_scan.py:_fwd_kernel (the Pallas
// forward of gru_layer_pallas). Contract, per step t (gate order r|u|n):
//   r, u = σ(xw[t]_{r,u} + cast(h, WT) · Wh[:, :2H])     products summed in f32
//   n    = tanh(xw[t]_n + cast(r⊙h, WT) · Wh[:, 2H:])    (reset before the
//                                                       product)
//   h'   = (1-u)·n + u·h;  h = m·h' + (1-m)·h   (m = mask[b, t]; a pad step
//                                              is an exact no-op)
// with h carried in from h0, so segment n's final state can seed segment
// n+1. Output: h_all [L, B, H] f32. The training entry `gru_scan_fwd_resid`
// also writes the backward sweep's residual hp [L, B, H]: the state BEFORE
// step t (pad steps included), as the TPU kernel's hp_out does; serving
// does not need it and the serving entry does not write it.
//
// What bounds it: the L steps are dependent, so the kernel is latency-bound.
// Its bytes are xw in ([L, B, 3H] f32) and h_all out ([L, B, H] f32); its
// arithmetic is 2·3H·H per valid (row, step). At serving shapes (B = 256,
// L = 50, H = 128) both bounds are a few microseconds, far below what 50
// steps of two DEPENDENT block-wide products (n needs r) cost.
//
// What the design does about it: as in lstm_scan_fwd, the time loop runs
// inside the block, with h resident in shared memory for the whole
// sequence; one CTA owns a tile of BT batch rows (BT is picked so the grid
// roughly covers the SMs). Each step has two phases, one barrier each:
//   1. thread `col` forms r|u gate column `col` (of 2H) for all BT rows;
//      the threads of the r columns also form cast(r⊙h) for their unit;
//   2. thread `j` forms candidate column j for all BT rows and applies the
//      masked update of unit j right there (it owns every input of it).
// So the GRU's extra dependent product costs no extra barrier over the
// LSTM. Wh [H, 3H] is copied once into dynamic shared memory when it fits
// beside the state (bf16 at H = 128 is 96 KB, f32 192 KB: both fit under
// the 227 KB a block may hold); otherwise every step reads it from global
// memory, where it stays L2-resident. The mask is read as [B, L] directly,
// and any L and B are taken: the ragged batch edge is masked here, not
// padded by the caller. Known limit: phase 2 keeps only H of the 2H
// threads busy, and the products run on CUDA cores; tensor cores are
// later work.

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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
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
// Serving: h_all only.
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
