// lstm_scan_bwd: one LSTM layer, backward, over a whole left-padded sequence.
//
// Replaces the TPU kernel arec/kernels/lstm_scan.py:_bwd_kernel (the Pallas
// backward of lstm_layer_pallas's custom VJP). Inputs are the forward's
// operands (xw [L, B, 4H], Wh [H, 4H], mask [B, L]), its residuals
// hp, cp [L, B, H] (the state BEFORE step t, from lstm_scan_fwd_resid) and
// the cotangents dh_out [L, B, H] (of h_all) and dcT [B, H] (of cT).
// Reverse time sweep, per step t (gate order i|f|g|o), with the TPU kernel's
// arithmetic:
//   gates  = xw[t] + cast(hp[t], WT) · Wh        recomputed, f32 sums
//   dh_tot = dh_out[t] + dh;  dh_new = m·dh_tot;  dh_skip = (1-m)·dh_tot
//   dc_new = m·dc;  dc_skip = (1-m)·dc
//   do = dh_new·tanh(c')·σo(1-σo);  dc_new += dh_new·σo·(1-tanh²(c'))
//   df = dc_new·cp[t]·σf(1-σf);  di = dc_new·tanh(g)·σi(1-σi);
//   dg = dc_new·σi·(1-tanh²(g))
//   dxw[t] = [di | df | dg | do]
//   dh = cast(dxw[t], WT) · cast(Wh, WT)ᵀ + dh_skip;  dc = dc_new·σf + dc_skip
// starting from dh = 0, dc = dcT; after step 0 (dh, dc) are (dh0, dc0).
// A second kernel forms dWh = Σ_{t,b} cast(hp[t,b])ᵀ · cast(dxw[t,b]) with
// f32 sums over RS contiguous ranges of the L·B rows, and a third adds the
// RS partials in range order: each output element sums its terms in one
// fixed order, with no atomics, so runs repeat bit for bit. Pad steps have
// dxw = 0 and add nothing.
//
// What bounds it: like the forward, the L steps are dependent, so the sweep
// is latency-bound; its bytes (xw, hp, cp, dh_out in; dxw out) are ~36 MB at
// c4's training shape (L = 50, B = 128, H = 128), ~11 µs of HBM time, while
// each step is two dependent block-wide products and four barriers.
//
// What the design does about it: as in lstm_scan_fwd, one CTA owns BT batch
// rows for the whole sweep, with the carries (dh, dc) in shared memory and
// bf16 Wh copied once into dynamic shared memory (128 KB at H = 128, the
// opt-in attribute); f32 Wh is read from global (L2-resident). The gate
// recompute is the forward's product (thread `col` forms gate column `col`).
// The carry product reads Wh along its rows (dh[j] = Σ_k dg[k]·Wh[j, k]), so
// one warp owns each unit j: its lanes take consecutive k (conflict-free
// shared-memory reads) and a fixed butterfly of shuffles sums them. The dWh
// kernel is a shared-memory tiled product over n = t·B + b, its rows split
// RS ways so that RS times as many blocks share the reduction. Ragged B and
// any L are masked here; nothing is padded by the caller.

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

// cast to the product dtype (round to nearest even), kept as an f32 value
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

template <typename WT, int BT, bool WH_SMEM>
__global__ void lstm_scan_bwd_kernel(const float* __restrict__ xw,      // [L, B, 4H]
                                     const WT* __restrict__ wh,         // [H, 4H]
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
  WT* wh_s = reinterpret_cast<WT*>(smem);                        // [H][G]
  float* hq_s = reinterpret_cast<float*>(smem + wh_elems * sizeof(WT));
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
      hq_s[idx] = round_to<WT>(hp[(static_cast<size_t>(t) * B + b0 + r) * H + j]);
    }
    __syncthreads();

    // phase 1: recompute gate column `col` for every row of the tile
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
      g[j] = round_to<WT>(d_i);
      g[H + j] = round_to<WT>(d_f);
      g[2 * H + j] = round_to<WT>(d_g);
      g[3 * H + j] = round_to<WT>(d_o);
      sk_s[idx] = (1.0f - m) * dh_total;
      dc_s[idx] = dc * sf + (1.0f - m) * dc_total;
    }
    __syncthreads();

    // phase 3: dh = cast(dgates) · Whᵀ + dh_skip, one warp per unit j
    for (int j = warp; j < H; j += nwarps) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
      const WT* wrow = W + static_cast<size_t>(j) * G;
      for (int k = lane; k < G; k += 32) {
        const float w = to_f32<WT>(wrow[k]);
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

template <typename WT>
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
                      ? round_to<WT>(hp[static_cast<size_t>(n0 + n) * H + i0 + i])
                      : 0.0f;
    }
    for (int idx = tid; idx < TN * TC; idx += blockDim.x) {
      const int n = idx / TC;
      const int c = idx - n * TC;
      d_t[n][c] = (n0 + n < n_end && c0 + c < G)
                      ? round_to<WT>(dxw[static_cast<size_t>(n0 + n) * G + c0 + c])
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

template <typename WT, int BT, bool WH_SMEM>
cudaError_t launch(const void* xw, const void* wh, const void* mask,
                   const void* hp, const void* cp, const void* dh_out,
                   const void* dcT, void* dxw, void* dwh, void* dh0, void* dc0,
                   void* part, int L, int B, int H, size_t smem,
                   cudaStream_t stream) {
  auto kernel = lstm_scan_bwd_kernel<WT, BT, WH_SMEM>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int G = 4 * H;
  const int threads = G < 1024 ? ((G + 31) / 32) * 32 : 1024;
  kernel<<<(B + BT - 1) / BT, threads, smem, stream>>>(
      static_cast<const float*>(xw), static_cast<const WT*>(wh),
      static_cast<const float*>(mask), static_cast<const float*>(hp),
      static_cast<const float*>(cp), static_cast<const float*>(dh_out),
      static_cast<const float*>(dcT), static_cast<float*>(dxw),
      static_cast<float*>(dh0), static_cast<float*>(dc0), L, B, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int N = L * B;
  const int split = ((N + TN * RS - 1) / (TN * RS)) * TN;
  const dim3 grid((G + TC - 1) / TC, (H + TI - 1) / TI, RS);
  lstm_dwh_kernel<WT><<<grid, 256, 0, stream>>>(
      static_cast<const float*>(hp), static_cast<const float*>(dxw),
      static_cast<float*>(part), N, H, split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  lstm_dwh_reduce_kernel<<<(H * G + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dwh), H * G);
  return cudaGetLastError();
}

template <typename WT, bool WH_SMEM>
cudaError_t dispatch_bt(int bt, const void* xw, const void* wh,
                        const void* mask, const void* hp, const void* cp,
                        const void* dh_out, const void* dcT, void* dxw,
                        void* dwh, void* dh0, void* dc0, void* part, int L,
                        int B, int H, size_t smem, cudaStream_t s) {
  switch (bt) {
    case 1: return launch<WT, 1, WH_SMEM>(xw, wh, mask, hp, cp, dh_out, dcT, dxw, dwh, dh0, dc0, part, L, B, H, smem, s);
    case 2: return launch<WT, 2, WH_SMEM>(xw, wh, mask, hp, cp, dh_out, dcT, dxw, dwh, dh0, dc0, part, L, B, H, smem, s);
    case 4: return launch<WT, 4, WH_SMEM>(xw, wh, mask, hp, cp, dh_out, dcT, dxw, dwh, dh0, dc0, part, L, B, H, smem, s);
    case 8: return launch<WT, 8, WH_SMEM>(xw, wh, mask, hp, cp, dh_out, dcT, dxw, dwh, dh0, dc0, part, L, B, H, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Every pointer is a device pointer
// to a contiguous tensor; `part` is scratch of 8·H·4H floats; `stream` is
// the caller's cudaStream_t. Launches the reverse sweep and then the dWh
// reduction on that stream; returns the first cudaError_t (0 = all
// launched).
extern "C" int lstm_scan_bwd(const void* xw, const void* wh, const void* mask,
                             const void* hp, const void* cp,
                             const void* dh_out, const void* dcT, void* dxw,
                             void* dwh, void* dh0, void* dc0, void* part,
                             int L, int B, int H, int wh_bf16, int bt,
                             int wh_in_smem, void* stream) {
  if (L < 1 || B < 1 || H < 1) return cudaErrorInvalidValue;
  const size_t G = 4 * static_cast<size_t>(H);
  const size_t state = static_cast<size_t>(bt) * (4 * H + G) * sizeof(float);
  const size_t welt = wh_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const size_t smem = (wh_in_smem ? H * G * welt : 0) + state;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (wh_bf16) {
    e = wh_in_smem ? dispatch_bt<__nv_bfloat16, true>(bt, xw, wh, mask, hp, cp, dh_out, dcT, dxw, dwh, dh0, dc0, part, L, B, H, smem, s)
                   : dispatch_bt<__nv_bfloat16, false>(bt, xw, wh, mask, hp, cp, dh_out, dcT, dxw, dwh, dh0, dc0, part, L, B, H, smem, s);
  } else {
    e = wh_in_smem ? dispatch_bt<float, true>(bt, xw, wh, mask, hp, cp, dh_out, dcT, dxw, dwh, dh0, dc0, part, L, B, H, smem, s)
                   : dispatch_bt<float, false>(bt, xw, wh, mask, hp, cp, dh_out, dcT, dxw, dwh, dh0, dc0, part, L, B, H, smem, s);
  }
  return static_cast<int>(e);
}
