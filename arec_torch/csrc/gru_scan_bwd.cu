// gru_scan_bwd: one GRU layer, backward, over a whole left-padded sequence.
//
// Replaces the TPU kernel arec/kernels/gru_scan.py:_bwd_kernel (the Pallas
// backward of gru_layer_pallas's custom VJP). Inputs are the forward's
// operands (xw [L, B, 3H], Wh [H, 3H], mask [B, L]), its residual hp
// [L, B, H] (the state BEFORE step t, from gru_scan_fwd_resid) and the
// cotangent dh_out [L, B, H] of h_all. Reverse time sweep, per step t (gate
// order r|u|n), with the TPU kernel's arithmetic (h = hp[t], q = cast to WT):
//   r, u = σ(xw_{r,u} + q(h)·Wh[:, :2H]);  n = tanh(xw_n + q(r⊙h)·Wh[:, 2H:])
//   dh_tot = dh_out[t] + dh;  dh_new = m·dh_tot;  dh_skip = (1-m)·dh_tot
//   dn = dh_new·(1-u);  du = dh_new·(h-n);  da_n = dn·(1-n²)
//   drh = q(da_n)·Wh[:, 2H:]ᵀ;  da_r = drh·h·r(1-r);  da_u = du·u(1-u)
//   dh = dh_new·u + drh·r + q([da_r|da_u])·Wh[:, :2H]ᵀ + dh_skip
//   dxw[t] = [da_r | da_u | da_n]   (unrounded)
// starting from dh = 0; after step 0, dh is dh0. Then
//   dWh[:, :2H] = Σ_{t,b} q(hp)ᵀ·q([da_r|da_u]);  dWh[:, 2H:] = Σ q(r⊙hp)ᵀ·q(da_n)
// by a second kernel with f32 sums over RS contiguous ranges of the L·B
// rows, and a third that adds the RS partials in range order: each output
// element sums its terms in one fixed order, with no atomics, so runs
// repeat bit for bit. Pad steps have dxw = 0 and add nothing.
//
// What bounds it: the L steps are dependent, so the sweep is latency-bound;
// its bytes (xw, hp, dh_out in; dxw out) are ~26 MB at c4's training shape
// (L = 50, B = 128, H = 128), ~8 µs of HBM time, while each step chains
// FOUR dependent block-wide products (q(h)·W_ru, then q(r⊙h)·W_n, then
// q(da_n)·W_nᵀ, then q([da_r|da_u])·W_ruᵀ) where the LSTM chains two.
//
// What the design does about it: as in lstm_scan_bwd, one CTA owns BT batch
// rows for the whole sweep, with the carry dh in shared memory and Wh
// copied once into dynamic shared memory when it fits beside the state
// (bf16 and, at BT = 1, f32 at H = 128); otherwise it is read from global
// (L2-resident). Four phases a step, one barrier each:
//   1. thread `col` recomputes r|u gate column `col`; an r column also forms
//      q(r⊙h) of its unit (kept for phase 2 and written to the rh scratch);
//   2. thread `j` recomputes candidate column j and then every derivative of
//      unit j that needs no further product (da_u, da_n, dh_new·u, dh_skip);
//   3. one warp per unit j forms drh[j] = Σ_k q(da_n)[k]·Wh[j, 2H+k] (lanes
//      take consecutive k: conflict-free reads of Wh by rows; a fixed
//      butterfly of shuffles sums them), then da_r of unit j;
//   4. one warp per unit j forms the carry product over the 2H r|u columns
//      and the new dh[j]; meanwhile all threads load hp[t-1].
// dWh[:, 2H:] needs q(r⊙hp) for every (t, b). The sweep writes it to an
// [L, B, H] scratch (3.3 MB at B = 128: ~1 µs of writes) rather than have
// the dWh pass recompute r, which would repeat the L·B × H × 2H gate
// product. The dWh kernel is a shared-memory tiled product over
// n = t·B + b, launched once per column block (hp with the r|u columns,
// the scratch with the n columns), its rows split RS ways. Ragged B and any
// L are masked here; nothing is padded by the caller.

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

// f32 words of shared memory per batch row, in units of H: h_prev, its
// cast, cast r⊙h_prev, dh, dh_new·u (+ drh·r), dh_skip [H each], σ(r)|σ(u)
// [2H] and the cast gate derivatives [3H]
constexpr int kStateWords = 11;

template <typename WT, int BT, bool WH_SMEM>
__global__ void gru_scan_bwd_kernel(const float* __restrict__ xw,      // [L, B, 3H]
                                    const WT* __restrict__ wh,         // [H, 3H]
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
  WT* wh_s = reinterpret_cast<WT*>(smem);                        // [H][3H]
  float* hp_s = reinterpret_cast<float*>(smem + wh_elems * sizeof(WT));
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

  // all state zero (rows past the batch edge stay so), then h_prev of the
  // last step
  for (int idx = tid; idx < BT * kStateWords * H; idx += nt) hp_s[idx] = 0.0f;
  __syncthreads();
  for (int idx = tid; idx < nrows * H; idx += nt) {
    const int r = idx / H;
    const int j = idx - r * H;
    const float h = hp[(static_cast<size_t>(L - 1) * B + b0 + r) * H + j];
    hp_s[idx] = h;
    hq_s[idx] = round_to<WT>(h);
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
        const float w = to_f32<WT>(W[static_cast<size_t>(k) * G + col]);
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(hq_s[r * H + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        if (r < nrows) {
          const float s = sigmoid(xw_t[static_cast<size_t>(r) * G + col] + acc[r]);
          g_s[r * H2 + col] = s;
          if (col < H) {
            const float v = round_to<WT>(s * hp_s[r * H + col]);
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
        const float w = to_f32<WT>(W[static_cast<size_t>(k) * G + H2 + j]);
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
          d_s[r * G + H + j] = round_to<WT>(da_u);
          d_s[r * G + H2 + j] = round_to<WT>(da_n);
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
      const WT* wrow = W + static_cast<size_t>(j) * G + H2;
      for (int k = lane; k < H; k += 32) {
        const float w = to_f32<WT>(wrow[k]);
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
            d_s[r * G + j] = round_to<WT>(da_r);
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
        hq_s[idx] = round_to<WT>(h);
      }
    }
    for (int j = warp; j < H; j += nwarps) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
      const WT* wrow = W + static_cast<size_t>(j) * G;
      for (int k = lane; k < H2; k += 32) {
        const float w = to_f32<WT>(wrow[k]);
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

template <typename WT>
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
                      ? round_to<WT>(a[static_cast<size_t>(n0 + n) * H + i0 + i])
                      : 0.0f;
    }
    for (int idx = tid; idx < TN * TC; idx += blockDim.x) {
      const int n = idx / TC;
      const int c = idx - n * TC;
      d_t[n][c] = (n0 + n < n_end && c0 + c < ncols)
                      ? round_to<WT>(dc[static_cast<size_t>(n0 + n) * G + c0 + c])
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

template <typename WT, int BT, bool WH_SMEM>
cudaError_t launch(const void* xw, const void* wh, const void* mask,
                   const void* hp, const void* dh_out, void* dxw, void* dwh,
                   void* dh0, void* rh, void* part, int L, int B, int H,
                   size_t smem, cudaStream_t stream) {
  auto kernel = gru_scan_bwd_kernel<WT, BT, WH_SMEM>;
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
      static_cast<const float*>(xw), static_cast<const WT*>(wh),
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
    gru_dwh_kernel<WT><<<grid, 256, 0, stream>>>(
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

template <typename WT, bool WH_SMEM>
cudaError_t dispatch_bt(int bt, const void* xw, const void* wh,
                        const void* mask, const void* hp, const void* dh_out,
                        void* dxw, void* dwh, void* dh0, void* rh, void* part,
                        int L, int B, int H, size_t smem, cudaStream_t s) {
  switch (bt) {
    case 1: return launch<WT, 1, WH_SMEM>(xw, wh, mask, hp, dh_out, dxw, dwh, dh0, rh, part, L, B, H, smem, s);
    case 2: return launch<WT, 2, WH_SMEM>(xw, wh, mask, hp, dh_out, dxw, dwh, dh0, rh, part, L, B, H, smem, s);
    case 4: return launch<WT, 4, WH_SMEM>(xw, wh, mask, hp, dh_out, dxw, dwh, dh0, rh, part, L, B, H, smem, s);
    case 8: return launch<WT, 8, WH_SMEM>(xw, wh, mask, hp, dh_out, dxw, dwh, dh0, rh, part, L, B, H, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Every pointer is a device pointer
// to a contiguous tensor; `rh` is scratch of L·B·H floats and `part` of
// 8·H·3H floats; `stream` is the caller's cudaStream_t. Launches the reverse
// sweep and then the dWh reduction on that stream; returns the first
// cudaError_t (0 = all launched).
extern "C" int gru_scan_bwd(const void* xw, const void* wh, const void* mask,
                            const void* hp, const void* dh_out, void* dxw,
                            void* dwh, void* dh0, void* rh, void* part,
                            int L, int B, int H, int wh_bf16, int bt,
                            int wh_in_smem, void* stream) {
  if (L < 1 || B < 1 || H < 1) return cudaErrorInvalidValue;
  const size_t G = 3 * static_cast<size_t>(H);
  const size_t state = static_cast<size_t>(bt) * kStateWords * H * sizeof(float);
  const size_t welt = wh_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const size_t smem = (wh_in_smem ? H * G * welt : 0) + state;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (wh_bf16) {
    e = wh_in_smem ? dispatch_bt<__nv_bfloat16, true>(bt, xw, wh, mask, hp, dh_out, dxw, dwh, dh0, rh, part, L, B, H, smem, s)
                   : dispatch_bt<__nv_bfloat16, false>(bt, xw, wh, mask, hp, dh_out, dxw, dwh, dh0, rh, part, L, B, H, smem, s);
  } else {
    e = wh_in_smem ? dispatch_bt<float, true>(bt, xw, wh, mask, hp, dh_out, dxw, dwh, dh0, rh, part, L, B, H, smem, s)
                   : dispatch_bt<float, false>(bt, xw, wh, mask, hp, dh_out, dxw, dwh, dh0, rh, part, L, B, H, smem, s);
  }
  return static_cast<int>(e);
}
