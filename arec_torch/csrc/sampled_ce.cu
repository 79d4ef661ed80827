// sampled_ce: the fused sampled-softmax cross-entropy sums, forward and
// backward.
//
// Replaces the TPU kernels arec/kernels/sampled_softmax.py:_sums_fwd_kernel
// (forward) and :_sums_bwd_kernel (backward). Per row i of the N loss rows,
// with S shared sampled columns j (all f32 in device memory):
//   tl_i    = tl_base_i + [aug: v_true[i, D]] + Σ_d q[i, d]·v_true[i, d]
//   logit_ij = cast(q_i)·cast(v_samp_j) + c_samp_j    products summed in f32;
//              −1e9 where sampled_ids_j == true_ids_i (accidental hit)
//   lse_i   = m + log(exp(tl_i − m) + Σ_j exp(logit_ij − m)),  m ≥ every term
//   ce_i    = lse_i − tl_i;   outputs ce, lse [N] and (Σ w·ce, Σ w)
// In aug mode v_true is the raw [N, D+1] output-table row with the item bias
// in lane D. The backward takes the scalar cotangent g of Σ w·ce:
//   wt_i = g·w_i·(exp(tl_i − lse_i) − 1);  wp_ij = g·w_i·exp(logit_ij − lse_i)
//   dq_i = wt_i·v_true[i, :D] + Σ_j cast(wp_ij)·cast(v_samp_j)
//   dv_true_i = wt_i·q_i (aug: wt_i in lane D);  dtl_base_i = wt_i
//   dv_samp_j = Σ_i cast(wp_ij)·cast(q_i);  dc_samp_j = Σ_i wp_ij
// The logits never reach device memory: every kernel recomputes its tile.
//
// What bounds it: at c4's training shape (N = 6400, S = 1024, D = 128) the
// bytes are a few MB (q, v_true in; dq, dv_true out), ~2 µs (forward) and
// ~5 µs (backward) of HBM time, while the N·S·D products are 0.84 GFMA per
// pass, here on CUDA cores in f32: the kernels are bound by operations
// (and, in this first version, by shared-memory traffic).
//
// What the design does about it. The TPU kernel ran its row tiles in order
// and accumulated (Σ w·ce, Σ w), dv_samp and db_samp across them in
// revisited output blocks. Hopper blocks run in no order, so:
//  * forward: one block per tile of 32 rows (a row per lane, 8 warps split
//    the sampled columns), an online row max / log-sum-exp over chunks of
//    64 sampled columns that starts from the true logit, the 8 warps' (max,
//    sum) pairs merged in a fixed order; per-block (Σ w·ce, Σ w) go to a
//    [blocks, 2] buffer that one warp then sums in a fixed order;
//  * backward, rows: the same tiling recomputes the tile's logits chunk by
//    chunk, stages cast(wp) in shared memory and accumulates dq in registers;
//  * backward, columns: one block per 8 sampled columns and one of RS
//    contiguous row ranges recomputes those columns' wp over its rows (32
//    at a time) and sums dv_samp and dc_samp in increasing row order into
//    its own partial; a last pass adds the RS partials in split order. No
//    atomics: runs repeat bit for bit.
// q and v_samp tiles sit in shared memory, pre-cast, with rows padded to
// D+1 floats so a warp's lanes (different rows) hit different banks. Ragged
// N and S are masked here; nothing is padded by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float NEG = -1e9f;
constexpr int NT = 32;          // rows per row tile (one per lane)
constexpr int NW = 8;           // warps per block
constexpr int SC = 64;          // sampled columns per chunk (forward, dq)
constexpr int CPW = SC / NW;    // columns per warp per chunk
constexpr int SCB = NW;         // sampled columns per block (dv_samp)
constexpr int DMAX = 256;       // widest D the register tiles take
constexpr int RS = 8;           // row splits of the dv_samp / dc_samp pass

template <bool ROUND>
__device__ __forceinline__ float cast(float x) {
  if constexpr (ROUND) return __bfloat162float(__float2bfloat16(x));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [row0, row0+NT) of q, cast, into q_s [NT][D+1]; zeros past N
template <bool ROUND>
__device__ void load_q_tile(float* q_s, const float* q, int row0, int N, int D) {
  for (int idx = threadIdx.x; idx < NT * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    q_s[r * (D + 1) + d] =
        row0 + r < N ? cast<ROUND>(q[static_cast<size_t>(row0 + r) * D + d]) : 0.0f;
  }
}

// sampled rows [c0, c0+n) of v_samp, cast, into v_s [n][D+1]; zeros past S
template <bool ROUND>
__device__ void load_v_chunk(float* v_s, const float* vs, int c0, int n, int S,
                             int D) {
  for (int idx = threadIdx.x; idx < n * D; idx += blockDim.x) {
    const int c = idx / D;
    const int d = idx - c * D;
    v_s[c * (D + 1) + d] =
        c0 + c < S ? cast<ROUND>(vs[static_cast<size_t>(c0 + c) * D + d]) : 0.0f;
  }
}

// true logit of row i (unrounded f32), summed by the 8 warps in slices of D
// and merged in warp order through red_s [NW][NT]; every thread gets it
__device__ float true_logit(const float* q, const float* vt,
                            const float* tl_base, float* red_s, int i,
                            bool valid, int D, int Dt) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  float part = 0.0f;
  if (valid) {
    for (int d = w; d < D; d += NW)
      part = fmaf(q[static_cast<size_t>(i) * D + d],
                  vt[static_cast<size_t>(i) * Dt + d], part);
  }
  red_s[w * NT + lane] = part;
  __syncthreads();
  float tl = 0.0f;
  if (valid) {
    tl = tl_base[i] + (Dt > D ? vt[static_cast<size_t>(i) * Dt + D] : 0.0f);
    float dot = 0.0f;
    for (int k = 0; k < NW; ++k) dot += red_s[k * NT + lane];
    tl += dot;
  }
  __syncthreads();
  return tl;
}

// raw products of row `lane` with this warp's CPW columns of the chunk
__device__ __forceinline__ void chunk_products(const float* q_s,
                                               const float* v_s, int D,
                                               float acc[CPW]) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < CPW; ++k) acc[k] = 0.0f;
  const float* qr = q_s + lane * (D + 1);
  for (int d = 0; d < D; ++d) {
    const float qv = qr[d];
#pragma unroll
    for (int k = 0; k < CPW; ++k)
      acc[k] = fmaf(qv, v_s[(w + NW * k) * (D + 1) + d], acc[k]);
  }
}

template <bool ROUND>
__global__ void sampled_ce_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ vt,
    const float* __restrict__ vs, const float* __restrict__ cs,
    const float* __restrict__ tl_base, const int* __restrict__ true_ids,
    const int* __restrict__ sampled_ids, const float* __restrict__ wts,
    float* __restrict__ ce, float* __restrict__ lse,
    float* __restrict__ part, int N, int D, int Dt, int S) {
  extern __shared__ __align__(16) float fsm[];
  float* q_s = fsm;                       // [NT][D+1]
  float* v_s = q_s + NT * (D + 1);        // [SC][D+1]
  float* red_m = v_s + SC * (D + 1);      // [NW][NT]
  float* red_s = red_m + NW * NT;         // [NW][NT]

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int row0 = blockIdx.x * NT;
  const int i = row0 + lane;
  const bool valid = i < N;

  load_q_tile<ROUND>(q_s, q, row0, N, D);
  const float tl = true_logit(q, vt, tl_base, red_s, i, valid, D, Dt);
  const int tid_i = valid ? true_ids[i] : -1;

  float m = tl, s = 0.0f;                 // online max / sum, from tl
  for (int c0 = 0; c0 < S; c0 += SC) {
    load_v_chunk<ROUND>(v_s, vs, c0, SC, S, D);
    __syncthreads();
    float acc[CPW];
    chunk_products(q_s, v_s, D, acc);
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      const int c = c0 + w + NW * k;
      if (c < S) {
        const float x = sampled_ids[c] == tid_i ? NEG : acc[k] + cs[c];
        if (x > m) {
          s = s * expf(m - x) + 1.0f;
          m = x;
        } else {
          s += expf(x - m);
        }
      }
    }
    __syncthreads();
  }

  red_m[w * NT + lane] = m;
  red_s[w * NT + lane] = s;
  __syncthreads();
  if (w == 0) {
    float wce = 0.0f, wsum = 0.0f;
    if (valid) {
      float M = red_m[lane];
      for (int k = 1; k < NW; ++k) M = fmaxf(M, red_m[k * NT + lane]);
      float sum = 0.0f;
      for (int k = 0; k < NW; ++k)
        sum += red_s[k * NT + lane] * expf(red_m[k * NT + lane] - M);
      const float l = M + logf(expf(tl - M) + sum);
      const float c = l - tl;
      ce[i] = c;
      lse[i] = l;
      wce = wts[i] * c;
      wsum = wts[i];
    }
    wce = warp_sum(wce);
    wsum = warp_sum(wsum);
    if (lane == 0) {
      part[2 * blockIdx.x] = wce;
      part[2 * blockIdx.x + 1] = wsum;
    }
  }
}

// (Σ w·ce, Σ w) from the [P, 2] per-block partials, in a fixed order
__global__ void sums_reduce_kernel(const float* __restrict__ part, int P,
                                   float* __restrict__ sums) {
  const int lane = threadIdx.x;
  float a = 0.0f, b = 0.0f;
  for (int p = lane; p < P; p += 32) {
    a += part[2 * p];
    b += part[2 * p + 1];
  }
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sums[0] = a;
    sums[1] = b;
  }
}

// DPW: dq elements per thread (D ≤ NW·DPW), a template parameter so the
// register tile is sized for the D at hand
template <bool ROUND, int DPW>
__global__ void sampled_ce_bwd_rows_kernel(
    const float* __restrict__ q, const float* __restrict__ vt,
    const float* __restrict__ vs, const float* __restrict__ cs,
    const float* __restrict__ tl_base, const int* __restrict__ true_ids,
    const int* __restrict__ sampled_ids, const float* __restrict__ wts,
    const float* __restrict__ lse, const float* __restrict__ g_num,
    float* __restrict__ dq, float* __restrict__ dvt, float* __restrict__ dtl,
    int N, int D, int Dt, int S) {
  extern __shared__ __align__(16) float fsm[];
  float* q_s = fsm;                       // [NT][D+1]
  float* v_s = q_s + NT * (D + 1);        // [SC][D+1]
  float* wp_s = v_s + SC * (D + 1);       // [NT][SC+1]
  float* red_s = wp_s + NT * (SC + 1);    // [NW][NT]

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int row0 = blockIdx.x * NT;
  const int i = row0 + lane;
  const bool valid = i < N;

  load_q_tile<ROUND>(q_s, q, row0, N, D);
  const float tl = true_logit(q, vt, tl_base, red_s, i, valid, D, Dt);
  const int tid_i = valid ? true_ids[i] : -1;
  const float l = valid ? lse[i] : 0.0f;
  const float g = valid ? g_num[0] * wts[i] : 0.0f;

  float acc_dq[DPW];
#pragma unroll
  for (int k = 0; k < DPW; ++k) acc_dq[k] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += SC) {
    load_v_chunk<ROUND>(v_s, vs, c0, SC, S, D);
    __syncthreads();
    float acc[CPW];
    chunk_products(q_s, v_s, D, acc);
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      const int cc = w + NW * k;
      const int c = c0 + cc;
      float wp = 0.0f;
      if (c < S && valid) {
        const float x = sampled_ids[c] == tid_i ? NEG : acc[k] + cs[c];
        wp = g * expf(x - l);
      }
      wp_s[lane * (SC + 1) + cc] = cast<ROUND>(wp);
    }
    __syncthreads();
    // dq[lane][d] += Σ_c cast(wp)[lane][c] · cast(v)[c][d], d = w + NW·k
    const float* wr = wp_s + lane * (SC + 1);
    for (int cc = 0; cc < SC; ++cc) {
      const float wv = wr[cc];
      const float* vr = v_s + cc * (D + 1);
#pragma unroll
      for (int k = 0; k < DPW; ++k) {
        const int d = w + NW * k;
        if (d < D) acc_dq[k] = fmaf(wv, vr[d], acc_dq[k]);
      }
    }
    __syncthreads();
  }

  if (valid) {
    const float wt = g * (expf(tl - l) - 1.0f);
#pragma unroll
    for (int k = 0; k < DPW; ++k) {
      const int d = w + NW * k;
      if (d < D) {
        dq[static_cast<size_t>(i) * D + d] =
            wt * vt[static_cast<size_t>(i) * Dt + d] + acc_dq[k];
        dvt[static_cast<size_t>(i) * Dt + d] = wt * q[static_cast<size_t>(i) * D + d];
      }
    }
    if (w == 0) {
      if (Dt > D) dvt[static_cast<size_t>(i) * Dt + D] = wt;
      dtl[i] = wt;
    }
  }
}

// partial sums of rows [blockIdx.y·split, (blockIdx.y+1)·split) into
// dvs_part [RS][S][D] and dcs_part [RS][S]
template <bool ROUND>
__global__ void sampled_ce_bwd_cols_kernel(
    const float* __restrict__ q, const float* __restrict__ vs,
    const float* __restrict__ cs, const int* __restrict__ true_ids,
    const int* __restrict__ sampled_ids, const float* __restrict__ wts,
    const float* __restrict__ lse, const float* __restrict__ g_num,
    float* __restrict__ dvs_part, float* __restrict__ dcs_part, int N, int D,
    int S, int split) {
  extern __shared__ __align__(16) float fsm[];
  float* q_s = fsm;                       // [NT][D+1]
  float* v_s = q_s + NT * (D + 1);        // [SCB][D+1]
  float* wp_s = v_s + SCB * (D + 1);      // [NT][SCB]
  float* row_s = wp_s + NT * SCB;         // [2][NT]: lse, g·w
  int* tid_s = reinterpret_cast<int*>(row_s + 2 * NT);   // [NT]

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;         // this thread's column of the block
  const int c = blockIdx.x * SCB + w;
  const bool col_ok = c < S;
  const float g = g_num[0];

  load_v_chunk<ROUND>(v_s, vs, blockIdx.x * SCB, SCB, S, D);
  const int sid = col_ok ? sampled_ids[c] : -1;
  const float csc = col_ok ? cs[c] : 0.0f;

  float acc_dv[DMAX / 32];
#pragma unroll
  for (int k = 0; k < DMAX / 32; ++k) acc_dv[k] = 0.0f;
  float acc_db = 0.0f;

  const int y = static_cast<int>(blockIdx.y);  // this block's row split
  const int row_end = min(N, (y + 1) * split);
  for (int row0 = y * split; row0 < row_end; row0 += NT) {
    load_q_tile<ROUND>(q_s, q, row0, row_end, D);
    if (threadIdx.x < NT) {
      const int i = row0 + threadIdx.x;
      const bool ok = i < row_end;
      row_s[threadIdx.x] = ok ? lse[i] : 0.0f;
      row_s[NT + threadIdx.x] = ok ? g * wts[i] : 0.0f;
      tid_s[threadIdx.x] = ok ? true_ids[i] : -1;
    }
    __syncthreads();
    // wp of (row lane, column w)
    {
      const float* qr = q_s + lane * (D + 1);
      const float* vr = v_s + w * (D + 1);
      float raw = 0.0f;
      for (int d = 0; d < D; ++d) raw = fmaf(qr[d], vr[d], raw);
      float wp = 0.0f;
      if (col_ok && row0 + lane < row_end) {
        const float x = sid == tid_s[lane] ? NEG : raw + csc;
        wp = row_s[NT + lane] * expf(x - row_s[lane]);
      }
      wp_s[lane * SCB + w] = wp;
    }
    __syncthreads();
    // dv_samp[c][d] += Σ_r cast(wp[r][c])·cast(q[r][d]), d = lane + 32·k
    for (int r = 0; r < NT; ++r) {
      const float wpr = wp_s[r * SCB + w];
      const float wv = cast<ROUND>(wpr);
      acc_db += wpr;
      const float* qr = q_s + r * (D + 1);
#pragma unroll
      for (int k = 0; k < DMAX / 32; ++k) {
        const int d = lane + 32 * k;
        if (d < D) acc_dv[k] = fmaf(wv, qr[d], acc_dv[k]);
      }
    }
    __syncthreads();
  }

  if (col_ok) {
    float* dv = dvs_part + (static_cast<size_t>(y) * S + c) * D;
#pragma unroll
    for (int k = 0; k < DMAX / 32; ++k) {
      const int d = lane + 32 * k;
      if (d < D) dv[d] = acc_dv[k];
    }
    if (lane == 0) dcs_part[static_cast<size_t>(y) * S + c] = acc_db;
  }
}

// dv_samp, dc_samp = the RS partials added in split order
__global__ void sampled_ce_cols_reduce_kernel(const float* __restrict__ dvs_part,
                                              const float* __restrict__ dcs_part,
                                              float* __restrict__ dvs,
                                              float* __restrict__ dcs, int S,
                                              int D) {
  const size_t n = static_cast<size_t>(S) * D;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx < n) {
    float a = 0.0f;
    for (int r = 0; r < RS; ++r) a += dvs_part[r * n + idx];
    dvs[idx] = a;
  } else if (idx < n + S) {
    const size_t c = idx - n;
    float a = 0.0f;
    for (int r = 0; r < RS; ++r) a += dcs_part[r * static_cast<size_t>(S) + c];
    dcs[c] = a;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <bool ROUND>
cudaError_t fwd(const float* q, const float* vt, const float* vs,
                const float* cs, const float* tl_base, const int* tid,
                const int* sid, const float* w, float* ce, float* lse,
                float* part, float* sums, int N, int D, int Dt, int S,
                cudaStream_t st) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(NT + SC) * (D + 1) + 2 * NW * NT);
  auto kernel = sampled_ce_fwd_kernel<ROUND>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (N + NT - 1) / NT;
  kernel<<<blocks, NW * 32, smem, st>>>(q, vt, vs, cs, tl_base, tid, sid, w, ce,
                                        lse, part, N, D, Dt, S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sums_reduce_kernel<<<1, 32, 0, st>>>(part, blocks, sums);
  return cudaGetLastError();
}

template <bool ROUND>
cudaError_t bwd(const float* q, const float* vt, const float* vs,
                const float* cs, const float* tl_base, const int* tid,
                const int* sid, const float* w, const float* lse,
                const float* g_num, float* dq, float* dvt, float* dvs,
                float* dcs, float* dtl, float* part, int N, int D, int Dt,
                int S, cudaStream_t st) {
  const size_t smem_rows = sizeof(float) * (static_cast<size_t>(NT + SC) * (D + 1) +
                                            NT * (SC + 1) + NW * NT);
  auto rows = D <= 16 * NW ? sampled_ce_bwd_rows_kernel<ROUND, 16>
                           : sampled_ce_bwd_rows_kernel<ROUND, DMAX / NW>;
  cudaError_t e = set_smem(rows, smem_rows);
  if (e != cudaSuccess) return e;
  rows<<<(N + NT - 1) / NT, NW * 32, smem_rows, st>>>(
      q, vt, vs, cs, tl_base, tid, sid, w, lse, g_num, dq, dvt, dtl, N, D, Dt, S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem_cols = sizeof(float) * (static_cast<size_t>(NT + SCB) * (D + 1) +
                                            NT * SCB + 3 * NT);
  auto cols = sampled_ce_bwd_cols_kernel<ROUND>;
  e = set_smem(cols, smem_cols);
  if (e != cudaSuccess) return e;
  const int tiles = (N + NT - 1) / NT;
  const int split = ((tiles + RS - 1) / RS) * NT;
  float* dvs_part = part;
  float* dcs_part = part + static_cast<size_t>(RS) * S * D;
  cols<<<dim3((S + SCB - 1) / SCB, RS), NW * 32, smem_cols, st>>>(
      q, vs, cs, tid, sid, w, lse, g_num, dvs_part, dcs_part, N, D, S, split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t n = static_cast<size_t>(S) * (D + 1);
  sampled_ce_cols_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                                  st>>>(dvs_part, dcs_part, dvs, dcs, S, D);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. Every pointer is a device pointer
// to a contiguous tensor (f32, ids int32); `stream` is the caller's
// cudaStream_t. `part` is scratch: 2·ceil(N/32) floats (forward),
// 8·S·(D+1) floats (backward). D ≤ 256 and Dt ∈ {D, D+1}. Each returns the
// first cudaError_t (0 = all launched).
extern "C" int sampled_ce_fwd(const void* q, const void* vt, const void* vs,
                              const void* cs, const void* tl_base,
                              const void* true_ids, const void* sampled_ids,
                              const void* w, void* ce, void* lse, void* part,
                              void* sums, int N, int D, int Dt, int S,
                              int round_bf16, void* stream) {
  if (N < 1 || S < 1 || D < 1 || D > DMAX || (Dt != D && Dt != D + 1))
    return cudaErrorInvalidValue;
  auto f = round_bf16 ? &fwd<true> : &fwd<false>;
  return static_cast<int>(f(
      static_cast<const float*>(q), static_cast<const float*>(vt),
      static_cast<const float*>(vs), static_cast<const float*>(cs),
      static_cast<const float*>(tl_base), static_cast<const int*>(true_ids),
      static_cast<const int*>(sampled_ids), static_cast<const float*>(w),
      static_cast<float*>(ce), static_cast<float*>(lse),
      static_cast<float*>(part), static_cast<float*>(sums), N, D, Dt, S,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int sampled_ce_bwd(const void* q, const void* vt, const void* vs,
                              const void* cs, const void* tl_base,
                              const void* true_ids, const void* sampled_ids,
                              const void* w, const void* lse,
                              const void* g_num, void* dq, void* dvt,
                              void* dvs, void* dcs, void* dtl, void* part,
                              int N, int D, int Dt, int S, int round_bf16,
                              void* stream) {
  if (N < 1 || S < 1 || D < 1 || D > DMAX || (Dt != D && Dt != D + 1))
    return cudaErrorInvalidValue;
  auto f = round_bf16 ? &bwd<true> : &bwd<false>;
  return static_cast<int>(f(
      static_cast<const float*>(q), static_cast<const float*>(vt),
      static_cast<const float*>(vs), static_cast<const float*>(cs),
      static_cast<const float*>(tl_base), static_cast<const int*>(true_ids),
      static_cast<const int*>(sampled_ids), static_cast<const float*>(w),
      static_cast<const float*>(lse), static_cast<const float*>(g_num),
      static_cast<float*>(dq), static_cast<float*>(dvt),
      static_cast<float*>(dvs), static_cast<float*>(dcs),
      static_cast<float*>(dtl), static_cast<float*>(part), N, D, Dt, S,
      static_cast<cudaStream_t>(stream)));
}
