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
// What bounds it. At MF's training shape (N = 8192, S = 2048, D = 128) the
// bytes are ~13 MB (q, v_true, v_samp in; dq, d(v_true), d(v_samp) out), a
// few µs of HBM time, and the N·S·D products are 4.3 GFLOP forward and
// 12.9 GFLOP backward, 4 µs and 13 µs at the bf16 tensor-core peak. So the
// roofline says operations, barely. What holds the kernels back in practice
// is the per-logit work beside the products (the mask, the exp on the SFU,
// the online max / sum or the residue and its rounding: ~20 instructions
// per logit against 256 or 512 tensor-core FLOPs) and the latency of each
// block's dependent chain of cp.async → ldmatrix → mma → exp.
//
// What the design does about it, in bf16 (the mode c4 and MF train in): a
// FlashAttention-style fused softmax with K = V = v_samp.
//  * A prep pass writes bf16 copies of q and v_samp, zero-padded to whole
//    64-row tiles and to a depth Dp that is a multiple of 16 (the MMA's k),
//    and the true logit in f32 from the f32 q and v_true (unrounded, as
//    arec's pure path has it).
//  * The kernels copy bf16 tiles into shared memory with cp.async, 16 bytes
//    a thread, double-buffered; each shared row is padded by 16 bytes, so
//    the 8 rows an ldmatrix reads start in 8 different bank quads. Every
//    product runs on the tensor cores: mma.sync m16n8k16, bf16 operands,
//    f32 accumulators in registers. A block is 4 warps × 16 rows.
//  * Forward: a block keeps 64 rows of q and streams one of P ranges of
//    v_samp in tiles of 64 columns. Each logit tile gets c_samp and the
//    accidental-hit mask in registers and feeds a branch-free online max /
//    sum per row, started from the true logit and reduced over each quad
//    with shuffles. P makes the grid at least two waves of 132 SMs. A merge
//    pass adds the P (max, sum) pairs of a row in split order and writes
//    ce, lse and per-block (Σ w·ce, Σ w), which one warp sums in order.
//  * Backward, rows (FlashAttention-2's dQ loop): per 64-row tile and one of
//    P column ranges, recompute the logits tile by tile, form wp in f32,
//    round it to bf16 straight from the accumulator registers into the A
//    operand of dq += cast(wp)·cast(v_samp). A combine pass adds the P dq
//    partials in range order to wt·v_true and writes d(v_true), d(tl_base).
//  * Backward, columns (its dK/dV loop): a block keeps 64 sampled columns
//    and streams the row tiles of one of RS row ranges: the transposed
//    logits, the f32 wp summed into d(c_samp) before rounding, and
//    dv += cast(wp)ᵀ·cast(q) on the tensor cores. q is read S/64 times in
//    all. A last pass adds the RS partials in split order.
//  * The bf16 rounding of wp is the contract's, from the logit summed in d
//    order, for every residue larger than |g·w|·2^-8 (see `unsure`). The
//    tensor cores sum in another order, which can move a residue across a
//    bf16 rounding boundary. A bound on that difference (4·D·‖q_i‖·‖v_j‖
//    f32 ulps of wp, from the norms of the bf16 rows, which the prep pass
//    writes, plus the roundings) clears most residues; the rest are formed
//    again from the d-order sum and the accurate expf, spread over the
//    warp's lanes. A smaller residue
//    that rounds apart moves one term of a gradient by at most one bf16
//    ulp of it, < 2^-15·|g·w|·|operand|.
//  No atomics: runs repeat bit for bit.
//
// f32, the parity mode, keeps the CUDA-core kernels of the first version,
// with no tensor cores at all: one block per 32 rows (a row per lane, 8
// warps split the sampled columns), f32 FMAs over shared-memory tiles
// padded to D+1 floats, an online max / sum per warp merged in warp order;
// for the backward a row-tiled dq pass and a pass over 8 sampled columns ×
// 8 row ranges whose partials are added in split order.
//
// Every entry point takes one scratch allocation and its size; the caller
// asks `sampled_ce_scratch_bytes` (the total of `layout` below) how large
// it must be. An entry point handed less returns cudaErrorInvalidValue and
// launches nothing.

#include "mma_tiles.cuh"

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float NEG = -1e9f;
constexpr int DMAX = 256;       // widest D the kernels take

// f32 (CUDA-core) kernels
constexpr int NT = 32;          // rows per row tile (one per lane)
constexpr int NW = 8;           // warps per block
constexpr int SC = 64;          // sampled columns per chunk (forward, dq)
constexpr int CPW = SC / NW;    // columns per warp per chunk
constexpr int SCB = NW;         // sampled columns per block (dv_samp)
constexpr int RS = 8;           // row splits of the dv_samp / dc_samp pass

// bf16 (tensor-core) kernels (the tiles: mma_tiles.cuh)
constexpr int MERGE_ROWS = 256; // rows per block of the forward merge

// ---------------------------------------------------------------- f32 ----

// rows [row0, row0+NT) of q into q_s [NT][D+1]; zeros past N
__device__ void load_q_tile(float* q_s, const float* q, int row0, int N, int D) {
  for (int idx = threadIdx.x; idx < NT * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    q_s[r * (D + 1) + d] = row0 + r < N ? q[static_cast<size_t>(row0 + r) * D + d] : 0.0f;
  }
}

// sampled rows [c0, c0+n) of v_samp into v_s [n][D+1]; zeros past S
__device__ void load_v_chunk(float* v_s, const float* vs, int c0, int n, int S, int D) {
  for (int idx = threadIdx.x; idx < n * D; idx += blockDim.x) {
    const int c = idx / D;
    const int d = idx - c * D;
    v_s[c * (D + 1) + d] = c0 + c < S ? vs[static_cast<size_t>(c0 + c) * D + d] : 0.0f;
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

  load_q_tile(q_s, q, row0, N, D);
  const float tl = true_logit(q, vt, tl_base, red_s, i, valid, D, Dt);
  const int tid_i = valid ? true_ids[i] : -1;

  float m = tl, s = 0.0f;                 // online max / sum, from tl
  for (int c0 = 0; c0 < S; c0 += SC) {
    load_v_chunk(v_s, vs, c0, SC, S, D);
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
__global__ void sampled_ce_sums_reduce_kernel(const float* __restrict__ part, int P,
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
template <int DPW>
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

  load_q_tile(q_s, q, row0, N, D);
  const float tl = true_logit(q, vt, tl_base, red_s, i, valid, D, Dt);
  const int tid_i = valid ? true_ids[i] : -1;
  const float l = valid ? lse[i] : 0.0f;
  const float g = valid ? g_num[0] * wts[i] : 0.0f;

  float acc_dq[DPW];
#pragma unroll
  for (int k = 0; k < DPW; ++k) acc_dq[k] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += SC) {
    load_v_chunk(v_s, vs, c0, SC, S, D);
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
      wp_s[lane * (SC + 1) + cc] = wp;
    }
    __syncthreads();
    // dq[lane][d] += Σ_c wp[lane][c] · v[c][d], d = w + NW·k
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

  load_v_chunk(v_s, vs, blockIdx.x * SCB, SCB, S, D);
  const int sid = col_ok ? sampled_ids[c] : -1;
  const float csc = col_ok ? cs[c] : 0.0f;

  float acc_dv[DMAX / 32];
#pragma unroll
  for (int k = 0; k < DMAX / 32; ++k) acc_dv[k] = 0.0f;
  float acc_db = 0.0f;

  const int y = static_cast<int>(blockIdx.y);  // this block's row split
  const int row_end = min(N, (y + 1) * split);
  for (int row0 = y * split; row0 < row_end; row0 += NT) {
    load_q_tile(q_s, q, row0, row_end, D);
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
    // dv_samp[c][d] += Σ_r wp[r][c]·q[r][d], d = lane + 32·k
    for (int r = 0; r < NT; ++r) {
      const float wpr = wp_s[r * SCB + w];
      acc_db += wpr;
      const float* qr = q_s + r * (D + 1);
#pragma unroll
      for (int k = 0; k < DMAX / 32; ++k) {
        const int d = lane + 32 * k;
        if (d < D) acc_dv[k] = fmaf(wpr, qr[d], acc_dv[k]);
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

// dv_samp, dc_samp = the rs partials [rs][S][D], [rs][S] added in split order
__global__ void sampled_ce_cols_reduce_kernel(const float* __restrict__ dvs_part,
                                              const float* __restrict__ dcs_part,
                                              float* __restrict__ dvs,
                                              float* __restrict__ dcs, int S,
                                              int D, int rs) {
  const size_t n = static_cast<size_t>(S) * D;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx < n) {
    float a = 0.0f;
    for (int r = 0; r < rs; ++r) a += dvs_part[r * n + idx];
    dvs[idx] = a;
  } else if (idx < n + S) {
    const size_t c = idx - n;
    float a = 0.0f;
    for (int r = 0; r < rs; ++r) a += dcs_part[r * static_cast<size_t>(S) + c];
    dcs[c] = a;
  }
}

// --------------------------------------------------------------- bf16 ----

// The contract rounds the residue wp = gw·exp(x − l) to bf16 from the logit
// x of an f32 dot product summed in d order (the f32 kernels' order). The
// tensor-core sum x' differs from it, so its residue may round to the other
// bf16 neighbour. Where that could show in a gradient, it must not. Below
// cut = |gw|·2^-8 a residue rounded apart moves its gradient term by at
// most one bf16 ulp, 2^-7·|wp| < 2^-15·|gw|, times its operand. Above it
// (at most 256 of a row: a row's residues sum to ≤ |gw|) the rounding must
// be the contract's, and `unsure` flags each residue whose distance to a
// bf16 rounding boundary is not provably larger than its own error:
//  * the products are exact in f32, so the d-order sum errs by at most
//    about D·2^-24·Σ_d|a_d·b_d| and the tensor cores' block sums, which
//    truncate, by twice that (the behaviour Fasi et al., 2021, measured on
//    Volta to Ampere, taken here for Hopper): |x' − x| ≤ 3·D·2^-24·Σ|a_d·b_d|
//    ≤ 3·D·2^-24·‖a‖·‖b‖ (Cauchy–Schwarz), which is 3·D·‖a‖·‖b‖ f32 ulps of
//    wp at most;
//  * the roundings of s = x + c_samp and of y = s − l, __expf's error
//    (2 + 1.173·|y| ulps), expf's (2) and the product's add at most
//    2·|s| + 4.35·|y| + 10 ulps of wp; for a residue above the cut
//    |y| < ln 256 < 5.55 and |s| ≤ |l| + |y|, so at most 2·|l| + 55.
// So the window is 4·D·‖a‖·‖b‖ + 2·|l| + 60 f32 ulps of wp (the prep pass
// writes 4·D·‖a‖ and ‖b‖ of the bf16 rows; 4 for 3 covers the second-order
// terms and the norms' own rounding). `seq_residue` forms each flagged
// residue again from the logit summed in d order over the bf16 rows in
// shared memory, with the accurate expf. The epilogues form every residue
// branch-free and collect a lane's flagged ones in a 32-bit mask (bit 4n+k:
// acc[n][k]); `redo_flagged` spreads the warp's over its lanes.

// the window's part that is the row's own: 2·|lse| + 60
__device__ __forceinline__ float window_base(float l) { return fmaf(2.0f, fabsf(l), 60.0f); }

// 1 if wp is above the cut and within `win` f32 ulps of a bf16 rounding tie
__device__ __forceinline__ uint32_t unsure(float wp, float cut, float win) {
  const int low = static_cast<int>(__float_as_uint(wp) & 0xffffu);   // the bits bf16 drops
  // f32 ulps to the nearest tie: in this binade, or (low + 2^14) to the
  // last one of the binade below, whose ulps are half as large
  const int dist = min(abs(low - 0x8000), low + 0x4000);
  return fabsf(wp) > cut && static_cast<float>(dist) <= win;
}

// One residue to form again: row ra of a_s and row rb of b_s (bf16 tiles in
// shared memory), its c_samp, g·w and lse, and whether it is a hit.
struct Redo {
  int ra, rb;
  float cs, gw, l;
  bool hit;
};

// the two bf16 of a 32-bit word as f32: lane 2j (low half), 2j+1 (high)
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// the residue of e from its logit summed in d order, one FMA chain, and the
// accurate expf
__device__ __forceinline__ float seq_residue(const Redo& e, const bf16* a_s, const bf16* b_s,
                                             int ld, int D) {
  const bf16* a_row = a_s + e.ra * ld;
  const bf16* b_row = b_s + e.rb * ld;
  float raw = 0.0f;
  for (int d0 = 0; d0 < D; d0 += 8) {        // rows are 16-byte aligned
    const uint4 a = *reinterpret_cast<const uint4*>(a_row + d0);
    const uint4 b = *reinterpret_cast<const uint4*>(b_row + d0);
    const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (d0 + 2 * j < D) raw = fmaf(bf16_lo(wa[j]), bf16_lo(wb[j]), raw);
      if (d0 + 2 * j + 1 < D) raw = fmaf(bf16_hi(wa[j]), bf16_hi(wb[j]), raw);
    }
  }
  return e.gw * expf((e.hit ? NEG : raw + e.cs) - e.l);
}

// Forms the flagged residues of a warp's tile again, evenly over its lanes:
// a popular column or a peaked row can give one lane most of them. `big`
// holds this lane's; the warp numbers them in lane order, each lane posts
// its own (lane << 5 | bit) in `res`, 32 words of shared memory that this
// warp owns, and takes every 32nd; describe(o, bit) gives the one of lane
// o at `bit` (every lane calls it: it may shuffle). The values go back to
// their lanes through `res`. a_s, b_s, ld: the tiles the Redo rows index.
template <class Describe>
__device__ __forceinline__ void redo_flagged(float acc[8][4], uint32_t big, float* res,
                                             const bf16* a_s, const bf16* b_s, int ld, int D,
                                             Describe describe) {
  const int lane = threadIdx.x & 31;
  const int cnt = __popc(big);
  int incl = cnt;                       // inclusive prefix count over lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  const int start = incl - cnt;         // the number of this lane's first
  int* post = reinterpret_cast<int*>(res);
  for (int base = 0; base < total; base += 32) {
    int at = start - base;              // this trip's slot of the lane's next
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (big >> (4 * n + k) & 1u) {
          if (at >= 0 && at < 32) post[at] = lane << 5 | (4 * n + k);
          ++at;
        }
    __syncwarp();
    const bool on = base + lane < total;
    const int id = on ? post[lane] : 0;
    const Redo e = describe(id >> 5, id & 31);
    if (on) res[lane] = seq_residue(e, a_s, b_s, ld, D);   // its own slot
    __syncwarp();
    at = start - base;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (big >> (4 * n + k) & 1u) {
          if (at >= 0 && at < 32) acc[n][k] = res[at];
          ++at;
        }
    __syncwarp();
  }
}

// bf16 copies of q [Np, Dp] and v_samp [Sp, Dp], zero past N, S and D, the
// true logit tl [Np] in f32 (0 past N) and, where qn is not null, the
// norms of the bf16 rows, qn [Np] scaled by 4·D and vn [Sp]; a warp a row
__global__ void sampled_ce_prep_kernel(
    const float* __restrict__ q, const float* __restrict__ vt,
    const float* __restrict__ tl_base, const float* __restrict__ vs,
    bf16* __restrict__ qb, bf16* __restrict__ vb, float* __restrict__ tl,
    float* __restrict__ qn, float* __restrict__ vn, int N, int S, int D, int Dt,
    int Dp, int Np, int Sp) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r < Np) {
    const bool ok = r < N;
    const size_t row = static_cast<size_t>(r);
    float dot = 0.0f, sq = 0.0f;
    for (int d = lane; d < Dp; d += 32) {
      const bool in = ok && d < D;
      const float x = in ? q[row * D + d] : 0.0f;
      const bf16 xb = __float2bfloat16(x);
      qb[row * Dp + d] = xb;
      sq = fmaf(__bfloat162float(xb), __bfloat162float(xb), sq);
      if (in) dot = fmaf(x, vt[row * Dt + d], dot);
    }
    dot = warp_sum(dot);
    sq = warp_sum(sq);
    if (lane == 0) {
      tl[r] = ok ? tl_base[r] + (Dt > D ? vt[row * Dt + D] : 0.0f) + dot : 0.0f;
      if (qn) qn[r] = 4.0f * D * sqrtf(sq);
    }
  } else if (r < Np + Sp) {
    const size_t c = static_cast<size_t>(r - Np);
    const bool ok = r - Np < S;
    float sq = 0.0f;
    for (int d = lane; d < Dp; d += 32) {
      const bf16 xb = __float2bfloat16(ok && d < D ? vs[c * D + d] : 0.0f);
      vb[c * Dp + d] = xb;
      sq = fmaf(__bfloat162float(xb), __bfloat162float(xb), sq);
    }
    sq = warp_sum(sq);
    if (vn && lane == 0) vn[c] = sqrtf(sq);
  }
}

// one of P column ranges of a 64-row tile: this range's running (max, sum)
// of every row into ms [P][Np] (float2), the sum taken from the true logit
__global__ void __launch_bounds__(MW * 32) sampled_ce_fwd_mma_kernel(
    const bf16* __restrict__ qb, const bf16* __restrict__ vb,
    const float* __restrict__ cs, const int* __restrict__ true_ids,
    const int* __restrict__ sampled_ids, const float* __restrict__ tl,
    float2* __restrict__ ms, int N, int S, int Dp, int Np, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Dp + PAD;
  bf16* q_s = reinterpret_cast<bf16*>(smem);                    // [TILE][ld]
  bf16* v_s = q_s + TILE * ld;                                  // [2][TILE][ld]
  float* cs_s = reinterpret_cast<float*>(v_s + 2 * TILE * ld);  // [2][TILE]
  int* sid_s = reinterpret_cast<int*>(cs_s + 2 * TILE);         // [2][TILE]

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * TILE;
  const int tile0 = blockIdx.y * per;
  const int n_tiles = min(per, cdiv(S, TILE) - tile0);

  auto stage = [&](int it, int buf) {
    const int c0 = (tile0 + it) * TILE;
    load_tile_async(v_s + buf * TILE * ld, vb, c0, Dp);
    if (threadIdx.x < TILE) {
      const int c = c0 + threadIdx.x;
      cs_s[buf * TILE + threadIdx.x] = c < S ? cs[c] : 0.0f;
      sid_s[buf * TILE + threadIdx.x] = c < S ? sampled_ids[c] : -1;
    }
  };
  load_tile_async(q_s, qb, row0, Dp);
  stage(0, 0);
  cp_async_commit();

  const int ra = row0 + 16 * w + g, rb = ra + 8;   // this thread's two rows
  const int tid_a = ra < N ? true_ids[ra] : -1;
  const int tid_b = rb < N ? true_ids[rb] : -1;
  float m_a = tl[ra], m_b = tl[rb];                // online max / sum, from tl
  float s_a = 0.0f, s_b = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) stage(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    float acc[8][4];
    tile_logits(q_s, v_s + buf * TILE * ld, Dp, acc);
    const int c0 = (tile0 + it) * TILE;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = 8 * n + 2 * t + e;
        const bool ok = c0 + cc < S;
        const float b = cs_s[buf * TILE + cc];
        const int sid = sid_s[buf * TILE + cc];
        acc[n][e] = !ok ? -INFINITY : sid == tid_a ? NEG : acc[n][e] + b;
        acc[n][2 + e] = !ok ? -INFINITY : sid == tid_b ? NEG : acc[n][2 + e] + b;
        mx_a = fmaxf(mx_a, acc[n][e]);
        mx_b = fmaxf(mx_b, acc[n][2 + e]);
      }
    const float new_a = fmaxf(m_a, quad_max(mx_a));
    const float new_b = fmaxf(m_b, quad_max(mx_b));
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sum_a += __expf(acc[n][e] - new_a);
        sum_b += __expf(acc[n][2 + e] - new_b);
      }
    s_a = s_a * __expf(m_a - new_a) + sum_a;
    s_b = s_b * __expf(m_b - new_b) + sum_b;
    m_a = new_a;
    m_b = new_b;
    __syncthreads();
  }
  s_a = quad_sum(s_a);
  s_b = quad_sum(s_b);
  if (t == 0) {
    ms[static_cast<size_t>(blockIdx.y) * Np + ra] = make_float2(m_a, s_a);
    ms[static_cast<size_t>(blockIdx.y) * Np + rb] = make_float2(m_b, s_b);
  }
}

// ce, lse of each row from its P (max, sum) pairs, added in split order, and
// per-block (Σ w·ce, Σ w) into part [blocks][2]
__global__ void sampled_ce_fwd_merge_kernel(const float2* __restrict__ ms,
                                            const float* __restrict__ tl,
                                            const float* __restrict__ wts,
                                            float* __restrict__ ce,
                                            float* __restrict__ lse,
                                            float* __restrict__ part, int N,
                                            int Np, int P) {
  __shared__ float red[2][MERGE_ROWS / 32];
  const int i = blockIdx.x * MERGE_ROWS + threadIdx.x;
  float wce = 0.0f, wsum = 0.0f;
  if (i < N) {
    const float t = tl[i];
    float M = t;
    for (int p = 0; p < P; ++p) M = fmaxf(M, ms[static_cast<size_t>(p) * Np + i].x);
    float sum = 0.0f;
    for (int p = 0; p < P; ++p) {
      const float2 v = ms[static_cast<size_t>(p) * Np + i];
      sum += v.y * expf(v.x - M);
    }
    const float l = M + logf(expf(t - M) + sum);
    ce[i] = l - t;
    lse[i] = l;
    wce = wts[i] * (l - t);
    wsum = wts[i];
  }
  wce = warp_sum(wce);
  wsum = warp_sum(wsum);
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = wce;
    red[1][threadIdx.x >> 5] = wsum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.0f, b = 0.0f;
    for (int k = 0; k < MERGE_ROWS / 32; ++k) {
      a += red[0][k];
      b += red[1][k];
    }
    part[2 * blockIdx.x] = a;
    part[2 * blockIdx.x + 1] = b;
  }
}

// Σ_j cast(wp_ij)·cast(v_samp_j) of one 64-row tile over the column tiles
// of range blockIdx.y, into dq_part [P][N][D]. NTD: 8-lane tiles of dq per
// warp row (Dp ≤ 8·NTD)
template <int NTD>
__global__ void __launch_bounds__(MW * 32, BWD_BLOCKS(NTD)) sampled_ce_bwd_rows_mma_kernel(
    const bf16* __restrict__ qb, const bf16* __restrict__ vb,
    const float* __restrict__ cs, const int* __restrict__ true_ids,
    const int* __restrict__ sampled_ids, const float* __restrict__ wts,
    const float* __restrict__ lse, const float* __restrict__ g_num,
    const float* __restrict__ qn, const float* __restrict__ vn,
    float* __restrict__ dq_part, int N, int D, int S, int Dp, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Dp + PAD;
  bf16* q_s = reinterpret_cast<bf16*>(smem);                    // [TILE][ld]
  bf16* v_s = q_s + TILE * ld;                                  // [2][TILE][ld]
  float* cs_s = reinterpret_cast<float*>(v_s + 2 * TILE * ld);  // [2][TILE]
  int* sid_s = reinterpret_cast<int*>(cs_s + 2 * TILE);         // [2][TILE]
  float* vn_s = reinterpret_cast<float*>(sid_s + 2 * TILE);     // [2][TILE]
  float* res_s = vn_s + 2 * TILE;                               // [MW][32]

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * TILE;
  const int tile0 = blockIdx.y * per;
  const int n_tiles = min(per, cdiv(S, TILE) - tile0);

  auto stage = [&](int it, int buf) {
    const int c0 = (tile0 + it) * TILE;
    load_tile_async(v_s + buf * TILE * ld, vb, c0, Dp);
    if (threadIdx.x < TILE) {
      const int c = c0 + threadIdx.x;
      cs_s[buf * TILE + threadIdx.x] = c < S ? cs[c] : 0.0f;
      sid_s[buf * TILE + threadIdx.x] = c < S ? sampled_ids[c] : -1;
      vn_s[buf * TILE + threadIdx.x] = c < S ? vn[c] : 0.0f;
    }
  };
  load_tile_async(q_s, qb, row0, Dp);
  stage(0, 0);
  cp_async_commit();

  const int ra = row0 + 16 * w + g, rb = ra + 8;   // this thread's two rows
  const bool ok_a = ra < N, ok_b = rb < N;
  const float gn = g_num[0];
  const int tid_a = ok_a ? true_ids[ra] : -1;
  const int tid_b = ok_b ? true_ids[rb] : -1;
  const float l_a = ok_a ? lse[ra] : 0.0f, l_b = ok_b ? lse[rb] : 0.0f;
  const float gw_a = ok_a ? gn * wts[ra] : 0.0f, gw_b = ok_b ? gn * wts[rb] : 0.0f;
  const float cut_a = fabsf(gw_a) * (1.0f / 256), cut_b = fabsf(gw_b) * (1.0f / 256);
  const float qn_a = qn[ra], qn_b = qn[rb];        // 4·D·‖q‖ (0 past N)
  const float base_a = window_base(l_a), base_b = window_base(l_b);

  float dacc[NTD][4];
#pragma unroll
  for (int j = 0; j < NTD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dacc[j][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) stage(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const bf16* vt_s = v_s + buf * TILE * ld;
    float acc[8][4];
    tile_logits(q_s, vt_s, Dp, acc);
    const int c0 = (tile0 + it) * TILE;
    uint32_t big = 0;                      // bit 4n+k: acc[n][k] is unsure
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = 8 * n + 2 * t + e;
        const bool ok = c0 + cc < S;
        const float b = cs_s[buf * TILE + cc], vnc = vn_s[buf * TILE + cc];
        const int sid = sid_s[buf * TILE + cc];
        const float xa = sid == tid_a ? NEG : acc[n][e] + b;
        const float xb = sid == tid_b ? NEG : acc[n][2 + e] + b;
        acc[n][e] = ok && ok_a ? gw_a * __expf(xa - l_a) : 0.0f;
        acc[n][2 + e] = ok && ok_b ? gw_b * __expf(xb - l_b) : 0.0f;
        big |= unsure(acc[n][e], cut_a, fmaf(qn_a, vnc, base_a)) << (4 * n + e) |
               unsure(acc[n][2 + e], cut_b, fmaf(qn_b, vnc, base_b)) << (4 * n + 2 + e);
      }
    redo_flagged(acc, big, res_s + 32 * w, q_s, vt_s, ld, D, [&](int o, int bit) {
      // lane o's rows: their true ids, lse and g·w
      const int ta = __shfl_sync(0xffffffffu, tid_a, o), tb = __shfl_sync(0xffffffffu, tid_b, o);
      const float la = __shfl_sync(0xffffffffu, l_a, o), lb = __shfl_sync(0xffffffffu, l_b, o);
      const float ga = __shfl_sync(0xffffffffu, gw_a, o), gb = __shfl_sync(0xffffffffu, gw_b, o);
      const bool hi = (bit & 3) >= 2;
      const int cc = 8 * (bit >> 2) + 2 * (o & 3) + (bit & 1);
      return Redo{16 * w + (o >> 2) + (hi ? 8 : 0), cc, cs_s[buf * TILE + cc], hi ? gb : ga,
                  hi ? lb : la, sid_s[buf * TILE + cc] == (hi ? tb : ta)};
    });
    accum_product<NTD>(acc, vt_s, Dp, dacc);
    __syncthreads();
  }

  // thread (g, t) holds lanes 8j+2t, 8j+2t+1 of rows ra, rb
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!(h ? ok_b : ok_a)) continue;
    float* out = dq_part + (static_cast<size_t>(blockIdx.y) * N + (h ? rb : ra)) * D;
#pragma unroll
    for (int j = 0; j < NTD; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * t + e;
        if (d < D) out[d] = dacc[j][2 * h + e];
      }
  }
}

// dq = wt·v_true + the P range partials in range order; d(v_true) = wt·q
// (aug: wt in lane D); d(tl_base) = wt; wt = g·w·(exp(tl − lse) − 1). One
// thread per element of dq.
__global__ void sampled_ce_bwd_rows_combine_kernel(
    const float* __restrict__ dq_part, const float* __restrict__ q,
    const float* __restrict__ vt, const float* __restrict__ tl,
    const float* __restrict__ lse, const float* __restrict__ wts,
    const float* __restrict__ g_num, float* __restrict__ dq,
    float* __restrict__ dvt, float* __restrict__ dtl, int N, int D, int Dt,
    int P) {
  const size_t n = static_cast<size_t>(N) * D;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int r = static_cast<int>(idx / D);
  const int d = static_cast<int>(idx - static_cast<size_t>(r) * D);
  const float wt = g_num[0] * wts[r] * (expf(tl[r] - lse[r]) - 1.0f);
  float acc = 0.0f;
  for (int p = 0; p < P; ++p) acc += dq_part[p * n + idx];
  const size_t row = static_cast<size_t>(r);
  dq[idx] = wt * vt[row * Dt + d] + acc;
  dvt[row * Dt + d] = wt * q[idx];
  if (d == 0) {
    if (Dt > D) dvt[row * Dt + D] = wt;
    dtl[r] = wt;
  }
}

// d(v_samp), d(c_samp) partials of one 64-column tile over the row tiles of
// row range blockIdx.y, into dvs_part [rs][S][D] and dcs_part [rs][S]
template <int NTD>
__global__ void __launch_bounds__(MW * 32, BWD_BLOCKS(NTD)) sampled_ce_bwd_cols_mma_kernel(
    const bf16* __restrict__ qb, const bf16* __restrict__ vb,
    const float* __restrict__ cs, const int* __restrict__ true_ids,
    const int* __restrict__ sampled_ids, const float* __restrict__ wts,
    const float* __restrict__ lse, const float* __restrict__ g_num,
    const float* __restrict__ qn, const float* __restrict__ vn,
    float* __restrict__ dvs_part, float* __restrict__ dcs_part, int N, int D,
    int S, int Dp, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Dp + PAD;
  bf16* v_s = reinterpret_cast<bf16*>(smem);                     // [TILE][ld]
  bf16* q_s = v_s + TILE * ld;                                   // [2][TILE][ld]
  float* lse_s = reinterpret_cast<float*>(q_s + 2 * TILE * ld);  // [2][TILE]
  float* gw_s = lse_s + 2 * TILE;                                // [2][TILE]
  int* tid_s = reinterpret_cast<int*>(gw_s + 2 * TILE);          // [2][TILE]
  float* qn_s = reinterpret_cast<float*>(tid_s + 2 * TILE);      // [2][TILE]
  float* res_s = qn_s + 2 * TILE;                                // [MW][32]

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * TILE;
  const int y = static_cast<int>(blockIdx.y);
  const int tile0 = y * per;
  const int n_tiles = min(per, cdiv(N, TILE) - tile0);
  const float gn = g_num[0];

  // rows past N: lse = +inf and g·w = 0, so their wp is exactly 0
  auto stage = [&](int it, int buf) {
    const int r0 = (tile0 + it) * TILE;
    load_tile_async(q_s + buf * TILE * ld, qb, r0, Dp);
    if (threadIdx.x < TILE) {
      const int i = r0 + threadIdx.x;
      const bool ok = i < N;
      lse_s[buf * TILE + threadIdx.x] = ok ? lse[i] : INFINITY;
      gw_s[buf * TILE + threadIdx.x] = ok ? gn * wts[i] : 0.0f;
      tid_s[buf * TILE + threadIdx.x] = ok ? true_ids[i] : -1;
      qn_s[buf * TILE + threadIdx.x] = ok ? qn[i] : 0.0f;
    }
  };
  load_tile_async(v_s, vb, col0, Dp);
  stage(0, 0);
  cp_async_commit();

  const int ca = col0 + 16 * w + g, cb = ca + 8;   // this thread's two columns
  const bool ok_a = ca < S, ok_b = cb < S;
  const int sid_a = ok_a ? sampled_ids[ca] : -1;
  const int sid_b = ok_b ? sampled_ids[cb] : -1;
  const float cs_a = ok_a ? cs[ca] : 0.0f, cs_b = ok_b ? cs[cb] : 0.0f;
  const float vn_a = ok_a ? vn[ca] : 0.0f, vn_b = ok_b ? vn[cb] : 0.0f;

  float dacc[NTD][4];
#pragma unroll
  for (int j = 0; j < NTD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dacc[j][e] = 0.0f;
  float db_a = 0.0f, db_b = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) stage(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const bf16* qt_s = q_s + buf * TILE * ld;
    float acc[8][4];                       // logitsᵀ: columns × rows
    tile_logits(v_s, qt_s, Dp, acc);
    uint32_t big = 0;                      // bit 4n+k: acc[n][k] is unsure
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = buf * TILE + 8 * n + 2 * t + e;
        const float l = lse_s[r], gw = gw_s[r], qnr = qn_s[r];
        const int tid = tid_s[r];
        const float xa = !ok_a ? -INFINITY : sid_a == tid ? NEG : acc[n][e] + cs_a;
        const float xb = !ok_b ? -INFINITY : sid_b == tid ? NEG : acc[n][2 + e] + cs_b;
        acc[n][e] = gw * __expf(xa - l);
        acc[n][2 + e] = gw * __expf(xb - l);
        const float cut = fabsf(gw) * (1.0f / 256), base = window_base(l);
        big |= unsure(acc[n][e], cut, fmaf(qnr, vn_a, base)) << (4 * n + e) |
               unsure(acc[n][2 + e], cut, fmaf(qnr, vn_b, base)) << (4 * n + 2 + e);
      }
    redo_flagged(acc, big, res_s + 32 * w, v_s, qt_s, ld, D, [&](int o, int bit) {
      // lane o's columns: their c_samp and sampled ids
      const float ca_o = __shfl_sync(0xffffffffu, cs_a, o), cb_o = __shfl_sync(0xffffffffu, cs_b, o);
      const int sa = __shfl_sync(0xffffffffu, sid_a, o), sb = __shfl_sync(0xffffffffu, sid_b, o);
      const bool hi = (bit & 3) >= 2;
      const int r = 8 * (bit >> 2) + 2 * (o & 3) + (bit & 1);
      return Redo{16 * w + (o >> 2) + (hi ? 8 : 0), r, hi ? cb_o : ca_o, gw_s[buf * TILE + r],
                  lse_s[buf * TILE + r], (hi ? sb : sa) == tid_s[buf * TILE + r]};
    });
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      db_a += acc[n][0] + acc[n][1];
      db_b += acc[n][2] + acc[n][3];
    }
    accum_product<NTD>(acc, qt_s, Dp, dacc);
    __syncthreads();
  }

  db_a = quad_sum(db_a);
  db_b = quad_sum(db_b);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = h ? cb : ca;
    if (!(h ? ok_b : ok_a)) continue;
    float* dv = dvs_part + (static_cast<size_t>(y) * S + c) * D;
#pragma unroll
    for (int j = 0; j < NTD; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * t + e;
        if (d < D) dv[d] = dacc[j][2 * h + e];
      }
    if (t == 0) dcs_part[static_cast<size_t>(y) * S + c] = h ? db_b : db_a;
  }
}

// ---------------------------------------------------------------- host ---

// byte offsets into the caller's scratch, each piece 256-byte aligned:
// f32, the forward's per-block sums or the backward's RS row ranges'
// partials; bf16, the bf16 copies of q and v_samp, the true logits, then
// the forward's per-range (max, sum) pairs and per-block sums or the
// backward's row norms of q and v_samp and its partials (dq of its column
// ranges, then d(v_samp), d(c_samp) of its row ranges, in one buffer)
struct Layout {
  size_t qb = 0, vb = 0, tl = 0, qn = 0, vn = 0, ms = 0, part = 0, cols = 0, total = 0;
  int Dp = 0, Np = 0, Sp = 0;
  Split split{1, 1};        // forward: column ranges; backward: row ranges
  Split col_split{1, 1};    // backward rows pass: column ranges
};
Layout layout(int N, int S, int D, bool bf16_mode, bool backward) {
  Layout L;
  auto take = [&](size_t bytes) {
    const size_t at = L.total;
    L.total += (bytes + 255) / 256 * 256;
    return at;
  };
  if (!bf16_mode) {
    if (backward)
      L.cols = take(sizeof(float) * RS * static_cast<size_t>(S) * (D + 1));
    else
      L.part = take(sizeof(float) * 2 * static_cast<size_t>(cdiv(N, NT)));
    return L;
  }
  L.Dp = round_up(D, KSTEP);
  L.Np = round_up(N, TILE);
  L.Sp = round_up(S, TILE);
  L.qb = take(sizeof(bf16) * static_cast<size_t>(L.Np) * L.Dp);
  L.vb = take(sizeof(bf16) * static_cast<size_t>(L.Sp) * L.Dp);
  L.tl = take(sizeof(float) * static_cast<size_t>(L.Np));
  if (backward) {
    L.qn = take(sizeof(float) * static_cast<size_t>(L.Np));
    L.vn = take(sizeof(float) * static_cast<size_t>(L.Sp));
    // the rows pass's dq partials, then (once added) the columns pass's
    L.col_split = make_split(L.Sp / TILE, L.Np / TILE);
    L.split = make_split(L.Np / TILE, L.Sp / TILE);
    const size_t rows = static_cast<size_t>(L.col_split.n) * N * D;
    const size_t cols = static_cast<size_t>(L.split.n) * S * (D + 1);
    L.cols = take(sizeof(float) * (rows > cols ? rows : cols));
  } else {
    L.split = make_split(L.Sp / TILE, L.Np / TILE);
    L.ms = take(sizeof(float2) * static_cast<size_t>(L.split.n) * L.Np);
    L.part = take(sizeof(float) * 2 * static_cast<size_t>(cdiv(N, MERGE_ROWS)));
  }
  return L;
}

// the backward's redo_flagged buffer is one side array of mma_smem
static_assert(MW * 32 == 2 * TILE, "redo_flagged's buffer is one side array");

cudaError_t prep(const float* q, const float* vt, const float* tl_base,
                 const float* vs, const Layout& L, void* scratch, int N, int S,
                 int D, int Dt, cudaStream_t st) {
  const int rows = L.Np + L.Sp;
  const bool norms = L.qn != L.vn;      // the backward's layout has them
  sampled_ce_prep_kernel<<<cdiv(rows, 8), 256, 0, st>>>(
      q, vt, tl_base, vs, at<bf16>(scratch, L.qb), at<bf16>(scratch, L.vb),
      at<float>(scratch, L.tl), norms ? at<float>(scratch, L.qn) : nullptr,
      norms ? at<float>(scratch, L.vn) : nullptr, N, S, D, Dt, L.Dp, L.Np, L.Sp);
  return cudaGetLastError();
}

cudaError_t fwd_f32(const float* q, const float* vt, const float* vs,
                    const float* cs, const float* tl_base, const int* tid,
                    const int* sid, const float* w, float* ce, float* lse,
                    float* sums, const Layout& L, void* scratch, int N, int D,
                    int Dt, int S, cudaStream_t st) {
  float* part = at<float>(scratch, L.part);
  const size_t smem = sizeof(float) * (static_cast<size_t>(NT + SC) * (D + 1) + 2 * NW * NT);
  cudaError_t e = set_smem(sampled_ce_fwd_kernel, smem);
  if (e != cudaSuccess) return e;
  const int blocks = cdiv(N, NT);
  sampled_ce_fwd_kernel<<<blocks, NW * 32, smem, st>>>(q, vt, vs, cs, tl_base, tid, sid,
                                                       w, ce, lse, part, N, D, Dt, S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sampled_ce_sums_reduce_kernel<<<1, 32, 0, st>>>(part, blocks, sums);
  return cudaGetLastError();
}

cudaError_t fwd_bf16(const float* q, const float* vt, const float* vs,
                     const float* cs, const float* tl_base, const int* tid,
                     const int* sid, const float* w, float* ce, float* lse,
                     float* sums, const Layout& L, void* scratch, int N, int D,
                     int Dt, int S, cudaStream_t st) {
  cudaError_t e = prep(q, vt, tl_base, vs, L, scratch, N, S, D, Dt, st);
  if (e != cudaSuccess) return e;
  const size_t smem = mma_smem(L.Dp, 2);
  e = set_smem(sampled_ce_fwd_mma_kernel, smem);
  if (e != cudaSuccess) return e;
  float2* ms = at<float2>(scratch, L.ms);
  const float* tl = at<float>(scratch, L.tl);
  sampled_ce_fwd_mma_kernel<<<dim3(L.Np / TILE, L.split.n), MW * 32, smem, st>>>(
      at<bf16>(scratch, L.qb), at<bf16>(scratch, L.vb), cs, tid, sid, tl, ms, N, S,
      L.Dp, L.Np, L.split.per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int blocks = cdiv(N, MERGE_ROWS);
  float* part = at<float>(scratch, L.part);
  sampled_ce_fwd_merge_kernel<<<blocks, MERGE_ROWS, 0, st>>>(ms, tl, w, ce, lse, part, N,
                                                             L.Np, L.split.n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sampled_ce_sums_reduce_kernel<<<1, 32, 0, st>>>(part, blocks, sums);
  return cudaGetLastError();
}

cudaError_t cols_reduce(const float* dvs_part, const float* dcs_part, float* dvs,
                        float* dcs, int S, int D, int rs, cudaStream_t st) {
  const size_t n = static_cast<size_t>(S) * (D + 1);
  sampled_ce_cols_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      dvs_part, dcs_part, dvs, dcs, S, D, rs);
  return cudaGetLastError();
}

cudaError_t bwd_f32(const float* q, const float* vt, const float* vs,
                    const float* cs, const float* tl_base, const int* tid,
                    const int* sid, const float* w, const float* lse,
                    const float* g_num, float* dq, float* dvt, float* dvs,
                    float* dcs, float* dtl, const Layout& L, void* scratch,
                    int N, int D, int Dt, int S, cudaStream_t st) {
  const size_t smem_rows = sizeof(float) * (static_cast<size_t>(NT + SC) * (D + 1) +
                                            NT * (SC + 1) + NW * NT);
  auto rows = D <= 16 * NW ? sampled_ce_bwd_rows_kernel<16>
                           : sampled_ce_bwd_rows_kernel<DMAX / NW>;
  cudaError_t e = set_smem(rows, smem_rows);
  if (e != cudaSuccess) return e;
  rows<<<cdiv(N, NT), NW * 32, smem_rows, st>>>(q, vt, vs, cs, tl_base, tid, sid, w, lse,
                                                g_num, dq, dvt, dtl, N, D, Dt, S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem_cols = sizeof(float) * (static_cast<size_t>(NT + SCB) * (D + 1) +
                                            NT * SCB + 3 * NT);
  e = set_smem(sampled_ce_bwd_cols_kernel, smem_cols);
  if (e != cudaSuccess) return e;
  const int split_rows = cdiv(cdiv(N, NT), RS) * NT;
  float* dvs_part = at<float>(scratch, L.cols);
  float* dcs_part = dvs_part + static_cast<size_t>(RS) * S * D;
  sampled_ce_bwd_cols_kernel<<<dim3(cdiv(S, SCB), RS), NW * 32, smem_cols, st>>>(
      q, vs, cs, tid, sid, w, lse, g_num, dvs_part, dcs_part, N, D, S, split_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return cols_reduce(dvs_part, dcs_part, dvs, dcs, S, D, RS, st);
}

template <int NTD>
cudaError_t bwd_bf16_tiles(const float* q, const float* vt, const float* cs,
                           const int* tid, const int* sid, const float* w,
                           const float* lse, const float* g_num, float* dq,
                           float* dvt, float* dvs, float* dcs, float* dtl,
                           const Layout& L, void* scratch, int N, int D, int Dt,
                           int S, cudaStream_t st) {
  const bf16* qb = at<bf16>(scratch, L.qb);
  const bf16* vb = at<bf16>(scratch, L.vb);
  const size_t smem_rows = mma_smem(L.Dp, 4);
  auto rows = sampled_ce_bwd_rows_mma_kernel<NTD>;
  cudaError_t e = set_smem(rows, smem_rows);
  if (e != cudaSuccess) return e;
  float* dq_part = at<float>(scratch, L.cols);
  const float* qn = at<float>(scratch, L.qn);
  const float* vn = at<float>(scratch, L.vn);
  rows<<<dim3(L.Np / TILE, L.col_split.n), MW * 32, smem_rows, st>>>(
      qb, vb, cs, tid, sid, w, lse, g_num, qn, vn, dq_part, N, D, S, L.Dp, L.col_split.per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t n = static_cast<size_t>(N) * D;
  sampled_ce_bwd_rows_combine_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                                       st>>>(dq_part, q, vt, at<float>(scratch, L.tl),
                                             lse, w, g_num, dq, dvt, dtl, N, D, Dt,
                                             L.col_split.n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem_cols = mma_smem(L.Dp, 5);
  auto cols = sampled_ce_bwd_cols_mma_kernel<NTD>;
  e = set_smem(cols, smem_cols);
  if (e != cudaSuccess) return e;
  float* dvs_part = at<float>(scratch, L.cols);
  float* dcs_part = dvs_part + static_cast<size_t>(L.split.n) * S * D;
  cols<<<dim3(L.Sp / TILE, L.split.n), MW * 32, smem_cols, st>>>(
      qb, vb, cs, tid, sid, w, lse, g_num, qn, vn, dvs_part, dcs_part, N, D, S, L.Dp,
      L.split.per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return cols_reduce(dvs_part, dcs_part, dvs, dcs, S, D, L.split.n, st);
}

cudaError_t bwd_bf16(const float* q, const float* vt, const float* vs,
                     const float* cs, const float* tl_base, const int* tid,
                     const int* sid, const float* w, const float* lse,
                     const float* g_num, float* dq, float* dvt, float* dvs,
                     float* dcs, float* dtl, const Layout& L, void* scratch,
                     int N, int D, int Dt, int S, cudaStream_t st) {
  cudaError_t e = prep(q, vt, tl_base, vs, L, scratch, N, S, D, Dt, st);
  if (e != cudaSuccess) return e;
  auto f = L.Dp <= 64 ? &bwd_bf16_tiles<8>
                      : L.Dp <= 128 ? &bwd_bf16_tiles<16> : &bwd_bf16_tiles<32>;
  return f(q, vt, cs, tid, sid, w, lse, g_num, dq, dvt, dvs, dcs, dtl, L, scratch, N, D,
           Dt, S, st);
}

bool dims_ok(int N, int S, int D, int Dt) {
  return N >= 1 && S >= 1 && D >= 1 && D <= DMAX && (Dt == D || Dt == D + 1);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Every pointer is a device pointer
// to a contiguous tensor (f32, ids int32); `scratch` is one device
// allocation of `scratch_bytes` bytes (at least what
// sampled_ce_scratch_bytes returns); `stream` is the caller's cudaStream_t.
// D ≤ 256 and Dt ∈ {D, D+1}; round_bf16 picks the tensor-core kernels (bf16
// operands) or the f32 ones. Each returns the first cudaError_t (0 = all
// launched), and cudaErrorInvalidValue, launching nothing, for dimensions
// it does not take or a scratch smaller than its layout.

// The scratch bytes one call takes, or −1 for dimensions the kernels do not
// take. Host only: it touches no device.
extern "C" long long sampled_ce_scratch_bytes(int N, int S, int D, int round_bf16,
                                              int backward) {
  if (!dims_ok(N, S, D, D)) return -1;
  return static_cast<long long>(layout(N, S, D, round_bf16 != 0, backward != 0).total);
}

extern "C" int sampled_ce_fwd(const void* q, const void* vt, const void* vs,
                              const void* cs, const void* tl_base,
                              const void* true_ids, const void* sampled_ids,
                              const void* w, void* ce, void* lse, void* sums,
                              void* scratch, int N, int D, int Dt, int S,
                              int round_bf16, long long scratch_bytes,
                              void* stream) {
  if (!dims_ok(N, S, D, Dt)) return cudaErrorInvalidValue;
  const Layout L = layout(N, S, D, round_bf16 != 0, false);
  if (scratch_bytes < 0 || static_cast<size_t>(scratch_bytes) < L.total)
    return cudaErrorInvalidValue;
  auto f = round_bf16 ? &fwd_bf16 : &fwd_f32;
  return static_cast<int>(f(
      static_cast<const float*>(q), static_cast<const float*>(vt),
      static_cast<const float*>(vs), static_cast<const float*>(cs),
      static_cast<const float*>(tl_base), static_cast<const int*>(true_ids),
      static_cast<const int*>(sampled_ids), static_cast<const float*>(w),
      static_cast<float*>(ce), static_cast<float*>(lse), static_cast<float*>(sums), L,
      scratch, N, D, Dt, S, static_cast<cudaStream_t>(stream)));
}

extern "C" int sampled_ce_bwd(const void* q, const void* vt, const void* vs,
                              const void* cs, const void* tl_base,
                              const void* true_ids, const void* sampled_ids,
                              const void* w, const void* lse,
                              const void* g_num, void* dq, void* dvt,
                              void* dvs, void* dcs, void* dtl, void* scratch,
                              int N, int D, int Dt, int S, int round_bf16,
                              long long scratch_bytes, void* stream) {
  if (!dims_ok(N, S, D, Dt)) return cudaErrorInvalidValue;
  const Layout L = layout(N, S, D, round_bf16 != 0, true);
  if (scratch_bytes < 0 || static_cast<size_t>(scratch_bytes) < L.total)
    return cudaErrorInvalidValue;
  auto f = round_bf16 ? &bwd_bf16 : &bwd_f32;
  return static_cast<int>(f(
      static_cast<const float*>(q), static_cast<const float*>(vt),
      static_cast<const float*>(vs), static_cast<const float*>(cs),
      static_cast<const float*>(tl_base), static_cast<const int*>(true_ids),
      static_cast<const int*>(sampled_ids), static_cast<const float*>(w),
      static_cast<const float*>(lse), static_cast<const float*>(g_num),
      static_cast<float*>(dq), static_cast<float*>(dvt), static_cast<float*>(dvs),
      static_cast<float*>(dcs), static_cast<float*>(dtl), L, scratch, N, D, Dt, S,
      static_cast<cudaStream_t>(stream)));
}

// What the tensor-core kernels launched for width D use, four ints each in
// `out` (registers per thread, local-memory bytes per thread, dynamic shared
// memory bytes per block, resident blocks per SM), in the order prep,
// fwd_mma, fwd_merge, bwd_rows_mma, bwd_rows_combine, bwd_cols_mma,
// cols_reduce: 28 ints.
extern "C" int sampled_ce_kernel_info(int D, int* out) {
  if (D < 1 || D > DMAX) return cudaErrorInvalidValue;
  const int Dp = round_up(D, KSTEP);
  const void* rows;
  const void* cols;
  if (Dp <= 64) {
    rows = reinterpret_cast<const void*>(sampled_ce_bwd_rows_mma_kernel<8>);
    cols = reinterpret_cast<const void*>(sampled_ce_bwd_cols_mma_kernel<8>);
  } else if (Dp <= 128) {
    rows = reinterpret_cast<const void*>(sampled_ce_bwd_rows_mma_kernel<16>);
    cols = reinterpret_cast<const void*>(sampled_ce_bwd_cols_mma_kernel<16>);
  } else {
    rows = reinterpret_cast<const void*>(sampled_ce_bwd_rows_mma_kernel<32>);
    cols = reinterpret_cast<const void*>(sampled_ce_bwd_cols_mma_kernel<32>);
  }
  struct K {
    const void* fn;
    size_t smem;
    int threads;
  } ks[7] = {{reinterpret_cast<const void*>(sampled_ce_prep_kernel), 0, 256},
             {reinterpret_cast<const void*>(sampled_ce_fwd_mma_kernel), mma_smem(Dp, 2),
              MW * 32},
             {reinterpret_cast<const void*>(sampled_ce_fwd_merge_kernel), 0, MERGE_ROWS},
             {rows, mma_smem(Dp, 4), MW * 32},
             {reinterpret_cast<const void*>(sampled_ce_bwd_rows_combine_kernel), 0, 256},
             {cols, mma_smem(Dp, 5), MW * 32},
             {reinterpret_cast<const void*>(sampled_ce_cols_reduce_kernel), 0, 256}};
  for (int k = 0; k < 7; ++k) {
    cudaError_t e = set_smem(ks[k].fn, ks[k].smem);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, ks[k].fn);
    if (e != cudaSuccess) return e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ks[k].fn, ks[k].threads,
                                                      ks[k].smem);
    if (e != cudaSuccess) return e;
    out[4 * k] = a.numRegs;
    out[4 * k + 1] = static_cast<int>(a.localSizeBytes);
    out[4 * k + 2] = static_cast<int>(ks[k].smem);
    out[4 * k + 3] = blocks;
  }
  return cudaSuccess;
}
