// batch_rank: the in-batch BPR loss of A-Recsys's batch-ranking MF (`bbpr`,
// Liu & Natarajan, AAAI'18), with or without arec's Horvitz–Thompson
// weights, fused, forward and backward.
//
// Replaces no TPU kernel: arec writes the in-batch losses in jnp
// (arec/losses/losses.py: batch_bpr_loss) and leaves them to XLA. The port's
// library ops (losses.batch_bpr_loss, which the mesh path and `mw` keep)
// make about ten [N, N] f32 tensors forward and keep them for the backward.
// Per row i of the N rows and in-batch column j (f32 in device memory, pos
// int32 and ≥ 0):
//   s_ij   = cast(q_i)·cast(v_j) + b_j   bf16 operands, products summed in f32
//   own_i  = s_ii                          (its sum taken in d order, prep pass)
//   live_ij: pos_j != pos_i                (every column of the row's own item
//                                           is masked, the diagonal with them)
//   ℓ_ij   = softplus(s_ij − own_i) = −log σ(own_i − s_ij)
//   no HT:  loss_i = Σ_live ℓ_ij / max(n_i, 1), n_i the row's live count
//   HT:     w_ij = (1 − pq_i) / (max(n_i, 1)·max(pq_j, 1e-12)), pq_j the
//           positive's probability under the empirical item distribution,
//           loss_i = Σ_live w_ij·ℓ_ij / max(Σ_live w_ij, 1e-12), taken as
//           a_i·Σ u_j·ℓ_ij / max(a_i·Σ u_j, 1e-12) with a_i = (1 − pq_i) /
//           max(n_i, 1) and u_j = 1 / max(pq_j, 1e-12)
// The forward writes loss [N], and for the backward rs_i (the row's scale:
// a_i / max(a_i·Σ u_j, 1e-12), or 1 / max(n_i, 1)) and T_i = Σ_live u_j·
// σ(s_ij − own_i) (u ≡ 1 without HT). The backward takes the rows'
// cotangents g [N]; with P = ∂L/∂s,
//   P_ij = g_i·rs_i·u_j·σ(s_ij − own_i) on live pairs, −g_i·rs_i·T_i on the
//          diagonal (own_i's share), 0 elsewhere
//   dq_i = bf16(Σ_j P_ij·cast(v_j)), dv_j = bf16(Σ_i P_ij·cast(q_i)),
//   db_j = Σ_i P_ij
// dq and dv rounded to bf16 last, as the autodiff of the operands' cast
// gives them (tables/engine.mm_f32); db in f32. The scores never reach
// device memory: every pass recomputes its tile.
//
// What bounds it. At xing-mf's batch (N = 8192, D = 128) the bytes are ~8
// MB (q, v in; dq, dv out), a few µs of HBM time, and the N·N·D products are
// 17.2 GFLOP forward and 34.4 backward, 17 µs and 35 µs at the bf16
// tensor-core peak: the roofline says operations. In practice the passes
// are bound by the per-pair work beside the products (mask, exp, log1p or
// the reciprocal, ~30–50 instructions a pair against 256 tensor-core
// FLOPs), and the backward by its products of P, which run three times
// (below).
//
// What the design does about it: the sampled CE's passes (mma_tiles.cuh),
// with the batch's own positives as the N shared columns.
//  * A prep pass writes bf16 copies of q and v, zero-padded to whole 64-row
//    tiles and to a depth Dp that is a multiple of 16, own_i, and per
//    column b_j, u_j and pos_j (−1 past N, which masks the pad).
//  * Forward: a block keeps 64 rows of q and streams one of P ranges of v's
//    tiles. Each score tile gets b, the mask and the four row sums (Σ u·ℓ,
//    Σ u, Σ u·σ, the live count) in registers, reduced over each quad with
//    shuffles. A merge pass adds the P partials of a row in range order.
//    softplus and σ come from one accurate expf and log1pf a pair.
//  * Backward, rows (dq): per 64-row tile and one of P column ranges,
//    recompute the scores tile by tile, form P in f32 with the same expf,
//    and add its product with v's tile into dq on the tensor cores. A
//    combine pass adds the P partials in range order and rounds to bf16.
//  * Backward, columns (dv, db): a block keeps 64 columns and streams the
//    row tiles of one of RS row ranges: the transposed scores, P summed
//    into db in f32, and its product with q's tile into dv. A last pass
//    adds the RS partials in split order and rounds dv to bf16.
//  * P is f32 (the autodiff of mm_f32 gives an f32 product of an f32 P with
//    the bf16 operand); a bf16 P would be a lower precision than the
//    configuration states. So P is split into TERMS = 3 bf16 parts (each
//    the rounding of what the parts before it left, which is exact), one
//    product each into the same f32 accumulators: what the parts leave is
//    below 2^-24·|P|, an f32 rounding of P. The sum over j then errs as an
//    f32 sum does, by at most about N·2^-24·Σ_j|P_ij·v_jd| in another order
//    than another f32 product's, and a result that lies within that of a
//    bf16 rounding tie may round to the other neighbour: one bf16 ulp
//    (2^-8 of it) on that element. Two parts would leave 2^-16·|P|, which
//    moves 256 times as many elements across a tie.
//  No atomics: runs repeat bit for bit.
//
// Every entry point takes one scratch allocation and its size; the caller
// asks `batch_rank_scratch_bytes` how large it must be. An entry point handed
// less returns cudaErrorInvalidValue and launches nothing.

#include "mma_tiles.cuh"

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int DMAX = 256;        // widest D the kernels take
constexpr int TERMS = 3;         // bf16 parts of P in the backward's products
constexpr int MERGE_ROWS = 256;  // rows per block of the merge and combines

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// σ(y) from e = exp(−|y|)
__device__ __forceinline__ float sigma_of(float y, float e) {
  const float r = 1.0f / (1.0f + e);
  return y >= 0.0f ? r : e * r;
}

// one pair's share of its row's forward sums: y = s_ij − own_i
template <bool HT>
__device__ __forceinline__ void fwd_pair(float y, bool live, float u, float& sp, float& ws,
                                         float& sg, float& n) {
  const float e = expf(-fabsf(y));
  const float wt = live ? (HT ? u : 1.0f) : 0.0f;
  sp = fmaf(wt, fmaxf(y, 0.0f) + log1pf(e), sp);
  sg = fmaf(wt, sigma_of(y, e), sg);
  if (HT) ws += wt;
  n += live ? 1.0f : 0.0f;
}

// P of one pair: y = s_ij − own_i, pc and pr the column's and the row's
// positives, rg = g_i·rs_i, dg = −rg·T_i
template <bool HT>
__device__ __forceinline__ float pair_grad(float y, int pc, int pr, bool diag, float rg,
                                           float dg, float u) {
  const float e = expf(-fabsf(y));
  const float p = (HT ? rg * u : rg) * sigma_of(y, e);
  return diag ? dg : (pc >= 0 && pc != pr) ? p : 0.0f;
}

// a warp a row r < Np: bf16 copies of q and v [Np, Dp] (zero past N and D),
// own_r, pos_r (−1 past N), b_r and u_r (0 past N; u ≡ 1 without pq); with
// g (the backward), rg_r = g_r·rs_r and dg_r = −rg_r·T_r (0 past N)
__global__ void batch_rank_prep_kernel(
    const float* __restrict__ q, const float* __restrict__ v, const float* __restrict__ b,
    const int* __restrict__ pos, const float* __restrict__ pq, const float* __restrict__ g,
    const float* __restrict__ rs, const float* __restrict__ tsum, bf16* __restrict__ qb,
    bf16* __restrict__ vb, float* __restrict__ own, int* __restrict__ posp,
    float* __restrict__ bp, float* __restrict__ up, float* __restrict__ rg,
    float* __restrict__ dg, int N, int D, int Dp, int Np) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= Np) return;
  const bool ok = r < N;
  const size_t row = static_cast<size_t>(r);
  float dot = 0.0f;
  for (int d = lane; d < Dp; d += 32) {
    const bool in = ok && d < D;
    const bf16 xq = __float2bfloat16(in ? q[row * D + d] : 0.0f);
    const bf16 xv = __float2bfloat16(in ? v[row * D + d] : 0.0f);
    qb[row * Dp + d] = xq;
    vb[row * Dp + d] = xv;
    dot = fmaf(__bfloat162float(xq), __bfloat162float(xv), dot);
  }
  dot = warp_sum(dot);
  if (lane == 0) {
    own[r] = ok ? dot + b[r] : 0.0f;
    posp[r] = ok ? pos[r] : -1;
    bp[r] = ok ? b[r] : 0.0f;
    up[r] = !ok ? 0.0f : pq ? 1.0f / fmaxf(pq[r], 1e-12f) : 1.0f;
    if (g) {
      const float x = ok ? g[r] * rs[r] : 0.0f;
      rg[r] = x;
      dg[r] = ok ? -x * tsum[r] : 0.0f;
    }
  }
}

// one of P column ranges of a 64-row tile: each row's (Σ u·ℓ, Σ u, Σ u·σ,
// live count) over the range's live columns into part [P][Np]
template <bool HT>
__global__ void __launch_bounds__(MW * 32) batch_rank_fwd_kernel(
    const bf16* __restrict__ qb, const bf16* __restrict__ vb, const float* __restrict__ own,
    const int* __restrict__ posp, const float* __restrict__ bp, const float* __restrict__ up,
    float4* __restrict__ part, int Dp, int Np, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Dp + PAD;
  bf16* q_s = reinterpret_cast<bf16*>(smem);                    // [TILE][ld]
  bf16* v_s = q_s + TILE * ld;                                  // [2][TILE][ld]
  float* b_s = reinterpret_cast<float*>(v_s + 2 * TILE * ld);   // [2][TILE]
  float* u_s = b_s + 2 * TILE;                                  // [2][TILE]
  int* pos_s = reinterpret_cast<int*>(u_s + 2 * TILE);          // [2][TILE]

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int t = lane & 3;
  const int row0 = blockIdx.x * TILE;
  const int tile0 = blockIdx.y * per;
  const int n_tiles = min(per, Np / TILE - tile0);

  auto stage = [&](int it, int buf) {
    const int c0 = (tile0 + it) * TILE;
    load_tile_async(v_s + buf * TILE * ld, vb, c0, Dp);
    if (threadIdx.x < TILE) {
      b_s[buf * TILE + threadIdx.x] = bp[c0 + threadIdx.x];
      u_s[buf * TILE + threadIdx.x] = up[c0 + threadIdx.x];
      pos_s[buf * TILE + threadIdx.x] = posp[c0 + threadIdx.x];
    }
  };
  load_tile_async(q_s, qb, row0, Dp);
  stage(0, 0);
  cp_async_commit();

  const int ra = row0 + 16 * w + (lane >> 2), rb = ra + 8;   // this thread's two rows
  const float own_a = own[ra], own_b = own[rb];
  const int pos_a = posp[ra], pos_b = posp[rb];
  float sp_a = 0.0f, sp_b = 0.0f, ws_a = 0.0f, ws_b = 0.0f;
  float sg_a = 0.0f, sg_b = 0.0f, n_a = 0.0f, n_b = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) stage(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    float acc[8][4];
    tile_logits(q_s, v_s + buf * TILE * ld, Dp, acc);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = buf * TILE + 8 * n + 2 * t + e;
        const float bc = b_s[cc], uc = u_s[cc];
        const int pc = pos_s[cc];
        fwd_pair<HT>(acc[n][e] + bc - own_a, pc >= 0 && pc != pos_a, uc, sp_a, ws_a, sg_a,
                     n_a);
        fwd_pair<HT>(acc[n][2 + e] + bc - own_b, pc >= 0 && pc != pos_b, uc, sp_b, ws_b,
                     sg_b, n_b);
      }
    __syncthreads();
  }
  sp_a = quad_sum(sp_a);
  sp_b = quad_sum(sp_b);
  ws_a = quad_sum(ws_a);
  ws_b = quad_sum(ws_b);
  sg_a = quad_sum(sg_a);
  sg_b = quad_sum(sg_b);
  n_a = quad_sum(n_a);
  n_b = quad_sum(n_b);
  if (t == 0) {
    part[static_cast<size_t>(blockIdx.y) * Np + ra] = make_float4(sp_a, ws_a, sg_a, n_a);
    part[static_cast<size_t>(blockIdx.y) * Np + rb] = make_float4(sp_b, ws_b, sg_b, n_b);
  }
}

// each row's sums from its P range partials, added in range order → loss,
// rs, T (pq null: no HT weights)
__global__ void batch_rank_merge_kernel(const float4* __restrict__ part,
                                        const float* __restrict__ pq, float* __restrict__ loss,
                                        float* __restrict__ rs, float* __restrict__ tsum, int N,
                                        int Np, int P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float sp = 0.0f, ws = 0.0f, sg = 0.0f, n = 0.0f;
  for (int p = 0; p < P; ++p) {
    const float4 x = part[static_cast<size_t>(p) * Np + i];
    sp += x.x;
    ws += x.y;
    sg += x.z;
    n += x.w;
  }
  if (pq) {
    const float a = (1.0f - pq[i]) / fmaxf(n, 1.0f);
    const float den = fmaxf(a * ws, 1e-12f);
    loss[i] = a * sp / den;
    rs[i] = a / den;
  } else {
    const float den = fmaxf(n, 1.0f);
    loss[i] = sp / den;
    rs[i] = 1.0f / den;
  }
  tsum[i] = sg;
}

// Σ_j P_ij·cast(v_j) of one 64-row tile over the column tiles of range
// blockIdx.y, into dq_part [P][N][D]. NTD: 8-lane tiles of dq per warp row
// (Dp ≤ 8·NTD)
template <int NTD, bool HT>
__global__ void __launch_bounds__(MW * 32, BWD_BLOCKS(NTD)) batch_rank_bwd_rows_kernel(
    const bf16* __restrict__ qb, const bf16* __restrict__ vb, const float* __restrict__ own,
    const int* __restrict__ posp, const float* __restrict__ bp, const float* __restrict__ up,
    const float* __restrict__ rg, const float* __restrict__ dg, float* __restrict__ dq_part,
    int N, int D, int Dp, int Np, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Dp + PAD;
  bf16* q_s = reinterpret_cast<bf16*>(smem);                    // [TILE][ld]
  bf16* v_s = q_s + TILE * ld;                                  // [2][TILE][ld]
  float* b_s = reinterpret_cast<float*>(v_s + 2 * TILE * ld);   // [2][TILE]
  float* u_s = b_s + 2 * TILE;                                  // [2][TILE]
  int* pos_s = reinterpret_cast<int*>(u_s + 2 * TILE);          // [2][TILE]

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int t = lane & 3;
  const int row0 = blockIdx.x * TILE;
  const int tile0 = blockIdx.y * per;
  const int n_tiles = min(per, Np / TILE - tile0);

  auto stage = [&](int it, int buf) {
    const int c0 = (tile0 + it) * TILE;
    load_tile_async(v_s + buf * TILE * ld, vb, c0, Dp);
    if (threadIdx.x < TILE) {
      b_s[buf * TILE + threadIdx.x] = bp[c0 + threadIdx.x];
      u_s[buf * TILE + threadIdx.x] = up[c0 + threadIdx.x];
      pos_s[buf * TILE + threadIdx.x] = posp[c0 + threadIdx.x];
    }
  };
  load_tile_async(q_s, qb, row0, Dp);
  stage(0, 0);
  cp_async_commit();

  const int ra = row0 + 16 * w + (lane >> 2), rb = ra + 8;   // this thread's two rows
  const float own_a = own[ra], own_b = own[rb];
  const int pos_a = posp[ra], pos_b = posp[rb];
  const float rg_a = rg[ra], rg_b = rg[rb], dg_a = dg[ra], dg_b = dg[rb];

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
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = 8 * n + 2 * t + e;
        const float bc = b_s[buf * TILE + cc], uc = u_s[buf * TILE + cc];
        const int pc = pos_s[buf * TILE + cc];
        acc[n][e] = pair_grad<HT>(acc[n][e] + bc - own_a, pc, pos_a, c0 + cc == ra, rg_a,
                                  dg_a, uc);
        acc[n][2 + e] = pair_grad<HT>(acc[n][2 + e] + bc - own_b, pc, pos_b, c0 + cc == rb,
                                      rg_b, dg_b, uc);
      }
    accum_product_split<NTD, TERMS>(acc, vt_s, Dp, dacc);
    __syncthreads();
  }

  // thread (g, t) holds lanes 8j+2t, 8j+2t+1 of rows ra, rb
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? rb : ra;
    if (r >= N) continue;
    float* out = dq_part + (static_cast<size_t>(blockIdx.y) * N + r) * D;
#pragma unroll
    for (int j = 0; j < NTD; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * t + e;
        if (d < D) out[d] = dacc[j][2 * h + e];
      }
  }
}

// dq = the P range partials [P][N][D] added in range order, rounded to bf16
__global__ void batch_rank_rows_combine_kernel(const float* __restrict__ dq_part,
                                               float* __restrict__ dq, int N, int D, int P) {
  const size_t n = static_cast<size_t>(N) * D;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = 0.0f;
  for (int p = 0; p < P; ++p) acc += dq_part[p * n + idx];
  dq[idx] = round_bf16(acc);
}

// Σ_i P_ij·cast(q_i) and Σ_i P_ij of one 64-column tile over the row tiles
// of row range blockIdx.y, into dv_part [RS][N][D] and db_part [RS][N]
template <int NTD, bool HT>
__global__ void __launch_bounds__(MW * 32, BWD_BLOCKS(NTD)) batch_rank_bwd_cols_kernel(
    const bf16* __restrict__ qb, const bf16* __restrict__ vb, const float* __restrict__ own,
    const int* __restrict__ posp, const float* __restrict__ bp, const float* __restrict__ up,
    const float* __restrict__ rg, const float* __restrict__ dg, float* __restrict__ dv_part,
    float* __restrict__ db_part, int N, int D, int Dp, int Np, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Dp + PAD;
  bf16* v_s = reinterpret_cast<bf16*>(smem);                     // [TILE][ld]
  bf16* q_s = v_s + TILE * ld;                                   // [2][TILE][ld]
  float* own_s = reinterpret_cast<float*>(q_s + 2 * TILE * ld);  // [2][TILE]
  float* rg_s = own_s + 2 * TILE;                                // [2][TILE]
  float* dg_s = rg_s + 2 * TILE;                                 // [2][TILE]
  int* pos_s = reinterpret_cast<int*>(dg_s + 2 * TILE);          // [2][TILE]

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int t = lane & 3;
  const int col0 = blockIdx.x * TILE;
  const int y = static_cast<int>(blockIdx.y);
  const int tile0 = y * per;
  const int n_tiles = min(per, Np / TILE - tile0);

  auto stage = [&](int it, int buf) {
    const int r0 = (tile0 + it) * TILE;
    load_tile_async(q_s + buf * TILE * ld, qb, r0, Dp);
    if (threadIdx.x < TILE) {
      own_s[buf * TILE + threadIdx.x] = own[r0 + threadIdx.x];
      rg_s[buf * TILE + threadIdx.x] = rg[r0 + threadIdx.x];
      dg_s[buf * TILE + threadIdx.x] = dg[r0 + threadIdx.x];
      pos_s[buf * TILE + threadIdx.x] = posp[r0 + threadIdx.x];
    }
  };
  load_tile_async(v_s, vb, col0, Dp);
  stage(0, 0);
  cp_async_commit();

  const int ca = col0 + 16 * w + (lane >> 2), cb = ca + 8;   // this thread's two columns
  const float b_a = bp[ca], b_b = bp[cb], u_a = up[ca], u_b = up[cb];
  const int pos_a = posp[ca], pos_b = posp[cb];

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
    float acc[8][4];                       // scoresᵀ: columns × rows
    tile_logits(v_s, qt_s, Dp, acc);
    const int r0 = (tile0 + it) * TILE;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rr = 8 * n + 2 * t + e;
        const float own_r = own_s[buf * TILE + rr];
        const float rg_r = rg_s[buf * TILE + rr], dg_r = dg_s[buf * TILE + rr];
        const int pr = pos_s[buf * TILE + rr];
        acc[n][e] = pair_grad<HT>(acc[n][e] + b_a - own_r, pos_a, pr, r0 + rr == ca, rg_r,
                                  dg_r, u_a);
        acc[n][2 + e] = pair_grad<HT>(acc[n][2 + e] + b_b - own_r, pos_b, pr, r0 + rr == cb,
                                      rg_r, dg_r, u_b);
      }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      db_a += acc[n][0] + acc[n][1];
      db_b += acc[n][2] + acc[n][3];
    }
    accum_product_split<NTD, TERMS>(acc, qt_s, Dp, dacc);
    __syncthreads();
  }

  db_a = quad_sum(db_a);
  db_b = quad_sum(db_b);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = h ? cb : ca;
    if (c >= N) continue;
    float* dv = dv_part + (static_cast<size_t>(y) * N + c) * D;
#pragma unroll
    for (int j = 0; j < NTD; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * t + e;
        if (d < D) dv[d] = dacc[j][2 * h + e];
      }
    if (t == 0) db_part[static_cast<size_t>(y) * N + c] = h ? db_b : db_a;
  }
}

// dv, db = the rs partials [rs][N][D], [rs][N] added in split order; dv
// rounded to bf16
__global__ void batch_rank_cols_reduce_kernel(const float* __restrict__ dv_part,
                                              const float* __restrict__ db_part,
                                              float* __restrict__ dv, float* __restrict__ db,
                                              int N, int D, int rs) {
  const size_t n = static_cast<size_t>(N) * D;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx < n) {
    float a = 0.0f;
    for (int r = 0; r < rs; ++r) a += dv_part[r * n + idx];
    dv[idx] = round_bf16(a);
  } else if (idx < n + N) {
    const size_t c = idx - n;
    float a = 0.0f;
    for (int r = 0; r < rs; ++r) a += db_part[r * static_cast<size_t>(N) + c];
    db[c] = a;
  }
}

// ---------------------------------------------------------------- host ---

// byte offsets into the caller's scratch, each piece 256-byte aligned: the
// bf16 copies of q and v, own, pos, b, u; the forward's per-range row sums,
// or the backward's rg, dg and partials (dq of its column ranges, then dv,
// db of its row ranges, in one buffer)
struct Layout {
  size_t qb = 0, vb = 0, own = 0, pos = 0, b = 0, u = 0, rg = 0, dg = 0, part = 0, total = 0;
  int Dp = 0, Np = 0;
  Split split{1, 1};        // forward: column ranges; backward: row ranges
  Split col_split{1, 1};    // backward rows pass: column ranges
};
Layout layout(int N, int D, bool backward) {
  Layout L;
  auto take = [&](size_t bytes) {
    const size_t at = L.total;
    L.total += (bytes + 255) / 256 * 256;
    return at;
  };
  L.Dp = round_up(D, KSTEP);
  L.Np = round_up(N, TILE);
  const size_t np = static_cast<size_t>(L.Np);
  L.qb = take(sizeof(bf16) * np * L.Dp);
  L.vb = take(sizeof(bf16) * np * L.Dp);
  L.own = take(sizeof(float) * np);
  L.pos = take(sizeof(int) * np);
  L.b = take(sizeof(float) * np);
  L.u = take(sizeof(float) * np);
  const int tiles = L.Np / TILE;
  L.split = make_split(tiles, tiles);
  if (backward) {
    L.rg = take(sizeof(float) * np);
    L.dg = take(sizeof(float) * np);
    L.col_split = make_split(tiles, tiles);
    const size_t rows = static_cast<size_t>(L.col_split.n) * N * D;
    const size_t cols = static_cast<size_t>(L.split.n) * N * (D + 1);
    L.part = take(sizeof(float) * (rows > cols ? rows : cols));
  } else {
    L.part = take(sizeof(float4) * L.split.n * np);
  }
  return L;
}

cudaError_t prep(const float* q, const float* v, const float* b, const int* pos,
                 const float* pq, const float* g, const float* rs, const float* tsum,
                 const Layout& L, void* scratch, int N, int D, cudaStream_t st) {
  const bool bwd = g != nullptr;
  batch_rank_prep_kernel<<<L.Np / 8, 256, 0, st>>>(
      q, v, b, pos, pq, g, rs, tsum, at<bf16>(scratch, L.qb), at<bf16>(scratch, L.vb),
      at<float>(scratch, L.own), at<int>(scratch, L.pos), at<float>(scratch, L.b),
      at<float>(scratch, L.u), bwd ? at<float>(scratch, L.rg) : nullptr,
      bwd ? at<float>(scratch, L.dg) : nullptr, N, D, L.Dp, L.Np);
  return cudaGetLastError();
}

template <bool HT>
cudaError_t fwd(const float* q, const float* v, const float* b, const int* pos,
                const float* pq, float* loss, float* rs, float* tsum, const Layout& L,
                void* scratch, int N, int D, cudaStream_t st) {
  cudaError_t e = prep(q, v, b, pos, pq, nullptr, nullptr, nullptr, L, scratch, N, D, st);
  if (e != cudaSuccess) return e;
  const size_t smem = mma_smem(L.Dp, 3);
  e = set_smem(batch_rank_fwd_kernel<HT>, smem);
  if (e != cudaSuccess) return e;
  float4* part = at<float4>(scratch, L.part);
  batch_rank_fwd_kernel<HT><<<dim3(L.Np / TILE, L.split.n), MW * 32, smem, st>>>(
      at<bf16>(scratch, L.qb), at<bf16>(scratch, L.vb), at<float>(scratch, L.own),
      at<int>(scratch, L.pos), at<float>(scratch, L.b), at<float>(scratch, L.u), part, L.Dp,
      L.Np, L.split.per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  batch_rank_merge_kernel<<<cdiv(N, MERGE_ROWS), MERGE_ROWS, 0, st>>>(part, pq, loss, rs, tsum,
                                                                      N, L.Np, L.split.n);
  return cudaGetLastError();
}

template <int NTD, bool HT>
cudaError_t bwd_tiles(float* dq, float* dv, float* db, const Layout& L, void* scratch, int N,
                      int D, cudaStream_t st) {
  const bf16* qb = at<bf16>(scratch, L.qb);
  const bf16* vb = at<bf16>(scratch, L.vb);
  const float* own = at<float>(scratch, L.own);
  const int* pos = at<int>(scratch, L.pos);
  const float* bp = at<float>(scratch, L.b);
  const float* up = at<float>(scratch, L.u);
  const float* rg = at<float>(scratch, L.rg);
  const float* dg = at<float>(scratch, L.dg);
  float* part = at<float>(scratch, L.part);
  const size_t smem_rows = mma_smem(L.Dp, 3);
  auto rows = batch_rank_bwd_rows_kernel<NTD, HT>;
  cudaError_t e = set_smem(rows, smem_rows);
  if (e != cudaSuccess) return e;
  rows<<<dim3(L.Np / TILE, L.col_split.n), MW * 32, smem_rows, st>>>(
      qb, vb, own, pos, bp, up, rg, dg, part, N, D, L.Dp, L.Np, L.col_split.per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t n = static_cast<size_t>(N) * D;
  batch_rank_rows_combine_kernel<<<static_cast<unsigned>((n + MERGE_ROWS - 1) / MERGE_ROWS),
                                   MERGE_ROWS, 0, st>>>(part, dq, N, D, L.col_split.n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem_cols = mma_smem(L.Dp, 4);
  auto cols = batch_rank_bwd_cols_kernel<NTD, HT>;
  e = set_smem(cols, smem_cols);
  if (e != cudaSuccess) return e;
  float* db_part = part + static_cast<size_t>(L.split.n) * N * D;
  cols<<<dim3(L.Np / TILE, L.split.n), MW * 32, smem_cols, st>>>(
      qb, vb, own, pos, bp, up, rg, dg, part, db_part, N, D, L.Dp, L.Np, L.split.per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  batch_rank_cols_reduce_kernel<<<static_cast<unsigned>((n + N + MERGE_ROWS - 1) / MERGE_ROWS),
                                  MERGE_ROWS, 0, st>>>(part, db_part, dv, db, N, D,
                                                       L.split.n);
  return cudaGetLastError();
}

template <bool HT>
cudaError_t bwd(float* dq, float* dv, float* db, const Layout& L, void* scratch, int N, int D,
                cudaStream_t st) {
  auto f = L.Dp <= 64 ? &bwd_tiles<8, HT>
                      : L.Dp <= 128 ? &bwd_tiles<16, HT> : &bwd_tiles<32, HT>;
  return f(dq, dv, db, L, scratch, N, D, st);
}

bool dims_ok(int N, int D) { return N >= 1 && D >= 1 && D <= DMAX; }

bool scratch_ok(long long bytes, const Layout& L) {
  return bytes >= 0 && static_cast<size_t>(bytes) >= L.total;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Every pointer is a device pointer
// to a contiguous tensor (f32, pos int32); `pq` is null without HT weights;
// `scratch` is one device allocation of `scratch_bytes` bytes (at least what
// batch_rank_scratch_bytes returns); `stream` is the caller's cudaStream_t.
// D ≤ 256. Each returns the first cudaError_t (0 = all launched), and
// cudaErrorInvalidValue, launching nothing, for dimensions it does not take
// or a scratch smaller than its layout.

// The scratch bytes one call takes, or −1 for dimensions the kernels do not
// take. Host only: it touches no device.
extern "C" long long batch_rank_scratch_bytes(int N, int D, int backward) {
  if (!dims_ok(N, D)) return -1;
  return static_cast<long long>(layout(N, D, backward != 0).total);
}

// q, v [N, D], b, pos, pq [N] → loss, rs, tsum [N]
extern "C" int batch_rank_fwd(const void* q, const void* v, const void* b, const void* pos,
                              const void* pq, void* loss, void* rs, void* tsum, void* scratch,
                              int N, int D, long long scratch_bytes, void* stream) {
  if (!dims_ok(N, D)) return cudaErrorInvalidValue;
  const Layout L = layout(N, D, false);
  if (!scratch_ok(scratch_bytes, L)) return cudaErrorInvalidValue;
  auto f = pq ? &fwd<true> : &fwd<false>;
  return static_cast<int>(f(static_cast<const float*>(q), static_cast<const float*>(v),
                            static_cast<const float*>(b), static_cast<const int*>(pos),
                            static_cast<const float*>(pq), static_cast<float*>(loss),
                            static_cast<float*>(rs), static_cast<float*>(tsum), L, scratch, N,
                            D, static_cast<cudaStream_t>(stream)));
}

// the forward's inputs, the rows' cotangents g and the forward's rs, tsum
// [N] → dq, dv [N, D], db [N]
extern "C" int batch_rank_bwd(const void* q, const void* v, const void* b, const void* pos,
                              const void* pq, const void* g, const void* rs, const void* tsum,
                              void* dq, void* dv, void* db, void* scratch, int N, int D,
                              long long scratch_bytes, void* stream) {
  if (!dims_ok(N, D)) return cudaErrorInvalidValue;
  const Layout L = layout(N, D, true);
  if (!scratch_ok(scratch_bytes, L)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = prep(static_cast<const float*>(q), static_cast<const float*>(v),
                       static_cast<const float*>(b), static_cast<const int*>(pos),
                       static_cast<const float*>(pq), static_cast<const float*>(g),
                       static_cast<const float*>(rs), static_cast<const float*>(tsum), L,
                       scratch, N, D, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto f = pq ? &bwd<true> : &bwd<false>;
  return static_cast<int>(f(static_cast<float*>(dq), static_cast<float*>(dv),
                            static_cast<float*>(db), L, scratch, N, D, st));
}

// What the kernels launched for width D (and HT weights or not) use, four
// ints each in `out` (registers per thread, local-memory bytes per thread,
// dynamic shared memory bytes per block, resident blocks per SM), in the
// order prep, fwd, merge, bwd_rows, rows_combine, bwd_cols, cols_reduce:
// 28 ints.
extern "C" int batch_rank_kernel_info(int D, int ht, int* out) {
  if (!dims_ok(1, D)) return cudaErrorInvalidValue;
  const int Dp = round_up(D, KSTEP);
  const void* rows;
  const void* cols;
  const void* fwd_k = ht ? reinterpret_cast<const void*>(batch_rank_fwd_kernel<true>)
                         : reinterpret_cast<const void*>(batch_rank_fwd_kernel<false>);
  if (Dp <= 64) {
    rows = ht ? reinterpret_cast<const void*>(batch_rank_bwd_rows_kernel<8, true>)
              : reinterpret_cast<const void*>(batch_rank_bwd_rows_kernel<8, false>);
    cols = ht ? reinterpret_cast<const void*>(batch_rank_bwd_cols_kernel<8, true>)
              : reinterpret_cast<const void*>(batch_rank_bwd_cols_kernel<8, false>);
  } else if (Dp <= 128) {
    rows = ht ? reinterpret_cast<const void*>(batch_rank_bwd_rows_kernel<16, true>)
              : reinterpret_cast<const void*>(batch_rank_bwd_rows_kernel<16, false>);
    cols = ht ? reinterpret_cast<const void*>(batch_rank_bwd_cols_kernel<16, true>)
              : reinterpret_cast<const void*>(batch_rank_bwd_cols_kernel<16, false>);
  } else {
    rows = ht ? reinterpret_cast<const void*>(batch_rank_bwd_rows_kernel<32, true>)
              : reinterpret_cast<const void*>(batch_rank_bwd_rows_kernel<32, false>);
    cols = ht ? reinterpret_cast<const void*>(batch_rank_bwd_cols_kernel<32, true>)
              : reinterpret_cast<const void*>(batch_rank_bwd_cols_kernel<32, false>);
  }
  struct K {
    const void* fn;
    size_t smem;
    int threads;
  } ks[7] = {{reinterpret_cast<const void*>(batch_rank_prep_kernel), 0, 256},
             {fwd_k, mma_smem(Dp, 3), MW * 32},
             {reinterpret_cast<const void*>(batch_rank_merge_kernel), 0, MERGE_ROWS},
             {rows, mma_smem(Dp, 3), MW * 32},
             {reinterpret_cast<const void*>(batch_rank_rows_combine_kernel), 0, MERGE_ROWS},
             {cols, mma_smem(Dp, 4), MW * 32},
             {reinterpret_cast<const void*>(batch_rank_cols_reduce_kernel), 0, MERGE_ROWS}};
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
