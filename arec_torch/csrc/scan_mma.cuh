// scan_mma.cuh: what the bf16 scans share. The copy and tensor-core
// primitives and the carry products (Wh's or Whᵀ's fragments in registers or
// in shared / global memory), used by all four; the backwards'
// (lstm_scan_bwd.cu, gru_scan_bwd.cu) gate pass, the general sweeps'
// shared-memory layout and the dWh pass; the forwards' (lstm_scan_fwd.cu,
// gru_scan_fwd.cu) shared-memory layout, step-input copies and m-tile
// products.
//
// Every product runs on the tensor cores: mma.sync m16n8k16, bf16 operands
// (rounded to nearest even, as the contract casts them), f32 accumulators.
// Shared rows are padded by 16 bytes, so the 8 rows one ldmatrix reads
// start in 8 different bank quads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int KSTEP = 16;      // the MMA's depth
constexpr int BT = 8;          // batch rows of a sweep CTA: the MMA's n
constexpr int MAX_WARPS = 16;  // warps of a sweep CTA (one 16-unit m-tile each, or more)
constexpr int ROWS = 64;       // rows of a gate-pass tile: 4 warps × 16
constexpr int COLS = 64;       // columns of a gate-pass tile and of a dWh tile
constexpr int DK = 64;         // rows n of a dWh chunk
constexpr int RS = 8;          // row ranges of the dWh pass, added in order
constexpr int PADB = 8;        // bf16 lanes of padding per shared row
constexpr int PADF = 4;        // f32 lanes of padding per shared row

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t{15}; }

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// σ and tanh of the bf16 forwards' serial steps: the hardware exp2
// (__expf) and a fast reciprocal (__fdividef), within a few f32 ulps of
// `sigmoid` and tanhf (tanh within a few units of 2^-24 absolute near 0):
// far below the bf16 rounding of h that each step's product sees, at a
// fraction of the instructions of expf and an IEEE division, which bound
// the step (chip_knockout.py).
__device__ __forceinline__ float fast_sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float fast_tanh(float x) { return 2.0f * fast_sigmoid(2.0f * x) - 1.0f; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy this thread issued has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// all but the newest group of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// lanes 0-15 give the addresses of the two matrices
__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a·b on the tensor cores: a 16×16 (row), b 16×8 (col), bf16; c f32
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  return bytes;
}

// ------------------------------------------------------------ gate pass ----
// A CTA of 4 warps owns a ROWS × COLS tile of the N × G gates: the q(a)
// rows of its ROWS rows and one W column tile in shared memory.

// dynamic shared memory of a gate-pass CTA at width H: the rows [ROWS][H +
// PADB] and the W column tile [H][COLS + PADB], bf16
__host__ __device__ constexpr size_t gates_smem(int H) {
  return (static_cast<size_t>(ROWS) * (H + PADB) + static_cast<size_t>(H) * (COLS + PADB)) *
         sizeof(bf16);
}

// s [ROWS][ld] ← cast(src rows r0.. of width H) to bf16, zero past N
__device__ __forceinline__ void load_rows_bf16(bf16* s, int ld, const float* __restrict__ src,
                                               int r0, int N, int H) {
  const int q = H / 4;
  for (int idx = threadIdx.x; idx < ROWS * q; idx += blockDim.x) {
    const int r = idx / q;
    const int c = 4 * (idx - r * q);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < N) v = *reinterpret_cast<const float4*>(src + static_cast<size_t>(r0 + r) * H + c);
    *reinterpret_cast<uint2*>(s + r * ld + c) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// s [K][COLS + PADB] ← W[:, c0 .. c0 + COLS) of the bf16 [K, G] matrix W
// (zero past G), by cp.async
__device__ __forceinline__ void load_w_tile_async(bf16* s, const bf16* __restrict__ W, int K,
                                                  int G, int c0) {
  for (int idx = threadIdx.x; idx < K * (COLS / 8); idx += blockDim.x) {
    const int k = idx / (COLS / 8);
    const int c = 8 * (idx - k * (COLS / 8));
    bf16* dst = s + k * (COLS + PADB) + c;
    if (c0 + c < G) {
      cp_async16(dst, W + static_cast<size_t>(k) * G + c0 + c);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// acc = the 16 × COLS product of this warp's rows 16w.. of a_s [ROWS][lda]
// with w_s [K][COLS + PADB] over k < K: acc[nt] is the m16n8 accumulator of
// columns 8nt..8nt+7 (thread (g, t) holds rows g, g+8 and columns 2t, 2t+1)
__device__ __forceinline__ void tile_product(const bf16* a_s, int lda, const bf16* w_s, int K,
                                             float acc[8][4]) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  constexpr int ldw = COLS + PADB;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  // A by rows: lanes 0-15 address rows 0-15 at k, lanes 16-31 at k+8
  const bf16* a_p = a_s + (16 * w + (lane & 15)) * lda + (lane >> 4) * 8;
  // B stored [k][n], transposed: matrices (k 0-7, n), (k 8-15, n), (k 0-7,
  // n+8), (k 8-15, n+8): the b0 b1 of two n-tiles
  const bf16* b_p = w_s + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ldw + ((lane >> 4) << 3);
  for (int k = 0; k < K; k += KSTEP) {
    uint32_t a[4];
    ldsm_x4(a, a_p + k);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t b[4];
      ldsm_x4_trans(b, b_p + k * ldw + 16 * jj);
      mma_bf16(acc[2 * jj], a, b[0], b[1]);
      mma_bf16(acc[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// Stage 1 of both backwards, one tile: stash[n][c] = act(xw[n][c] +
// Σ_k q(a[n][k])·Wh[k][c]) for the ROWS rows n of tile blockIdx.x and the
// COLS columns from c_begin + COLS·blockIdx.y (those below c_end), act =
// tanh on columns [tanh_lo, tanh_hi) and σ elsewhere; xw, a [N, H] f32,
// Wh [H, G] bf16. With RH (the GRU's r|u launch, a = hp), an r column
// c < H also writes rh[n][c] = q(σ·hp[n][c]). Each thread loads its xw
// (and hp) values first, so their latency hides behind the copies and the
// products.
template <bool RH>
__global__ void __launch_bounds__(128) gates_kernel(
    const float* __restrict__ xw, const bf16* __restrict__ wh, const float* __restrict__ a,
    float* __restrict__ stash, float* __restrict__ rh, int N, int H, int G, int c_begin,
    int c_end, int tanh_lo, int tanh_hi) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = H + PADB;
  bf16* a_s = reinterpret_cast<bf16*>(smem);   // [ROWS][lda] q(a)
  bf16* w_s = a_s + ROWS * lda;                // [H][COLS + PADB]
  const int r0 = blockIdx.x * ROWS;
  const int c0 = c_begin + blockIdx.y * COLS;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  load_w_tile_async(w_s, wh, H, G, c0);
  cp_async_commit();
  float2 x[8][2], hv[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = r0 + 16 * w + (lane >> 2) + 8 * h;
      const int c = c0 + 8 * nt + 2 * (lane & 3);   // c, c+1 lie in one gate
      const bool ok = n < N && c < c_end;
      x[nt][h] = ok ? *reinterpret_cast<const float2*>(xw + static_cast<size_t>(n) * G + c)
                    : make_float2(0.0f, 0.0f);
      if (RH)
        hv[nt][h] = ok && c < H
                        ? *reinterpret_cast<const float2*>(a + static_cast<size_t>(n) * H + c)
                        : make_float2(0.0f, 0.0f);
    }
  load_rows_bf16(a_s, lda, a, r0, N, H);
  cp_async_wait_all();
  __syncthreads();
  float acc[8][4];
  tile_product(a_s, lda, w_s, H, acc);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = r0 + 16 * w + (lane >> 2) + 8 * h;
      const int c = c0 + 8 * nt + 2 * (lane & 3);
      if (n >= N || c >= c_end) continue;
      const float v0 = x[nt][h].x + acc[nt][2 * h];
      const float v1 = x[nt][h].y + acc[nt][2 * h + 1];
      const bool th = c >= tanh_lo && c < tanh_hi;
      const float2 y = th ? make_float2(tanhf(v0), tanhf(v1))
                          : make_float2(sigmoid(v0), sigmoid(v1));
      if (RH && c < H)
        *reinterpret_cast<float2*>(rh + static_cast<size_t>(n) * H + c) =
            make_float2(round_bf16(y.x * hv[nt][h].x), round_bf16(y.y * hv[nt][h].y));
      *reinterpret_cast<float2*>(stash + static_cast<size_t>(n) * G + c) = y;
    }
}

// one gate-pass launch over the columns [c_begin, c_end) of all N rows,
// writing rh too where it is given
cudaError_t launch_gates(const float* xw, const bf16* wh, const float* a, float* stash,
                         float* rh, int N, int H, int G, int c_begin, int c_end, int tanh_lo,
                         int tanh_hi, cudaStream_t s) {
  const size_t smem = gates_smem(H);
  auto kernel = rh != nullptr ? gates_kernel<true> : gates_kernel<false>;
  cudaError_t e = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(cdiv(N, ROWS), cdiv(c_end - c_begin, COLS));
  kernel<<<grid, 128, smem, s>>>(xw, wh, a, stash, rh, N, H, G, c_begin, c_end, tanh_lo,
                                 tanh_hi);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- sweep ----
// A CTA owns BT batch rows for the whole reverse sweep. Dynamic shared
// memory, in bytes from its start: Wh [H][G + PADB] bf16 (the general
// sweep, when it fits), `nqd` buffers of the cast derivatives [BT][G +
// PADB] bf16 (the carry product's B operand), `nbuf` buffers of the
// prefetched step inputs (the stashed gates [BT][G + PADF], two [BT][H +
// PADF] per-step inputs, the mask [BT]) and `nstate` [BT][H + PADF] f32
// states (the general sweep's).
struct Sweep {
  size_t w, qd, g, x, o, m, s, total;
};

__host__ __device__ constexpr Sweep sweep_layout(int H, int G, bool w_smem, int nqd, int nbuf,
                                                 int nstate) {
  const size_t w = w_smem ? align16(static_cast<size_t>(H) * (G + PADB) * sizeof(bf16)) : 0;
  const size_t qd = nqd * align16(static_cast<size_t>(BT) * (G + PADB) * sizeof(bf16));
  const size_t g = nbuf * static_cast<size_t>(BT) * (G + PADF) * sizeof(float);
  const size_t x = nbuf * static_cast<size_t>(BT) * (H + PADF) * sizeof(float);
  const size_t m = align16(nbuf * BT * sizeof(float));
  const size_t st = nstate * static_cast<size_t>(BT) * (H + PADF) * sizeof(float);
  return Sweep{0, w, w + qd, w + qd + g, w + qd + g + x, w + qd + g + 2 * x,
               w + qd + g + 2 * x + m, w + qd + g + 2 * x + m + st};
}

// the general sweeps' layout: Wh in shared memory when `w_smem`, one
// buffer of the derivatives, two of the inputs, three states
__host__ __device__ constexpr Sweep general_layout(int H, int G, bool w_smem) {
  return sweep_layout(H, G, w_smem, 1, 2, 3);
}

// the register-resident sweeps' layout: two buffers of the derivatives
// (one per step parity), three of the inputs (copied two steps ahead)
__host__ __device__ constexpr Sweep reg_layout(int H, int G) {
  return sweep_layout(H, G, false, 2, 3, 0);
}

// Zero the shared bytes [from, total), and start the copy of the bf16
// matrix w [rows, cols] into w_s (row stride cols + PADB) when w_s is given
// (completed by the caller's cp_async_wait_*).
__device__ __forceinline__ void smem_init(unsigned char* smem, size_t from, size_t total,
                                          bf16* w_s, const bf16* __restrict__ w, int rows,
                                          int cols) {
  for (size_t i = from / 16 + threadIdx.x; i < total / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (w_s != nullptr) {
    const int chunks = cols / 8;
    for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
      const int k = idx / chunks;
      const int c = 8 * (idx - k * chunks);
      cp_async16(w_s + k * (cols + PADB) + c, w + static_cast<size_t>(k) * cols + c);
    }
  }
}

// Zero every buffer but Wh, and start the copy of Wh [H, G] into shared
// memory when it is there.
__device__ __forceinline__ void sweep_init(unsigned char* smem, const Sweep& l,
                                           const bf16* __restrict__ wh, int H, int G) {
  smem_init(smem, l.qd, l.total, l.qd > 0 ? reinterpret_cast<bf16*>(smem + l.w) : nullptr, wh,
            H, G);
}

// Start the copies of step t's inputs for the CTA's rows b0.. (nrows of
// them) into buffer `buf`: the stashed gates [G] of each row, x[t] and
// o[t] [H], mask[:, t]. Rows past the batch are never loaded (they stay 0).
__device__ __forceinline__ void sweep_prefetch(unsigned char* smem, const Sweep& l, int buf,
                                               int t, const float* __restrict__ stash,
                                               const float* __restrict__ x,
                                               const float* __restrict__ o,
                                               const float* __restrict__ mask, int b0,
                                               int nrows, int L, int B, int H, int G) {
  float* g_s = reinterpret_cast<float*>(smem + l.g) + buf * BT * (G + PADF);
  float* x_s = reinterpret_cast<float*>(smem + l.x) + buf * BT * (H + PADF);
  float* o_s = reinterpret_cast<float*>(smem + l.o) + buf * BT * (H + PADF);
  float* m_s = reinterpret_cast<float*>(smem + l.m) + buf * BT;
  const size_t row0 = static_cast<size_t>(t) * B + b0;
  const int gq = G / 4, hq = H / 4;
  for (int idx = threadIdx.x; idx < nrows * gq; idx += blockDim.x) {
    const int r = idx / gq;
    const int c = 4 * (idx - r * gq);
    cp_async16(g_s + r * (G + PADF) + c, stash + (row0 + r) * G + c);
  }
  for (int idx = threadIdx.x; idx < nrows * hq; idx += blockDim.x) {
    const int r = idx / hq;
    const int c = 4 * (idx - r * hq);
    cp_async16(x_s + r * (H + PADF) + c, x + (row0 + r) * H + c);
    cp_async16(o_s + r * (H + PADF) + c, o + (row0 + r) * H + c);
  }
  if (static_cast<int>(threadIdx.x) < nrows)
    cp_async4(m_s + threadIdx.x, mask + static_cast<size_t>(b0 + threadIdx.x) * L + t);
}

// One k-step of the carry product: c += W[rows of a_p's m-tile][k..k+16) ·
// qd[b][k..k+16)ᵀ. a_p, b_p: the lane's addresses (see carry_product).
template <bool W_SMEM>
__device__ __forceinline__ void carry_step(const bf16* a_p, int ldw, const bf16* b_p, int k,
                                           float c[4]) {
  uint32_t a[4], b[2];
  if constexpr (W_SMEM) {
    ldsm_x4(a, a_p + k);
  } else {
    a[0] = ldg32(a_p + k);
    a[1] = ldg32(a_p + 8 * ldw + k);
    a[2] = ldg32(a_p + k + 8);
    a[3] = ldg32(a_p + 8 * ldw + k + 8);
  }
  ldsm_x2(b, b_p + k);
  mma_bf16(c, a, b[0], b[1]);
}

// The transposed carry product of this warp's m-tile: acc[e] = Σ_{k < K}
// W[row0 + m][kw0 + k] · qd_s[b][kq0 + k] for the thread's (m, b) of the
// m16n8 accumulator (rows g, g+8 are units, columns 2t, 2t+1 batch rows).
// W is Wh [H][ldw] in shared memory (W_SMEM) or in global memory. Two
// accumulators take alternate k-steps and are added last.
template <bool W_SMEM>
__device__ __forceinline__ void carry_product(const bf16* W, int ldw, int row0, int kw0,
                                              const bf16* qd_s, int ldq, int kq0, int K,
                                              float acc[4]) {
  const int lane = threadIdx.x & 31;
  const bf16* a_p = W_SMEM ? W + (row0 + (lane & 15)) * ldw + kw0 + (lane >> 4) * 8
                           : W + static_cast<size_t>(row0 + (lane >> 2)) * ldw + kw0 +
                                 2 * (lane & 3);
  // B stored [n = b][k]: matrices (n 0-7, k), (n 0-7, k+8) give b0, b1
  const bf16* b_p = qd_s + (lane & 7) * ldq + kq0 + ((lane >> 3) & 1) * 8;
  float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int k = 0;
  for (; k + 2 * KSTEP <= K; k += 2 * KSTEP) {
    carry_step<W_SMEM>(a_p, ldw, b_p, k, c0);
    carry_step<W_SMEM>(a_p, ldw, b_p, k + KSTEP, c1);
  }
  if (k < K) carry_step<W_SMEM>(a_p, ldw, b_p, k, c0);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = c0[e] + c1[e];
}

// The scans at the configs' widths (H = 64, 128) keep their weight in
// registers: a[ks] is the m16n8k16 A fragment of rows row0..row0+15 and
// columns 16ks..16ks+15 of the bf16 matrix w (row stride ld), loaded once:
// Wh [H, G] in the sweeps (rows are this warp's units), Whᵀ [G, H] in the
// forwards (rows are one gate block's columns for this warp's units).
template <int KS>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[KS][4], const bf16* __restrict__ w,
                                             int ld, int row0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = w + static_cast<size_t>(row0 + (lane >> 2)) * ld + 2 * (lane & 3);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    a[ks][0] = ldg32(p + KSTEP * ks);
    a[ks][1] = ldg32(p + 8 * ld + KSTEP * ks);
    a[ks][2] = ldg32(p + KSTEP * ks + 8);
    a[ks][3] = ldg32(p + 8 * ld + KSTEP * ks + 8);
  }
}

// carry_product with Wh's fragments in registers, over the k-steps
// [KS0, KS0 + NKS) (NKS even): acc[e] = Σ_k W[unit][k]·qd[b][k] at the
// thread's accumulator positions; qd [BT][ldq] in shared memory, one
// ldmatrix.x4 per two k-steps, issued a pair ahead of its products; four
// accumulators, added last.
template <int KS0, int NKS, int KS>
__device__ __forceinline__ void carry_product_reg(const uint32_t (&a)[KS][4], const bf16* qd,
                                                  int ldq, float acc[4]) {
  static_assert(NKS % 2 == 0 && KS0 + NKS <= KS, "k-steps in pairs, inside the fragments");
  const int lane = threadIdx.x & 31;
  // B stored [n = b][k]: matrices (n 0-7, k), (k+8), (k+16), (k+24) give
  // the b0 b1 of two k-steps
  const bf16* b_p = qd + (lane & 7) * ldq + KS0 * KSTEP + (lane >> 3) * 8;
  float c[4][4] = {};
  uint32_t b[2][4];
  ldsm_x4(b[0], b_p);
#pragma unroll
  for (int i = 0; i < NKS; i += 2) {
    const int cur = (i / 2) & 1;
    if (i + 2 < NKS) ldsm_x4(b[cur ^ 1], b_p + (i + 2) * KSTEP);
    mma_bf16(c[i & 3], a[KS0 + i], b[cur][0], b[cur][1]);
    mma_bf16(c[(i + 1) & 3], a[KS0 + i + 1], b[cur][2], b[cur][3]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = (c[0][e] + c[1][e]) + (c[2][e] + c[3][e]);
}

// ------------------------------------------------------------- forwards ----
// A forward CTA owns BT batch rows for the whole sequence. Dynamic shared
// memory, in bytes from its start: Whᵀ [G][H + PADB] bf16 (the general
// kernels, when it fits), `nq` buffers [BT][H + PADB] bf16 of the step
// products' B operands (q(h); the GRU's q(r⊙h)), NBUF buffers of the step
// inputs (xw[t]'s rows [BT][G + PADF] and the mask [BT], f32) and `nstate`
// [BT][H + PADF] f32 states (the general kernels').
constexpr int NBUF = 3;   // step inputs are copied in two steps ahead

struct Fwd {
  size_t w, q, x, m, s, total;
};

__host__ __device__ constexpr Fwd fwd_layout(int H, int G, bool w_smem, int nq, int nstate) {
  const size_t w = w_smem ? align16(static_cast<size_t>(G) * (H + PADB) * sizeof(bf16)) : 0;
  const size_t q = nq * align16(static_cast<size_t>(BT) * (H + PADB) * sizeof(bf16));
  const size_t x = NBUF * static_cast<size_t>(BT) * (G + PADF) * sizeof(float);
  const size_t m = align16(NBUF * BT * sizeof(float));
  const size_t s = nstate * static_cast<size_t>(BT) * (H + PADF) * sizeof(float);
  return Fwd{0, w, w + q, w + q + x, w + q + x + m, w + q + x + m + s};
}

// Start the copies of step t's inputs for the CTA's rows b0.. (nrows of
// them) into buffer `buf`: xw[t]'s rows [G] and mask[:, t]. Rows past the
// batch are never loaded (they stay 0).
__device__ __forceinline__ void fwd_prefetch(unsigned char* smem, const Fwd& l, int buf, int t,
                                             const float* __restrict__ xw,
                                             const float* __restrict__ mask, int b0, int nrows,
                                             int L, int B, int G) {
  float* x_s = reinterpret_cast<float*>(smem + l.x) + buf * BT * (G + PADF);
  float* m_s = reinterpret_cast<float*>(smem + l.m) + buf * BT;
  const float* src = xw + (static_cast<size_t>(t) * B + b0) * G;
  const int gq = G / 4;
  for (int idx = threadIdx.x; idx < nrows * gq; idx += blockDim.x) {
    const int r = idx / gq;
    const int c = 4 * (idx - r * gq);
    cp_async16(x_s + r * (G + PADF) + c, src + static_cast<size_t>(r) * G + c);
  }
  if (static_cast<int>(threadIdx.x) < nrows)
    cp_async4(m_s + threadIdx.x, mask + static_cast<size_t>(b0 + threadIdx.x) * L + t);
}

// b[i] holds the B fragments (b0 b1 of k-step 2i, then b0 b1 of k-step
// 2i+1) of a product over k < 16·KS with B = q [BT][ldq] (stored [n][k]) in
// shared memory: one ldmatrix.x4 per two k-steps, all issued together.
template <int KS>
__device__ __forceinline__ void load_b_frags(uint32_t (&b)[KS / 2][4], const bf16* q, int ldq) {
  static_assert(KS % 2 == 0, "k-steps in pairs");
  const int lane = threadIdx.x & 31;
  const bf16* p = q + (lane & 7) * ldq + (lane >> 3) * 8;
#pragma unroll
  for (int i = 0; i < KS / 2; ++i) ldsm_x4(b[i], p + 2 * KSTEP * i);
}

// acc[m] = the m16n8 product over k < 16·KS of the register A fragments of
// m-tile M0 + m by the B fragments b, for the NM m-tiles; their chains are
// interleaved (a lone m-tile's in two, even and odd k-steps, added last),
// each summed in k order.
template <int M0, int NM, int MA, int KS>
__device__ __forceinline__ void mtile_products(const uint32_t (&a)[MA][KS][4],
                                               const uint32_t (&b)[KS / 2][4],
                                               float (&acc)[NM][4]) {
  static_assert(M0 + NM <= MA, "m-tiles inside the fragments");
  constexpr int NC = NM < 2 ? 2 : 1;   // chains an m-tile is split into
  float c[NM][NC][4] = {};
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int m = 0; m < NM; ++m)
      mma_bf16(c[m][ks % NC], a[M0 + m][ks], b[ks / 2][2 * (ks & 1)], b[ks / 2][2 * (ks & 1) + 1]);
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = NC == 2 ? c[m][0][e] + c[m][NC - 1][e] : c[m][0][e];
}

// How a bf16 forward launches at width H: its kernel, threads, dynamic
// shared memory and whether Whᵀ sits in shared memory (the general kernel)
struct FwdPlan {
  const void* fn;
  int threads;
  size_t smem;
  bool w_smem;
};

// the plan of the general kernel `fn(w_smem)` at width H with `nq` B
// buffers and `nstate` states: Whᵀ in shared memory when it fits beside
// them; false where even the buffers do not fit
template <typename Fn>
bool plan_general(int H, int G, int nq, int nstate, Fn fn, FwdPlan* p) {
  const size_t limit = static_cast<size_t>(smem_optin());
  p->w_smem = fwd_layout(H, G, true, nq, nstate).total <= limit;
  p->smem = fwd_layout(H, G, p->w_smem, nq, nstate).total;
  p->fn = fn(p->w_smem);
  p->threads = (H / 16 < MAX_WARPS ? H / 16 : MAX_WARPS) * 32;
  return p->smem <= limit;
}

// launch the planned forward over cdiv(B, BT) CTAs with `args` (pointers
// to the kernel's arguments)
cudaError_t launch_fwd(const FwdPlan& p, int B, void** args, cudaStream_t s) {
  cudaError_t e = set_smem(p.fn, p.smem);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernel(p.fn, dim3(cdiv(B, BT)), dim3(p.threads), args, p.smem, s);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// ------------------------------------------------------------------ dWh ----
// part[z][i][c] = Σ_n q(a[n][i]) · q(d[n][c]) over the rows n of split z
// (the N rows cut into RS contiguous ranges of `split`), for i < H and the
// columns c of one COLS-wide tile; a is a0 for the columns below csplit,
// a1 above (tiles never straddle csplit). A CTA of 4 warps owns a 64 × 64
// tile (warp w its rows 16w..16w+15) and walks its range in chunks of DK
// rows, cast to bf16 as they are staged, the next chunk's loads in flight
// in registers during this chunk's products. Each output sums its terms in
// one fixed order and the partials are added in split order: no atomics.
__global__ void __launch_bounds__(128) dwh_mma_kernel(const float* __restrict__ a0,
                                                      const float* __restrict__ a1,
                                                      const float* __restrict__ d,
                                                      float* __restrict__ part, int N, int H,
                                                      int G, int csplit, int split) {
  __shared__ __align__(16) bf16 a_s[DK][COLS + PADB];   // [n][i]
  __shared__ __align__(16) bf16 d_s[DK][COLS + PADB];   // [n][c]
  const int tiles0 = cdiv(csplit, COLS);
  const bool second = static_cast<int>(blockIdx.x) >= tiles0;
  const int c0 = second ? csplit + (blockIdx.x - tiles0) * COLS : blockIdx.x * COLS;
  const int c_end = second ? G : csplit;
  const float* a = second ? a1 : a0;
  const int i0 = blockIdx.y * COLS;
  const int z = blockIdx.z;
  const int n_beg = z * split;
  const int n_end = min(N, n_beg + split);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  constexpr int PER = DK * (COLS / 4) / 128;   // float4 of each operand a thread stages

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float4 ra[PER], rd[PER];
  auto load = [&](int n0) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int idx = tid + 128 * u;
      const int r = idx / (COLS / 4);
      const int q = 4 * (idx - r * (COLS / 4));
      const int n = n0 + r;
      ra[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      rd[u] = ra[u];
      if (n < n_end && i0 + q < H)
        ra[u] = *reinterpret_cast<const float4*>(a + static_cast<size_t>(n) * H + i0 + q);
      if (n < n_end && c0 + q < c_end)
        rd[u] = *reinterpret_cast<const float4*>(d + static_cast<size_t>(n) * G + c0 + q);
    }
  };
  load(n_beg);
  for (int n0 = n_beg; n0 < n_end; n0 += DK) {
    __syncthreads();                 // the last chunk's products are done
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int idx = tid + 128 * u;
      const int r = idx / (COLS / 4);
      const int q = 4 * (idx - r * (COLS / 4));
      *reinterpret_cast<uint2*>(&a_s[r][q]) =
          make_uint2(pack_bf16(ra[u].x, ra[u].y), pack_bf16(ra[u].z, ra[u].w));
      *reinterpret_cast<uint2*>(&d_s[r][q]) =
          make_uint2(pack_bf16(rd[u].x, rd[u].y), pack_bf16(rd[u].z, rd[u].w));
    }
    __syncthreads();
    if (n0 + DK < n_end) load(n0 + DK);
#pragma unroll
    for (int k0 = 0; k0 < DK; k0 += KSTEP) {
      // A = q(a)ᵀ from a_s [k = n][m = i], transposed: matrices (m 0-7, k
      // 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
      uint32_t af[4];
      ldsm_x4_trans(af, &a_s[k0 + (lane & 7) + ((lane >> 4) << 3)][16 * w + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t b[4];
        ldsm_x4_trans(b, &d_s[k0 + (lane & 7) + (((lane >> 3) & 1) << 3)][16 * jj + ((lane >> 4) << 3)]);
        mma_bf16(acc[2 * jj], af, b[0], b[1]);
        mma_bf16(acc[2 * jj + 1], af, b[2], b[3]);
      }
    }
  }
  float* out = part + static_cast<size_t>(z) * H * G;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = c0 + 8 * nt + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + 16 * w + (lane >> 2) + 8 * h;
      if (i < H && c < c_end)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(i) * G + c) =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
  }
}

// dwh = the RS partials added in split order
__global__ void dwh_reduce_kernel(const float* __restrict__ part, float* __restrict__ dwh,
                                  int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) {
    float a = 0.0f;
    for (int r = 0; r < RS; ++r) a += part[static_cast<size_t>(r) * n + idx];
    dwh[idx] = a;
  }
}

// dWh [H, G] from the N rows: a0 against the columns below csplit, a1
// against the rest; `part` is scratch of RS·H·G floats
cudaError_t launch_dwh(const float* a0, const float* a1, const float* d, float* part, float* dwh,
                       int N, int H, int G, int csplit, cudaStream_t s) {
  const int split = cdiv(cdiv(N, RS), DK) * DK;
  const dim3 grid(cdiv(csplit, COLS) + cdiv(G - csplit, COLS), cdiv(H, COLS), RS);
  dwh_mma_kernel<<<grid, 128, 0, s>>>(a0, a1, d, part, N, H, G, csplit, split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dwh_reduce_kernel<<<cdiv(H * G, 256), 256, 0, s>>>(part, dwh, H * G);
  return cudaGetLastError();
}

// registers, local bytes, dynamic shared memory and resident blocks per SM
// of `fn` launched with `threads` and `smem` bytes, into out[0..4)
cudaError_t kernel_info(const void* fn, int threads, size_t smem, int* out) {
  cudaError_t e = set_smem(fn, smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = blocks;
  return cudaSuccess;
}

}  // namespace
