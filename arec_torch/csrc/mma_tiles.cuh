// mma_tiles.cuh: the tensor-core tiles of the fused losses that score rows
// against a shared set of columns, sampled_ce.cu (the sampled-softmax CE,
// S drawn columns) and batch_rank.cu (the in-batch ranking loss, the
// batch's own N positives as columns). Both run the same FlashAttention-
// style passes over 64 × 64 tiles of scores that never reach device memory:
//  * bf16 copies of the row and column operands, zero-padded to whole
//    64-row tiles and to a depth Dp that is a multiple of 16 (the MMA's k);
//  * tiles copied into shared memory with cp.async, 16 bytes a thread,
//    double-buffered; each shared row padded by 16 bytes, so the 8 rows an
//    ldmatrix reads start in 8 different bank quads;
//  * every product on the tensor cores: mma.sync m16n8k16, bf16 operands,
//    f32 accumulators in registers; a block is 4 warps × 16 rows;
//  * the score tile (`tile_logits`), and the product of a tile of f32
//    weights on those scores with one side's operand, the weights rounded
//    to bf16 (`accum_product`) or split into bf16 parts
//    (`accum_product_split`).
// A change here is measured on both losses.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;        // rows (or columns) of a tile
constexpr int MW = 4;           // warps per block, 16 rows of a tile each
constexpr int KSTEP = 16;       // the MMA's depth: D is padded to it
constexpr int PAD = 8;          // bf16 lanes of padding per shared row
constexpr int WAVE = 264;       // blocks a split grid aims for: 2 × 132 SMs
constexpr int SPLIT_MAX = 32;   // most ranges a split makes

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest group of copies have landed
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

// two f32 as sums of TERMS bf16 each: part t is the rounding (to nearest
// even) of what parts 0..t-1 left, which is exact in f32. What the last
// part leaves is below 2^-(8·TERMS) of the value.
template <int TERMS>
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t (&w)[TERMS]) {
#pragma unroll
  for (int t = 0; t < TERMS; ++t) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    w[t] = *reinterpret_cast<const uint32_t*>(&h);
    if (t + 1 < TERMS) {
      lo -= __low2float(h);
      hi -= __high2float(h);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [r0, r0+TILE) of a bf16 [*, Dp] matrix into s [TILE][Dp+PAD]
__device__ __forceinline__ void load_tile_async(bf16* s, const bf16* g, int r0, int Dp) {
  const int chunks = Dp / 8;                 // 16-byte pieces of a row
  for (int idx = threadIdx.x; idx < TILE * chunks; idx += MW * 32) {
    const int r = idx / chunks;
    const int c = idx - r * chunks;
    cp_async16(s + r * (Dp + PAD) + c * 8, g + static_cast<size_t>(r0 + r) * Dp + c * 8);
  }
}

// acc = the 16×64 products of this warp's 16 rows of a_s [TILE][Dp+PAD]
// (rows 16w..16w+15) with the 64 rows of b_s [TILE][Dp+PAD]: acc[n] is the
// m16n8 accumulator of b_s rows 8n..8n+7 (thread (g, t) holds rows g, g+8 of
// the warp's 16 and b_s rows 8n+2t, 8n+2t+1)
__device__ __forceinline__ void tile_logits(const bf16* a_s, const bf16* b_s, int Dp,
                                            float acc[8][4]) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int ld = Dp + PAD;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  // ldmatrix.x4 of A: lanes 0-15 address rows 0-15 at k, lanes 16-31 at k+8
  const bf16* a_p = a_s + (16 * w + (lane & 15)) * ld + (lane >> 4) * 8;
  // of B ([n][k] in memory): matrices (n 0-7, k), (n 0-7, k+8), (n 8-15, k),
  // (n 8-15, k+8), i.e. the b0b1, b2b3 of two n-tiles
  const bf16* b_p = b_s + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
  for (int k = 0; k < Dp; k += KSTEP) {
    uint32_t a[4];
    ldsm_x4(a, a_p + k);
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t b[4];
      ldsm_x4(b, b_p + n * 8 * ld + k);
      mma_bf16(acc[n], a, b[0], b[1]);
      mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// out += cast(p)·b_s: p is a 16×64 f32 tile in tile_logits' accumulator
// layout, rounded to bf16 in registers into the A operand (its columns are
// the k of this product: b_s's 64 rows); out[j] is the m16n8 accumulator of
// b_s lanes 8j..8j+7, j < Dp/8
template <int NTD>
__device__ __forceinline__ void accum_product(const float p[8][4], const bf16* b_s,
                                              int Dp, float out[NTD][4]) {
  const int lane = threadIdx.x & 31;
  const int ld = Dp + PAD;
  // ldmatrix.x4.trans of B ([k][n] in memory): matrices (k 0-7, n), (k 8-15,
  // n), (k 0-7, n+8), (k 8-15, n+8)
  const bf16* b_p = b_s + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < TILE / KSTEP; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int j = 0; j < NTD; j += 2) {
      if (j * 8 < Dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, b_p + kk * KSTEP * ld + j * 8);
        mma_bf16(out[j], a, b[0], b[1]);
        mma_bf16(out[j + 1], a, b[2], b[3]);
      }
    }
  }
}

// accum_product with p kept to f32's precision: each of its values split
// into TERMS bf16 parts (split_bf16), one product each into the same
// accumulators
template <int NTD, int TERMS>
__device__ __forceinline__ void accum_product_split(const float p[8][4], const bf16* b_s,
                                                    int Dp, float out[NTD][4]) {
  const int lane = threadIdx.x & 31;
  const int ld = Dp + PAD;
  const bf16* b_p = b_s + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < TILE / KSTEP; ++kk) {
    uint32_t w[4][TERMS];
    split_bf16<TERMS>(p[2 * kk][0], p[2 * kk][1], w[0]);
    split_bf16<TERMS>(p[2 * kk][2], p[2 * kk][3], w[1]);
    split_bf16<TERMS>(p[2 * kk + 1][0], p[2 * kk + 1][1], w[2]);
    split_bf16<TERMS>(p[2 * kk + 1][2], p[2 * kk + 1][3], w[3]);
#pragma unroll
    for (int j = 0; j < NTD; j += 2) {
      if (j * 8 < Dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, b_p + kk * KSTEP * ld + j * 8);
#pragma unroll
        for (int t = 0; t < TERMS; ++t) {
          const uint32_t a[4] = {w[0][t], w[1][t], w[2][t], w[3][t]};
          mma_bf16(out[j], a, b[0], b[1]);
          mma_bf16(out[j + 1], a, b[2], b[3]);
        }
      }
    }
  }
}

// a backward pass's blocks kept resident per SM: three up to D = 128 (NTD ≤
// 16), which holds a thread to 168 registers; at D = 256 its tiles fill half
// the shared memory anyway
#define BWD_BLOCKS(NTD) ((NTD) <= 16 ? 3 : 1)

// ---------------------------------------------------------------- host ---

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// P ranges of `tiles` tiles, `per` tiles each (the last may hold fewer, none
// is empty), so that P × `across` blocks make about two waves
struct Split {
  int n, per;
};
inline Split make_split(int tiles, int across) {
  int want = cdiv(WAVE, across);
  want = want < tiles ? want : tiles;
  want = want < SPLIT_MAX ? want : SPLIT_MAX;
  const int per = cdiv(tiles, want);
  return {cdiv(tiles, per), per};
}

inline int round_up(int x, int m) { return cdiv(x, m) * m; }

// dynamic shared memory of the tensor-core passes: three bf16 tiles (one
// resident, two streamed) and side arrays of 2·TILE 4-byte words each
// (per-tile values of the streamed tiles, and per-warp buffers)
inline size_t mma_smem(int Dp, int side_words) {
  return sizeof(bf16) * 3 * TILE * static_cast<size_t>(Dp + PAD) +
         sizeof(float) * 2 * TILE * side_words;
}

template <typename T>
T* at(void* base, size_t off) {
  return reinterpret_cast<T*>(static_cast<char*>(base) + off);
}

}  // namespace
