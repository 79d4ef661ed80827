// mips_topk: the exact seen-masked top-k of serving and evaluation over the
// whole item matrix, without writing a score matrix to device memory.
//
// For each query row b of q [B, D] (f32) and every item i of
// items [V, D] (bf16) with bias [V] (f32):
//   s_bi = f32(bf16(q_b) · items_i) + bias_i, then −1e9 added once for every
//          entry of row b of the seen slab [B, S] (int32) that names i
//          (a scatter-ADD: a duplicated id is penalised twice);
//   out: the k largest s_bi of the row, descending: values [B, k] f32,
//        ids [B, k] int64.
// Each product of bf16 operands is exact in f32 and the sums run in f32:
// only their order differs from the plain path (`mips_topk_plain`). A seen
// id below 0 names nothing; one ≥ V names nothing, or V − 1 where `clamp`
// is set: `seen_rule`'s two rules (arec's `_topk_full` drops such an id,
// its `blocked_topk_mips` clamps it).
//
// It replaces no TPU kernel: arec's top-k is lax.top_k over scores that
// XLA computes. It is added because the port's chain of library ops for it
// (operand casts, an f32 GEMM, the bias add, the index_put_ penalty,
// torch.topk's radix selection) took 9.4 ms of device time a call at MF's
// serving shape (B 256, V 1,304,126, D 128, k 30), about 90 times its
// bound: 256 · 1,304,126 · 128 · 2 = 85.5 GFLOP is 0.086 ms at 989 TFLOP/s,
// and the bf16 item matrix with its f32 bias is 339 MB, 0.101 ms at
// 3.35 TB/s. So the bound is the item matrix's bytes, just above the
// products; the chain's [B, V] f32 scores alone would be 1.3 GB each way.
//
// The design. The items are cut into `splits` contiguous slabs of 64-row
// tiles, one select CTA a slab and query tile, as many as the card holds
// at once (two a SM) but no slab under 6 tiles: the split count follows
// from (B, V, D, k) and the card, never from a configuration. Four
// launches:
//  1. Sample: each select CTA scores its slab's first tile (below) and
//     writes those scores, penalised, to scratch.
//  2. Floor: one block a row takes the k-th best of its sampled scores. It
//     is a score that k items reach, so no item below it is in the row's
//     top k.
//  3. Select: each select CTA scores its whole slab and keeps a score only
//     where it reaches the row's floor, or later the k-th best the row
//     holds for this slab. The floor lies at about the k-th best of
//     splits · 64 items, so at random scores a slab of n items keeps about
//     n · k / (splits · 64) a row: 18 at MF's shape.
//  4. Final: one block a row takes the k best of all it kept and sorts
//     them (a warp bitonic network).
// The floor and final blocks take the k-th best of their threads' own
// maxima first: k scores reach it, so only the scores at or above it
// (about k) enter the exact radix select over the scores' order-preserving
// keys, 8 bits a round, each warp counting into its own shared histogram.
// A select CTA of 8 warps keeps QT query rows (32 a warp, or 16 where
// D > 128) as bf16 A fragments in registers, and streams its slab through
// shared memory (cp.async, 16 bytes a thread, 3 stages; rows padded by 16
// bytes so an ldmatrix touches 8 bank quads). Every product runs on the
// tensor cores (mma.sync m16n8k16, bf16, f32 accumulators that start from
// the item's bias, −inf past the slab), two 8-item n-tiles at a time, and
// the products of the next pair are issued before the epilogue of this
// one. Sample and select compute each score by the same instructions in
// the same order, so the floor is bit for bit a score the select pass
// sees. The epilogue compares a lane's row maxima with its rows'
// thresholds, and only where one passes, appends each passing score,
// unpenalised, with its tag to the lane's own buffer in shared memory: no
// lane waits on another. When a lane's buffer could overflow in the next
// pair, the warp drains all its lanes' buffers: each entry is penalised by
// its row's seen ids in the slab (found once, before the loop) and
// appended to the row's list for this slab in scratch. A penalty only
// lowers a score, so filtering on the unpenalised score loses nothing. A
// list about to fill is cut to its k best by the warp, and the row's
// threshold rises to the k-th best.
// Where the time goes (knock-outs on an H100, PERF.md): the products and
// the appends of passing scores, whose warps stall on each other; two CTAs
// a SM hide a quarter of that. The kernels sit some 4.7 times above their
// bound.
// Ties are broken towards the lower id in the output order; which of
// several ids tied at the k-th score is kept follows the scratch order.
// No atomics reach device memory: runs repeat bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int KSTEP = 16;           // the MMA's depth
constexpr int PADB = 8;             // bf16 lanes of padding per shared row
constexpr int TN = 64;              // item rows a tile, and sampled a slab
constexpr int NWARP = 8;            // warps a select CTA
constexpr int NTHREAD = NWARP * 32;
constexpr int LB = 24;              // scores a lane's buffer holds
constexpr int UTHREAD = 256;        // threads a floor / final block
constexpr int SC = 8;               // seen ids of a row kept for one slab
constexpr int MAX_SPLITS = 256;
constexpr int MIN_SLAB = 6;         // tiles a slab holds at least, where V allows
constexpr int MAX_K = 64;
constexpr long long MAX_V = 1LL << 29;  // an item offset fits a buffer tag
constexpr float PENALTY = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* q;
  const bf16* items;
  const float* bias;
  const int* seen;
  const float* floor;               // [B]: select pass; nullptr: sample pass
  float* sample;                    // [B][splits][TN]
  float* part_v;                    // [B][splits][CAP]
  int* part_i;
  int* part_n;                      // [B][splits]
  long long V;
  int B, D, S, k, splits, qtiles, ntiles;
  int clamp, seen_vec;
};

// KS k-steps (depth KS·16 ≥ D), MT m-tiles a warp, CAP kept scores a row
// and slab
template <int KS, int MT, int CAP>
struct Cfg {
  static constexpr int STAGES = 3;
  static constexpr int LDS = KS * KSTEP + PADB;   // bf16 a shared item row
  static constexpr int QT = NWARP * 16 * MT;       // query rows a CTA
  static constexpr int ROWS_W = 16 * MT;           // query rows a warp
  static constexpr int PUSH = 8 * MT;              // a lane's scores a pair
  static constexpr size_t tile_bytes = static_cast<size_t>(TN) * LDS * sizeof(bf16);
  static constexpr size_t smem = STAGES * tile_bytes + STAGES * TN * sizeof(float) +
                                 static_cast<size_t>(NWARP) * LB * 32 * 8 +
                                 static_cast<size_t>(QT) * (SC + 3) * 4;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// order-preserving key of a float: a > b ⇔ fkey(a) > fkey(b); no float
// has key 0, which stands for "no score"
__device__ __forceinline__ unsigned fkey(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float fkey_inv(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the total order of (score, id): higher score first, then lower id
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// a seen id as the plain paths read it: −1 names nothing
__device__ __forceinline__ int seen_id(int id, long long V, int clamp) {
  if (id < 0) return -1;
  if (id >= V) return clamp ? static_cast<int>(V - 1) : -1;
  return id;
}

// score s of `item` less −1e9 for each seen entry of its row that names
// it: the row's ns ids in this slab (ss), or where there are more than SC
// of them, the whole seen row (grow, S ids)
__device__ __forceinline__ float penalise(float s, int item, int ns, const int* ss,
                                          const int* grow, int S, long long V, int clamp) {
  if (ns > SC) {
    for (int u = 0; u < S; ++u)
      if (seen_id(__ldg(grow + u), V, clamp) == item) s += PENALTY;
  } else {
    for (int u = 0; u < ns; ++u)
      if (ss[u] == item) s += PENALTY;
  }
  return s;
}

// The warp cuts a row's n ≥ k kept scores (cv, ci; any order) to its k
// best, in slots 0..k-1, and returns the k-th best score.
template <int CAP>
__device__ float warp_cut(float* cv, int* ci, int n, int k, int lane) {
  constexpr int E = CAP / 32;
  float v[E];
  int id[E];
  unsigned key[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int g = j * 32 + lane;
    const bool ok = g < n;
    v[j] = ok ? cv[g] : -INFINITY;
    id[j] = ok ? ci[g] : -1;
    key[j] = ok ? fkey(v[j]) : 0u;
  }
  __syncwarp();
  // the k-th largest key: the largest t with #{key ≥ t} ≥ k
  unsigned t = 0;
#pragma unroll 4
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned c = t | (1u << bit);
    int m = 0;
#pragma unroll
    for (int j = 0; j < E; ++j) m += key[j] >= c;
    if (static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(m))) >= k) t = c;
  }
  // keep every key above t, then keys equal to t until k are kept
  const unsigned below = (1u << lane) - 1u;
  int base = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const bool gt = key[j] > t;
    const unsigned m = __ballot_sync(FULL, gt);
    if (gt) {
      const int p = base + __popc(m & below);
      cv[p] = v[j];
      ci[p] = id[j];
    }
    base += __popc(m);
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const bool eq = key[j] == t;
    const unsigned m = __ballot_sync(FULL, eq);
    const int p = base + __popc(m & below);
    if (eq && p < k) {
      cv[p] = v[j];
      ci[p] = id[j];
    }
    base += __popc(m);
  }
  __syncwarp();
  return fkey_inv(t);
}

// the scores of n-tiles 2p and 2p + 1 of a shared tile (rows T, biases
// bs) into acc[u]: each sum starts from its item's bias
template <int KS, int MT, int LDS>
__device__ __forceinline__ void mma_pair(float (&acc)[2][MT][4], const uint32_t (&af)[MT][KS][4],
                                         const bf16* T, const float* bs, int p, int lane) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float2 bb = *reinterpret_cast<const float2*>(bs + (2 * p + u) * 8 + 2 * (lane & 3));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      acc[u][mt][0] = acc[u][mt][2] = bb.x;
      acc[u][mt][1] = acc[u][mt][3] = bb.y;
    }
  }
  const bf16* brow = T + (p * 16 + (lane & 7)) * LDS + (lane >> 3) * 8;
#pragma unroll
  for (int kp = 0; kp < KS; kp += 2) {
    uint32_t b0[4], b1[4];
    ldsm_x4(b0, brow + kp * KSTEP);
    ldsm_x4(b1, brow + 8 * LDS + kp * KSTEP);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_bf16(acc[0][mt], af[mt][kp], b0[0], b0[1]);
      mma_bf16(acc[1][mt], af[mt][kp], b1[0], b1[1]);
      mma_bf16(acc[0][mt], af[mt][kp + 1], b0[2], b0[3]);
      mma_bf16(acc[1][mt], af[mt][kp + 1], b1[2], b1[3]);
    }
  }
}

// A warp's part of the select CTA's shared memory and its rows.
struct Rows {
  const int* seen_s;       // [QT][SC]: each row's seen ids in this slab
  const int* seen_n;       // [QT]
  int* row_n;              // [QT]: each row's list length for this slab
  float* row_thr;          // [QT]: each row's threshold
  int wrow, row0, split;
  int v0;                  // the slab's first item
};

// The warp's lane buffers (lc entries in this lane's: the score and a tag,
// the item's offset in the slab · 4 + its row's slot in the quad) into its
// rows' lists in scratch. A list about to fill is cut to its k best, and
// its row's threshold raised to the k-th.
template <int MT, int CAP>
__device__ __forceinline__ void drain(const int2* lb, int lc, const Rows& w, const Args& a) {
  // a step appends at most 4 scores to a row, one a lane of its quad
  constexpr int TRIG = CAP - 4;
  const int lane = threadIdx.x & 31, r = lane >> 2;
  __syncwarp();
  const int steps = static_cast<int>(__reduce_max_sync(FULL, static_cast<unsigned>(lc)));
  for (int j = 0; j < steps; ++j) {
    int ql = -1, n = 0;
    size_t off = 0;
    if (j < lc) {
      const int2 ent = lb[j * 32 + lane];
      const int slot = ent.y & 3, item = w.v0 + (ent.y >> 2);
      ql = w.wrow + (slot >> 1) * 16 + r + 8 * (slot & 1);
      const int b = w.row0 + ql;
      const float pen = penalise(__int_as_float(ent.x), item, w.seen_n[ql], w.seen_s + ql * SC,
                                 a.seen + static_cast<size_t>(b) * a.S, a.S, a.V, a.clamp);
      n = atomicAdd(w.row_n + ql, 1);
      off = (static_cast<size_t>(b) * a.splits + w.split) * CAP;
      a.part_v[off + n] = pen;
      a.part_i[off + n] = item;
    }
    unsigned full = __ballot_sync(FULL, ql >= 0 && n + 1 >= TRIG);
    if (!full) continue;
    __syncwarp();
    while (full) {
      const int src = __ffs(full) - 1;
      const int cq = __shfl_sync(FULL, ql, src);
      const size_t coff = __shfl_sync(FULL, off, src);
      full &= ~__ballot_sync(FULL, ql == cq);
      const float kth = warp_cut<CAP>(a.part_v + coff, a.part_i + coff, w.row_n[cq], a.k, lane);
      if (lane == 0) {
        w.row_n[cq] = a.k;
        w.row_thr[cq] = fmaxf(w.row_thr[cq], kth);
      }
      __syncwarp();
    }
  }
  __syncwarp();
}

// One select CTA: the sample pass scores the first tile of its slab and
// writes every score, penalised; the select pass scores the whole
// slab and keeps the scores that pass their row's threshold.
template <int KS, int MT, int CAP, bool SAMPLE_PASS>
__global__ void __launch_bounds__(NTHREAD, 2) mips_select_kernel(const Args a) {
  using C = Cfg<KS, MT, CAP>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  float* bias_s = reinterpret_cast<float*>(smem + STAGES * C::tile_bytes);
  int2* lb = reinterpret_cast<int2*>(bias_s + STAGES * TN);
  int* seen_s = reinterpret_cast<int*>(lb + NWARP * LB * 32);
  int* seen_n = seen_s + C::QT * SC;
  int* row_n = seen_n + C::QT;
  float* row_thr = reinterpret_cast<float*>(row_n + C::QT);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = lane >> 2, c = lane & 3;
  const int split = blockIdx.x / a.qtiles, qtile = blockIdx.x - split * a.qtiles;
  const int t0 = static_cast<int>(static_cast<long long>(split) * a.ntiles / a.splits);
  const int t1 = static_cast<int>(static_cast<long long>(split + 1) * a.ntiles / a.splits);
  const int nt = SAMPLE_PASS ? 1 : t1 - t0;
  const int v0 = t0 * TN;
  const int v1 = static_cast<int>(min(static_cast<long long>(t1) * TN, a.V));
  const int row0 = qtile * C::QT;
  const Rows w{seen_s, seen_n, row_n, row_thr, warp * C::ROWS_W, row0, split, v0};

  // the item rows of tile t into `stage`, zero past the slab; its bias
  auto load_tile = [&](int t, int stage) {
    const int i0 = v0 + t * TN;
    bf16* dst = tiles + stage * TN * C::LDS;
    const int cpr = a.D / 8;
    for (int e = tid; e < TN * cpr; e += NTHREAD) {
      const int row = e / cpr, ch = e - row * cpr;
      const int item = i0 + row;
      const bool ok = item < v1;
      cp_async16_zfill(dst + row * C::LDS + ch * 8,
                       a.items + (ok ? static_cast<size_t>(item) * a.D + ch * 8 : 0),
                       ok ? 16 : 0);
    }
    if (tid < TN / 4) {
      const int item = i0 + tid * 4;
      const int n = max(0, min(4, v1 - item));
      cp_async16_zfill(bias_s + stage * TN + tid * 4, a.bias + (n ? item : 0), n * 4);
    }
  };

  // depth past D reads zeros; no copy ever writes there
  constexpr int DP = KS * KSTEP;
  if (a.D < DP) {
    const int wd = DP - a.D;
    const bf16 zero = __float2bfloat16(0.0f);
    for (int e = tid; e < STAGES * TN * wd; e += NTHREAD) {
      const int row = e / wd;
      tiles[row * C::LDS + a.D + (e - row * wd)] = zero;
    }
  }
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nt) load_tile(st, st);
    cp_async_commit();
  }

  // each row's seen ids that fall in this slab (the first SC of them; a
  // row with more reads its whole seen row when it penalises), and its
  // threshold: keep a score s ≥ floor, i.e. s > the float just below it;
  // a row past B keeps nothing
  for (int q = tid; q < C::QT; q += NTHREAD) {
    const int b = row0 + q;
    int n = 0;
    auto take = [&](int raw) {
      const int id = seen_id(raw, a.V, a.clamp);
      if (id >= v0 && id < v1) {
        if (n < SC) seen_s[q * SC + n] = id;
        ++n;
      }
    };
    if (b < a.B) {
      const int* row = a.seen + static_cast<size_t>(b) * a.S;
      if (a.seen_vec) {
#pragma unroll 4
        for (int t = 0; t < a.S; t += 4) {
          const int4 x = __ldg(reinterpret_cast<const int4*>(row + t));
          take(x.x);
          take(x.y);
          take(x.z);
          take(x.w);
        }
      } else {
#pragma unroll 8
        for (int t = 0; t < a.S; ++t) take(__ldg(row + t));
      }
    }
    seen_n[q] = n;
    row_n[q] = 0;
    row_thr[q] = b >= a.B ? INFINITY : SAMPLE_PASS ? -INFINITY
                                     : nextafterf(__ldg(a.floor + b), -INFINITY);
  }

  // this warp's query rows as A fragments, rounded to bf16 (nearest even)
  uint32_t af[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + w.wrow + mt * 16 + r + 8 * h;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = kk * KSTEP + half * 8 + 2 * c;
          uint32_t x = 0;
          if (row < a.B && col < a.D) {
            const float2 f =
                __ldg(reinterpret_cast<const float2*>(a.q + static_cast<size_t>(row) * a.D + col));
            x = pack_bf16(f.x, f.y);
          }
          af[mt][kk][h + 2 * half] = x;
        }
    }

  int2* my_lb = lb + warp * LB * 32;     // this warp's lane buffers [LB][32]
  int lc = 0;                            // entries in this lane's buffer
  float thr[MT][2];                      // the thresholds of its quad's rows
  auto load_thr = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) thr[mt][h] = row_thr[w.wrow + mt * 16 + r + 8 * h];
  };

  // the epilogue of the scores s of n-tiles 2p, 2p + 1 of the tile at i0
  // (−inf past the slab)
  auto epilogue = [&](const float (&s)[2][MT][4], int p, int i0) {
    if constexpr (SAMPLE_PASS) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = (2 * p + u) * 8 + 2 * c, item = i0 + col;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ql = w.wrow + mt * 16 + r + 8 * h, b = row0 + ql;
            if (b >= a.B) continue;
            const int* grow = a.seen + static_cast<size_t>(b) * a.S;
            float2 out;
            out.x = penalise(s[u][mt][2 * h], item, seen_n[ql], seen_s + ql * SC, grow, a.S,
                             a.V, a.clamp);
            out.y = penalise(s[u][mt][2 * h + 1], item + 1, seen_n[ql], seen_s + ql * SC, grow,
                             a.S, a.V, a.clamp);
            *reinterpret_cast<float2*>(
                a.sample + (static_cast<size_t>(b) * a.splits + split) * TN + col) = out;
          }
      }
    } else {
      // does any of this lane's scores pass its row's threshold?
      bool hit = false;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          hit |= fmaxf(fmaxf(s[0][mt][2 * h], s[0][mt][2 * h + 1]),
                       fmaxf(s[1][mt][2 * h], s[1][mt][2 * h + 1])) > thr[mt][h];
      if (!hit) return;
      const int off = i0 - v0 + 2 * p * 8 + 2 * c;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (s[u][mt][e] > thr[mt][e >> 1])
              my_lb[lc++ * 32 + lane] =
                  make_int2(__float_as_int(s[u][mt][e]),
                            (off + u * 8 + (e & 1)) * 4 + mt * 2 + (e >> 1));
    }
  };

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t == 0) load_thr();
    if (t + STAGES - 1 < nt) load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();

    const int stage = t % STAGES;
    const bf16* T = tiles + stage * TN * C::LDS;
    float* bs = bias_s + stage * TN;
    const int i0 = v0 + t * TN;
    const int nvalid = min(TN, v1 - i0);
    if (nvalid < TN) {          // the slab's ragged end: no score there
      if (tid >= nvalid && tid < TN) bs[tid] = -INFINITY;
      __syncthreads();
    }

    // four pairs of n-tiles; each pair's products issued before the
    // previous pair's epilogue; the buffers drained where the next pair
    // could overflow one
    float acc0[2][MT][4], acc1[2][MT][4];
    auto check = [&]() {
      if constexpr (!SAMPLE_PASS) {
        if (__any_sync(FULL, lc > LB - C::PUSH)) {
          drain<MT, CAP>(my_lb, lc, w, a);
          lc = 0;
          load_thr();
        }
      }
    };
    mma_pair<KS, MT, C::LDS>(acc0, af, T, bs, 0, lane);
#pragma unroll 1
    for (int pp = 0; pp < TN / 32; ++pp) {
      mma_pair<KS, MT, C::LDS>(acc1, af, T, bs, 2 * pp + 1, lane);
      epilogue(acc0, 2 * pp, i0);
      check();
      if (2 * pp + 2 < TN / 16) mma_pair<KS, MT, C::LDS>(acc0, af, T, bs, 2 * pp + 2, lane);
      epilogue(acc1, 2 * pp + 1, i0);
      check();
    }
  }
  if constexpr (!SAMPLE_PASS) {
    // the rest of the buffers, then each row's list length
    drain<MT, CAP>(my_lb, lc, w, a);
    if (lane < C::ROWS_W) {
      const int ql = w.wrow + lane, b = row0 + ql;
      if (b < a.B) a.part_n[static_cast<size_t>(b) * a.splits + split] = row_n[ql];
    }
  }
}

constexpr int NUW = UTHREAD / 32;    // warps a floor / final block
constexpr int HIST = NUW * 256 + NUW + 2;
constexpr int CMAX = 4096;           // candidates a final block selects from

// the k-th largest of the block's m keys in shared memory, by 8 bits a
// round, each warp counting into its own histogram; `hist` holds HIST ints
__device__ unsigned block_kth(const unsigned* keys, int m, int k, int* hist) {
  int* tot = hist + NUW * 256;
  int* found = tot + NUW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned prefix = 0, known = 0;
  int need = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < NUW * 256; i += UTHREAD) hist[i] = 0;
    __syncthreads();
    for (int e = tid; e < m; e += UTHREAD) {
      const unsigned key = keys[e];
      if ((key & known) == prefix) atomicAdd(hist + warp * 256 + ((key >> shift) & 255u), 1);
    }
    __syncthreads();
    // suffix sums: thread t holds bin 255 − t; the digit is the bin where
    // the count from the top first reaches `need`
    int cnt = 0;
#pragma unroll
    for (int w2 = 0; w2 < NUW; ++w2) cnt += hist[w2 * 256 + 255 - tid];
    int inc = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(FULL, inc, off);
      if (lane >= off) inc += x;
    }
    if (lane == 31) tot[warp] = inc;
    __syncthreads();
    for (int w2 = 0; w2 < warp; ++w2) inc += tot[w2];
    if (inc >= need && inc - cnt < need) {
      found[0] = 255 - tid;          // the digit
      found[1] = need - (inc - cnt);
    }
    __syncthreads();
    prefix |= static_cast<unsigned>(found[0]) << shift;
    need = found[1];
    known |= 255u << shift;
    __syncthreads();
  }
  return prefix;
}

// the exclusive prefix sum of v over the block, in thread order, and its
// total; `tmp` holds NUW ints
__device__ __forceinline__ int block_scan(int v, int* tmp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += x;
  }
  if (lane == 31) tmp[warp] = inc;
  __syncthreads();
  int base = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < NUW; ++w) {
    if (w < warp) base += tmp[w];
    total += tmp[w];
  }
  __syncthreads();
  return base + inc - v;
}

// One block a row, over its `lists` lists of 2^lg scores (of which the
// first counts[l] are scores where `counts` is given, else all): the k-th
// best score to floor_out[row] (the floor pass), or the k best, best
// first, to out_v / out_i (the final pass). The k-th best of the threads'
// own maxima is reached by k scores, so only the scores at or above it
// (about k of them, at most CMAX) take part in the exact selection.
template <int E>
__global__ void __launch_bounds__(UTHREAD, 4) mips_union_kernel(
    const float* __restrict__ vals, const int* __restrict__ ids, const int* __restrict__ counts,
    int lists, int lg, int k, float* floor_out, float* out_v, long long* out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int hist[HIST];
  __shared__ int tmp[NUW];
  __shared__ unsigned mx_s[UTHREAD];
  __shared__ float sel_v[32 * E];
  __shared__ int sel_i[32 * E];
  const int m = lists << lg, b = blockIdx.x, tid = threadIdx.x;
  unsigned* keys = reinterpret_cast<unsigned*>(smem);        // [m]
  unsigned* ckey = keys + m;                                 // [CMAX]
  int* cidx = reinterpret_cast<int*>(ckey + CMAX);           // [CMAX]
  int* cnt_s = cidx + CMAX;                                  // [lists]
  const float* v = vals + static_cast<size_t>(b) * m;
  if (counts) {
    for (int l = tid; l < lists; l += UTHREAD) cnt_s[l] = counts[static_cast<size_t>(b) * lists + l];
    __syncthreads();
  }
  const int wmask = (1 << lg) - 1;
  unsigned mx = 0;
  for (int e = tid; e < m; e += UTHREAD) {
    const unsigned key = (!counts || (e & wmask) < cnt_s[e >> lg]) ? fkey(v[e]) : 0u;
    keys[e] = key;
    mx = max(mx, key);
  }
  mx_s[tid] = mx;
  __syncthreads();
  const unsigned lo = block_kth(mx_s, UTHREAD, k, hist);
  int mine = 0;
  for (int e = tid; e < m; e += UTHREAD) mine += keys[e] >= lo && keys[e] != 0u;
  int total;
  int pos = block_scan(mine, tmp, total);
  const bool few = total <= CMAX;
  if (few)
    for (int e = tid; e < m; e += UTHREAD)
      if (keys[e] >= lo && keys[e] != 0u) {
        ckey[pos] = keys[e];
        cidx[pos++] = e;
      }
  __syncthreads();
  const unsigned* sk = few ? ckey : keys;
  const int n = few ? total : m;
  const unsigned t = block_kth(sk, n, k, hist);
  if (floor_out) {
    if (tid == 0) floor_out[b] = fkey_inv(t);
    return;
  }
  // every key above t, then keys equal to t in order until k: each thread
  // takes a contiguous run of the candidates
  const int run = cdiv(n, UTHREAD), e0 = min(n, tid * run), e1 = min(n, e0 + run);
  int gt = 0, eq = 0;
  for (int e = e0; e < e1; ++e) {
    gt += sk[e] > t;
    eq += sk[e] == t;
  }
  int ngt, neq;
  int bgt = block_scan(gt, tmp, ngt);
  int beq = block_scan(eq, tmp, neq);
  const int* id = ids + static_cast<size_t>(b) * m;
  for (int e = e0; e < e1; ++e) {
    const int src = few ? cidx[e] : e;
    if (sk[e] > t) {
      sel_v[bgt] = fkey_inv(sk[e]);
      sel_i[bgt++] = id[src];
    } else if (sk[e] == t) {
      const int p = ngt + beq++;
      if (p < k) {
        sel_v[p] = fkey_inv(t);
        sel_i[p] = id[src];
      }
    }
  }
  __syncthreads();
  const int lane = tid & 31;
  if (tid >= 32) return;
  // a bitonic network over 32·E slots (g = j·32 + lane), padded, best first
  float sv[E];
  int si[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int g = j * 32 + lane;
    sv[j] = g < k ? sel_v[g] : -INFINITY;
    si[j] = g < k ? sel_i[g] : INT_MAX;
  }
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int p = j ^ (stride >> 5);
          if (j < p) {
            const bool desc = ((j * 32 + lane) & size) == 0;
            if (desc ? before(sv[p], si[p], sv[j], si[j]) : before(sv[j], si[j], sv[p], si[p])) {
              const float tv = sv[j];
              sv[j] = sv[p];
              sv[p] = tv;
              const int ti = si[j];
              si[j] = si[p];
              si[p] = ti;
            }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float pv = __shfl_xor_sync(FULL, sv[j], stride);
          const int pi = __shfl_xor_sync(FULL, si[j], stride);
          const bool lower = (lane & stride) == 0;
          const bool desc = ((j * 32 + lane) & size) == 0;
          const bool better = before(pv, pi, sv[j], si[j]);
          if (lower == desc ? better : !better) {
            sv[j] = pv;
            si[j] = pi;
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int g = j * 32 + lane;
    if (g < k) {
      out_v[static_cast<size_t>(b) * k + g] = sv[j];
      out_i[static_cast<size_t>(b) * k + g] = si[j];
    }
  }
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

template <int KS_, int MT_, int CAP_>
struct Variant {
  using C = Cfg<KS_, MT_, CAP_>;
  static constexpr int CAP = CAP_;
  template <bool SAMPLE_PASS>
  static const void* fn() {
    return reinterpret_cast<const void*>(mips_select_kernel<KS_, MT_, CAP_, SAMPLE_PASS>);
  }
  template <bool SAMPLE_PASS>
  static void launch(unsigned grid, cudaStream_t s, const Args& a) {
    mips_select_kernel<KS_, MT_, CAP_, SAMPLE_PASS><<<grid, NTHREAD, C::smem, s>>>(a);
  }
};

// the select kernel's variant for (D, k): its depth, rows a warp and list
template <class F>
cudaError_t with_variant(int D, int k, F&& f) {
  if (k <= 32) {
    if (D <= 64) return f(Variant<4, 2, 64>{});
    if (D <= 128) return f(Variant<8, 2, 64>{});
    return f(Variant<16, 1, 64>{});
  }
  if (D <= 64) return f(Variant<4, 2, 128>{});
  if (D <= 128) return f(Variant<8, 2, 128>{});
  return f(Variant<16, 1, 128>{});
}

bool shape_ok(int B, long long V, int D, int k) {
  return B >= 1 && V >= k && V <= MAX_V && k >= 1 && k <= MAX_K && D >= 16 && D <= 256 &&
         D % 16 == 0;
}

// scratch offsets (bytes, 256-aligned) for B rows, `splits` slabs and
// `cap` kept scores a row and slab
struct Layout {
  size_t sample, floor, part_v, part_i, part_n, total;
  Layout(int B, int splits, int cap) {
    auto up = [](size_t n) { return (n + 255) & ~size_t{255}; };
    const size_t bs = static_cast<size_t>(B) * splits;
    sample = 0;
    floor = up(bs * TN * 4);
    part_v = floor + up(static_cast<size_t>(B) * 4);
    part_i = part_v + up(bs * cap * 4);
    part_n = part_i + up(bs * cap * 4);
    total = part_n + up(bs * 4);
  }
};

size_t union_smem(int lists, int width) {
  return static_cast<size_t>(lists) * width * 4 + static_cast<size_t>(CMAX) * 8 +
         static_cast<size_t>(lists) * 4;
}

}  // namespace

// What mips_topk launches for (B, V, D, k) on the current card, without
// launching: out = {splits, query tiles, select CTA threads, its dynamic
// shared bytes, its resident CTAs a SM, its registers a thread, its local
// (spill) bytes a thread, kept scores a row and slab, the card's SMs, the
// final pass's shared bytes, the scratch bytes}. The split count fills
// the card once: SMs × resident CTAs ÷ query tiles, at most one a tile of
// 64 items and 256.
extern "C" int mips_topk_plan(int B, long long V, int D, int k, long long* out) {
  if (!shape_ok(B, V, D, k)) return cudaErrorInvalidValue;
  return static_cast<int>(with_variant(D, k, [&](auto var) -> cudaError_t {
    using Var = decltype(var);
    using C = typename Var::C;
    if (static_cast<int>(C::smem) > smem_optin()) return cudaErrorInvalidConfiguration;
    int dev = 0, sms = 0, bps = 0;
    cudaFuncAttributes f;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const void* fn = Var::template fn<false>();
    if (e == cudaSuccess) e = set_smem(fn, C::smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, fn, NTHREAD, C::smem);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&f, fn);
    if (e != cudaSuccess) return e;
    if (bps < 1) return cudaErrorInvalidConfiguration;
    const int qtiles = cdiv(B, C::QT);
    const long long ntiles = (V + TN - 1) / TN;
    long long splits = static_cast<long long>(sms) * bps / qtiles;
    splits = std::max(1LL, std::min({splits, ntiles / MIN_SLAB, static_cast<long long>(MAX_SPLITS)}));
    out[0] = splits;
    out[1] = qtiles;
    out[2] = NTHREAD;
    out[3] = static_cast<long long>(C::smem);
    out[4] = bps;
    out[5] = f.numRegs;
    out[6] = static_cast<long long>(f.localSizeBytes);
    out[7] = Var::CAP;
    out[8] = sms;
    out[9] = static_cast<long long>(union_smem(static_cast<int>(splits), Var::CAP));
    out[10] = static_cast<long long>(Layout(B, static_cast<int>(splits), Var::CAP).total);
    return cudaSuccess;
  }));
}

// values [B, k] f32 and ids [B, k] int64 of the top k (see the top of the
// file), with `scratch` of at least the plan's scratch bytes. Launches the
// four passes on `stream`; returns the first CUDA error.
extern "C" int mips_topk(const void* q, const void* items, const void* bias,
                         const void* seen, int B, long long V, int D, int S, int k, int clamp,
                         int splits, void* scratch, long long scratch_bytes, void* out_v,
                         void* out_i, void* stream) {
  if (!shape_ok(B, V, D, k) || S < 0) return cudaErrorInvalidValue;
  const long long ntiles = (V + TN - 1) / TN;
  if (splits < 1 || splits > MAX_SPLITS || splits > ntiles) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(items) % 16 || reinterpret_cast<uintptr_t>(bias) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 8 ||
      reinterpret_cast<uintptr_t>(seen) % 4 || reinterpret_cast<uintptr_t>(scratch) % 256)
    return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_variant(D, k, [&](auto var) -> cudaError_t {
    using Var = decltype(var);
    using C = typename Var::C;
    const Layout lay(B, splits, Var::CAP);
    if (static_cast<size_t>(scratch_bytes) < lay.total) return cudaErrorInvalidValue;
    unsigned char* base = static_cast<unsigned char*>(scratch);
    Args a{static_cast<const float*>(q),
           static_cast<const bf16*>(items),
           static_cast<const float*>(bias),
           static_cast<const int*>(seen),
           nullptr,
           reinterpret_cast<float*>(base + lay.sample),
           reinterpret_cast<float*>(base + lay.part_v),
           reinterpret_cast<int*>(base + lay.part_i),
           reinterpret_cast<int*>(base + lay.part_n),
           V,
           B,
           D,
           S,
           k,
           splits,
           cdiv(B, C::QT),
           static_cast<int>(ntiles),
           clamp ? 1 : 0,
           (S % 4 == 0 && reinterpret_cast<uintptr_t>(seen) % 16 == 0) ? 1 : 0};
    float* floor = reinterpret_cast<float*>(base + lay.floor);
    const unsigned grid = static_cast<unsigned>(splits) * a.qtiles;
    const auto uni = Var::CAP == 64 ? mips_union_kernel<1> : mips_union_kernel<2>;
    constexpr int LG_TN = 6, LG_CAP = Var::CAP == 64 ? 6 : 7;
    const size_t s_floor = union_smem(splits, TN), s_final = union_smem(splits, Var::CAP);
    cudaError_t e = set_smem(Var::template fn<true>(), C::smem);
    if (e == cudaSuccess) e = set_smem(Var::template fn<false>(), C::smem);
    if (e == cudaSuccess)
      e = set_smem(reinterpret_cast<const void*>(uni), std::max(s_floor, s_final));
    if (e != cudaSuccess) return e;
    Var::template launch<true>(grid, s, a);                        // 1. sample
    uni<<<B, UTHREAD, s_floor, s>>>(a.sample, nullptr, nullptr, splits, LG_TN, k, floor,
                                    nullptr, nullptr);              // 2. floor
    a.floor = floor;
    Var::template launch<false>(grid, s, a);                       // 3. select
    uni<<<B, UTHREAD, s_final, s>>>(a.part_v, a.part_i, a.part_n, splits, LG_CAP, k,
                                    nullptr, static_cast<float*>(out_v),
                                    static_cast<long long*>(out_i));  // 4. final
    return cudaGetLastError();
  }));
}
