// row_scatter: table[ids[i]] = rows[i], in place, for every i whose id lies
// in [0, V); the other ids are dropped.
//
// Replaces the TPU kernel tools/ab_row_update.py:_kernel (launched by
// _scatter_rows_pallas), a DMA row scatter-set. That kernel never lowered
// on its own stack, so the semantics held here are those of its oracle,
// XLA's scatter table.at[ids].set(rows, mode="drop", unique_indices=True,
// indices_are_sorted=True). On the sparse train step's path the ids are
// the dense prefix followed by engine.unique_rows' output: the in-range ids
// are sorted and unique and form a prefix, and the sentinel ids (>= V) form
// a suffix. Nothing here relies on that order.
//
// What bounds it: bytes. Each valid row is read once from `rows` and
// written once into `table`, and there is no arithmetic. At the MF main
// path (14,365 rows of 258 f32 into the [1,304,126, 258] item table,
// 12,314 rows of 256 into the [1,504,123, 256] user table) that is about
// 28 MB and 24 MB, 8.3 and 7.1 us of HBM time at 3.35 TB/s. In practice a
// launch that moves this few bytes is held by the memory system: on an
// H100 80GB HBM3 torch's own contiguous copy_ of the same rows takes about
// as long as this kernel (chip_knockout.py, PERF.md).
//
// The design. Each step below was measured against the alternatives by
// chip_knockout.py at both main-path shapes (PERF.md).
// - One warp a row, 8 warps a block, a grid of ceil(N / 8) blocks; the
//   warp reads its row's id (an id outside [0, V) costs no row load), then
//   all the row's loads, then all its stores. Measured and not taken
//   (chip_knockout.py): 4 warps a block ("w4"); a persistent grid of one
//   wave, SMs x resident blocks, warps walking spans of rows with their
//   ids read 32 at a time ("persistent": with the sparse step's sentinel
//   suffix its warps' spans are all sentinel or all work, each warp
//   copying its rows one after another); two rows in flight a warp
//   ("rows2": 64-85 registers, fewer resident warps).
// - 16-byte vectors on every row of even W whose bases are 8-byte aligned,
//   whatever each row's phase: the source and destination phases (0 or 8
//   mod 16) come from the row's own addresses (the item table's 1,032-byte
//   pitch puts odd rows at 8 mod 16). The body is cut on the destination's
//   16-byte grid. Equal phases: one aligned 16-byte load a vector. Unequal
//   phases: each lane loads the aligned source vector that ends 8 bytes into
//   its destination vector, and one __shfl_down_sync pair brings the other
//   8 bytes from the next lane (the pass's last lane, and the row's last
//   vector, load them themselves). The destination's 8-byte head and tail,
//   where there are any, are copied by lanes 0 and 1. Other rows (odd W, or
//   a base only 4-byte aligned) take 4-byte loads and stores. A row longer
//   than one piece (K vectors a lane, 1 KB) is copied piece by piece.
// - The table rows are written evict-first (__stcs), so the write-back's
//   ~25 MB displaces less of L2: as fast as plain stores where `rows` is
//   cold, faster where it was just written (as the sparse step leaves it)
//   or is read again. `rows` is read with plain loads: read evict-first
//   (__ldcs) it was faster where cold, no faster where just written, and
//   slower where a caller reads the same rows again (knock-outs "ldcs",
//   "no_hints").
//
// Unique in-range ids make the writes race-free and the result independent
// of the order the blocks run in: it is the serial copy, bit for bit. Rows
// that no id names are never touched.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int WARPS = 8;        // warps a block
constexpr int THREADS = WARPS * 32;
constexpr int K = 2;            // 16-byte vectors a lane holds of one piece
constexpr int K1 = 8;           // floats a lane holds of one 4-byte piece
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float ld1(const float* p) {
  return *p;
}
// table rows are written evict-first (__stcs)
__device__ __forceinline__ void st4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ void st2(float* p, float2 v) {
  __stcs(reinterpret_cast<float2*>(p), v);
}
__device__ __forceinline__ void st1(float* p, float v) {
  __stcs(p, v);
}

struct Args {
  float* table;
  const int* ids;
  const float* rows;
  long long V;
  int W, N;
};

__device__ __forceinline__ const float* src_row(const Args& a, int row) {
  return a.rows + static_cast<size_t>(row) * a.W;
}
__device__ __forceinline__ float* dst_row(const Args& a, int id) {
  return a.table + static_cast<size_t>(id) * a.W;
}
// floats of a row before its first 16-byte boundary: 0 or 2 (8-byte
// aligned rows)
__device__ __forceinline__ int head(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 8) ? 2 : 0;
}

// 16-byte path (even W, 8-byte aligned bases). The destination row is a
// head of hd floats (0 or 2), nb aligned 16-byte body vectors and a tail
// of 0 or 2 floats; a piece holds body vectors j0 .. j0 + 32K - 1, vector
// j of lane (j - j0) % 32 at index (j - j0) / 32.
struct Piece16 {
  float4 v[K];   // the lane's source vectors (see the header)
  float2 x[K];   // the 8 bytes after them, for a pass's last lane
  float2 e;      // lane 0: the row's head; lane 1: its tail (piece 0)
  float* d;
  int j0, nb, hd, tail;
  bool same;

  // pieces a row of W floats takes (its body has at most W / 4 vectors)
  __host__ __device__ static int pieces(int W) {
    const int nb = W >> 2;
    return nb > 0 ? (nb + 32 * K - 1) / (32 * K) : 1;
  }

  __device__ __forceinline__ void load(const Args& a, int row, int id,
                                       int piece, int lane) {
    const float* s = src_row(a, row);
    d = dst_row(a, id);
    hd = head(d);
    same = head(s) == hd;
    nb = (a.W - hd) >> 2;
    tail = (a.W - hd) & 3;
    j0 = piece * 32 * K;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + 32 * k + lane;
      const int c = hd + 4 * j;
      if (j < nb) {
        if (same) {
          v[k] = ld4(s + c);
        } else {
          if (c >= 2) {
            v[k] = ld4(s + c - 2);
          } else {
            const float2 h = ld2(s);
            v[k].z = h.x;
            v[k].w = h.y;
          }
          if (lane == 31 || j == nb - 1) x[k] = ld2(s + c + 2);
        }
      }
    }
    if (piece == 0) {
      if (lane == 0 && hd) e = ld2(s);
      if (lane == 1 && tail) e = ld2(s + a.W - 2);
    }
  }

  __device__ __forceinline__ void store(const Args& a, int lane) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + 32 * k + lane;
      float4 o = v[k];
      if (!same) {
        float2 n = make_float2(__shfl_down_sync(FULL, v[k].x, 1),
                               __shfl_down_sync(FULL, v[k].y, 1));
        if (lane == 31 || j == nb - 1) n = x[k];
        o = make_float4(v[k].z, v[k].w, n.x, n.y);
      }
      if (j < nb) st4(d + hd + 4 * j, o);
    }
    if (j0 == 0) {
      if (lane == 0 && hd) st2(d, e);
      if (lane == 1 && tail) st2(d + a.W - 2, e);
    }
  }
};

// 4-byte path: a piece holds floats i0 .. i0 + 32 K1 - 1 of the row.
struct Piece4 {
  float v[K1];
  float* d;
  int i0;

  __host__ __device__ static int pieces(int W) {
    return (W + 32 * K1 - 1) / (32 * K1);
  }

  __device__ __forceinline__ void load(const Args& a, int row, int id,
                                       int piece, int lane) {
    const float* s = src_row(a, row);
    d = dst_row(a, id);
    i0 = piece * 32 * K1;
#pragma unroll
    for (int k = 0; k < K1; ++k) {
      const int i = i0 + 32 * k + lane;
      if (i < a.W) v[k] = ld1(s + i);
    }
  }

  __device__ __forceinline__ void store(const Args& a, int lane) {
#pragma unroll
    for (int k = 0; k < K1; ++k) {
      const int i = i0 + 32 * k + lane;
      if (i < a.W) st1(d + i, v[k]);
    }
  }
};

// One warp a row: the row's id (one load, the same address for every lane,
// so every branch is uniform across the warp), then its pieces.
template <class P>
__global__ void __launch_bounds__(THREADS)
scatter(Args a) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= a.N) return;
  const int id = __ldg(a.ids + row);
  if (id < 0 || id >= a.V) return;
  for (int p = 0; p < P::pieces(a.W); ++p) {
    P piece;
    piece.load(a, static_cast<int>(row), id, p, lane);
    piece.store(a, lane);
  }
}

// 1: the 16-byte path, 0: the 4-byte one
int vec16(const void* table, const void* rows, int W) {
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(rows);
  return W % 2 == 0 && bases % 8 == 0;
}

}  // namespace

// table f32 [V, W] (written in place), ids int32 [N], rows f32 [N, W], all
// contiguous on the current device; N >= 1 (the wrapper launches nothing
// for N = 0). Returns the CUDA error of the launch (0 = launched).
extern "C" int row_scatter(void* table, const void* ids, const void* rows,
                           long long V, int W, int N, void* stream) {
  if (N < 1 || W < 1 || V < 0) return cudaErrorInvalidValue;
  const Args a{static_cast<float*>(table), static_cast<const int*>(ids),
               static_cast<const float*>(rows), V, W, N};
  const unsigned grid =
      static_cast<unsigned>((static_cast<long long>(N) + WARPS - 1) / WARPS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec16(table, rows, W))
    scatter<Piece16><<<grid, THREADS, 0, s>>>(a);
  else
    scatter<Piece4><<<grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// What row_scatter launches for N ids with these bases, without launching:
// out = {grid, threads a block, SMs, resident blocks per SM, registers a
// thread, local (spill) bytes a thread, vector bytes (16 or 4)}.
extern "C" int row_scatter_plan(const void* table, const void* rows, int W,
                                int N, int* out) {
  if (N < 1 || W < 1) return cudaErrorInvalidValue;
  const int v16 = vec16(table, rows, W);
  const void* fn = v16 ? reinterpret_cast<const void*>(scatter<Piece16>)
                       : reinterpret_cast<const void*>(scatter<Piece4>);
  int dev = 0;
  cudaFuncAttributes f;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[2], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], fn, THREADS,
                                                      0);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&f, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = static_cast<int>((static_cast<long long>(N) + WARPS - 1) / WARPS);
  out[1] = THREADS;
  out[4] = f.numRegs;
  out[5] = static_cast<int>(f.localSizeBytes);
  out[6] = v16 ? 16 : 4;
  return 0;
}
