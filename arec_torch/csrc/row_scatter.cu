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
// a suffix.
//
// What bounds it: bytes. Each valid row is read once from `rows` and
// written once into `table`, and there is no arithmetic. At the MF main
// path (14,365 rows of 258 f32 into the [1,304,126, 258] item table,
// 12,314 rows of 256 into the [1,504,123, 256] user table) that is about
// 30 MB and 25 MB, 9 and 7.5 us of HBM time at 3.35 TB/s.
//
// What the design does. The TPU kernel read a host-formed n_valid from SMEM
// and walked the rows in order with 8 DMAs in flight. Here one warp copies
// one row and 8 warps share a block; each warp reads its own id and
// returns when it is out of range, so no n_valid is formed (no prefix
// count, no host sync) and the sentinel suffix costs one id load a row.
// The lanes move the row in coalesced vectors of VEC floats: 16 bytes when
// W % 4 == 0 and both bases are 16-byte aligned (the user table's 1024-byte
// pitch), 8 bytes when W is even and the bases 8-byte aligned (the item
// table's 1032-byte pitch, which is 16-byte aligned only on even rows),
// else 4. Unique in-range ids make the writes race-free and the result
// independent of the order the blocks run in: it is the serial copy, bit
// for bit. Rows that no id names are never touched.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int WARPS = 8;        // rows per block, one warp each

template <int VEC> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

template <int VEC>
__global__ void __launch_bounds__(WARPS * 32)
scatter(float* __restrict__ table, const int* __restrict__ ids,
        const float* __restrict__ rows, long long V, int W, int N) {
  using T = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const long long r =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (r >= N) return;
  const int id = ids[r];
  if (id < 0 || id >= V) return;
  const T* src = reinterpret_cast<const T*>(rows + r * W);
  T* dst = reinterpret_cast<T*>(table + static_cast<long long>(id) * W);
  const int n = W / VEC;
  for (int i = lane; i < n; i += 32) dst[i] = src[i];
}

}  // namespace

// table f32 [V, W] (written in place), ids int32 [N], rows f32 [N, W], all
// contiguous on one device; N >= 1 (the wrapper launches nothing for N = 0).
// Returns the CUDA error of the launch (0 = launched).
extern "C" int row_scatter(void* table, const void* ids, const void* rows,
                           long long V, int W, int N, void* stream) {
  if (N < 1 || W < 1 || V < 0) return cudaErrorInvalidValue;
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(rows);
  const int vec = (W % 4 == 0 && bases % 16 == 0)  ? 4
                  : (W % 2 == 0 && bases % 8 == 0) ? 2
                                                   : 1;
  const unsigned blocks = static_cast<unsigned>((N + WARPS - 1) / WARPS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* t = static_cast<float*>(table);
  const int* i = static_cast<const int*>(ids);
  const float* r = static_cast<const float*>(rows);
  if (vec == 4)
    scatter<4><<<blocks, WARPS * 32, 0, s>>>(t, i, r, V, W, N);
  else if (vec == 2)
    scatter<2><<<blocks, WARPS * 32, 0, s>>>(t, i, r, V, W, N);
  else
    scatter<1><<<blocks, WARPS * 32, 0, s>>>(t, i, r, V, W, N);
  return static_cast<int>(cudaGetLastError());
}
