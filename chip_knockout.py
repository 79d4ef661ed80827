#!/usr/bin/env python3
"""Knock-out builds of the scan forwards and of the row scatter: where
their time goes.

    python3 chip_knockout.py                 # both sections; one card
    python3 chip_knockout.py row_scatter     # or: scan

Copies of a kernel source are patched as text, compiled into _proof/exp/
(git-ignored; one nvcc each, all started together, the program's flags)
and loaded with ctypes; nothing in the program changes. Each scan variant
is timed at the serving launch (L = 50, B = 256, H = 128, c4's serving
shape, `chip_smoke.layer_inputs`), as device time queued behind a GPU spin
(`chip_smoke.queued_ms`) and back to back.

1. "cuda_core_gru": the GRU forward's CUDA-core kernel (f32, the parity
   mode; bf16 off the mma's depth), at the CTA tile the wrapper gives it
   (two rows, 128 CTAs, Wh in shared memory), in bf16 and f32: why bf16
   read slower than f32. Variants: "program" (the program's own build),
   "base" (a copy whose CTAs record the SM they ran on: `%smid`),
   "one_cta_per_sm" (16 KB more shared memory a CTA, so two bf16 CTAs no
   longer fit on one SM), "shift_cvt" (bf16 → f32 by a 16-bit shift, exact
   as the cvt is), "both". Each is held bit for bit against the program's
   build, with its resident blocks per SM, its CTAs per SM and the
   instruction mix of its SASS.
2. "mma_lstm", "mma_gru": the bf16 tensor-core forwards. Variants: "base"
   (as built: σ and tanh from __expf and __fdividef), "exact_act" (from
   expf, tanhf and an IEEE division), "approx_act" (from
   tanh.approx.f32), "no_act" (σ, tanh replaced by affine maps),
   "split2" (each m-tile's product in two chains), "no_mma" (the step
   products skipped), "no_sync" (the step's barriers removed), "no_out"
   (no h_all stores). Only "base", "exact_act" and "split2" compute the
   contract, each printed with its largest difference from "base"; the
   others only time what is left.
3. "row_scatter" (section row_scatter): `row_scatter.cu` at the MF main
   path's item and user write-back shapes, with 1/16 of the ids sentinel
   and with a sparse step's own in-range counts ("_step": 8,618 of 14,365
   and 12,292 of 12,314, a sentinel suffix), four write-backs cycled, each
   variant timed twice (in order, then in reverse). Variants: "program"
   (the program's source), "old" (the previous one-warp-a-row kernel, its
   source kept below; "old_ids_only", "old_no_stores" knock its row copy
   out), "ids_only" (rows neither loaded nor stored: the launch, the ids,
   the address and phase work), "no_stores", "stores_only" (values made
   from the addresses, no row loads), "persistent" (the grid capped at one
   wave, SMs x resident blocks, each warp walking a span of rows, its ids
   read 32 at a time), "rows2" (two rows in flight a warp), "w4"
   (4 warps a block), "ldcs" (`rows` read evict-first too, `__ldcs`),
   "no_hints" (plain stores for `__stcs`), "ldcs_only" (`__ldcs` loads,
   plain stores), "dst32" (the body cut on the destination's 32-byte
   grid), "bulk" (a `cp.async.bulk` ring of two row buffers a warp). The
   ones that compute the contract are held bit for bit to the plain
   version, and are also timed with each call's `rows` written just before
   it (device time of the kernel alone, by the profiler), as the sparse
   step's torch.cat leaves them in L2, and as chip_smoke times the step's
   captured write-back (one ids and rows into four copies of the table,
   the same rows read by every call); "program" and "old" also writing
   contiguous table rows, with torch's `copy_` of the same rows into
   contiguous table rows beside them (the card's own copy of these
   bytes).

The last line of the output is one JSON object with every number.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "arec_torch", "csrc")
OUT = os.path.join(ROOT, "_proof", "exp")
L, B, H = 50, 256, 128
PAD = 16 * 1024

# ------------------------------------------------------------ patches ----
# (text in the source, its replacement, count expected (None: any > 0)),
# and a fourth item "scan_mma.cuh" for a patch of the shared header

SMID = ("  const int nt = blockDim.x;\n",
        "  const int nt = blockDim.x;\n  if (threadIdx.x == 0) {\n"
        "    unsigned sm;\n    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
        "    exp_smid[blockIdx.x] = sm;\n  }\n", 1)
SMID_HEAD = ('#include "scan_mma.cuh"\n',
             '#include "scan_mma.cuh"\n__device__ unsigned exp_smid[4096];\n', 1)
PAD_SMEM = ("  const size_t smem = (wh_in_smem ? H * G * welt : 0) + state;\n",
            f"  const size_t smem = (wh_in_smem ? H * G * welt : 0) + state + {PAD};\n",
            1)
SHIFT = ("  return __bfloat162float(x);\n",
         "  return __uint_as_float(static_cast<unsigned>(__bfloat16_as_ushort(x)) << 16);\n",
         1)
SMID_TAIL = """
// resident CTAs per SM of the serving launch (BT = 2, Wh in shared memory)
// in bf16 and f32 with `pad` more bytes of shared memory, and the SM each
// CTA of the last launch ran on
extern "C" int exp_blocks_per_sm(int H, int pad, int* out) {
  const size_t state = 2 * kStateWords * static_cast<size_t>(H) * sizeof(float);
  const size_t wh = static_cast<size_t>(H) * 3 * H;
  const void* fns[2] = {
      reinterpret_cast<const void*>(gru_scan_fwd_kernel<__nv_bfloat16, 2, true, false>),
      reinterpret_cast<const void*>(gru_scan_fwd_kernel<float, 2, true, false>)};
  const size_t smem[2] = {wh * 2 + state + pad, wh * 4 + state + pad};
  for (int k = 0; k < 2; ++k) {
    const cudaError_t e = kernel_info(fns[k], 2 * H, smem[k], out + 4 * k);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

extern "C" int exp_smids(unsigned* out, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, exp_smid, n * sizeof(unsigned)));
}
"""


def act(sigmoid, tanh):
    """The tensor-core step's σ and tanh replaced (macros after the shared
    header)."""
    return ('#include "scan_mma.cuh"\n',
            '#include "scan_mma.cuh"\n'
            f"__device__ __forceinline__ float exp_sigmoid(float x) {{ {sigmoid} }}\n"
            f"__device__ __forceinline__ float exp_tanh(float x) {{ {tanh} }}\n"
            "#define fast_sigmoid exp_sigmoid\n#define fast_tanh exp_tanh\n", 1)


TANH_APPROX = ("float y; asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x)); "
               "return y;")
ACTS = {
    "exact_act": act("return 1.0f / (1.0f + expf(-x));", "return tanhf(x);"),
    "approx_act": act(
        "float y; asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(y) : \"f\"(0.5f * x)); "
        "return 0.5f + 0.5f * y;", TANH_APPROX),
    "no_act": act("return 0.25f * x + 0.5f;", "return 0.5f * x;"),
}
NO_SYNC = ("    cp_async_wait_prev();      // step t+1's inputs are in\n"
           "    __syncthreads();\n",
           "    cp_async_wait_prev();      // step t+1's inputs are in\n", None)
SPLIT2 = ("  constexpr int NC = NM < 2 ? 2 : 1;", "  constexpr int NC = 2;", 1,
          "scan_mma.cuh")
NO_OUT = ("\n        const size_t out = (row0 + b) * H + j;\n        h_all[out] = hn;\n",
          "\n        const size_t out = (row0 + b) * H + j;\n", 1)


def skip(call, nm):
    """The products `call` replaced by accumulators read off the B
    fragments (so their loads stay)."""
    out = call.split("(a, bq, ")[1].rstrip(");\n")
    return (call, f"    for (int m = 0; m < {nm}; ++m)\n"
                  f"      for (int e = 0; e < 4; ++e) {out}[m][e] = "
                  f"__uint_as_float(bq[m][e] & 0x3f7fffffu);\n", 1)


EXPERIMENTS = {
    "cuda_core_gru": ("gru_scan_fwd", {
        "base": [SMID_HEAD, SMID],
        "one_cta_per_sm": [SMID_HEAD, SMID, PAD_SMEM],
        "shift_cvt": [SMID_HEAD, SMID, SHIFT],
        "both": [SMID_HEAD, SMID, PAD_SMEM, SHIFT]}),
    "mma_lstm": ("lstm_scan_fwd", {
        "base": [], **{k: [v] for k, v in ACTS.items()}, "split2": [SPLIT2],
        "no_mma": [skip("    mtile_products<0, 4>(a, bq, acc);\n", 4)],
        "no_sync": [NO_SYNC], "no_out": [NO_OUT]}),
    "mma_gru": ("gru_scan_fwd", {
        "base": [], **{k: [v] for k, v in ACTS.items()}, "split2": [SPLIT2],
        "no_mma": [skip("    mtile_products<0, 2>(a, bq, acc);\n", 2),
                   skip("    mtile_products<2, 1>(a, bq, an);\n", 1)],
        "no_sync": [NO_SYNC, ("    __syncthreads();\n\n    // n = tanh",
                              "\n    // n = tanh", 1)],
        "no_out": [NO_OUT]}),
}


# ------------------------------------------------------- row_scatter ----
# The previous kernel: one warp a row, 8 warps a block, a
# grid of ceil(N / 8) blocks, the vector width chosen once a launch.
OLD_ROW_SCATTER = r"""#include <cuda_runtime.h>

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
"""

# The cp.async.bulk ring variant: the same persistent grid, spans and id
# batches; per row one lane bulk-copies the source's 16-byte-aligned span
# into one of two row buffers of its warp (completion on an mbarrier), and
# once it has landed, bulk-copies it on to the table where the phases
# agree; where they differ the threads store it from shared memory in
# 16-byte vectors. The threads copy the 8-byte heads and tails.
BULK_ROW_SCATTER = r"""
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SPAN_MIN = 2;
constexpr int MAXW = 264;                  // floats a row buffer holds
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned sa(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ int head(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 8) ? 2 : 0;
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldcs(reinterpret_cast<const float2*>(p));
}

__global__ void __launch_bounds__(THREADS)
scatter_bulk(float* table, const int* ids, const float* rows, long long V,
             int W, int N, int span) {
  __shared__ __align__(16) float buf[WARPS][2][MAXW];
  __shared__ __align__(8) unsigned long long bar[WARPS][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    for (int k = 0; k < 2; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(sa(&bar[warp][k])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  const long long w = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (w * span >= N) return;
  int next = static_cast<int>(w * span);
  const int end = static_cast<int>(w * span + span < N ? w * span + span : N);
  int batch = 0, id = -1;
  unsigned todo = 0, phase = 0;
  auto next_row = [&](const float*& s, float*& d) -> bool {
    while (todo == 0) {
      if (next >= end) return false;
      const int r = next + lane;
      id = r < end ? __ldg(ids + r) : -1;
      todo = __ballot_sync(FULL, id >= 0 && id < V);
      batch = next;
      next += 32;
    }
    const int b = __ffs(todo) - 1;
    todo &= todo - 1;
    const int tid = __shfl_sync(FULL, id, b);
    s = rows + static_cast<size_t>(batch + b) * W;
    d = table + static_cast<size_t>(tid) * W;
    return true;
  };
  // the source's aligned span [hs, hs + 4 ns) into buffer k
  auto issue = [&](const float* s, int k) {
    const int hs = head(s);
    const unsigned bytes = ((W - hs) >> 2) * 16u;
    if (lane == 0)  // buffer k's store, two rows back, has read it
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    __syncwarp();   // and so have the threads
    if (lane == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(sa(&bar[warp][k])), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];"
          :: "r"(sa(buf[warp][k])), "l"(s + hs), "r"(bytes),
             "r"(sa(&bar[warp][k])) : "memory");
    }
  };
  auto finish = [&](const float* s, float* d, int k) {
    const unsigned parity = (phase >> k) & 1;
    phase ^= 1u << k;
    unsigned done = 0;
    while (!done)
      asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 "
                   "p, [%1], %2; selp.u32 %0, 1, 0, p; }"
                   : "=r"(done) : "r"(sa(&bar[warp][k])), "r"(parity)
                   : "memory");
    const int hs = head(s), hd = head(d);
    const int ns = (W - hs) >> 2;
    const float* b = buf[warp][k];
    if (hs == hd) {
      if (lane == 0)
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group "
                     "[%0], [%1], %2;"
                     :: "l"(d + hd), "r"(sa(b)), "r"(ns * 16) : "memory");
    } else {
      const int nb = (W - hd) >> 2;
      for (int j = lane; j < nb; j += 32) {
        const int c = hd + 4 * j;
        const float2 lo = c >= hs && c + 2 <= hs + 4 * ns
            ? *reinterpret_cast<const float2*>(b + c - hs) : ld2(s + c);
        const float2 hi = c + 2 >= hs && c + 4 <= hs + 4 * ns
            ? *reinterpret_cast<const float2*>(b + c + 2 - hs)
            : ld2(s + c + 2);
        __stcs(reinterpret_cast<float4*>(d + c),
               make_float4(lo.x, lo.y, hi.x, hi.y));
      }
    }
    if (lane == 0 && hd) __stcs(reinterpret_cast<float2*>(d), ld2(s));
    const int tail = (W - hd) & 3;
    if (lane == 1 && tail)
      __stcs(reinterpret_cast<float2*>(d + W - 2), ld2(s + W - 2));
    if (lane == 0) asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    __syncwarp();
  };
  const float *s0, *s1;
  float *d0, *d1;
  int k = 0;
  if (next_row(s0, d0)) {
    issue(s0, 0);
    for (;;) {
      const bool more = next_row(s1, d1);
      if (more) issue(s1, k ^ 1);
      finish(s0, d0, k);
      if (!more) break;
      s0 = s1;
      d0 = d1;
      k ^= 1;
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

extern "C" int row_scatter(void* table, const void* ids, const void* rows,
                           long long V, int W, int N, void* stream) {
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(rows);
  if (N < 1 || W < 6 || W > MAXW || W % 2 || bases % 8)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scatter_bulk,
                                                THREADS, 0);
  const long long want = (N + WARPS * SPAN_MIN - 1) / (WARPS * SPAN_MIN);
  const long long cap = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(want < cap ? want : cap);
  const int span = (N + grid * WARPS - 1) / (grid * WARPS);
  scatter_bulk<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), static_cast<const int*>(ids),
      static_cast<const float*>(rows), V, W, N, span);
  return static_cast<int>(cudaGetLastError());
}
"""

# (text in row_scatter.cu, its replacement, count expected)
FAKE = ("constexpr unsigned FULL = 0xffffffffu;\n",
        "constexpr unsigned FULL = 0xffffffffu;\n"
        "__device__ __forceinline__ float fake(const void* q) {\n"
        "  const uintptr_t u = reinterpret_cast<uintptr_t>(q);\n"
        "  return __int_as_float(static_cast<int>(u));\n}\n"
        "__device__ __forceinline__ float4 fake4(const void* q) {\n"
        "  const float f = fake(q);\n"
        "  return make_float4(f, f, f, f);\n}\n", 1)
NO_LOADS = [FAKE,
            ("  return *reinterpret_cast<const float4*>(p);\n",
             "  return fake4(p);\n", 1),
            ("  return *reinterpret_cast<const float2*>(p);\n",
             "  return make_float2(fake(p), fake(p));\n", 1),
            ("  return *p;\n", "  return fake(p);\n", 1)]
NO_STORES = [(f"__device__ __forceinline__ void st{n}(float* p, {t} v) {{\n",
              f"__device__ __forceinline__ void st{n}(float* p, {t} v) {{\n"
              f"  if ({x} != 1234.5f) return;\n", 1)
             for n, t, x in ((4, "float4", "v.x"), (2, "float2", "v.x"),
                             (1, "float", "v"))]
OLD_COPY = "  for (int i = lane; i < n; i += 32) dst[i] = src[i];\n"
OLD_IDS_ONLY = (OLD_COPY, "  if (reinterpret_cast<uintptr_t>(dst) == 1) "
                          "dst[0] = src[0];\n", 1)
OLD_NO_STORES = (OLD_COPY, "  for (int i = lane; i < n; i += 32) {\n"
                           "    const T v = src[i];\n"
                           "    if (*reinterpret_cast<const float*>(&v) == "
                           "1234.5f) dst[i] = v;\n  }\n", 1)
PROGRAM_KERNEL = """template <class P>
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
"""
# warps walking spans of ceil(N / warps) rows, the span's ids read 32 at a
# time (one coalesced load, handed out by __shfl_sync), `rows` rows in
# flight: all their loads, then all their stores
SPAN_KERNEL = """template <class P>
__global__ void __launch_bounds__(THREADS)
scatter(Args a) {
  constexpr int ROWS = %d;
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * WARPS;
  const long long span = (a.N + warps - 1) / warps;
  const long long r0 =
      (static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5)) *
      span;
  if (r0 >= a.N) return;
  const int first = static_cast<int>(r0);
  const int end = static_cast<int>(r0 + span < a.N ? r0 + span : a.N);
  const int pieces = P::pieces(a.W);
  int batch = -1;
  for (int base = first; base < end; base += ROWS) {
    if (((base - first) & 31) == 0) {
      const int r = base + lane;
      batch = r < end ? __ldg(a.ids + r) : -1;
    }
    int id[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      id[k] = __shfl_sync(FULL, batch, (base - first + k) & 31);
    for (int p = 0; p < pieces; ++p) {
      P piece[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        if (id[k] >= 0 && id[k] < a.V)
          piece[k].load(a, base + k, id[k], p, lane);
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        if (id[k] >= 0 && id[k] < a.V) piece[k].store(a, lane);
    }
  }
}
"""
GRID = ("  const unsigned grid =\n      static_cast<unsigned>((static_cast"
        "<long long>(N) + WARPS - 1) / WARPS);\n")
# one wave: SMs x resident blocks an SM
PERSISTENT = [(PROGRAM_KERNEL, SPAN_KERNEL % 1, 1), (GRID, """\
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const auto fn = vec16(table, rows, W) ? scatter<Piece16> : scatter<Piece4>;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, 0);
  const long long want = (static_cast<long long>(N) + WARPS - 1) / WARPS;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
""", 1)]
ROWS2 = [(PROGRAM_KERNEL, SPAN_KERNEL % 2, 1),
         (GRID, "  const unsigned grid = static_cast<unsigned>("
                "(static_cast<long long>(N) + 2 * WARPS - 1) / (2 * WARPS));\n",
          1)]
W4 = ("constexpr int WARPS = 8; ", "constexpr int WARPS = 4; ", 1)
# `rows` read evict-first too
LDCS = [("  return *reinterpret_cast<const float4*>(p);\n",
         "  return __ldcs(reinterpret_cast<const float4*>(p));\n", 1),
        ("  return *reinterpret_cast<const float2*>(p);\n",
         "  return __ldcs(reinterpret_cast<const float2*>(p));\n", 1),
        ("  return *p;\n", "  return __ldcs(p);\n", 1)]
# the table rows written with plain stores
NO_HINTS = [("  __stcs(reinterpret_cast<float4*>(p), v);\n",
             "  *reinterpret_cast<float4*>(p) = v;\n", 1),
            ("  __stcs(reinterpret_cast<float2*>(p), v);\n",
             "  *reinterpret_cast<float2*>(p) = v;\n", 1),
            ("  __stcs(p, v);\n", "  *p = v;\n", 1)]
# the body cut on the destination's 32-byte grid (a head of 0-6 floats,
# copied by lanes 0-2; the tail by lane 3), so that no warp-wide store
# leaves a 32-byte sector partly written
DST32 = [("    hd = head(d);\n    same = head(s) == hd;\n",
          "    hd = ((32 - (reinterpret_cast<uintptr_t>(d) & 31)) & 31) >> 2;\n"
          "    if (hd > a.W) hd = a.W;\n    same = head(s) == head(d);\n", 1),
         ("      if (lane == 0 && hd) e = ld2(s);\n"
          "      if (lane == 1 && tail) e = ld2(s + a.W - 2);\n",
          "      if (2 * lane < hd) e = ld2(s + 2 * lane);\n"
          "      if (lane == 3 && tail) e = ld2(s + a.W - 2);\n", 1),
         ("      if (lane == 0 && hd) st2(d, e);\n"
          "      if (lane == 1 && tail) st2(d + a.W - 2, e);\n",
          "      if (2 * lane < hd) st2(d + 2 * lane, e);\n"
          "      if (lane == 3 && tail) st2(d + a.W - 2, e);\n", 1)]
# variant: (base source, patches); None is the program's row_scatter.cu
ROW_SCATTER = {
    "program": (None, []),
    "old": (OLD_ROW_SCATTER, []),
    "old_ids_only": (OLD_ROW_SCATTER, [OLD_IDS_ONLY]),
    "old_no_stores": (OLD_ROW_SCATTER, [OLD_NO_STORES]),
    "ids_only": (None, NO_LOADS + NO_STORES),
    "no_stores": (None, NO_STORES),
    "stores_only": (None, NO_LOADS),
    "persistent": (None, PERSISTENT),
    "rows2": (None, ROWS2),
    "w4": (None, [W4]),
    "ldcs": (None, LDCS),
    "no_hints": (None, NO_HINTS),
    "ldcs_only": (None, LDCS + NO_HINTS),
    "dst32": (None, DST32),
    "bulk": (BULK_ROW_SCATTER, []),
}
# in-range ids of one sparse step's write-back (chip_smoke's MF phase, the
# step it checks against the dense one: its touched rows)
STEP_IN_RANGE = {"item": 8_618, "user": 12_292}
# the variants that compute the contract (held bit for bit to the plain
# version); the others only time what is left
RS_EXACT = ("program", "old", "persistent", "rows2", "w4", "ldcs",
            "no_hints", "ldcs_only", "dst32", "bulk")
# also timed writing contiguous table rows (ids n_valid·k + 0, 1, 2, ...)
RS_CONTIGUOUS = ("program", "old")

def variant_sources(sections):
    """{(experiment, variant): ({file name: text}, file to compile)} of the
    variants of `sections` ("scan", "row_scatter")."""
    jobs = {}
    if "scan" in sections:
        for exp, (source, variants) in EXPERIMENTS.items():
            for name, patches in variants.items():
                texts = {f: open(os.path.join(CSRC, f)).read()
                         for f in (f"{source}.cu", "scan_mma.cuh")}
                for old, new, count, *target in patches:
                    f = target[0] if target else f"{source}.cu"
                    n = texts[f].count(old)
                    assert n == count if count else n > 0, (exp, name, old,
                                                            n)
                    texts[f] = texts[f].replace(old, new)
                if exp == "cuda_core_gru":
                    texts[f"{source}.cu"] += SMID_TAIL
                jobs[exp, name] = (texts, f"{source}.cu")
    if "row_scatter" in sections:
        program = open(os.path.join(CSRC, "row_scatter.cu")).read()
        for name, (base, patches) in ROW_SCATTER.items():
            text = program if base is None else base
            for old, new, count in patches:
                n = text.count(old)
                assert n == count, ("row_scatter", name, old, n)
                text = text.replace(old, new)
            jobs["row_scatter", name] = ({"row_scatter.cu": text},
                                         "row_scatter.cu")
    return jobs


def build_all(sections):
    """{(experiment, variant): library path} and {(experiment, variant):
    registers a thread of each kernel in it (ptxas)}, all compiled
    together."""
    sys.path.insert(0, ROOT)
    from arec_torch.kernels import _build
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for (exp, name), (texts, main) in variant_sources(sections).items():
        inc = os.path.join(OUT, f"{exp}_{name}")
        os.makedirs(inc, exist_ok=True)
        for f, text in texts.items():
            with open(os.path.join(inc, f), "w") as fh:
                fh.write(text)
        so = os.path.join(OUT, f"lib{exp}_{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", inc, "-o", so,
               os.path.join(inc, main)]
        procs[exp, name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    libs, regs = {}, {}
    for key, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        libs[key] = so
        regs[key] = [int(m) for m in re.findall(r"Used (\d+) registers",
                                                 out)]
    return libs, regs


def sass_mix(so, pattern):
    """{kernel symbol matching `pattern`: {opcode: count}} in the SASS of
    library `so` ({} without cuobjdump)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    mix, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fn = fn if re.search(pattern, fn) else None
            if fn:
                mix[fn] = {}
        elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            op = line.split("*/", 1)[1].strip().split()[0].rstrip(";")
            if op.startswith("@"):
                op = line.split("*/", 1)[1].strip().split()[1]
            op = op.split(".")[0]
            mix[fn][op] = mix[fn].get(op, 0) + 1
    return mix


def entry(lib, symbol, n_ptr, n_int):
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hot_rows_ms(call, fresh, reps=3):
    """Device ms per call of a row-scatter kernel (by name, torch.profiler)
    whose `rows` were written just before it, as the sparse step's
    torch.cat leaves them in L2: each call of `fresh` = [(ids, rows, src),
    ...] copies src into rows, then scatters them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for ids, rows, src in fresh:
        rows.copy_(src)
        call((ids, rows))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for ids, rows, src in fresh:
                rows.copy_(src)
                call((ids, rows))
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and ("::scatter<" in e.key or "scatter_bulk" in e.key))
    return us / (reps * len(fresh)) / 1e3


def row_scatter_section(libs, regs, dev, stream):
    """Each row_scatter variant at the MF main path's two write-back shapes
    (chip_smoke.MF_SHAPES with 1/16 of the ids sentinel, as chip_smoke's
    row-scatter phase times them; and with the in-range counts of a sparse
    step's own write-back, "_step"): device time per call over four
    write-backs cycled (`chip_smoke.queued_ms`), timed twice, the variants
    in order and then in reverse; the contract's variants held bit for bit
    to the plain version first."""
    import torch
    from arec_torch.kernels import row_scatter as trs
    from chip_smoke import MF_SHAPES, bound_scatter, queued_ms, scatter_case

    shapes = {}
    for name, (V, W, N) in MF_SHAPES.items():
        shapes[name] = (V, W, N, N - N // 16)
        shapes[f"{name}_step"] = (V, W, N, STEP_IN_RANGE[name])

    fns = {}
    for name in ROW_SCATTER:
        fn = ctypes.CDLL(libs["row_scatter", name]).row_scatter
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    out = {}
    for shape, (V, W, N, n_valid) in shapes.items():
        table, ids, rows = scatter_case(V, W, N, n_valid, dev, seed=W + N)
        cases = [(ids, rows)] + [
            scatter_case(V, W, N, n_valid, dev, seed=k)[1:]
            for k in range(1, 4)]
        torch.cuda.empty_cache()
        orig = table.clone()
        want = trs.scatter_rows_set_plain(orig.clone(), ids, rows)
        bms, by, nbytes = bound_scatter(ids, rows, V)[:3]
        res = {"V": V, "W": W, "N": N, "n_valid": n_valid, "bound_ms": bms,
               "bound_by": by, "bytes": nbytes, "variants": {}}

        def call(fn, t, c):
            assert fn(t.data_ptr(), c[0].data_ptr(), c[1].data_ptr(), V, W,
                      N, stream) == 0

        for name, fn in fns.items():
            v = res["variants"][name] = {
                "registers": regs["row_scatter", name], "ms": []}
            if name in RS_EXACT:
                t = orig.clone()
                call(fn, t, cases[0])
                torch.cuda.synchronize()
                assert torch.equal(t, want), (shape, name, "not bit for bit")
                v["bit_for_bit"] = True
                del t
        # the same rows into contiguous table rows, sentinels kept
        contig = [(torch.cat([torch.arange(k * n_valid, (k + 1) * n_valid,
                                           dtype=torch.int32, device=dev),
                              c[0][n_valid:]]), c[1])
                  for k, c in enumerate(cases)]
        fresh = [(c[0], c[1], c[1].clone()) for c in cases]
        # chip_smoke's captured write-back timing: one ids and rows, four
        # copies of the table, so the same rows are read by every call
        copies = [table] + [table.clone() for _ in range(3)]
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                fn = fns[name]
                v = res["variants"][name]
                v["ms"].append(queued_ms(
                    [lambda c=c, fn=fn: call(fn, table, c) for c in cases]))
                if name in RS_CONTIGUOUS:
                    v.setdefault("contiguous_ms", []).append(queued_ms(
                        [lambda c=c, fn=fn: call(fn, table, c)
                         for c in contig]))
            for name in order:
                if name in RS_EXACT:
                    fn = fns[name]
                    v = res["variants"][name]
                    v.setdefault("hot_rows_ms", []).append(hot_rows_ms(
                        lambda c, fn=fn: call(fn, table, c), fresh))
                    v.setdefault("same_rows_ms", []).append(queued_ms(
                        [lambda t=t, fn=fn: call(fn, t, cases[0])
                         for t in copies]))
            res.setdefault("copy_ms", []).append(queued_ms(
                [lambda k=k, c=c: table[k * n_valid:(k + 1) * n_valid]
                 .copy_(c[1][:n_valid]) for k, c in enumerate(cases)]))
        for name, v in res["variants"].items():
            print(f"row_scatter {shape} [{V}, {W}] N={N} {name}: "
                  f"{v['ms']} ms (bound {bms:.5f}), registers "
                  f"{v['registers']}"
                  + (f"; rows just written {v['hot_rows_ms']} ms; the same "
                     f"rows into 4 table copies {v['same_rows_ms']} ms"
                     if "hot_rows_ms" in v else "")
                  + (f"; contiguous rows {v['contiguous_ms']} ms"
                     if "contiguous_ms" in v else ""), flush=True)
        print(f"row_scatter {shape}: torch copy_ of the {n_valid} valid rows "
              f"into contiguous table rows {res['copy_ms']} ms", flush=True)
        out[shape] = res
        del table, orig, want, cases, ids, rows, fresh, contig, copies
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sections = argv or ["scan", "row_scatter"]
    assert set(sections) <= {"scan", "row_scatter"}, sections
    sys.path.insert(0, ROOT)
    from arec_torch.kernels import _build
    from chip_smoke import cuda_ms, layer_inputs, queued_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    libs, regs = build_all(sections)
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    if "row_scatter" in sections:
        results["row_scatter"] = row_scatter_section(libs, regs, dev, stream)
    if "scan" in sections:
        _build.build(["gru_scan_fwd"])
        results.update(scan_section(libs, dev, stream, cuda_ms, layer_inputs,
                                    queued_ms))
    print(card)
    print(json.dumps({"card": card, **results}))
    return 0


def scan_section(libs, dev, stream, cuda_ms, layer_inputs, queued_ms):
    """Experiments 1 and 2 of the module's docstring."""
    import torch
    from arec_torch.kernels import _build
    results = {exp: {} for exp in EXPERIMENTS}

    def timed(call):
        call()
        torch.cuda.synchronize()
        return {"ms": queued_ms([call]), "back_to_back_ms": cuda_ms(call, 50)}

    # 1. the CUDA-core GRU forward, bf16 and f32, two rows a CTA
    xw, wh, mask, h0 = layer_inputs(L, B, H, dev, seed=B, cell="gru")
    ref = {}
    variants = {"program": str(_build.library_path("gru_scan_fwd")),
                **{v: libs["cuda_core_gru", v]
                   for v in EXPERIMENTS["cuda_core_gru"][1]}}
    for name, so in variants.items():
        lib = ctypes.CDLL(so)
        fn = entry(lib, "gru_scan_fwd", 5, 6)
        res = {"sass": {
            "bfloat16" if "bfloat16Li2" in k else "float32":
                {op: n for op, n in sorted(m.items(), key=lambda kv: -kv[1])}
            for k, m in sass_mix(
                so, r"gru_scan_fwd_kernelI.*Li2ELb1ELb0E").items()}}
        if name != "program":
            info = (ctypes.c_int * 8)()
            pad = PAD if name in ("one_cta_per_sm", "both") else 0
            assert lib.exp_blocks_per_sm(H, pad, info) == 0
            res["blocks_per_sm"] = {"bfloat16": info[3], "float32": info[7]}
            res["registers"] = {"bfloat16": info[0], "float32": info[4]}
        for dt in ("bfloat16", "float32"):
            w = wh.to(getattr(torch, dt)).contiguous()
            out = torch.empty(L, B, H, device=dev)

            def call():
                assert fn(xw.data_ptr(), w.data_ptr(), mask.data_ptr(),
                          h0.data_ptr(), out.data_ptr(), L, B, H,
                          int(dt == "bfloat16"), 2, 1, stream) == 0
            res[dt] = timed(call)
            if name == "program":
                ref[dt] = out.clone()
            else:
                call()
                torch.cuda.synchronize()
                smid = (ctypes.c_uint * (B // 2))()
                assert lib.exp_smids(smid, B // 2) == 0
                per_sm = {}
                for s in smid:
                    per_sm[s] = per_sm.get(s, 0) + 1
                res[dt].update(sms_used=len(per_sm), sms_with_2_ctas=sum(
                    n > 1 for n in per_sm.values()))
            assert torch.equal(out, ref[dt]), (name, dt, "not bit for bit")
            print(f"cuda_core_gru {name} {dt}: {res[dt]}", flush=True)
        results["cuda_core_gru"][name] = res

    # 2. the bf16 tensor-core forwards' serving launch
    for exp, cell, symbol, n_ptr in (("mma_lstm", "lstm", "lstm_scan_fwd_bf16",
                                      7),
                                     ("mma_gru", "gru", "gru_scan_fwd_bf16",
                                      5)):
        args = layer_inputs(L, B, H, dev, seed=B, cell=cell)
        xw, wh, mask, h0 = args[:4]
        wt = wh.t().to(torch.bfloat16, memory_format=torch.contiguous_format)
        outs = [torch.empty(L, B, H, device=dev)] + (
            [torch.empty(B, H, device=dev)] if cell == "lstm" else [])
        ptrs = [t.data_ptr() for t in (xw, wt, mask, *args[3:], *outs)]
        base = None
        for name in EXPERIMENTS[exp][1]:
            fn = entry(ctypes.CDLL(libs[exp, name]), symbol, n_ptr, 3)

            def call():
                assert fn(*ptrs, L, B, H, stream) == 0
            res = timed(call)
            if name in ("base", "exact_act", "split2"):
                call()
                torch.cuda.synchronize()
                if base is None:
                    base = outs[0].clone()
                res["max_abs_diff_from_base"] = float(
                    (outs[0] - base).abs().max())
            results[exp][name] = res
            print(f"{exp} {name}: {res}", flush=True)
    results["shape"] = f"L={L} B={B} H={H}"
    return results


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
