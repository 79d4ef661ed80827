// mma_probe: how the card's tensor cores sum a bf16 product in f32.
//
// One warp runs mma.sync m16n8k16 (bf16 operands, f32 accumulators), the
// instruction of every bf16 product in sampled_ce.cu and in the scan
// backwards, over K / 16 chained k-steps: d [16, 8] = c + a · bᵀ with
// a [16, K] and b [8, K] bf16 (row-major), c and d f32. Its fragments are
// loaded straight from global memory in the instruction's documented
// layout. It replaces no TPU kernel: it lets a test check, against an
// exact sum, the premise sampled_ce.cu's rounding window rests on (the
// tensor cores' sum-order error, after Fasi et al., 2021).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void mma_probe_kernel(const __nv_bfloat16* __restrict__ a,
                                 const __nv_bfloat16* __restrict__ b,
                                 const float* __restrict__ c, float* __restrict__ d, int K) {
  const int lane = threadIdx.x;
  const int g = lane >> 2;
  const int t = 2 * (lane & 3);
  float acc[4] = {c[g * 8 + t], c[g * 8 + t + 1], c[(g + 8) * 8 + t], c[(g + 8) * 8 + t + 1]};
  for (int k = 0; k < K; k += 16) {
    const uint32_t a0 = ld32(a + g * K + k + t);
    const uint32_t a1 = ld32(a + (g + 8) * K + k + t);
    const uint32_t a2 = ld32(a + g * K + k + 8 + t);
    const uint32_t a3 = ld32(a + (g + 8) * K + k + 8 + t);
    const uint32_t b0 = ld32(b + g * K + k + t);
    const uint32_t b1 = ld32(b + g * K + k + 8 + t);
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  d[g * 8 + t] = acc[0];
  d[g * 8 + t + 1] = acc[1];
  d[(g + 8) * 8 + t] = acc[2];
  d[(g + 8) * 8 + t + 1] = acc[3];
}

}  // namespace

// Plain C entry point, loaded with ctypes: device pointers a [16, K], b
// [8, K] (bf16), c, d [16, 8] (f32), K a multiple of 16, the caller's
// stream. Returns the launch's cudaError_t.
extern "C" int mma_probe(const void* a, const void* b, const void* c, void* d, int K,
                         void* stream) {
  if (K < 16 || K % 16) return cudaErrorInvalidValue;
  mma_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<const float*>(c), static_cast<float*>(d), K);
  return static_cast<int>(cudaGetLastError());
}
