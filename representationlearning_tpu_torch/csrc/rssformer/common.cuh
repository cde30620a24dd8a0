// Shared helpers of the RSSFormer kernels: K5 (the MlpDWBN feed-forward block)
// and K6 (the window-attention core). See the note at the top of each .cu file.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rss {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Abramowitz-Stegun 7.1.26 erf, term for term the `_erf` of the TPU kernels
// (representationlearning_tpu/ops/pallas/mit_block.py:47-59).
__device__ __forceinline__ float erf_as(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f,
              a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float s = (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + p * ax);
  const float poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))));
  return s * (1.0f - poly * expf(-ax * ax));
}

// gelu((v + bias) * scale + shift) with the affine rounded step by step (no fused
// multiply-add), as the plain version computes it, so that both round the same
// f32 value to the same bf16 operand of the next product.
__device__ __forceinline__ float bias_bn_gelu(float v, float bias, float scale, float shift) {
  const float u = __fadd_rn(__fmul_rn(__fadd_rn(v, bias), scale), shift);
  return 0.5f * u * (1.0f + erf_as(u * 0.70710678118654752f));
}

// ---- copies (K5, K6) and warp-level tensor-core pieces (K6), as K1 has them
// (csrc/mit_block/common.cuh)
// mma.sync m16n8k16, bf16 operands, f32 sums. With g = lane / 4, t = lane % 4:
//   A (16 x 16, row major): a0 = (row g, k 2t..2t+1), a1 = (row g + 8, same k),
//                           a2 = (row g, k 2t+8..2t+9), a3 = (row g + 8, same k)
//   B (16 x 8):             b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16 x 8):             c0, c1 = (row g, n 2t..2t+1), c2, c3 = (row g + 8, same n)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (or 4) from device memory to shared memory without passing through
// registers; of the 16, the bytes past `src_bytes` are filled with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two f32 -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

}  // namespace rss
