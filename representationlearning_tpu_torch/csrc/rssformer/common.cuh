// Shared helpers of the RSSFormer kernels: K5 (the MlpDWBN feed-forward block)
// and K6 (the window-attention core). See the note at the top of each .cu file.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace rss
