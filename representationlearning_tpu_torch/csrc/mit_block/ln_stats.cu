// K1 part 1: LayerNorm row statistics.
//
// Replaces: the `_ln` statistics of the TPU kernel
//   representationlearning_tpu/ops/pallas/mit_block.py:34-39 (`_ln`, reached from
//   `fused_block_pallas` :259 through `_kernel` :216 -> `_block_math` :62), for
//   LN1, the sr LayerNorm and LN2.
// What bounds it on the H100: device-memory bytes. It reads each row of
//   (rows, C) f32 once and writes 8 bytes a row; there is no arithmetic to speak of.
// What the design does about it: one warp per row, lanes stride over the
//   channels so a warp reads one contiguous row; sum and sum of squares in one
//   pass (the one-pass variance E[x^2] - mu^2 of `_ln`). The GEMM kernels apply
//   (x - mu) * rstd * g + b as their A-operand prologue, so the normalised
//   tensor itself is never written to device memory.
#include "common.cuh"

namespace k1 {

__global__ void ln_stats_kernel(const float* __restrict__ x, float* __restrict__ stats,
                                int rows, int C) {
  const int warps = blockDim.x / 32;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * C;
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = xr[c];
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    const float mu = s / (float)C;
    const float var = ss / (float)C - mu * mu;
    stats[2 * (size_t)row] = mu;
    stats[2 * (size_t)row + 1] = rsqrtf(var + kLnEps);
  }
}

}  // namespace k1

extern "C" int k1_ln_stats(const void* x, void* stats, int rows, int C, void* stream) {
  const int threads = 256;
  const int rows_per_block = threads / 32;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  k1::ln_stats_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)stats, rows, C);
  return (int)cudaGetLastError();
}
