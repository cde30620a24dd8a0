// K3: one iteration of the VARM / PAR mask propagation.
//
// Replaces: the TPU kernel `varm_propagate_pallas`
//   (representationlearning_tpu/ops/pallas/varm.py:91, body `_kernel` :35).
// What it computes:
//   dst[b, c, y, x] = sum_k ref[b, k, y, x] * src[b, c, clamp(y + dy_k d_k), clamp(x + dx_k d_k)]
//   summed in tap order starting from the k = 0 term, f32. The wrapper launches
//   it `num_iter` times, ping-ponging between two buffers.
// What bounds it on the H100: f32 operations and cache traffic, not device
//   memory. Every output value needs K multiply-adds and K mask loads at
//   scattered (dilated) offsets; masks and weights of one call fit, or nearly
//   fit, in the 50 MB L2.
// What the design does about it: the TPU kernel holds a block of mask planes
//   in fast memory across all iterations, which a 227 KB shared memory cannot
//   do for a halo that grows by max(d) per iteration; so one launch is one
//   iteration. One thread per (b, y, x) loops over a block of kChannels mask
//   planes with the accumulators in registers, so each weight ref[k] is loaded
//   once per channel block, coalesced along x, and reused for every channel.
//   Each product and each sum is rounded on its own (`__fmul_rn`, `__fadd_rn`:
//   no fused multiply-add), in the plain version's order, so the result equals
//   the plain version bit for bit.
#include "common.cuh"

namespace refine {

constexpr int kChannels = 6;  // mask planes per thread

__global__ void __launch_bounds__(256)
varm_iter_kernel(const float* __restrict__ src, const float* __restrict__ ref,
                 float* __restrict__ dst, int C, int H, int W, int cblocks, Dilations dil) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z / cblocks;
  const int c0 = (blockIdx.z % cblocks) * kChannels;
  if (x >= W || y >= H) return;
  const int nc = min(kChannels, C - c0);  // C need not divide the channel block
  const size_t plane = (size_t)H * W;
  const size_t pix = (size_t)y * W + x;
  const float* m = src + ((size_t)b * C + c0) * plane;
  const float* r = ref + (size_t)b * 8 * dil.n * plane + pix;

  float acc[kChannels];
#pragma unroll
  for (int c = 0; c < kChannels; ++c) acc[c] = 0.f;
  for (int i = 0; i < dil.n; ++i) {
    const int d = dil.d[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float w = r[(size_t)(8 * i + j) * plane];
      const size_t nb = (size_t)clampi(y + tap_dy(j) * d, H - 1) * W + clampi(x + tap_dx(j) * d, W - 1);
#pragma unroll
      for (int c = 0; c < kChannels; ++c) {
        if (c < nc) {
          const float term = __fmul_rn(m[c * plane + nb], w);
          // the k = 0 term starts the sum, as in the plain version
          acc[c] = (i == 0 && j == 0) ? term : __fadd_rn(acc[c], term);
        }
      }
    }
  }
  float* o = dst + ((size_t)b * C + c0) * plane + pix;
#pragma unroll
  for (int c = 0; c < kChannels; ++c)
    if (c < nc) o[c * plane] = acc[c];
}

}  // namespace refine

// src, dst (B, C, H, W) f32, distinct buffers; ref (B, 8 * n_dil, H, W) f32.
// `dilations` is a host array.
extern "C" int k3_varm_iter(const void* src, const void* ref, void* dst, int B, int C,
                            int H, int W, const int* dilations, int n_dil, void* stream) {
  using namespace refine;
  if (n_dil < 1 || n_dil > kMaxDilations) return (int)cudaErrorInvalidValue;
  Dilations dil;
  dil.n = n_dil;
  for (int i = 0; i < kMaxDilations; ++i) dil.d[i] = i < n_dil ? dilations[i] : 0;
  const int cblocks = (C + kChannels - 1) / kChannels;
  if ((long long)B * cblocks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, B * cblocks);
  varm_iter_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)ref, (float*)dst, C, H, W, cblocks, dil);
  return (int)cudaGetLastError();
}
