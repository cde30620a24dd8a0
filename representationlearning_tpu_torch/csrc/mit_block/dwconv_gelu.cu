// K1 part 4: MixFFN's 3x3 zero-padded depthwise conv + bias + exact GELU.
//
// Replaces: representationlearning_tpu/ops/pallas/mit_block.py:169-182 (the nine
//   shifted multiply-adds on the (H, W, hid) grid and the A&S-erf GELU of
//   `_block_math` :62, reached from `fused_block_pallas` :259 -> `_kernel` :216).
// What bounds it on the H100: device-memory bytes. It does 9 multiply-adds per
//   element and moves 8 bytes per element (f32 in, f32 out); at stage 1 that is
//   8 x 16384 x 256 elements, 134 MB each way.
// What the design does about it: one thread per output element with channels
//   fastest, so a warp reads 32 neighbouring channels of one pixel and each of
//   the nine taps is a coalesced read; the one-pixel halo comes from the L1/L2
//   caches, not from a staged copy. Taps accumulate in the TPU kernel's order
//   (ky, kx), bias follows, then GELU with the same Abramowitz-Stegun erf, so
//   the result is the TPU kernel's to rounding.
#include "common.cuh"

namespace k1 {

__global__ void dwconv_gelu_kernel(const float* __restrict__ f, const float* __restrict__ w,
                                   const float* __restrict__ bias, float* __restrict__ out,
                                   int B, int H, int W, int hid) {
  const size_t total = (size_t)B * H * W * hid;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % hid);
    const size_t pos = idx / hid;
    const int x = (int)(pos % W);
    const int y = (int)((pos / W) % H);
    const size_t b = pos / ((size_t)H * W);
    const float* wc = w + (size_t)c * 9;
    float acc = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int yy = y + ky - 1;
      if (yy < 0 || yy >= H) continue;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int xx = x + kx - 1;
        if (xx < 0 || xx >= W) continue;
        acc += f[((b * H + yy) * W + xx) * hid + c] * wc[ky * 3 + kx];
      }
    }
    const float v = acc + bias[c];
    out[idx] = 0.5f * v * (1.0f + erf_as(v * 0.70710677f));
  }
}

}  // namespace k1

// out (B, H*W, hid) = gelu(dwconv3x3(f) + bias); f (B, H*W, hid) f32, w (hid, 9) f32.
extern "C" int k1_dwconv_gelu(const void* f, const void* w, const void* bias, void* out,
                              int B, int H, int W, int hid, void* stream) {
  const size_t total = (size_t)B * H * W * hid;
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 1048576 ? want : 1048576);
  k1::dwconv_gelu_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)f, (const float*)w, (const float*)bias, (float*)out, B, H, W, hid);
  return (int)cudaGetLastError();
}
