// K2: dilated-neighbour affinity weights for VARM / PAR / PAMR.
//
// Replaces: the TPU kernel `affinity_pallas`
//   (representationlearning_tpu/ops/pallas/affinity.py:134, body `_kernel` :46).
// What it computes, per pixel (b, y, x), over the K = 8 * n_dil taps in order:
//   nb_k[c] = img[b, c, clamp(y + dy d), clamp(x + dx d)]
//   mean, unbiased variance of nb over K per channel (two passes)
//   inv[c]  = scale / (sqrt(var / (K - 1)) + 1e-8)
//   a_k     = -mean_c((|nb_k[c] - centre[c]| * inv[c])^2)
//   out_k   = softmax_k(a) + w2 * pos[k]              (par)
//           = softmax_k(a)                            (pamr)
//           = softmax_k(a) - w2 * softmax_k(t)        (varm)
//   t_k     = mean_c(d1^2 + d2^2), d1 / d2 the difference of nb_k to the same
//             tap of the next output row / column (zero on the last one).
// What bounds it on the H100: device-memory bytes. The (B, K, H, W) f32 output
//   is K / 3 times the input; the arithmetic per output value is a few dozen
//   operations on an image that stays in L1 / L2.
// What the design does about it: one thread per pixel, consecutive threads
//   along x, so each of a warp's K stores is one contiguous row segment of
//   plane k and each neighbour load one (clamped) row segment. K logits per
//   thread would not fit in registers with a run-time K, so nothing is kept:
//   the logits are recomputed in a max pass, a sum pass and a write pass over
//   the taps (the image is read from cache each time), and the output is
//   written exactly once. Replicate padding is index clamping; no padded copy
//   of the image is made. A pixel whose neighbours all equal the centre gets
//   exactly zero logits and a uniform softmax, whatever `inv` is.
#include "common.cuh"

namespace refine {

constexpr int kPar = 0, kPamr = 1, kVarm = 2;

struct PosSoftmax {
  float v[kMaxTaps];
};

struct Pixel {
  const float* img;  // this image's three planes
  int H, W, y, x;
  size_t plane;
  float centre[3];

  __device__ __forceinline__ float at(int c, int yy, int xx) const {
    return img[c * plane + (size_t)yy * W + xx];
  }

  // a_k: minus the mean over channels of the squared scaled colour distance
  __device__ __forceinline__ float logit(int yy, int xx, const float* inv) const {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float a = fabsf(at(c, yy, xx) - centre[c]) * inv[c];
      s += a * a;
    }
    return -s * (1.0f / 3.0f);
  }

  // t_k: the local variation of tap (dy, dx) * d
  __device__ __forceinline__ float variation(int oy, int ox) const {
    const int yy = clampi(y + oy, H - 1), xx = clampi(x + ox, W - 1);
    // the same tap seen from the next output row / column: clamp(y + 1 + oy),
    // not clamp(y + oy) + 1
    const int y1 = clampi(y + 1 + oy, H - 1), x1 = clampi(x + 1 + ox, W - 1);
    // On raw 0..255 images t reaches 1e5, where one f32 spacing (0.008) is a
    // percent of exp(t - tmax): each square and each sum is rounded on its own
    // (no fused multiply-add), as the plain version's elementwise ops round them.
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = at(c, yy, xx);
      const float d1 = (y == H - 1) ? 0.f : v - at(c, y1, xx);
      const float d2 = (x == W - 1) ? 0.f : v - at(c, yy, x1);
      const float sq = __fadd_rn(__fmul_rn(d1, d1), __fmul_rn(d2, d2));
      s = (c == 0) ? sq : __fadd_rn(s, sq);
    }
    return __fmul_rn(s, 1.0f / 3.0f);
  }
};

template <int MODE>
__global__ void __launch_bounds__(256)
affinity_kernel(const float* __restrict__ imgs, float* __restrict__ out, int H, int W,
                Dilations dil, float scale, float w2, PosSoftmax pos) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  const int K = 8 * dil.n;
  Pixel p;
  p.plane = (size_t)H * W;
  p.img = imgs + (size_t)b * 3 * p.plane;
  p.H = H; p.W = W; p.y = y; p.x = x;
#pragma unroll
  for (int c = 0; c < 3; ++c) p.centre[c] = p.at(c, y, x);

  // pass 1: mean over the K neighbours
  float mean[3] = {0.f, 0.f, 0.f};
  for (int i = 0; i < dil.n; ++i) {
    const int d = dil.d[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int yy = clampi(y + tap_dy(j) * d, H - 1), xx = clampi(x + tap_dx(j) * d, W - 1);
#pragma unroll
      for (int c = 0; c < 3; ++c) mean[c] += p.at(c, yy, xx);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) mean[c] *= 1.0f / (float)K;

  // pass 2: unbiased variance -> inv = scale / (std + 1e-8)
  float inv[3] = {0.f, 0.f, 0.f};
  for (int i = 0; i < dil.n; ++i) {
    const int d = dil.d[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int yy = clampi(y + tap_dy(j) * d, H - 1), xx = clampi(x + tap_dx(j) * d, W - 1);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float df = p.at(c, yy, xx) - mean[c];
        inv[c] += df * df;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
    inv[c] = scale / (sqrtf(inv[c] * (1.0f / (float)(K - 1))) + 1e-8f);

  // pass 3: the largest logit (and the largest variation)
  float amax = -INFINITY, tmax = -INFINITY;
  for (int i = 0; i < dil.n; ++i) {
    const int d = dil.d[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int oy = tap_dy(j) * d, ox = tap_dx(j) * d;
      amax = fmaxf(amax, p.logit(clampi(y + oy, H - 1), clampi(x + ox, W - 1), inv));
      if (MODE == kVarm) tmax = fmaxf(tmax, p.variation(oy, ox));
    }
  }

  // pass 4: the softmax denominators
  float asum = 0.f, tsum = 0.f;
  for (int i = 0; i < dil.n; ++i) {
    const int d = dil.d[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int oy = tap_dy(j) * d, ox = tap_dx(j) * d;
      asum += expf(p.logit(clampi(y + oy, H - 1), clampi(x + ox, W - 1), inv) - amax);
      if (MODE == kVarm) tsum += expf(p.variation(oy, ox) - tmax);
    }
  }

  // pass 5: write each weight once, plane k, row y, coalesced along x
  float* o = out + (size_t)b * K * p.plane + (size_t)y * W + x;
  for (int i = 0; i < dil.n; ++i) {
    const int d = dil.d[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int oy = tap_dy(j) * d, ox = tap_dx(j) * d;
      const int k = 8 * i + j;
      float r = expf(p.logit(clampi(y + oy, H - 1), clampi(x + ox, W - 1), inv) - amax) / asum;
      if (MODE == kPar) r += w2 * pos.v[k];
      if (MODE == kVarm) r -= w2 * (expf(p.variation(oy, ox) - tmax) / tsum);
      o[(size_t)k * p.plane] = r;
    }
  }
}

}  // namespace refine

// imgs (B, 3, H, W) f32 -> out (B, 8 * n_dil, H, W) f32. `dilations` and `pos`
// (8 * n_dil floats, read in par mode only) are host arrays.
extern "C" int k2_affinity(const void* imgs, void* out, int B, int H, int W,
                           const int* dilations, int n_dil, int mode, float scale,
                           float w2, const float* pos, void* stream) {
  using namespace refine;
  if (n_dil < 1 || n_dil > kMaxDilations || mode < kPar || mode > kVarm)
    return (int)cudaErrorInvalidValue;
  Dilations dil;
  PosSoftmax ps;
  dil.n = n_dil;
  for (int i = 0; i < kMaxDilations; ++i) dil.d[i] = i < n_dil ? dilations[i] : 0;
  for (int k = 0; k < kMaxTaps; ++k) ps.v[k] = k < 8 * n_dil ? pos[k] : 0.f;
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, B);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* in = (const float*)imgs;
  float* o = (float*)out;
  if (mode == kPar)
    affinity_kernel<kPar><<<grid, block, 0, s>>>(in, o, H, W, dil, scale, w2, ps);
  else if (mode == kPamr)
    affinity_kernel<kPamr><<<grid, block, 0, s>>>(in, o, H, W, dil, scale, w2, ps);
  else
    affinity_kernel<kVarm><<<grid, block, 0, s>>>(in, o, H, W, dil, scale, w2, ps);
  return (int)cudaGetLastError();
}
