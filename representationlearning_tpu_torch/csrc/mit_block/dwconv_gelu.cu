// K1 part 4: MixFFN's 3x3 zero-padded depthwise conv + bias + exact GELU.
//
// Replaces: representationlearning_tpu/ops/pallas/mit_block.py:169-182 (the nine
//   shifted multiply-adds on the (H, W, hid) grid and the A&S-erf GELU of
//   `_block_math` :62, reached from `fused_block_pallas` :259 -> `_kernel` :216).
// What bounds it on the H100: device-memory bytes, with the GELU's instructions
//   close behind. It does 9 multiply-adds and some 30 instructions of bias and
//   GELU per element and moves 8 bytes per element (f32 in, f32 out); at stage 1
//   of the 512 x 512 forward that is 8 x 16384 x 256 elements, 134 MB each way.
// What the design does about it:
//   * A thread owns 4 channels (one float4) x a run of R columns and walks a run of
//     rows (both from the wrapper's `dwconv_plan`: R 1, 2 or 4), keeping a sliding
//     window of three input rows of R + 2 float4 in registers, plus the next row,
//     loaded while the current one is computed. Each input is read about
//     (R + 2) / R x (rows + 2) / rows times, not nine, and the repeats of the halo
//     come from L1 / L2 while device memory sees each byte about once.
//   * Lanes run along channels, so every warp access is 512 contiguous bytes;
//     loads are 16-byte read-only loads and stores are float4.
//   * The thread's 36 weights (9 float4 loads: its 4 channels' 9 taps lie side by
//     side) and 4 biases are loaded once into registers.
//   * 32-bit index math from blockIdx: x = channel group + column run, y = row
//     run, z = image; one 64-bit image offset.
//   * Zero padding by predicated loads: a tap outside the grid reads zero and adds
//     0 * w, with no branch in the inner loop.
//   * Taps accumulate in the TPU kernel's order (ky, kx) as multiply-adds, the bias
//     follows, then GELU with the same Abramowitz-Stegun erf (`gelu_as`, branch-free,
//     common.cuh). Every plan computes each output by the same instructions, so all
//     plans give the same bits.
#include "common.cuh"

namespace k1 {

constexpr int kDwThreads = 128;

__device__ __forceinline__ float4 fma4(float4 a, float4 b, float4 c) {
  return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y), fmaf(a.z, b.z, c.z),
                     fmaf(a.w, b.w, c.w));
}

struct DwArgs {
  const float* f;
  const float* w;
  const float* bias;
  float* out;
  int H, W, G;   // grid rows and columns; G = hid / 4 channel groups
  int runs;      // column runs a row: ceil(W / R)
  int rows;      // rows a thread walks
};

template <int R>
__global__ void __launch_bounds__(kDwThreads) dwconv_gelu_kernel(const DwArgs p) {
  const int t = blockIdx.x * kDwThreads + threadIdx.x;
  if (t >= p.G * p.runs) return;
  const int xr = t / p.G, c4 = t - xr * p.G;
  const int H = p.H, W = p.W, G = p.G;
  const int x0 = xr * R;
  const int y0 = blockIdx.y * p.rows;
  const int y1 = min(y0 + p.rows, H);
  const size_t img = (size_t)blockIdx.z * H * W * G;
  const float4* src = reinterpret_cast<const float4*>(p.f) + img + c4;
  float4* dst = reinterpret_cast<float4*>(p.out) + img + c4;

  // weights: channels 4 c4 .. 4 c4 + 3, taps 0..8 each, 36 consecutive floats
  float wt[36];
  const float4* w4 = reinterpret_cast<const float4*>(p.w) + c4 * 9;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float4 v = __ldg(w4 + i);
    wt[4 * i] = v.x;
    wt[4 * i + 1] = v.y;
    wt[4 * i + 2] = v.z;
    wt[4 * i + 3] = v.w;
  }
  float4 wk[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wk[k] = make_float4(wt[k], wt[9 + k], wt[18 + k], wt[27 + k]);
  const float4 bs = __ldg(reinterpret_cast<const float4*>(p.bias) + c4);

  // row y, columns x0 - 1 .. x0 + R; zero outside the grid
  auto load_row = [&](float4 (&row)[R + 2], int y) {
    const bool yok = y >= 0 && y < H;
    const int base = (y * W + x0 - 1) * G;
#pragma unroll
    for (int j = 0; j < R + 2; ++j) {
      const int xx = x0 - 1 + j;
      const bool ok = yok && xx >= 0 && xx < W;
      row[j] = ok ? __ldg(src + base + j * G) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  float4 win[3][R + 2], next[R + 2];
  load_row(win[0], y0 - 1);
  load_row(win[1], y0);
  load_row(win[2], y0 + 1);
  for (int y = y0; y < y1; ++y) {
    load_row(next, y + 2);   // in flight while row y is computed
    const int obase = (y * W + x0) * G;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) acc = fma4(win[ky][j + kx], wk[ky * 3 + kx], acc);
      const float4 o = make_float4(gelu_as(acc.x + bs.x), gelu_as(acc.y + bs.y),
                                   gelu_as(acc.z + bs.z), gelu_as(acc.w + bs.w));
      if (x0 + j < W) dst[obase + j * G] = o;
    }
#pragma unroll
    for (int j = 0; j < R + 2; ++j) {
      win[0][j] = win[1][j];
      win[1][j] = win[2][j];
      win[2][j] = next[j];
    }
  }
}

template <int R>
cudaError_t dwconv_launch(DwArgs p, int B, cudaStream_t st) {
  p.runs = (p.W + R - 1) / R;
  const dim3 grid((p.G * p.runs + kDwThreads - 1) / kDwThreads, (p.H + p.rows - 1) / p.rows, B);
  dwconv_gelu_kernel<R><<<grid, kDwThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace k1

// out (B, H*W, hid) = gelu(dwconv3x3(f) + bias); f (B, H*W, hid) f32, w (hid, 9) f32,
// all 16-byte aligned, hid % 4 == 0. `cols` (R: 1, 2 or 4) and `rows` come from the
// wrapper's plan.
extern "C" int k1_dwconv_gelu(const void* f, const void* w, const void* bias, void* out,
                              int B, int H, int W, int hid, int cols, int rows, void* stream) {
  using namespace k1;
  if (B < 1 || H < 1 || W < 1 || hid < 4 || hid % 4 || rows < 1 ||
      (H + rows - 1) / rows > 65535 || B > 65535 || (long long)H * W * hid >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const DwArgs p{(const float*)f, (const float*)w, (const float*)bias, (float*)out,
                 H, W, hid / 4, 0, rows};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (cols) {
    case 1: return (int)dwconv_launch<1>(p, B, st);
    case 2: return (int)dwconv_launch<2>(p, B, st);
    case 4: return (int)dwconv_launch<4>(p, B, st);
  }
  return (int)cudaErrorInvalidValue;
}

namespace k1 {

// The GELU as written before it was made branch-free: the A&S erf with sign(x) and the
// IEEE division. The reference of gelu_as.
__device__ __forceinline__ float gelu_as_divided(float v) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f,
              a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float x = v * 0.70710677f;
  const float s = (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + p * ax);
  const float poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))));
  return 0.5f * v * (1.0f + s * (1.0f - poly * expf(-ax * ax)));
}

__global__ void gelu_check_kernel(unsigned long long* bad) {
  unsigned long long n = 0;
  const unsigned step = gridDim.x * blockDim.x;
  for (unsigned u = blockIdx.x * blockDim.x + threadIdx.x;; u += step) {
    const float a = gelu_as(__uint_as_float(u)), b = gelu_as_divided(__uint_as_float(u));
    n += __float_as_uint(a) != __float_as_uint(b) && !(isnan(a) && isnan(b));
    if (u > 0xffffffffu - step) break;
  }
  atomicAdd(bad, n);
}

}  // namespace k1

// The f32 inputs (all 2^32 bit patterns) on which gelu_as differs in its bits from
// the formula with sign(x) and the IEEE division, at most 2^31 - 1; -1 on a CUDA
// error. Synchronises: for tests only.
extern "C" int k1_gelu_as_mismatches() {
  unsigned long long* d = nullptr;
  unsigned long long n = 0;
  if (cudaMalloc(&d, sizeof(n)) != cudaSuccess) return -1;
  cudaMemset(d, 0, sizeof(n));
  k1::gelu_check_kernel<<<1024, 256>>>(d);
  const bool ok = cudaMemcpy(&n, d, sizeof(n), cudaMemcpyDeviceToHost) == cudaSuccess;
  cudaFree(d);
  return ok ? (int)(n < 0x7fffffffull ? n : 0x7fffffffull) : -1;
}
