// Shared pieces of the K4 backward (flash attention): the tile loader and three
// register-tiled products over tiles in shared memory. See the note at the top of
// flash_bwd.cu. (The forward, flash_fwd.cu, runs on the tensor cores and keeps its
// own pieces.)
//
// A thread block has 128 threads seen as 8 x 16 (ty, tx). Of a 64-row output
// tile thread (ty, tx) owns rows ty + 8 i (i < 8) and columns tx + 16 j, so the
// 16 threads that share a row are the lanes of one half-warp. Tiles of q, k, v,
// do are stored as f32 with an odd pitch (HD + 1), the score tiles with pitch 65:
// a warp's reads are then either one address (broadcast) or 16 different banks.
// bf16 inputs are widened on the way into shared memory, which is exact; products
// of two bf16 values are exact in f32, so the sums are f32 accumulations of bf16
// operands.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace k4 {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;       // query rows per tile
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 128;
constexpr int kLdS = kBK + 1;  // f32 pitch of a score tile

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v as the input dtype would hold it (the TPU kernel's `.astype(q.dtype)`)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows row0 .. row0 + 63 of src (n rows of HD values) -> dst[64][HD + 1] as f32,
// zeros past the end
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* dst, int row0,
                                          int n) {
  constexpr int P = HD + 1;
  for (int idx = threadIdx.x; idx < 64 * HD; idx += kThreads) {
    const int r = idx / HD, c = idx % HD;
    dst[r * P + c] = (row0 + r < n) ? to_float(src[(size_t)(row0 + r) * HD + c]) : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 8 i][d] * B[tx + 16 j][d], d < DEPTH (a 64 x 64 tile)
template <int DEPTH>
__device__ __forceinline__ void mm_nt(const float* A, int lda, const float* B, int ldb,
                                      float (&acc)[8][4], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DEPTH; ++d) {
    float a[8], b[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = A[(ty + 8 * i) * lda + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * ldb + d];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k A[ty + 8 i][k] * B[k][tx + 16 j], k < 64 (a 64 x 16 NJ tile)
template <int NJ>
__device__ __forceinline__ void mm_nn(const float* A, int lda, const float* B, int ldb,
                                      float (&acc)[8][NJ], int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < 64; ++k) {
    float a[8], b[NJ];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = A[(ty + 8 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] = sum_q A[q][ty + 8 i] * B[q][tx + 16 j], q < 64 (a 64 x 16 NJ tile)
template <int NJ>
__device__ __forceinline__ void mm_tn(const float* A, int lda, const float* B, int ldb,
                                      float (&acc)[8][NJ], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int q = 0; q < 64; ++q) {
    float a[8], b[NJ];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = A[q * lda + ty + 8 * i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = B[q * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

}  // namespace k4
