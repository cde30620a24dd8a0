// K1 part 2: the block's linear layers, as one tiled bf16 tensor-core GEMM
// with a LayerNorm prologue and a bias/residual epilogue. (The sr x sr conv of
// the block has a kernel of its own, sr_conv.cu.)
//
// Replaces: every `_mm` of the TPU kernel's body
//   representationlearning_tpu/ops/pallas/mit_block.py:42-44, reached from
//   `fused_block_pallas` :259 -> `_kernel` :216 -> `_block_math` :62:
//   LN1 -> q (:80-81), kv (:140), proj + residual 1 (:164-165), LN2 -> fc1
//   (:167-168) and fc2 + residual 2 (:183-184).
// What bounds it on the H100: at the block's shapes (K = C <= 512, up to 2048
//   for fc2, M = 8 * 16384 tokens at stage 1) the products are thin; the operand and result bytes (A in f32, C in f32)
//   weigh more than the tensor-core work, so it is bound by device memory and by
//   the simple, unpipelined tile loads of this first version.
// What the design does about it: the Pallas kernel holds a whole image in VMEM
//   (about 88 MB at stage 1); a Hopper SM has 227 KB of shared memory, so this
//   kernel tiles over tokens (64 x 64 output tiles, K in steps of 32) and keeps
//   only the tiles in shared memory. LayerNorm is applied while A is loaded (row
//   statistics come from ln_stats.cu), so the normalised activations are never
//   written out. A and B are rounded to bf16 in shared memory and multiplied with WMMA
//   (mma.sync underneath) into f32 accumulators, the numerics of the TPU
//   kernel's bf16-operand / f32-accumulate dots. Bias and residual are added in
//   f32 in the epilogue.
#include "common.cuh"

namespace k1 {

namespace wmma = nvcuda::wmma;

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kLdA = kBK + 8;   // bf16 row pitch of the A/B tiles (80 bytes)
constexpr int kLdC = kBN + 4;   // f32 row pitch of the output tile
constexpr int kGemmThreads = 128;

template <bool LN>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const float* __restrict__ A, const bf16* __restrict__ Wt,
            const float* __restrict__ bias, const float* __restrict__ stats,
            const float* __restrict__ lnw, const float* __restrict__ lnb,
            const float* __restrict__ res, float* __restrict__ out,
            int M, int Nout, int K) {
  __shared__ __align__(128) bf16 As[kBM * kLdA];
  __shared__ __align__(128) bf16 Bs[kBN * kLdA];
  __shared__ __align__(128) float Cs[kBM * kLdC];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A tile: 64 rows x 32 columns of f32, four float4 per thread
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kGemmThreads;
      const int r = idx >> 3;
      const int kc = (idx & 7) * 4;
      const int gm = m0 + r;
      const int k = k0 + kc;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gm < M) {
        v = *reinterpret_cast<const float4*>(A + (size_t)gm * K + k);
        if (LN) {
          const float mu = stats[2 * (size_t)gm], rs = stats[2 * (size_t)gm + 1];
          v.x = ln_apply(v.x, mu, rs, lnw[k + 0], lnb[k + 0]);
          v.y = ln_apply(v.y, mu, rs, lnw[k + 1], lnb[k + 1]);
          v.z = ln_apply(v.z, mu, rs, lnw[k + 2], lnb[k + 2]);
          v.w = ln_apply(v.w, mu, rs, lnw[k + 3], lnb[k + 3]);
        }
      }
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(As + r * kLdA + kc);
      dst[0] = __floats2bfloat162_rn(v.x, v.y);
      dst[1] = __floats2bfloat162_rn(v.z, v.w);
    }
    // B tile: 64 output features x 32 columns of bf16, 16 bytes per load
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kGemmThreads;
      const int r = idx >> 2;
      const int kc = (idx & 3) * 8;
      const int gn = n0 + r;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (gn < Nout) w = *reinterpret_cast<const uint4*>(Wt + (size_t)gn * K + k0 + kc);
      *reinterpret_cast<uint4*>(Bs + r * kLdA + kc) = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + (wn + j * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * kLdC + wn + j * 16, acc[i][j], kLdC,
                              wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < kBM * kBN; idx += kGemmThreads) {
    const int r = idx / kBN, c = idx % kBN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < Nout) {
      float v = Cs[r * kLdC + c] + bias[gn];
      if (res != nullptr) v += res[(size_t)gm * Nout + gn];
      out[(size_t)gm * Nout + gn] = v;
    }
  }
}

}  // namespace k1

// out[M, Nout] = LN?(a)[M, K] @ w[Nout, K]^T + bias (+ res). LN is applied when
// `stats` is not null. a, res, out f32; w bf16; K % 32 == 0.
extern "C" int k1_linear(const void* a, const void* w, const void* bias, const void* stats,
                         const void* lnw, const void* lnb, const void* res, void* out,
                         int M, int Nout, int K, void* stream) {
  const dim3 grid((M + k1::kBM - 1) / k1::kBM, (Nout + k1::kBN - 1) / k1::kBN);
  if (stats != nullptr) {
    k1::gemm_kernel<true><<<grid, k1::kGemmThreads, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const k1::bf16*)w, (const float*)bias, (const float*)stats,
        (const float*)lnw, (const float*)lnb, (const float*)res, (float*)out, M, Nout, K);
  } else {
    k1::gemm_kernel<false><<<grid, k1::kGemmThreads, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const k1::bf16*)w, (const float*)bias, nullptr, nullptr, nullptr,
        (const float*)res, (float*)out, M, Nout, K);
  }
  return (int)cudaGetLastError();
}
