// Shared helpers of the K1 kernel family (one MiT encoder block, split into a
// few token-tiled kernels). See the note at the top of each .cu file.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <mma.h>

namespace k1 {

using bf16 = __nv_bfloat16;

constexpr float kLnEps = 1e-6f;

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

// ((x - mu) * rstd) * g + b with every step rounded on its own (no fused
// multiply-add), as the plain version computes it, so both round the same
// normalised value to the same bf16 operand.
__device__ __forceinline__ float ln_apply(float x, float mu, float rstd, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), rstd), g), b);
}

// ---- GELU with the Abramowitz-Stegun 7.1.26 erf, term for term the `_erf` and
// `_gelu` of the TPU kernels (representationlearning_tpu/ops/pallas/mit_block.py:47-59,
// mlp_dwbn.py:49-50): gelu(v) = 0.5 v (1 + erf(v / sqrt 2)), erf(x) = sign(x) (1 -
// poly(t) exp(-x^2)), t = 1 / (1 + p |x|). Written so that the compiler can overlap one
// GELU with the next: t is the approximate reciprocal refined by one Newton step, with
// no branch to a slow path as the IEEE division has, on |x| clamped to 21.5 (beyond,
// exp(-x^2) is 0 and t does not count; the clamp also keeps y = inf out); the sign is
// copied from x, which differs from sign(x) only at x = 0, where 0.5 v is 0. Bit for bit
// the formula with sign(x) and the IEEE division, on every one of the 2^32 f32 inputs
// (`k1_gelu_as_mismatches` in csrc/mit_block/dwconv_gelu.cu counts those that differ: 0).
// The same text stands in csrc/mit_block/common.cuh and csrc/rssformer/common.cuh.
__device__ __forceinline__ float rcp_newton(float y) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  const float e = fmaf(-y, r, 1.0f);
  return fmaf(r, e, r);
}

__device__ __forceinline__ float erf_as_abs(float ax) {   // |erf(x)| for ax = |x|
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f,
              a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float t = rcp_newton(1.0f + p * fminf(ax, 21.5f));
  const float poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))));
  return 1.0f - poly * expf(-ax * ax);
}

__device__ __forceinline__ float gelu_as(float v) {
  const float x = v * 0.70710677f;
  return 0.5f * v * (1.0f + copysignf(erf_as_abs(fabsf(x)), x));
}
// ---- end of the GELU


// ---- warp-level tensor-core pieces shared by attention.cu and sr_conv.cu ----
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

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8, and receives of matrix i the pair (row g, columns 2t..2t+1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed: the pair is (rows 2t..2t+1, column g).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes from device memory to shared memory without passing through
// registers; with `valid` false the 16 bytes are filled with zeros instead.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
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

// ---- the operand type T of the products: bf16 or float (3xTF32) ----
// A k slice is 32 bytes of a row: 16 bf16 (one m16n8k16) or 8 f32 (m16n8k8 three
// times). `ldmatrix` reads either the same way: lane (g, t) receives 4 bytes at byte
// 4t of row g of each 8 x 16-byte matrix, which is the bf16 pair (2t, 2t + 1) or the
// f32 element t. So the addresses that give the bf16 A and B fragments of a slice,
// taken in bytes, give the TF32 ones too: a0 (row g, k t), a1 (row g + 8, k t),
// a2 (row g, k t + 4), a3 (row g + 8, k t + 4); b0 (k t, n g), b1 (k t + 4, n g).
template <typename T>
constexpr int kSliceK = 32 / (int)sizeof(T);  // k of a slice: 16 bf16, 8 f32

// x = big + small for 3xTF32 (as csrc/attention/common.cuh splits it): the tensor cores
// read a TF32 operand from the upper 19 bits of its register, so x serves as big, and
// small = x - trunc(x) is exact, itself truncated where it is read.
__device__ __forceinline__ uint32_t tf32_small(uint32_t x) {
  const float v = __uint_as_float(x);
  return __float_as_uint(__fsub_rn(v, __uint_as_float(x & 0xffffe000u)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b over one k slice: bf16 operands, or f32 operands as small.big + big.small +
// big.big in TF32 (f32 to within about 2^-21 of each product)
template <typename T>
__device__ __forceinline__ void mma_slice(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  if constexpr (sizeof(T) == 2) {
    mma_bf16(c, a, b0, b1);
  } else {
    const uint32_t as[4] = {tf32_small(a[0]), tf32_small(a[1]), tf32_small(a[2]),
                            tf32_small(a[3])};
    mma_tf32(c, as, b0, b1);
    const uint32_t ab[4] = {a[0], a[1], a[2], a[3]};
    mma_tf32(c, ab, tf32_small(b0), tf32_small(b1));
    mma_tf32(c, ab, b0, b1);
  }
}

// the arguments of `linear` (gemm.cu, gemm_f32.cu): out[M, Nout] = LN?(a) @ w^T + bias (+ res)
template <typename T>
struct LinArgs {
  const float* a;
  const T* w;
  const float* bias;
  const float* stats;
  const float* lnw;
  const float* lnb;
  const float* res;
  float* out;
  int M, Nout, K, per;
};

}  // namespace k1
