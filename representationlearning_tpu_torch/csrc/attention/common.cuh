// Shared pieces of K4 (flash attention), forward (flash_fwd.cu) and backward
// (flash_bwd.cu): dtype conversions, `cp.async` copies, the operand splits and
// `mma.sync` products of the tensor cores, and `ldmatrix`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace k4 {

using bf16 = __nv_bfloat16;

constexpr int kSmemLimit = 227 * 1024;  // dynamic shared memory a block may ask for
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory; zeros where `valid` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes; zero where `valid` is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small for the TF32 products. The tensor cores read a TF32 operand from the
// upper 19 bits of its register and ignore the low 13, so x itself serves as big (x
// truncated to 11 significant bits), and small = x - trunc(x) is exact, itself truncated
// to 11 bits where it is read: big + small holds x to within 2^-21 of it. A logical and
// a subtraction a value, where rounding both halves with `cvt.rna.tf32.f32` (the
// conversion unit, a quarter of the f32 rate or less) or by Veltkamp's splitting (five
// operations) made the forward slower (PERF.md, K4 forward): the splits were most of its
// instructions.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x);
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big & 0xffffe000u)));
}

// mma.sync m16n8k8, TF32 operands, f32 sums. With g = lane / 4, t = lane % 4:
//   A: a0 (row g, k t), a1 (row g + 8, k t), a2 (row g, k t + 4), a3 (row g + 8, k t + 4)
//   B: b0 (k t, n g), b1 (k t + 4, n g);  C: c0, c1 (row g, n 2t, 2t + 1), c2, c3 (row g + 8)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a (x) b in 3xTF32: small.big + big.small + big.big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

// mma.sync m16n8k16, bf16 operands, f32 sums: A a0 (row g, k 2t..2t+1), a1 (row g + 8),
// a2 (row g, k 2t+8..2t+9), a3 (row g + 8); B b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9);
// C as above
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8 and
// receives of matrix i the pair (row g, columns 2t..2t+1), or with .trans (rows 2t..2t+1,
// column g)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x with one `ex2.approx` (2 ulp); 2^-inf = 0
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The A fragments of 16 bf16 rows (from row0 of a tile at pitch P) for D / 16 k steps of 16
template <int D>
__device__ __forceinline__ void a_frags_bf16(uint32_t (&a)[D / 16][4], const bf16* X, int P,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(a[kk], X + ((lane & 7) + ((lane >> 3) & 1) * 8) * P + 16 * kk + (lane >> 4) * 8);
}

}  // namespace k4
