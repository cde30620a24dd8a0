// K4 forward: o = softmax(q k^T * scale) v with an online softmax, and the row
// logsumexp that the backward kernel recomputes the probabilities from.
//
// Replaces: representationlearning_tpu/ops/pallas/attention.py `_flash_fwd_kernel`
//   (:26-51, reached from `_flash_fwd_call` :95): what it computes, not its
//   256 x 256 blocking. The TPU wrapper sends shapes that are no tile multiples
//   to a plain composition; this kernel masks the tails itself and takes any
//   Nq >= 1 and Nk >= 1.
// What bounds it on the H100: at the train step's shapes (Nq 6400 / 1600 / 400,
//   Nk 100, hd 64) the two products are small and the work is the q read and the
//   o write: bytes, and below a few hundred blocks, launch latency. With f32
//   inputs the products run as f32 FMAs, so at long key lengths (the 512 x 512
//   inference shapes, Nk 256) the f32 rate takes over.
// What the design does about it: one thread block per (bh, 64-query tile); the
//   q tile stays in shared memory, keys and values stream through it in tiles
//   of 64, the 64 x 64 scores live in registers, and only the probabilities
//   (rounded to the input dtype, as the TPU kernel's `p.astype(v.dtype)`) pass
//   through shared memory on the way to p v. Running max, running sum and the
//   output accumulate in f32 registers; the (Nq, Nk) scores never reach device
//   memory.
#include "common.cuh"

namespace k4 {

template <int HD>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (3 * 64 * (HD + 1) + kBQ * kLdS);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int Nq, int Nk, float scale) {
  constexpr int P = HD + 1, NJ = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + 64 * P;
  float* Vs = Ks + 64 * P;
  float* Ps = Vs + 64 * P;

  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* kb = k + (size_t)bh * Nk * HD;
  const T* vb = v + (size_t)bh * Nk * HD;

  load_tile<T, HD>(q + (size_t)bh * Nq * HD, Qs, q0, Nq);

  float m_run[8], l_run[8], acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Nk; k0 += kBK) {
    __syncthreads();  // the last tile's readers of Ks, Vs and Ps are done
    load_tile<T, HD>(kb, Ks, k0, Nk);
    load_tile<T, HD>(vb, Vs, k0, Nk);
    __syncthreads();

    float s[8][4];
    mm_nt<HD>(Qs, P, Ks, P, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx + 16 * j < Nk) ? s[i][j] * scale : -CUDART_INF_F;
        mt = fmaxf(mt, s[i][j]);
      }
      // every tile holds at least one key, so the new max is finite
      const float m_new = fmaxf(m_run[i], row_max(mt));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (k0 + tx + 16 * j < Nk) ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        Ps[(ty + 8 * i) * kLdS + tx + 16 * j] = round_to<T>(p);
      }
      const float alpha = expf(m_run[i] - m_new);  // 0 on the first tile
      l_run[i] = l_run[i] * alpha + row_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    mm_nn<NJ>(Ps, kLdS, Vs, P, acc, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= Nq) continue;
    const size_t base = (size_t)bh * Nq + row;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      o[base * HD + tx + 16 * j] = from_float<T>(acc[i][j] / l_run[i]);
    if (tx == 0) lse[base] = m_run[i] + logf(l_run[i]);
  }
}

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
               int Nq, int Nk, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Nq + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, Nq, Nk, scale);
  return (int)cudaGetLastError();
}

}  // namespace k4

// o (BH, Nq, D) in the input dtype and lse (BH, Nq) f32 from q (BH, Nq, D) and
// k, v (BH, Nk, D), all contiguous, f32 or (is_bf16) bf16. D is 32 or 64.
extern "C" int k4_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int BH, int Nq, int Nk, int D, float scale, int is_bf16,
                            void* stream) {
  if (BH < 1 || BH > 65535 || Nq < 1 || Nk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return is_bf16 ? k4::launch_fwd<k4::bf16, 64>(q, k, v, o, lse, BH, Nq, Nk, scale, st)
                   : k4::launch_fwd<float, 64>(q, k, v, o, lse, BH, Nq, Nk, scale, st);
  if (D == 32)
    return is_bf16 ? k4::launch_fwd<k4::bf16, 32>(q, k, v, o, lse, BH, Nq, Nk, scale, st)
                   : k4::launch_fwd<float, 32>(q, k, v, o, lse, BH, Nq, Nk, scale, st);
  return (int)cudaErrorInvalidValue;
}
