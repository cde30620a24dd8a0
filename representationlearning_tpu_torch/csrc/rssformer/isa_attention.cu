// K6: the window-attention core of RSSFormer's Mhca with the DAL channel gate.
//
// Replaces: `_core_pallas`
//   (representationlearning_tpu/ops/pallas/isa_attention.py:106, call :118), whose
//   body is `_core_math` (:43-93): per window and head, softmax(q_h k_h^T) v_h
//   scaled by sigmoid(sum(M_h) / hd^2 + max(M_h)), M_h = q_h^T k_h.
// What bounds it on the H100: bytes. A window is T x C of q, k and v in and T x C
//   out (4 x 9.06 MB at 1444 windows of 49 x 32 f32) for about 0.5 GFLOP.
// What the design does about it: the TPU kernel takes 64 windows a program and
//   contracts over all C lanes with the other heads masked to zero, because its
//   matrix unit wants 128 lanes. Here a window is small work (49 x 16 a head), so
//   one block of 128 threads owns one window: q, k and v are read once into shared
//   memory (18.8 KB), the (hd, hd) gate block, the T x T scores, the softmax and
//   the weighted sum are f32 multiply-adds from shared memory head by head, and the
//   result is written once. No window is padded: the grid is NW blocks. With
//   `round_bf16` the operands of every product (q, k, v, the probabilities) are
//   rounded to bf16 first and the sums stay f32, the numerics of the TPU kernel
//   under dtype = bfloat16. Any T, C and nh with C % nh == 0 that fit in shared
//   memory.
#include "common.cuh"

namespace rss {

constexpr int kIsaThreads = 128;

__device__ __forceinline__ float round_operand(float x, bool round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__global__ void __launch_bounds__(kIsaThreads)
isa_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out, int T, int C, int nh,
           int round_bf16) {
  extern __shared__ __align__(16) float sm[];
  const int ld = C + 1;  // odd pitch: rows read by neighbouring threads hit other banks
  float* qs = sm;
  float* ks = qs + T * ld;
  float* vs = ks + T * ld;
  float* S = vs + T * ld;      // (T, T) scores, then probabilities
  float* red = S + T * T;      // 8 floats of the block reductions
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hd = C / nh;
  const bool rb = round_bf16 != 0;
  const size_t base = (size_t)blockIdx.x * T * C;

  for (int idx = tid; idx < T * C; idx += kIsaThreads) {
    const int t = idx / C, c = idx - t * C;
    qs[t * ld + c] = round_operand(q[base + idx], rb);
    ks[t * ld + c] = round_operand(k[base + idx], rb);
    vs[t * ld + c] = round_operand(v[base + idx], rb);
  }
  __syncthreads();

  for (int h = 0; h < nh; ++h) {
    const int c0 = h * hd;
    // the gate: sum and max of M_h[d][e] = sum_t q[t][c0 + d] k[t][c0 + e]
    float msum = 0.f, mmax = -INFINITY;
    for (int idx = tid; idx < hd * hd; idx += kIsaThreads) {
      const int d = idx / hd, e = idx - d * hd;
      float m = 0.f;
      for (int t = 0; t < T; ++t) m = fmaf(qs[t * ld + c0 + d], ks[t * ld + c0 + e], m);
      msum += m;
      mmax = fmaxf(mmax, m);
    }
    msum = warp_sum(msum);
    mmax = warp_max(mmax);
    if (lane == 0) {
      red[warp] = msum;
      red[4 + warp] = mmax;
    }
    // the scores S[s][t] = sum_d q[s][c0 + d] k[t][c0 + d]
    for (int idx = tid; idx < T * T; idx += kIsaThreads) {
      const int s = idx / T, t = idx - s * T;
      float a = 0.f;
      for (int d = 0; d < hd; ++d) a = fmaf(qs[s * ld + c0 + d], ks[t * ld + c0 + d], a);
      S[idx] = a;
    }
    __syncthreads();
    const float gsum = red[0] + red[1] + red[2] + red[3];
    const float gmax = fmaxf(fmaxf(red[4], red[5]), fmaxf(red[6], red[7]));
    const float alpha = 1.0f / (1.0f + expf(-(gsum / (float)(hd * hd) + gmax)));
    // softmax over t, a warp a row
    for (int s = warp; s < T; s += kIsaThreads / 32) {
      float mx = -INFINITY;
      for (int t = lane; t < T; t += 32) mx = fmaxf(mx, S[s * T + t]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int t = lane; t < T; t += 32) {
        const float e = expf(S[s * T + t] - mx);
        S[s * T + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int t = lane; t < T; t += 32) S[s * T + t] = round_operand(S[s * T + t] / sum, rb);
    }
    __syncthreads();
    // out[s][c0 + d] = alpha * sum_t p[s][t] v[t][c0 + d]
    for (int idx = tid; idx < T * hd; idx += kIsaThreads) {
      const int s = idx / hd, d = idx - s * hd;
      float a = 0.f;
      for (int t = 0; t < T; ++t) a = fmaf(S[s * T + t], vs[t * ld + c0 + d], a);
      out[base + (size_t)s * C + c0 + d] = alpha * a;
    }
    __syncthreads();  // S and red are rewritten by the next head
  }
}

}  // namespace rss

// out (NW, T, C) from q, k, v (NW, T, C), all f32; q is already scaled.
extern "C" int k6_isa_core(const void* q, const void* k, const void* v, void* out, int NW,
                           int T, int C, int nh, int round_bf16, void* stream) {
  const int smem = (3 * T * (C + 1) + T * T + 8) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(rss::isa_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  rss::isa_kernel<<<NW, rss::kIsaThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, T, C, nh, round_bf16);
  return (int)cudaGetLastError();
}
