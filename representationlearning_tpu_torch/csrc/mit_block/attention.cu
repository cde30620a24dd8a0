// K1 part 3: spatial-reduction attention, softmax(q k^T * hd^-1/2) v per head,
// with the optional export of the raw pre-scale logits.
//
// Replaces: the per-head attention loop of the TPU kernel
//   representationlearning_tpu/ops/pallas/mit_block.py:146-163 (reached from
//   `fused_block_pallas` :259 -> `_kernel` :216 -> `_block_math` :62), including
//   the `export=True` logits output (:150-151, :185-186) and the Nk == 0 case
//   (:152-157).
// What bounds it on the H100: at the encoder's shapes (hd = 64, Nk = 256 at
//   stages 1-3, Nk = 1024 at stage 4) the products are small; without export it
//   is bound by latency and the q/out bytes, with export (stage 4: 8 x 8 x 1024
//   x 1024 f32, 268 MB per block) by the device-memory write of the logits.
// What the design does about it: one thread block per (image, head, 64-query
//   tile), four warps of 16 query rows each. Keys and values stream through
//   shared memory in tiles of 64, so any Nk fits (the Pallas kernel holds all
//   of them in VMEM). To keep the TPU kernel's rounding, the probabilities are
//   normalised BEFORE they are rounded to bf16 for the product with v: a first
//   pass over the key tiles finds each row's max and sum (and writes the raw
//   logits when exporting), a second pass recomputes q k^T, forms
//   p = exp(s - max) / sum, rounds p to bf16 and accumulates p v on the tensor
//   cores (WMMA, f32 accumulators). q, k, v are rounded to bf16 as the TPU
//   kernel's bf16 dots do.
#include <math_constants.h>

#include "common.cuh"

namespace k1 {

namespace wmma = nvcuda::wmma;

constexpr int kQT = 64;  // query rows per block
constexpr int kKT = 64;  // keys per tile
constexpr int kAttnThreads = 128;

template <int HD>
struct AttnSmem {
  static constexpr int kLdH = HD + 8;    // bf16 pitch of the q/k/v tiles
  static constexpr int kLdS = kKT + 4;   // f32 pitch of the score tile
  static constexpr int kLdP = kKT + 8;   // bf16 pitch of the probability tile
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(bf16) * kQT * kLdH;
  static constexpr size_t kV = kK + sizeof(bf16) * kKT * kLdH;
  static constexpr size_t kS = kV + sizeof(bf16) * kKT * kLdH;
  static constexpr size_t kP = kS + sizeof(float) * kQT * kLdS;
  static constexpr size_t kM = kP + sizeof(bf16) * kQT * kLdP;
  static constexpr size_t kL = kM + sizeof(float) * kQT;
  static constexpr size_t kBytes = kL + sizeof(float) * kQT;
  static_assert(HD <= kKT, "the output tile reuses the score tile");
};

template <int HD>
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                 float* __restrict__ out, float* __restrict__ logits, int N, int Nk, int C,
                 int nh, float scale) {
  using S = AttnSmem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + S::kQ);
  bf16* Ks = reinterpret_cast<bf16*>(smem + S::kK);
  bf16* Vs = reinterpret_cast<bf16*>(smem + S::kV);
  float* Ss = reinterpret_cast<float*>(smem + S::kS);
  bf16* Ps = reinterpret_cast<bf16*>(smem + S::kP);
  float* row_m = reinterpret_cast<float*>(smem + S::kM);
  float* row_l = reinterpret_cast<float*>(smem + S::kL);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // q features: head * hd + d; kv features: (i2 * nh + head) * hd + d (:141-144)
  const float* qb = q + (size_t)b * N * C + h * HD;
  const float* kb = kv + (size_t)b * Nk * 2 * C + h * HD;
  const float* vb = kb + C;
  float* lb = logits ? logits + (size_t)(b * nh + h) * N * Nk : nullptr;

  constexpr int kV4 = HD / 4;  // float4 per row of a head
  for (int idx = tid; idx < kQT * kV4; idx += kAttnThreads) {
    const int r = idx / kV4, c = (idx % kV4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < N) v = *reinterpret_cast<const float4*>(qb + (size_t)(q0 + r) * C + c);
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(Qs + r * S::kLdH + c);
    d[0] = __floats2bfloat162_rn(v.x, v.y);
    d[1] = __floats2bfloat162_rn(v.z, v.w);
  }
  if (tid < kQT) {
    row_m[tid] = -CUDART_INF_F;
    row_l[tid] = 0.f;
  }

  auto load_tile = [&](const float* src, bf16* dst, int k0) {
    for (int idx = tid; idx < kKT * kV4; idx += kAttnThreads) {
      const int r = idx / kV4, c = (idx % kV4) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < Nk) v = *reinterpret_cast<const float4*>(src + (size_t)(k0 + r) * 2 * C + c);
      __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst + r * S::kLdH + c);
      d[0] = __floats2bfloat162_rn(v.x, v.y);
      d[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  };

  // raw logits of this warp's 16 query rows against the current key tile -> Ss
  auto scores = [&]() {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s[kKT / 16];
#pragma unroll
    for (int j = 0; j < kKT / 16; ++j) wmma::fill_fragment(s[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + warp * 16 * S::kLdH + kk, S::kLdH);
#pragma unroll
      for (int j = 0; j < kKT / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + j * 16 * S::kLdH + kk, S::kLdH);
        wmma::mma_sync(s[j], a, kf, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kKT / 16; ++j)
      wmma::store_matrix_sync(Ss + warp * 16 * S::kLdS + j * 16, s[j], S::kLdS,
                              wmma::mem_row_major);
    __syncwarp();
  };

  const int ntiles = (Nk + kKT - 1) / kKT;
  // pass 1: row max and sum of exp (online), raw-logit export
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kKT;
    load_tile(kb, Ks, k0);
    __syncthreads();
    scores();
    const int ka = k0 + lane, kb2 = k0 + lane + 32;
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const float s0 = Ss[r * S::kLdS + lane], s1 = Ss[r * S::kLdS + lane + 32];
      if (lb != nullptr && q0 + r < N) {
        float* lr = lb + (size_t)(q0 + r) * Nk;
        if (ka < Nk) lr[ka] = s0;
        if (kb2 < Nk) lr[kb2] = s1;
      }
      // the scaled logit is rounded before the max is subtracted (no fused
      // multiply-add), as in the plain version
      const float v0 = ka < Nk ? __fmul_rn(s0, scale) : -CUDART_INF_F;
      const float v1 = kb2 < Nk ? __fmul_rn(s1, scale) : -CUDART_INF_F;
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(v0, v1)));
      float e = (ka < Nk ? expf(v0 - m_new) : 0.f) + (kb2 < Nk ? expf(v1 - m_new) : 0.f);
      e = warp_sum(e);
      __syncwarp();
      if (lane == 0) {
        row_l[r] = row_l[r] * expf(m_old - m_new) + e;
        row_m[r] = m_new;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  // pass 2: p = exp(s - max) / sum rounded to bf16, o += p v
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HD / 16];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(o[j], 0.0f);
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kKT;
    load_tile(kb, Ks, k0);
    load_tile(vb, Vs, k0);
    __syncthreads();
    scores();
    const int ka = k0 + lane, kb2 = k0 + lane + 32;
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const float m = row_m[r], l = row_l[r];
      const float p0 = ka < Nk ? expf(__fmul_rn(Ss[r * S::kLdS + lane], scale) - m) / l : 0.f;
      const float p1 =
          kb2 < Nk ? expf(__fmul_rn(Ss[r * S::kLdS + lane + 32], scale) - m) / l : 0.f;
      Ps[r * S::kLdP + lane] = __float2bfloat16_rn(p0);
      Ps[r * S::kLdP + lane + 32] = __float2bfloat16_rn(p1);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kKT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::load_matrix_sync(pf, Ps + warp * 16 * S::kLdP + kk, S::kLdP);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, Vs + kk * S::kLdH + j * 16, S::kLdH);
        wmma::mma_sync(o[j], pf, vf, o[j]);
      }
    }
    __syncthreads();
  }

  // epilogue: this warp's 16 x HD output rows through its own rows of Ss
#pragma unroll
  for (int j = 0; j < HD / 16; ++j)
    wmma::store_matrix_sync(Ss + warp * 16 * S::kLdS + j * 16, o[j], S::kLdS,
                            wmma::mem_row_major);
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    if (q0 + r >= N) continue;
    float* orow = out + ((size_t)b * N + q0 + r) * C + h * HD;
    for (int c = lane; c < HD; c += 32) orow[c] = Ss[r * S::kLdS + c];
  }
}

template <int HD>
int launch_attention(const float* q, const float* kv, float* out, float* logits, int B,
                     int N, int Nk, int C, int nh, float scale, cudaStream_t stream) {
  const size_t smem = AttnSmem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kQT - 1) / kQT, nh, B);
  attention_kernel<HD><<<grid, kAttnThreads, smem, stream>>>(q, kv, out, logits, N, Nk, C,
                                                            nh, scale);
  return (int)cudaGetLastError();
}

}  // namespace k1

// out (B, N, C) = per-head softmax(q k^T * scale) v; q (B, N, C), kv (B, Nk, 2C),
// all f32. logits (B, nh, N, Nk) f32 receives the raw q k^T when not null.
// C / nh must be 32 or 64.
extern "C" int k1_attention(const void* q, const void* kv, void* out, void* logits, int B,
                            int N, int Nk, int C, int nh, float scale, void* stream) {
  const int hd = C / nh;
  if (hd == 64)
    return k1::launch_attention<64>((const float*)q, (const float*)kv, (float*)out,
                                    (float*)logits, B, N, Nk, C, nh, scale,
                                    (cudaStream_t)stream);
  if (hd == 32)
    return k1::launch_attention<32>((const float*)q, (const float*)kv, (float*)out,
                                    (float*)logits, B, N, Nk, C, nh, scale,
                                    (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
