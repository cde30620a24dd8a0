// K4 backward: dq, dk, dv of o = softmax(q k^T * scale) v from q, k, v, o, do
// and the forward's row logsumexp.
//
// Replaces: representationlearning_tpu/ops/pallas/attention.py `_flash_bwd_kernel`
//   (:54-88, reached from `_flash_vjp_bwd` :134): delta = rowsum(do * o),
//   p = exp(s - lse), dp = do v^T, ds = p (dp - delta), dq = scale ds k,
//   dk = scale ds^T q, dv = p^T do, with p and ds rounded to the input dtype
//   before their products (:81-82) and dk, dv summed in f32 and cast once.
// What is different on this card: the TPU kernel adds dk and dv into a block
//   that stays in fast memory while the grid walks the query tiles in order
//   (:141-142). Thread blocks here run side by side, so each block writes the
//   dk / dv share of its own query tiles into a workspace, and a second small
//   kernel adds the shares in chunk order. No atomics: two runs on the same
//   inputs give the same bits.
// What bounds it: at the train step's shapes (Nq 6400 / 1600 / 400, Nk 100) the
//   reads of q, o, do and the write of dq, plus the workspace round trip
//   (2 x chunks x Nk x D f32 per bh); at long key lengths the five f32 products.
// What the design does about it: one thread block per (bh, chunk of query
//   tiles). The wrapper picks the chunk so that the card is filled a few times
//   over and no more, which keeps the workspace small where Nq is large. q and
//   do tiles stay in shared memory while keys and values stream through; the
//   scores and dp live in registers, p and ds pass through shared memory once
//   for the three products that consume them.
#include "common.cuh"

namespace k4 {

template <int HD>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (4 * 64 * (HD + 1) + 2 * kBQ * kLdS + 2 * kBQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ o, const T* __restrict__ dout,
                 const float* __restrict__ lse, T* __restrict__ dq, float* __restrict__ ws_dk,
                 float* __restrict__ ws_dv, int Nq, int Nk, float scale, int chunk,
                 int nchunks) {
  constexpr int P = HD + 1, NJ = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + 64 * P;
  float* Ks = dOs + 64 * P;
  float* Vs = Ks + 64 * P;
  float* Ps = Vs + 64 * P;
  float* dSs = Ps + kBQ * kLdS;
  float* lse_s = dSs + kBQ * kLdS;
  float* delta_s = lse_s + kBQ;

  const int bh = blockIdx.y, c = blockIdx.x;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const int nqt = (Nq + kBQ - 1) / kBQ;
  const size_t qoff = (size_t)bh * Nq * HD, koff = (size_t)bh * Nk * HD;
  const T* kb = k + koff;
  const T* vb = v + koff;
  // this block's share of dk and dv, (Nk, HD) f32 each
  float* wk = ws_dk + ((size_t)bh * nchunks + c) * Nk * HD;
  float* wv = ws_dv + ((size_t)bh * nchunks + c) * Nk * HD;

  for (int t = 0; t < chunk; ++t) {
    const int qt = c * chunk + t;
    if (qt >= nqt) break;  // the same for every thread of the block
    const int q0 = qt * kBQ;
    const bool first = (t == 0);
    __syncthreads();  // the last query tile's readers are done
    load_tile<T, HD>(q + qoff, Qs, q0, Nq);
    load_tile<T, HD>(dout + qoff, dOs, q0, Nq);
    // delta = rowsum(do * o) and lse of this warp's 16 rows
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr, row = q0 + r;
      float a = 0.f;
      if (row < Nq) {
        const size_t g = qoff + (size_t)row * HD;
        for (int d = lane; d < HD; d += 32) a += to_float(dout[g + d]) * to_float(o[g + d]);
      }
      a = warp_sum(a);
      if (lane == 0) {
        delta_s[r] = a;
        lse_s[r] = (row < Nq) ? lse[(size_t)bh * Nq + row] : 0.f;
      }
    }

    float dqa[8][NJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) dqa[i][j] = 0.f;

    for (int k0 = 0; k0 < Nk; k0 += kBK) {
      __syncthreads();  // the last key tile's readers of Ks, Vs, Ps, dSs are done
      load_tile<T, HD>(kb, Ks, k0, Nk);
      load_tile<T, HD>(vb, Vs, k0, Nk);
      __syncthreads();

      {
        float s[8][4], dp[8][4];
        mm_nt<HD>(Qs, P, Ks, P, s, ty, tx);
        mm_nt<HD>(dOs, P, Vs, P, dp, ty, tx);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = ty + 8 * i;
          const float l = lse_s[r], dl = delta_s[r];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int cc = tx + 16 * j;
            const bool valid = (q0 + r < Nq) && (k0 + cc < Nk);
            const float p = valid ? expf(s[i][j] * scale - l) : 0.f;
            const float ds = p * (dp[i][j] - dl);
            Ps[r * kLdS + cc] = round_to<T>(p);
            dSs[r * kLdS + cc] = round_to<T>(ds);
          }
        }
      }
      __syncthreads();

      mm_nn<NJ>(dSs, kLdS, Ks, P, dqa, ty, tx);  // dq += ds k

      float g[8][NJ];
      mm_tn<NJ>(dSs, kLdS, Qs, P, g, ty, tx);    // ds^T q: rows are keys
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int kr = k0 + ty + 8 * i;
        if (kr >= Nk) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const size_t idx = (size_t)kr * HD + tx + 16 * j;
          const float val = scale * g[i][j];
          // the same thread owns this element at every query tile of the chunk
          wk[idx] = first ? val : wk[idx] + val;
        }
      }
      mm_tn<NJ>(Ps, kLdS, dOs, P, g, ty, tx);    // p^T do
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int kr = k0 + ty + 8 * i;
        if (kr >= Nk) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const size_t idx = (size_t)kr * HD + tx + 16 * j;
          wv[idx] = first ? g[i][j] : wv[idx] + g[i][j];
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + ty + 8 * i;
      if (row >= Nq) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        dq[qoff + (size_t)row * HD + tx + 16 * j] = from_float<T>(scale * dqa[i][j]);
    }
  }
}

// out[bh][e] = sum over the chunks, in chunk order, of ws[bh][chunk][e]
template <typename T>
__global__ void reduce_chunks_kernel(const float* __restrict__ ws, T* __restrict__ out,
                                     int nchunks, size_t per, size_t total) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const size_t bh = idx / per, e = idx % per;
  const float* p = ws + bh * nchunks * per + e;
  float acc = 0.f;
  for (int c = 0; c < nchunks; ++c) acc += p[(size_t)c * per];
  out[idx] = from_float<T>(acc);
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* dq, void* dk, void* dv, void* ws, int BH, int Nq, int Nk,
               float scale, int chunk, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nqt = (Nq + kBQ - 1) / kBQ;
  const int nchunks = (nqt + chunk - 1) / chunk;
  const size_t per = (size_t)Nk * HD, total = (size_t)BH * per;
  float* ws_dk = (float*)ws;
  float* ws_dv = ws_dk + total * nchunks;
  flash_bwd_kernel<T, HD><<<dim3(nchunks, BH), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, (const float*)lse,
      (T*)dq, ws_dk, ws_dv, Nq, Nk, scale, chunk, nchunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  reduce_chunks_kernel<T><<<blocks, 256, 0, stream>>>(ws_dk, (T*)dk, nchunks, per, total);
  reduce_chunks_kernel<T><<<blocks, 256, 0, stream>>>(ws_dv, (T*)dv, nchunks, per, total);
  return (int)cudaGetLastError();
}

}  // namespace k4

// dq (BH, Nq, D), dk, dv (BH, Nk, D) in the input dtype. ws holds
// 2 * BH * ceil(ceil(Nq / 64) / chunk) * Nk * D floats and needs no initial
// value. chunk >= 1 is the number of 64-query tiles one thread block walks.
extern "C" int k4_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* dq, void* dk, void* dv,
                            void* ws, int BH, int Nq, int Nk, int D, float scale, int chunk,
                            int is_bf16, void* stream) {
  if (BH < 1 || BH > 65535 || Nq < 1 || Nk < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define K4_BWD(T, HD) \
  k4::launch_bwd<T, HD>(q, k, v, o, dout, lse, dq, dk, dv, ws, BH, Nq, Nk, scale, chunk, st)
  if (D == 64) return is_bf16 ? K4_BWD(k4::bf16, 64) : K4_BWD(float, 64);
  if (D == 32) return is_bf16 ? K4_BWD(k4::bf16, 32) : K4_BWD(float, 32);
#undef K4_BWD
  return (int)cudaErrorInvalidValue;
}
