// K6: the window-attention core of RSSFormer's Mhca with the DAL channel gate.
//
// Replaces: `_core_pallas`
//   (representationlearning_tpu/ops/pallas/isa_attention.py:106, call :118), whose
//   body is `_core_math` (:43-93): per window and head, softmax(q_h k_h^T) v_h
//   scaled by sigmoid(sum(M_h) / hd^2 + max(M_h)), M_h = q_h^T k_h.
// What bounds it on the H100: bytes, in principle. q, k and v are read once and
//   the result written once: at the predict path's 1444 windows of 49 x 32 f32,
//   36.2 MB, 0.0108 ms at 3.35 TB/s, against 0.5 GFLOP of bf16 products. In
//   practice the work of a window's softmax: with the loads and stores alone
//   this walk takes 0.0115 ms, with the products alone about twice that.
// What the design does about it:
//   * Persistent blocks walk the windows in steps of `windows` consecutive
//     windows (the plan of `ops/isa_attention.py::isa_plan`, a function of the
//     shapes). q, k and v of a step are one flat run of token rows each; they
//     travel by `cp.async` (16-byte pieces where C % 4 == 0) into a ring of 2 or 3
//     shared-memory stages, so the next steps load while this one computes; the
//     results are stored as whole rows with float4. Rows are kept at a pitch of
//     P = C + ((4 - C) & 31) floats, so that the column-wise reads of the gate and
//     of v (rows 2t, 2t + 1 of column g) hit 32 banks.
//   * A step: every thread rounds the step's q, k and v to bf16 in place (as the
//     plain version rounds every operand); a warp for each (window, head) takes
//     the gate, M_h as 16 x 16 tiles of `mma.sync` m16n8k16 products over T, its
//     sum and its max over d, e < hd only (a padded entry is 0 and must not raise
//     the max of a window whose M_h is all negative); a barrier; then the 16-row
//     tiles of each (window, head), shared out to `warps / (windows nh)` warps.
//   * The probabilities are the plain version's to the bit, because a bf16
//     rounding of a probability that lies within a few f32 spacings of the
//     boundary moves the output by up to 2^-8 p |v|: at 49 keys a p is large, and
//     scores from the tensor cores (whose sums round otherwise than a float32
//     matrix product) put the predict path at 0.8 to 1.3 times the 1e-3 tolerance.
//     So each score is the float32 multiply-add chain over d of the rounded
//     operands, the exponential is `expf` of its difference to the row max, the
//     row sum follows PyTorch's CUDA reduction (torch_row_sum) and the quotient is
//     correctly rounded. The score row stays in registers in the accumulator
//     layout of `mma.sync` (T <= 128), and the rounded probabilities are the A
//     fragment of p v on the tensor cores, with v's B fragments held in registers
//     across row tiles where they fit. Padded keys are -inf, padded rows and head
//     columns load as zeros, never as stale data.
//   * The result of a row tile overwrites the q rows it was made from (only its
//     warp reads them after the barrier).
//   * Under dtype = float32 the same walk, ring and staged store run f32
//     multiply-adds in every product (tensor cores cannot hold 1e-5): a lane takes
//     a query row, its q row in registers, every k and v element read by the
//     whole warp at once.
//   * Every output is summed in one warp in a fixed order: a rerun gives the same
//     bits, whatever the plan.
#include <math_constants.h>

#include "common.cuh"

namespace rss {

constexpr int kIsaMaxWarps = 8;
constexpr int kIsaMaxT = 128;   // tokens a window: a score row lives in registers
constexpr int kIsaMaxHd = 64;   // head width

struct IsaArgs {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  int NW, T, C, nh, hd, P, windows, stages, vec;
};

// element (row r, column c) of a head whose column 0 is at X, zero past T or past
// the head width (HD where it is known at compile time, else hd)
template <int HD>
__device__ __forceinline__ float at(const float* X, int r, int c, int T, int hd, int P) {
  return (r < T && c < (HD ? HD : hd)) ? X[r * P + c] : 0.f;
}

// ---------------------------------------------------------------- bf16 products
// KT: row tiles of 16 the registers hold (T <= 16 KT); HD16: head-width tiles of
// 16; HD: the head width where it is 16 HD16 (its column masks vanish), else 0.
#define AT(X, r, c) at<HD>(X, r, c, T, hd, P)

// sigmoid(sum(M_h) / hd^2 + max over d, e < hd of M_h), M_h = q_h^T k_h. The
// tile loops run to their compile-time ends, with no branch inside: loads past T
// or hd are zeros, so the products of a tile run back to back.
template <int KT, int HD16, int HD>
__device__ __forceinline__ float gate_bf16(const float* Q, const float* K, int T, int hd, int P,
                                           int lane) {
  constexpr int ND = 2 * HD16;
  if (HD) hd = HD;
  const int g = lane >> 2, t = lane & 3;
  float gsum = 0.f, gmax = -CUDART_INF_F;
#pragma unroll
  for (int md = 0; md < HD16; ++md) {
    float m[ND][4];
#pragma unroll
    for (int ne = 0; ne < ND; ++ne) m[ne][0] = m[ne][1] = m[ne][2] = m[ne][3] = 0.f;
    const int d = 16 * md + g;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const int r = 16 * kt + 2 * t;
      uint32_t a[4];  // (row d, k token): q transposed
      a[0] = pack_bf16(AT(Q, r, d), AT(Q, r + 1, d));
      a[1] = pack_bf16(AT(Q, r, d + 8), AT(Q, r + 1, d + 8));
      a[2] = pack_bf16(AT(Q, r + 8, d), AT(Q, r + 9, d));
      a[3] = pack_bf16(AT(Q, r + 8, d + 8), AT(Q, r + 9, d + 8));
#pragma unroll
      for (int ne = 0; ne < ND; ++ne) {
        const int e = 8 * ne + g;
        mma_bf16(m[ne], a, pack_bf16(AT(K, r, e), AT(K, r + 1, e)),
                 pack_bf16(AT(K, r + 8, e), AT(K, r + 9, e)));
      }
    }
#pragma unroll
    for (int ne = 0; ne < ND; ++ne)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gsum += m[ne][i];  // a padded entry is 0
        const bool in = d + (i >> 1) * 8 < hd && 8 * ne + 2 * t + (i & 1) < hd;
        gmax = fmaxf(gmax, in ? m[ne][i] : -CUDART_INF_F);
      }
  }
  gsum = warp_sum(gsum);
  gmax = warp_max(gmax);
  return 1.0f / (1.0f + expf(-(gsum / (float)(hd * hd) + gmax)));
}

// columns c .. c + 3 of row r, zero past T or the head width: one 16-byte load
// where the head width is a multiple of 16
template <int HD>
__device__ __forceinline__ float4 at4(const float* X, int r, int c, int T, int hd, int P) {
  if constexpr (HD != 0) {
    return r < T ? *reinterpret_cast<const float4*>(X + r * P + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    return make_float4(at<HD>(X, r, c, T, hd, P), at<HD>(X, r, c + 1, T, hd, P),
                       at<HD>(X, r, c + 2, T, hd, P), at<HD>(X, r, c + 3, T, hd, P));
  }
}

// The sum of a score row's exponentials in the order of PyTorch's CUDA reduction
// of a row of T <= 128 (Reduce.cuh: 32 lanes, lane l adding keys l, l + 32, l + 64,
// l + 96 in turn, then shfl_down by 16, 8, 4, 2, 1), reproduced on the accumulator
// layout: keys 8j + 2t + b (j < NT, b < 2) of this lane, elements 2h + b of e[j]
// for row half h. Keys past T are 0 and add nothing. Equal sums make equal
// probabilities, so the kernel rounds the same ones to bf16 as the plain version.
template <int NT>
__device__ __forceinline__ float torch_row_sum(const float (&e)[NT][4], int h) {
  float c[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    float a[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      a[jj] = jj < NT ? e[jj][2 * h + b] : 0.f;
#pragma unroll
      for (int i = 1; i < NT / 4; ++i) a[jj] += e[jj + 4 * i][2 * h + b];  // keys + 32 i
    }
    c[b] = (a[0] + a[2]) + (a[1] + a[3]);  // shfl_down 16, then 8
  }
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    c[b] += __shfl_xor_sync(0xffffffffu, c[b], 2);  // 4
    c[b] += __shfl_xor_sync(0xffffffffu, c[b], 1);  // 2
  }
  return c[0] + c[1];  // 1
}

// alpha * softmax(q_h k_h^T) v_h for the row tiles part, part + parts, ... of 16
// rows, written over those rows of q (whose values are already rounded to bf16).
// The probabilities are the plain version's to the bit: each score is the f32
// multiply-add chain over d that a float32 matrix product computes, `expf` of its
// difference to the row max, the row sum in PyTorch's order and a correctly
// rounded quotient; so the probabilities that round to bf16 round alike. Only
// the products whose sums are not rounded again, p v and the gate, go through
// the tensor cores. Keys past T are -inf before the exp and 0 after it; their v
// rows load as zeros.
template <int KT, int HD16, int HD>
__device__ __forceinline__ void rows_bf16(float* Q, const float* K, const float* V, int T,
                                          int hd, int P, int lane, int part, int parts,
                                          float alpha) {
  constexpr int NT = 2 * KT, ND = 2 * HD16;  // key tiles and head-width tiles of 8
  constexpr bool kHoist = KT * HD16 <= 4;    // v fragments held across row tiles
  if (HD) hd = HD;
  const int g = lane >> 2, t = lane & 3;
  const int t16 = (T + 15) >> 4;
  if (part >= t16) return;

  // B fragments of v for p v (k = key, n = head column)
  auto load_vb = [&](int kk, int nd, uint32_t(&b)[2]) {
    const int key = 16 * kk + 2 * t, c = 8 * nd + g;
    b[0] = pack_bf16(AT(V, key, c), AT(V, key + 1, c));
    b[1] = pack_bf16(AT(V, key + 8, c), AT(V, key + 9, c));
  };
  uint32_t vb[kHoist ? KT : 1][ND][2];
  if constexpr (kHoist) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) load_vb(kk, nd, vb[kk][nd]);
  }

  for (int mi = part; mi < t16; mi += parts) {
    const int r0 = 16 * mi + g;  // this lane's rows r0 and r0 + 8
    const bool hi = 16 * mi + 8 < T;  // rows r0 + 8 hold a token in some lane
    // the scores of rows r0, r0 + 8 against keys 8j + 2t, 8j + 2t + 1: the chain of
    // multiply-adds over d, four columns at a time
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 1
    for (int c = 0; c < 16 * HD16; c += 4) {
      const float4 qa = at4<HD>(Q, r0, c, T, hd, P), qb = at4<HD>(Q, r0 + 8, c, T, hd, P);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (8 * j >= T) break;  // keys past T only
        const int key = 8 * j + 2 * t;
        const float4 ka = at4<HD>(K, key, c, T, hd, P), kb = at4<HD>(K, key + 1, c, T, hd, P);
        s[j][0] = fmaf(qa.w, ka.w, fmaf(qa.z, ka.z, fmaf(qa.y, ka.y, fmaf(qa.x, ka.x, s[j][0]))));
        s[j][1] = fmaf(qa.w, kb.w, fmaf(qa.z, kb.z, fmaf(qa.y, kb.y, fmaf(qa.x, kb.x, s[j][1]))));
        if (hi) {
          s[j][2] = fmaf(qb.w, ka.w, fmaf(qb.z, ka.z, fmaf(qb.y, ka.y, fmaf(qb.x, ka.x, s[j][2]))));
          s[j][3] = fmaf(qb.w, kb.w, fmaf(qb.z, kb.z, fmaf(qb.y, kb.y, fmaf(qb.x, kb.x, s[j][3]))));
        }
      }
    }
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[j][i] = 8 * j + 2 * t + (i & 1) < T ? s[j][i] : -CUDART_INF_F;
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = expf(s[j][0] - m0);
      s[j][1] = expf(s[j][1] - m0);
      s[j][2] = hi ? expf(s[j][2] - m1) : 0.f;
      s[j][3] = hi ? expf(s[j][3] - m1) : 0.f;
    }
    const float l0 = torch_row_sum<NT>(s, 0), l1 = hi ? torch_row_sum<NT>(s, 1) : 1.f;
    // e / l correctly rounded: q = e (1 / l), then one correction by the exact
    // residual e - q l (Markstein), with 1 / l itself correctly rounded
    const float i0 = __frcp_rn(l0), i1 = __frcp_rn(l1);
    auto quot = [](float e, float l, float inv) {
      const float q = __fmul_rn(e, inv);
      return fmaf(fmaf(-q, l, e), inv, q);
    };

    // p v in two accumulators, the even and the odd key steps, added at the end
    float o[2][ND][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) o[u][nd][0] = o[u][nd][1] = o[u][nd][2] = o[u][nd][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      // score tiles 2kk and 2kk + 1 are the A fragment of keys 16kk .. 16kk + 15
      uint32_t pa[4];
      pa[0] = pack_bf16(quot(s[2 * kk][0], l0, i0), quot(s[2 * kk][1], l0, i0));
      pa[1] = pack_bf16(quot(s[2 * kk][2], l1, i1), quot(s[2 * kk][3], l1, i1));
      pa[2] = pack_bf16(quot(s[2 * kk + 1][0], l0, i0), quot(s[2 * kk + 1][1], l0, i0));
      pa[3] = pack_bf16(quot(s[2 * kk + 1][2], l1, i1), quot(s[2 * kk + 1][3], l1, i1));
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b[2];
        if constexpr (kHoist) {
          b[0] = vb[kk][nd][0];
          b[1] = vb[kk][nd][1];
        } else {
          load_vb(kk, nd, b);
        }
        mma_bf16(o[kk & 1][nd], pa, b[0], b[1]);
      }
    }
    __syncwarp();  // every lane has read its q rows of this tile: they may go
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int c = 8 * nd + 2 * t;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + (i >> 1) * 8, cc = c + (i & 1);
        if (r < T && cc < hd) Q[r * P + cc] = alpha * (o[0][nd][i] + o[1][nd][i]);
      }
    }
  }
}

// ------------------------------------------------------------------ f32 products
__device__ __forceinline__ float gate_f32(const float* Q, const float* K, int T, int hd, int P,
                                          int lane) {
  float gsum = 0.f, gmax = -CUDART_INF_F;
  for (int idx = lane; idx < hd * hd; idx += 32) {
    const int d = idx / hd, e = idx - d * hd;
    float m = 0.f;
    for (int r = 0; r < T; ++r) m = fmaf(Q[r * P + d], K[r * P + e], m);
    gsum += m;
    gmax = fmaxf(gmax, m);
  }
  gsum = warp_sum(gsum);
  gmax = warp_max(gmax);
  return 1.0f / (1.0f + expf(-(gsum / (float)(hd * hd) + gmax)));
}

// A lane a query row (rows 32 part + lane, then every 32 parts): its q row in
// registers, every k and v element read by all lanes at once (no bank conflict).
// Three passes over the keys: the row max, the sum of exp(s - max), then
// p = exp(s - max) / sum and the sum of p v, so that each probability is the
// plain version's e / sum.
template <int HD16>
__device__ __forceinline__ void rows_f32(float* Q, const float* K, const float* V, int T,
                                         int hd, int P, int lane, int part, int parts,
                                         float alpha) {
  constexpr int HDM = 16 * HD16;
  for (int r = 32 * part + lane; r < T; r += 32 * parts) {
    float qr[HDM], o[HDM];
#pragma unroll
    for (int d = 0; d < HDM; ++d) {
      qr[d] = d < hd ? Q[r * P + d] : 0.f;
      o[d] = 0.f;
    }
    auto score = [&](int key) {
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < HDM; ++d)
        if (d < hd) a = fmaf(qr[d], K[key * P + d], a);
      return a;
    };
    float mx = -CUDART_INF_F;
    for (int key = 0; key < T; ++key) mx = fmaxf(mx, score(key));
    float sum = 0.f;
    for (int key = 0; key < T; ++key) sum += expf(score(key) - mx);
    for (int key = 0; key < T; ++key) {
      const float pr = expf(score(key) - mx) / sum;
#pragma unroll
      for (int d = 0; d < HDM; ++d)
        if (d < hd) o[d] = fmaf(pr, V[key * P + d], o[d]);
    }
#pragma unroll
    for (int d = 0; d < HDM; ++d)
      if (d < hd) Q[r * P + d] = alpha * o[d];
  }
}

// ------------------------------------------------------------------ the walk
// BF16: bf16 operands with KT row tiles of 16 in registers; else f32 products.
// HD16: head-width tiles of 16; HD: the head width where it is 16 HD16, else 0.
template <bool BF16, int KT, int HD16, int HD>
__global__ void __launch_bounds__(32 * kIsaMaxWarps, 2) isa_kernel(const IsaArgs p) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int rows = p.windows * p.T;  // token rows of a step, each of q, k, v
  const int slot = 3 * rows * p.P;   // floats of a ring stage
  float* alphas = sm + p.stages * slot;  // the gate of each (window, head) of a step
  const int nsteps = (p.NW + p.windows - 1) / p.windows;
  const int mine = (int)blockIdx.x < nsteps ? (nsteps - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int C4 = p.C >> 2;
  // a 16-byte piece of a row: where C / 4 divides the block's threads, this thread's
  // column stays the same and its rows step by `per`, with no division a piece
  const int per = C4 ? (int)blockDim.x / C4 : 0;
  const bool by_rows = p.vec && per * C4 == (int)blockDim.x;
  const int my_c = by_rows ? (tid % C4) * 4 : 0, my_r = by_rows ? tid / C4 : 0;
  const int items = p.windows * p.nh;
  const int parts = max(1, nwarps / items);  // warps a (window, head) shares out its rows to

  // first token row and number of rows of this block's step j
  auto first_row = [&](int j) {
    return (size_t)(blockIdx.x + (size_t)j * gridDim.x) * p.windows * p.T;
  };
  auto step_rows = [&](int j) {
    const size_t left = (size_t)p.NW * p.T - first_row(j);
    return left < (size_t)rows ? (int)left : rows;
  };
  auto fetch = [&](int j) {  // one commit group, empty past the block's last step
    if (j < mine) {
      const size_t r0 = first_row(j);
      const int n = step_rows(j);
      float* dst = sm + (j % p.stages) * slot;
      if (by_rows) {
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          const float* src = x == 0 ? p.q : (x == 1 ? p.k : p.v);
          for (int r = my_r; r < n; r += per)
            cp_async16(dst + (x * rows + r) * p.P + my_c, src + (r0 + r) * p.C + my_c);
        }
      } else if (p.vec) {
        for (int idx = tid; idx < 3 * n * C4; idx += blockDim.x) {
          const int x = idx / (n * C4), rem = idx - x * n * C4, r = rem / C4;
          const int c = (rem - r * C4) * 4;
          const float* src = x == 0 ? p.q : (x == 1 ? p.k : p.v);
          cp_async16(dst + (x * rows + r) * p.P + c, src + (r0 + r) * p.C + c);
        }
      } else {
        for (int idx = tid; idx < 3 * n * p.C; idx += blockDim.x) {
          const int x = idx / (n * p.C), rem = idx - x * n * p.C, r = rem / p.C;
          const int c = rem - r * p.C;
          const float* src = x == 0 ? p.q : (x == 1 ? p.k : p.v);
          cp_async4(dst + (x * rows + r) * p.P + c, src + (r0 + r) * p.C + c);
        }
      }
    }
    cp_async_commit();
  };

  for (int j = 0; j < p.stages - 1; ++j) fetch(j);
  for (int j = 0; j < mine; ++j) {
    if (p.stages == 3) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();  // step j has landed for every thread, and step j - 1 is stored:
                      // its stage takes step j + stages - 1
    fetch(j + p.stages - 1);
    float* st = sm + (j % p.stages) * slot;
    const int n = step_rows(j), here = (n / p.T) * p.nh;
    auto head = [&](int it) {  // q of (window, head) `it` of the step
      const int w = it / p.nh;
      return st + w * p.T * p.P + (it - w * p.nh) * p.hd;
    };
    if constexpr (BF16) {
      // the step's q, k and v rounded to bf16 in place (kept as f32), as the plain
      // version rounds the operands of every product. The gates below may read a
      // value before or after its rounding: they round it themselves, to the same bf16.
      float4* x4 = reinterpret_cast<float4*>(st);
      for (int i = tid; i < slot / 4; i += blockDim.x) {
        float4 x = x4[i];
        x.x = __bfloat162float(__float2bfloat16_rn(x.x));
        x.y = __bfloat162float(__float2bfloat16_rn(x.y));
        x.z = __bfloat162float(__float2bfloat16_rn(x.z));
        x.w = __bfloat162float(__float2bfloat16_rn(x.w));
        x4[i] = x;
      }
    }
    for (int it = warp; it < here; it += nwarps) {
      const float* Q = head(it);
      float g;
      if constexpr (BF16)
        g = gate_bf16<KT, HD16, HD>(Q, Q + rows * p.P, p.T, p.hd, p.P, lane);
      else
        g = gate_f32(Q, Q + rows * p.P, p.T, p.hd, p.P, lane);
      if (lane == 0) alphas[it] = g;
    }
    __syncthreads();  // the step is rounded and every gate has read its q rows: the rows
                      // may be overwritten
    for (int u = warp; u < here * parts; u += nwarps) {
      const int it = u / parts, part = u - it * parts;
      float* Q = head(it);
      const float* K = Q + rows * p.P;
      if constexpr (BF16)
        rows_bf16<KT, HD16, HD>(Q, K, K + rows * p.P, p.T, p.hd, p.P, lane, part, parts,
                                alphas[it]);
      else
        rows_f32<HD16>(Q, K, K + rows * p.P, p.T, p.hd, p.P, lane, part, parts, alphas[it]);
    }
    __syncthreads();  // the step's results stand in its q rows
    const size_t r0 = first_row(j);
    if (by_rows) {
      for (int r = my_r; r < n; r += per)
        *reinterpret_cast<float4*>(p.out + (r0 + r) * p.C + my_c) =
            *reinterpret_cast<const float4*>(st + r * p.P + my_c);
    } else if (p.vec) {
      for (int idx = tid; idx < n * C4; idx += blockDim.x) {
        const int r = idx / C4, c = (idx - r * C4) * 4;
        *reinterpret_cast<float4*>(p.out + (r0 + r) * p.C + c) =
            *reinterpret_cast<const float4*>(st + r * p.P + c);
      }
    } else {
      for (int idx = tid; idx < n * p.C; idx += blockDim.x) {
        const int r = idx / p.C, c = idx - r * p.C;
        p.out[(r0 + r) * p.C + c] = st[r * p.P + c];
      }
    }
  }
  cp_async_wait<0>();
}

template <bool BF16, int KT, int HD16, int HD>
struct Isa {
  static constexpr auto kernel = isa_kernel<BF16, KT, HD16, HD>;

  // lets the kernel take `smem` bytes of dynamic shared memory: once per process
  // and size (a larger grant covers every smaller one)
  static cudaError_t prepare(int smem) {
    static int granted = 48 * 1024;
    if (smem <= granted) return cudaSuccess;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) granted = smem;
    return err;
  }

  static cudaError_t launch(const IsaArgs& p, int warps, int blocks, int smem, cudaStream_t st) {
    const cudaError_t err = prepare(smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, 32 * warps, smem, st>>>(p);
    return cudaGetLastError();
  }

  static int blocks_per_sm(int warps, int smem) {
    int n = -1;
    if (prepare(smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 32 * warps, smem) != cudaSuccess)
      return -1;
    return n;
  }
};

// calls f with the instantiation for T, hd and the compute dtype
template <class F>
cudaError_t with_hd(int hd, F&& f) {  // f32 products
  if (hd <= 16) return f(Isa<false, 0, 1, 0>());
  if (hd <= 32) return f(Isa<false, 0, 2, 0>());
  return f(Isa<false, 0, 4, 0>());
}
template <int KT, class F>
cudaError_t with_hd_bf16(int hd, F&& f) {
  switch (hd) {  // a full head width: no column masks
    case 16: return f(Isa<true, KT, 1, 16>());
    case 32: return f(Isa<true, KT, 2, 32>());
    case 64: return f(Isa<true, KT, 4, 64>());
  }
  if (hd < 16) return f(Isa<true, KT, 1, 0>());
  if (hd < 32) return f(Isa<true, KT, 2, 0>());
  return f(Isa<true, KT, 4, 0>());
}
template <class F>
cudaError_t dispatch(int T, int hd, int round_bf16, F&& f) {
  if (!round_bf16) return with_hd(hd, f);
  if (T <= 32) return with_hd_bf16<2>(hd, f);
  return T <= 64 ? with_hd_bf16<4>(hd, f) : with_hd_bf16<8>(hd, f);
}

inline int isa_pitch(int C) { return C + ((4 - C) & 31); }

inline int isa_smem(int T, int C, int nh, int windows, int stages) {
  return 4 * (stages * 3 * windows * T * isa_pitch(C) + windows * nh);
}

inline bool isa_takes(int T, int C, int nh, int windows, int warps, int stages) {
  return T >= 1 && T <= kIsaMaxT && nh >= 1 && C % nh == 0 && C / nh <= kIsaMaxHd &&
         windows >= 1 && warps >= 1 && warps <= kIsaMaxWarps && (stages == 2 || stages == 3);
}

}  // namespace rss

// out (NW, T, C) from q, k, v (NW, T, C), all f32; q is already scaled. `windows`
// (a step), `warps`, `stages` (of the ring) and `blocks` (the grid) come from the
// wrapper's plan.
extern "C" int k6_isa_core(const void* q, const void* k, const void* v, void* out, int NW,
                           int T, int C, int nh, int round_bf16, int windows, int warps,
                           int stages, int blocks, void* stream) {
  using namespace rss;
  if (NW < 1 || blocks < 1 || !isa_takes(T, C, nh, windows, warps, stages))
    return (int)cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) &
                        15) == 0;
  const IsaArgs p{(const float*)q, (const float*)k, (const float*)v, (float*)out,
                  NW, T, C, nh, C / nh, isa_pitch(C), windows, stages,
                  (C % 4 == 0 && aligned) ? 1 : 0};
  const int smem = isa_smem(T, C, nh, windows, stages);
  return (int)dispatch(T, C / nh, round_bf16, [&](auto isa) {
    return decltype(isa)::launch(p, warps, blocks, smem, (cudaStream_t)stream);
  });
}

// Blocks of that plan one SM holds at once, as the card reports it; -1 for a
// plan the kernel does not take.
extern "C" int k6_isa_blocks_per_sm(int T, int C, int nh, int round_bf16, int windows,
                                    int warps, int stages) {
  using namespace rss;
  if (!isa_takes(T, C, nh, windows, warps, stages)) return -1;
  const int smem = isa_smem(T, C, nh, windows, stages);
  int n = -1;
  dispatch(T, C / nh, round_bf16, [&](auto isa) {
    n = decltype(isa)::blocks_per_sm(warps, smem);
    return cudaSuccess;
  });
  return n;
}
