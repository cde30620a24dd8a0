// K1 `attention` with f32 operands, `attention_wg_kernel`, built beside attention.cu (which
// holds the bf16 kernels and the C entry point). Replaces, and is bound by, what
// attention.cu's note says; its design is noted below.
#include <math_constants.h>

#include "../hopper/wgmma.cuh"
#include "common.cuh"

namespace k1 {

// ---- attention with f32 operands: 3xTF32 `wgmma` (sm_90a), csrc/hopper/wgmma.cuh
//
// ONE PASS over the keys at every Nk, with an online softmax: a running row max and
// sum in registers, the output rescaled when the max grows, one division a row at the
// end. The bf16 kernels may not do this (attention.cu): they round the probabilities
// to bf16 before p v, and rounding unnormalised probabilities that are rescaled later
// would round other numbers than the TPU kernel does. With f32 operands nothing is
// rounded to bf16; an online softmax differs from the plain version only in the order
// of f32 operations, so the keys are read once and q k^T is computed once.
//
// * A pre-pass (`kv_split_kernel`, the call's first launch) writes, per (image, head),
//   into the wrapper's workspace K [key][d] and V^T [d][key], keys padded with zeros to a
//   multiple of the key tile, so that every copy of the main kernel is a plain
//   tensor-map box. Within each group of 16 features of K, d is permuted so that a
//   lane's 16-byte load of q gives its A fragments of two k slices (lane t, slice s:
//   k t <- d 4t + 2s, k t + 4 <- d 4t + 2s + 1); within each group of 8 keys of V^T,
//   keys follow the order in which the score accumulators become A fragments (k t <-
//   key 2t, k t + 4 <- key 2t + 1). (Copying K and V straight from kv and transposing V in
//   the producer instead, with no pre-pass, took 7% longer: the transpose held up the ring.)
// * A block is CW consumer warpgroups of 64 queries each and a producer warpgroup;
//   persistent blocks walk units of 64 CW queries of one (image, head), the units of a
//   head next to each other. The producer's first thread streams the key tiles of its
//   units (kAwKT keys of K and V^T, 32 KB at hd 64) through a ring of tensor-map copies
//   guarded by `mbarrier`s (full: landed; ready: split; empty: the consumers are done);
//   it runs ahead across units. Its warps 1-3 write the TF32 small halves of a landed
//   tile into the stage's second buffers (`split_stage`; big is the raw f32, the tensor
//   cores reading a TF32 operand's upper 19 bits). Every block of a head reads the
//   head's keys from L2; split here, a block reads half the bytes that a pre-pass
//   writing the small halves would have it read (the two took the same time, PERF.md).
// * A consumer warpgroup holds q of its 64 queries in registers as big and small
//   halves (loaded from device memory while the last tile of the unit before is
//   multiplied), computes S = q K^T as m64n64k8 `wgmma`s (3 a k slice), masks and
//   exponentiates in registers, P in place of S (the raw f32 as big) with its small half
//   beside it, and adds P V^T into its output accumulators as m64nHDk8 `wgmma`s. Two
//   consumer warpgroups run side by side: one's softmax runs under the other's products
//   (making them take turns by named barriers took 4-8% longer; keeping q K^T of the next
//   tile in flight under the softmax needs a second score tile of registers, and ptxas
//   then serialised the products: 46% longer, PERF.md).
// * The export of the raw logits leaves while the products go on: a warpgroup stages
//   its 64 x 64 score tile in shared memory of its own (the 128-byte swizzle, so the
//   accumulators write it without bank conflicts) and one thread stores it by tensor
//   map (rows past N and keys past Nk are not written); the staging is written again
//   only once that store has read it. Where rows are not 16-byte aligned (Nk % 4 != 0)
//   the accumulators are stored element by element with a streaming hint.
// * The key tile is a constant of the kernel, and every query's row is computed by the
//   same instructions in the same order whichever block takes it: every plan (queries
//   a block, persistent blocks) gives the same bits. No float atomics.
// What binds it (8 x 512², PERF.md): the products, at about 60% of the TF32 rate that the
// SM clock of the run allows. The card holds its power limit while the kernel runs (690 W
// of 700, SM clock 1.76 GHz where an idle card runs 1.98), and a warpgroup's key tile
// takes about 4,600 cycles: 2,400 issuing and draining its 48 `wgmma`s while the other
// warpgroup's share the tensor cores, 1,360 for the softmax between them (MUFU and
// shuffle latency: its two chains of products cannot overlap in the registers at hand),
// 700 for each unit's q, epilogue and first copy spread over its tiles.
constexpr int kAwKT = 64;            // keys a tile
constexpr int kAwMaxStages = 4;
constexpr int kAwSplitThreads = 96;  // the producer's warps 1-3
constexpr int kAwRegs = 168;         // registers a thread at launch, two consumer warpgroups
constexpr int kAwConsumerRegs = 232; // after `setmaxnreg`: the producer keeps 40

template <int HD>
__host__ __device__ constexpr int aw_stage_bytes() { return 16 * HD * kAwKT; }   // K, V^T, small halves
template <int CW>
__host__ __device__ constexpr int aw_staging_bytes() { return CW * 64 * kAwKT * 4; }
template <int HD, int CW>
__host__ __device__ constexpr int aw_stages() {
  const int s = (hop::kWgSmemLimit - 1024 - 24 * kAwMaxStages - aw_staging_bytes<CW>()) /
                aw_stage_bytes<HD>();
  return s > kAwMaxStages ? kAwMaxStages : s;
}
// bytes of dynamic shared memory: 1 KB to align, the ring, the staging, the barriers
template <int HD, int CW>
__host__ __device__ constexpr int aw_smem() {
  return 1024 + aw_stages<HD, CW>() * aw_stage_bytes<HD>() + aw_staging_bytes<CW>() +
         24 * kAwMaxStages;
}

struct AwArgs {
  const float* q;
  float* out;
  float* logits;   // the raw logits (B, nh, N, Nk), or null
  int N, Nk, C, nh, units, qtiles;
  float scale;
  int export_mode;   // 0 none, 1 by tensor map, 2 element by element
};

// kv (B, Nk, 2C) -> per (b, h): kws [Nk][HD] (K, d permuted) and vws [HD][Nkp] (V^T, keys
// permuted, zeros past Nk); a block does 32 keys of one head
template <int HD>
__global__ void __launch_bounds__(256)
kv_split_kernel(const float* __restrict__ kv, float* __restrict__ kws, float* __restrict__ vws,
                int Nk, int Nkp, int C, int nh) {
  __shared__ float vs[32][HD + 1];
  const int k0 = blockIdx.x * 32, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * nh + h;
  const float* src = kv + (size_t)b * Nk * 2 * C + h * HD;
  float* kd = kws + bh * Nk * HD;
  float* vd = vws + bh * HD * Nkp;
  for (int i = threadIdx.x; i < 32 * HD; i += 256) {
    const int r = i / HD, c = i % HD, key = k0 + r;
    const int d = (c & ~15) + 4 * (c & 3) + 2 * ((c >> 3) & 1) + ((c >> 2) & 1);
    float v = 0.f;
    if (key < Nk) {
      kd[(size_t)key * HD + c] = src[(size_t)key * 2 * C + d];
      v = src[(size_t)key * 2 * C + C + c];
    }
    vs[r][c] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < HD * 32; i += 256) {
    const int d = i / 32, c = i % 32, key = (c & ~7) + 2 * (c & 3) + ((c >> 2) & 1);
    vd[(size_t)d * Nkp + k0 + c] = vs[key][d];
  }
}

__device__ __forceinline__ float aw_ex2(float x) {   // 2^x, 2 ulp; -inf gives 0
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float aw_quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float aw_quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// keeps A fragments that a `wgmma` reads asynchronously in their registers until its wait
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(a[i][k])::"memory");
}

template <int HD, int CW>
__global__ void __launch_bounds__(128 * (CW + 1), 1)
attention_wg_kernel(const AwArgs p, const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap lmap) {
  using namespace hop;
  constexpr int KT = kAwKT, S = aw_stages<HD, CW>();
  constexpr int kK = HD * KT * 4;   // K or its small half: HD / 32 boxes of KT rows of 128 bytes
  constexpr int kV = HD * KT * 4;   // V^T or its small half: KT / 32 boxes of HD rows
  constexpr int kStage = aw_stage_bytes<HD>();
  constexpr int kStg = 64 * KT * 4; // a consumer warpgroup's staged score tile: KT / 32 boxes
  constexpr int NS = KT / 2, NO = HD / 2;   // accumulators a thread: scores, output
  static_assert(S >= 2 && (HD == 32 || HD == 64) && kStage == 2 * kK + 2 * kV, "attention geometry");
  static_assert(NS == 32, "P's A fragments are the score accumulators of one n64 tile");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* stg0 = smem + S * kStage;
  const uint32_t full0 = smem_u32(stg0 + CW * kStg), ready0 = full0 + 8 * S, empty0 = ready0 + 8 * S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ntiles = (p.Nk + KT - 1) / KT;
  if (tid == 128 * CW) {   // the producer's copying thread
    tensormap_prefetch(&kmap);
    tensormap_prefetch(&vmap);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(ready0 + 8 * s, kAwSplitThreads);
      mbar_init(empty0 + 8 * s, 4 * CW);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * CW) {   // ---- the producer warpgroup
    if constexpr (CW == 2) regs_dec<40>();
    const int total = (p.units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * ntiles;
    if (warp == 4 * CW) {   // the copies
      if (lane == 0) {
        for (int f = 0; f < total; ++f) {
          const int slot = f % S, j = f % ntiles, bh = (blockIdx.x + (f / ntiles) * gridDim.x) / p.qtiles;
          mbar_wait(empty0 + 8 * slot, ((f / S) & 1) ^ 1);
          unsigned char* st = smem + slot * kStage;
          const uint32_t bar = full0 + 8 * slot;
          mbar_arrive_expect(bar, kK + kV);
#pragma unroll
          for (int b = 0; b < HD / 32; ++b) tma_load_3d(st + b * KT * 128, &kmap, 32 * b, j * KT, bh, bar);
#pragma unroll
          for (int b = 0; b < KT / 32; ++b)
            tma_load_3d(st + 2 * kK + b * HD * 128, &vmap, j * KT + 32 * b, 0, bh, bar);
        }
      }
    } else {                // the small halves, a tile behind the copies
      const int stid = tid - 128 * CW - 32;
      for (int f = 0; f < total; ++f) {
        const int slot = f % S;
        mbar_wait(full0 + 8 * slot, (f / S) & 1);
        unsigned char* st = smem + slot * kStage;
        split_stage(st, st + kK, kK / 16, stid, kAwSplitThreads);
        split_stage(st + 2 * kK, st + 2 * kK + kV, kV / 16, stid, kAwSplitThreads);
        fence_proxy_async();
        mbar_arrive(ready0 + 8 * slot);
      }
    }
    return;
  }

  // ---- the consumer warpgroups: warp w of warpgroup wg owns queries 16 w .. 16 w + 15 of
  // the warpgroup's 64; lane (g, t) rows g and g + 8 of them
  if constexpr (CW == 2) regs_inc<kAwConsumerRegs>();
  const int wg = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4, wtid = tid % 128;
  unsigned char* stg = stg0 + wg * kStg;

  // q of this lane's rows of unit u, raw: big as it lies (the tensor cores read a TF32
  // operand's upper 19 bits), small split once the unit starts; rows past N read row
  // N - 1, whose results are never stored
  uint32_t qb[HD / 8][4], qs[HD / 8][4];
  auto load_q = [&](int u) {
    const int bh = u / p.qtiles, r = (u % p.qtiles) * 64 * CW + 64 * wg + 16 * w + g;
    const float* base = p.q + (size_t)(bh / p.nh) * p.N * p.C + (bh % p.nh) * HD + 4 * t;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float* row = base + (size_t)min(r + 8 * hf, p.N - 1) * p.C;
#pragma unroll
      for (int m = 0; m < HD / 16; ++m) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row + 16 * m));
        qb[2 * m][hf] = __float_as_uint(v.x);
        qb[2 * m][hf + 2] = __float_as_uint(v.y);
        qb[2 * m + 1][hf] = __float_as_uint(v.z);
        qb[2 * m + 1][hf + 2] = __float_as_uint(v.w);
      }
    }
  };

  // exp(scale (s - max)) as 2^(s c - max c), c = scale log2 e: one multiply-add and one
  // `ex2.approx` (2 ulp) an element; -inf gives 0. In f32 the probabilities differ from
  // the plain version's exp(s scale - max) by a few f32 spacings.
  const float c = p.scale * 1.4426950408889634f;
  const bool by_map = p.export_mode == 1;
  float s[NS];   // the scores, then P (its big half: the raw f32) while p v reads it
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
  int f = 0;
  if ((int)blockIdx.x < p.units) load_q(blockIdx.x);
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int bh = u / p.qtiles;
    const int q0 = (u % p.qtiles) * 64 * CW + 64 * wg;   // this warpgroup's first query
    const int row0 = q0 + 16 * w + g;                   // this lane's rows: row0, row0 + 8
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) qs[kk][i] = tf32_small_of(qb[kk][i]);
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;   // max: times c

    for (int j = 0; j < ntiles; ++j, ++f) {
      const int slot = f % S;
      const unsigned char* st = smem + slot * kStage;
      mbar_wait(ready0 + 8 * slot, (f / S) & 1);
      // ---- S = q K^T
      fence_acc(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const int bx = (kk / 4) * KT * 128, sl = 2 * (kk % 4);   // box, 32 bytes a k slice
        mma3<KT>(s, qb[kk], qs[kk], desc_sw(st + bx) + sl, desc_sw(st + kK + bx) + sl, kk != 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_acc(s);
      if (j == ntiles - 1 && u + (int)gridDim.x < p.units) load_q(u + gridDim.x);   // q is read no more
      const int k0 = j * KT;

      // ---- the raw logits out
      if (by_map) {
        if (wtid == 0) bulk_wait_read<0>();   // the store of the tile before has read the staging
        named_sync(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < KT / 8; ++jj) {
          const int col = 8 * jj + 2 * t, box = col >> 5, piece = (col & 31) >> 2;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = 16 * w + g + 8 * hf;
            *reinterpret_cast<float2*>(stg + box * 64 * 128 + r * 128 + ((piece ^ (r & 7)) << 4) +
                                       (col & 3) * 4) = make_float2(s[4 * jj + 2 * hf], s[4 * jj + 2 * hf + 1]);
          }
        }
        fence_proxy_async();
        named_sync(1 + wg, 128);
        if (wtid == 0 && q0 < p.N) {
#pragma unroll
          for (int b = 0; b < KT / 32; ++b)
            if (k0 + 32 * b < p.Nk) tma_store_3d(&lmap, stg + b * 64 * 128, k0 + 32 * b, q0, bh);
          bulk_commit();
        }
      } else if (p.export_mode == 2) {
        float* lb = p.logits + (size_t)bh * p.N * p.Nk;
#pragma unroll
        for (int jj = 0; jj < KT / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = row0 + 8 * (e >> 1), cc = k0 + 8 * jj + 2 * t + (e & 1);
            if (r < p.N && cc < p.Nk) __stcs(lb + (size_t)r * p.Nk + cc, s[4 * jj + e]);
          }
      }

      // ---- online softmax; keys past Nk count as -inf
      if (k0 + KT > p.Nk) {
#pragma unroll
        for (int i = 0; i < NS; ++i)
          if (k0 + 8 * (i / 4) + 2 * t + (i & 1) >= p.Nk) s[i] = -CUDART_INF_F;
      }
      float n0 = -CUDART_INF_F, n1 = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < KT / 8; ++jj) {
        n0 = fmaxf(n0, fmaxf(s[4 * jj], s[4 * jj + 1]));
        n1 = fmaxf(n1, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
      }
      n0 = fmaxf(m0, aw_quad_max(n0) * c);   // finite from the first tile on: its key 0 exists
      n1 = fmaxf(m1, aw_quad_max(n1) * c);
      const float a0 = aw_ex2(m0 - n0), a1 = aw_ex2(m1 - n1);   // 0 on the first tile
      m0 = n0;
      m1 = n1;
      float e0 = 0.f, e1 = 0.f;
      // P in place, each quad of accumulators in the order of the A fragment: keys (2t,
      // 2t + 1) of the lane as k (t, t + 4); its small half beside it
      uint32_t ps[KT / 8][4];
#pragma unroll
      for (int jj = 0; jj < KT / 8; ++jj) {
        const float p0 = aw_ex2(fmaf(s[4 * jj], c, -n0)), p1 = aw_ex2(fmaf(s[4 * jj + 1], c, -n0));
        const float p2 = aw_ex2(fmaf(s[4 * jj + 2], c, -n1)), p3 = aw_ex2(fmaf(s[4 * jj + 3], c, -n1));
        e0 += p0 + p1;
        e1 += p2 + p3;
        s[4 * jj] = p0;
        s[4 * jj + 1] = p2;
        s[4 * jj + 2] = p1;
        s[4 * jj + 3] = p3;
#pragma unroll
        for (int i = 0; i < 4; ++i) ps[jj][i] = tf32_small_of(__float_as_uint(s[4 * jj + i]));
      }
      l0 = l0 * a0 + e0;   // this lane's share of the row sums; the quad adds them at the end
      l1 = l1 * a1 + e1;
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj) {
        o[4 * jj] *= a0;
        o[4 * jj + 1] *= a0;
        o[4 * jj + 2] *= a1;
        o[4 * jj + 3] *= a1;
      }

      // ---- o += P V
      fence_acc(o);
      wg_fence();
#pragma unroll
      for (int jj = 0; jj < KT / 8; ++jj) {
        const uint32_t pb[4] = {__float_as_uint(s[4 * jj]), __float_as_uint(s[4 * jj + 1]),
                                __float_as_uint(s[4 * jj + 2]), __float_as_uint(s[4 * jj + 3])};
        const int bx = 2 * kK + (jj / 4) * HD * 128, sl = 2 * (jj % 4);
        mma3<HD>(o, pb, ps[jj], desc_sw(st + bx) + sl, desc_sw(st + bx + kV) + sl, 1);
      }
      wg_commit();
      wg_wait<0>();
      fence_acc(o);
      fence_acc(s);     // the products read P's big and small halves until here
      fence_regs(ps);
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);   // this warp is done with the stage
    }

    // ---- one division a row; an element is o * (1 / l)
    const float i0 = 1.0f / aw_quad_sum(l0), i1 = 1.0f / aw_quad_sum(l1);
    float* ob = p.out + (size_t)(bh / p.nh) * p.N * p.C + (bh % p.nh) * HD + 2 * t;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      if (row0 < p.N)
        *reinterpret_cast<float2*>(ob + (size_t)row0 * p.C + 8 * jj) =
            make_float2(o[4 * jj] * i0, o[4 * jj + 1] * i0);
      if (row0 + 8 < p.N)
        *reinterpret_cast<float2*>(ob + (size_t)(row0 + 8) * p.C + 8 * jj) =
            make_float2(o[4 * jj + 2] * i1, o[4 * jj + 3] * i1);
    }
  }
  if (by_map && wtid == 0) bulk_wait<0>();   // the last stores have landed
}

// One instantiation: its shared memory allowed once per process (and the registers that
// `setmaxnreg` counts on checked), its launch of `blocks` persistent blocks
template <int HD, int CW>
struct AttnWg {
  static constexpr int kSmem = aw_smem<HD, CW>();
  static constexpr int kThreads = 128 * (CW + 1);
  static constexpr auto kernel = attention_wg_kernel<HD, CW>;
  static_assert(kSmem <= hop::kWgSmemLimit, "the ring fits a block's shared memory");

  static cudaError_t prepare() {
    static const cudaError_t err = [] {
      cudaFuncAttributes attr;
      cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
      if (e == cudaSuccess && CW == 2 && attr.numRegs != kAwRegs) e = cudaErrorInvalidConfiguration;
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      return e;
    }();
    return err;
  }
  static cudaError_t launch(const AwArgs& a, const CUtensorMap& km, const CUtensorMap& vm,
                            const CUtensorMap& lm, int blocks, cudaStream_t st) {
    const cudaError_t err = prepare();
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, kSmem, st>>>(a, km, vm, lm);
    return cudaGetLastError();
  }
};

template <int HD>
int attention_f32_hd(const float* q, const float* kv, float* ws, float* out, float* logits, int B,
                     int N, int Nk, int C, int nh, float scale, int queries, int blocks,
                     cudaStream_t st) {
  const int Nkp = (Nk + kAwKT - 1) / kAwKT * kAwKT, BH = B * nh;
  float* kws = ws;
  float* vws = ws + (size_t)BH * Nk * HD;
  kv_split_kernel<HD><<<dim3(Nkp / 32, nh, B), 256, 0, st>>>(kv, kws, vws, Nk, Nkp, C, nh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap km = {}, vm = {}, lm = {};
  err = hop::wg_tensor_map_3d(&km, kws, HD, Nk, BH, 4LL * HD, 4LL * HD * Nk, kAwKT);
  if (err == cudaSuccess)
    err = hop::wg_tensor_map_3d(&vm, vws, Nkp, HD, BH, 4LL * Nkp, 4LL * Nkp * HD, HD);
  const int mode = logits == nullptr ? 0 : (Nk % 4 == 0 ? 1 : 2);
  if (err == cudaSuccess && mode == 1)
    err = hop::wg_tensor_map_3d(&lm, logits, Nk, N, BH, 4LL * Nk, 4LL * Nk * N, 64);
  if (err != cudaSuccess) return (int)err;
  const int cw = queries / 64, qtiles = (N + queries - 1) / queries;
  const AwArgs a{q, out, logits, N, Nk, C, nh, BH * qtiles, qtiles, scale, mode};
  if (cw == 2) return (int)AttnWg<HD, 2>::launch(a, km, vm, lm, blocks, st);
  if (cw == 1) return (int)AttnWg<HD, 1>::launch(a, km, vm, lm, blocks, st);
  return (int)cudaErrorInvalidValue;
}

int attention_f32(const float* q, const float* kv, float* ws, float* out, float* logits, int B,
                  int N, int Nk, int C, int nh, float scale, int queries, int blocks,
                  cudaStream_t st) {
  if ((queries != 64 && queries != 128) || blocks < 1) return (int)cudaErrorInvalidValue;
  const int hd = C / nh;
  if (hd == 64)
    return attention_f32_hd<64>(q, kv, ws, out, logits, B, N, Nk, C, nh, scale, queries, blocks, st);
  if (hd == 32)
    return attention_f32_hd<32>(q, kv, ws, out, logits, B, N, Nk, C, nh, scale, queries, blocks, st);
  return (int)cudaErrorInvalidValue;
}

int attention_f32_smem(int hd, int queries) {
  if (hd == 64) return queries == 128 ? AttnWg<64, 2>::kSmem : queries == 64 ? AttnWg<64, 1>::kSmem : -1;
  if (hd == 32) return queries == 128 ? AttnWg<32, 2>::kSmem : queries == 64 ? AttnWg<32, 1>::kSmem : -1;
  return -1;
}

}  // namespace k1
