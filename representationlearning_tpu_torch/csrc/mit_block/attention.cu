// K1 part 3: spatial-reduction attention, softmax(q k^T * hd^-1/2) v per head,
// with the optional export of the raw pre-scale logits, selected at compile time by the
// operand type of the two products: bf16 (the TPU kernel's bf16 path) runs the two
// kernels below, on `mma.sync`; float (its f32 default) runs `attention_wg_kernel`
// (attention_f32.cu, a source of its own so that nvcc builds it side by side): 3xTF32
// `wgmma` fed by tensor-map copies, ONE pass over the keys at every Nk with an online
// softmax, which f32 may do and bf16 may not (see below and attention_f32.cu).
//
// Replaces: the per-head attention loop of the TPU kernel
//   representationlearning_tpu/ops/pallas/mit_block.py:146-163 (reached from
//   `fused_block_pallas` :259 -> `_kernel` :216 -> `_block_math` :62), including
//   the `export=True` logits output (:150-151, :185-186) and the Nk == 0 case
//   (:152-157).
// What bounds it on the H100: bytes (bf16). Without export q is read and the output
//   written once (67 MB at stage 1 of the 512 x 512 forward, 8.6 GFLOP beside
//   it); with export (stage 4: 8 x 8 x 1024 x 1024 f32, 268 MB a launch) the
//   write of the logits to device memory is nearly all of it. What a block
//   really waits for, though, is its own chain of load, product, softmax and
//   product, so the design keeps that chain in registers and the loads off it.
//   With f32 operands the three TF32 products of each f32 product bound it.
// What the design does about it (bf16; float's design is noted at `attention_wg_kernel`):
//   * A pre-pass (`kv_to_heads_kernel`) rounds k and v to bf16 once, head by
//     head, into a workspace of the wrapper, [(b, head), k | v, key, d]. Every
//     later load of a key or value is a 16-byte `cp.async` straight into shared
//     memory: no conversion in a block's loop, half the bytes.
//   * One warp owns 16 queries. q goes from device memory into `mma.sync`
//     (m16n8k16) A fragments; the scores of a warp live in accumulator
//     registers, the row max and sum come from those registers with two
//     shuffles inside the quad that shares a row, and the normalised bf16
//     probabilities are packed from the accumulators into the A fragments of
//     the product with v. No score and no probability passes through shared
//     memory.
//   * ONE PASS where the keys fit: for Nk <= kOnePassKeys (256: every launch
//     of stages 1-3 of every path) K and V of the (image, head) lie in shared
//     memory whole (72 KB at most) and a warp holds its 16 full score rows (128
//     registers a thread at 256 keys). The whole row is there before anything
//     is rounded, so p = exp(s - max) / sum is normalised in f32 and then
//     rounded, as the TPU kernel does; q k^T is computed once and every key is
//     read once. A block walks over several query tiles, so K and V are loaded
//     once for all of them and a launch of few tiles still spreads over the SMs.
//   * STREAMING beyond that (stage 4: Nk = 1024): a block of four warps owns
//     128 queries, 32 a warp, so that a K or V fragment read from shared memory
//     serves two products; key tiles of 64 go through a ring of three
//     shared-memory stages that `cp.async` fills two tiles ahead of the
//     products. Two passes stay: the probabilities must be normalised
//     BEFORE they are rounded to bf16, and the sum of a row is known only after
//     its last key; rescaling a running product of rounded, unnormalised
//     probabilities (the usual online form) would round other numbers than the
//     TPU kernel does. Pass 1 computes q k^T and keeps a running max and sum in
//     each thread's registers (the quad is combined once, at the end); pass 2
//     recomputes q k^T (as many tensor-core operations as p v), normalises,
//     rounds and accumulates p v.
//   * The export leaves as whole rows: the streaming form stages its score
//     tile in shared memory that pass 1 leaves idle and stores 128 contiguous
//     bytes a row, 16 a lane (from the accumulators a store touches 16 rows of
//     32 bytes, and the store unit, not the memory, then sets the pace); the
//     one-pass form, which exports in no model, trades halves between
//     neighbouring lanes for 16-byte stores. All with a streaming hint
//     (`__stcs`: 268 MB pass the 50 MB L2 and are not read back here). Nk that
//     is no multiple of 4 falls back to scalar streaming stores.
#include <math_constants.h>

#include "common.cuh"

namespace k1 {

constexpr int kAttnThreads = 128;  // the one-pass form: four warps of 16 queries
constexpr int kQT = 64;            // its queries a tile
constexpr int kStreamThreads = 128;  // the streaming form: four warps of 32 queries
constexpr int kStreamQT = 128;       // its queries a block
constexpr int kOnePassKeys = 256;  // the one-pass form holds at most this many keys
constexpr int kKT = 64;            // keys a tile of the streaming form
constexpr int kRing = 3;           // stages of its ring

// kv (B, Nk, 2C) f32 -> ws [(b * nh + h) * 2 + i2][Nk][hd] bf16, eight features a thread
template <typename T>
__global__ void kv_to_heads_kernel(const float* __restrict__ kv, T* __restrict__ ws,
                                   size_t total8, int Nk, int C, int nh, int hd) {
  static_assert(sizeof(T) == 2, "bf16 operands: f32 runs attention_wg_kernel");
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total8) return;
  const int per_row = 2 * C / 8;
  const size_t row = idx / per_row;  // b * Nk + key
  const int f = (int)(idx - row * per_row) * 8;
  const int i2 = f / C, rem = f - i2 * C, h = rem / hd, d = rem - h * hd;
  const size_t b = row / Nk, key = row - b * Nk;
  const float4* src = reinterpret_cast<const float4*>(kv + row * 2 * C + f);
  const float4 lo = src[0], hi = src[1];
  T* dst = ws + (((b * nh + h) * 2 + i2) * Nk + key) * hd + d;
  uint4 o;
  o.x = pack_bf16(lo.x, lo.y);
  o.y = pack_bf16(lo.z, lo.w);
  o.z = pack_bf16(hi.x, hi.y);
  o.w = pack_bf16(hi.z, hi.w);
  *reinterpret_cast<uint4*>(dst) = o;
}

// the padding of a row of K or V in shared memory: 16 bytes, in elements
template <typename T>
constexpr int kPad = 16 / (int)sizeof(T);
// 32-byte k slices of a head's features: the products' k steps over d
template <int HD, typename T>
constexpr int kDSlices = HD * (int)sizeof(T) / 32;

// `rows` rows of HD elements from src (row `first` onwards, rows at or beyond
// `limit` as zeros) into dst with pitch HD + kPad, by the whole block
template <int HD, int THREADS, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int first, int rows,
                                          int limit, int tid) {
  constexpr int kEl = 16 / (int)sizeof(T), kChunks = HD / kEl;  // 16-byte pieces a row
  for (int idx = tid; idx < rows * kChunks; idx += THREADS) {
    const int r = idx / kChunks, c = (idx % kChunks) * kEl;
    const bool ok = first + r < limit;
    cp_async16(dst + r * (HD + kPad<T>) + c, src + (size_t)(ok ? first + r : 0) * HD + c, ok);
  }
}

// the A fragments of this lane's two query rows (row0 = tile row g, row0 + 8), a k
// slice each: bf16 pairs (d 2t, 2t + 1 | 2t + 8, 2t + 9) of 16
template <int HD, typename T>
__device__ __forceinline__ void load_q(uint32_t (&qa)[kDSlices<HD, T>][4], const float* qb,
                                       int C, int row0, int N, int t) {
#pragma unroll
  for (int kk = 0; kk < kDSlices<HD, T>; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + (i & 1) * 8;
      const int c = kk * 16 + 2 * t + (i >> 1) * 8;
      float2 v = make_float2(0.f, 0.f);
      if (r < N) v = *reinterpret_cast<const float2*>(qb + (size_t)r * C + c);
      qa[kk][i] = pack_bf16(v.x, v.y);
    }
  }
}

// s[j] = q (16 x HD) . K(8 keys starting at shared-memory row `krow` + 8 j)^T for
// G score tiles at once: all their fragments are loaded first and the products
// of the G tiles alternate, so that no product waits for the one before it
// (they add into different accumulators).
template <int HD, int G, typename T>
__device__ __forceinline__ void qk_tiles(float (*s)[4], const uint32_t (&qa)[kDSlices<HD, T>][4],
                                         const T* krow, int lane) {
  // matrices of 16 bytes: two make a k slice; an x4 takes 64 bytes of d
  constexpr int kE = 16 / (int)sizeof(T);
  uint32_t kb[G][kDSlices<HD, T> / 2][4];
#pragma unroll
  for (int u = 0; u < G; ++u)
#pragma unroll
    for (int k2 = 0; k2 < kDSlices<HD, T> / 2; ++k2)
      ldsm_x4(kb[u][k2],
              krow + (u * 8 + (lane & 7)) * (HD + kPad<T>) + k2 * 4 * kE + (lane >> 3) * kE);
#pragma unroll
  for (int u = 0; u < G; ++u) s[u][0] = s[u][1] = s[u][2] = s[u][3] = 0.f;
#pragma unroll
  for (int k = 0; k < kDSlices<HD, T>; ++k)
#pragma unroll
    for (int u = 0; u < G; ++u)
      mma_slice<T>(s[u], qa[k], kb[u][k / 2][2 * (k & 1)], kb[u][k / 2][2 * (k & 1) + 1]);
}

// o += p (16 queries x 16 keys, packed in pa) . V(16 keys starting at row `vrow`)
template <int HD>
__device__ __forceinline__ void pv_step(float (&o)[HD / 8][4], const uint32_t (&pa)[4],
                                        const bf16* vrow, int lane) {
#pragma unroll
  for (int n2 = 0; n2 < HD / 16; ++n2) {
    uint32_t vb[4];  // transposed: (keys 0-7 | 8-15) x (d n2*16 .. +7 | +8 .. +15)
    ldsm_x4_trans(vb, vrow + (lane & 15) * (HD + 8) + n2 * 16 + (lane >> 4) * 8);
    mma_bf16(o[2 * n2], pa, vb[0], vb[1]);
    mma_bf16(o[2 * n2 + 1], pa, vb[2], vb[3]);
  }
}

// exp(v - m) as 2^((v - m) log2 e): a subtraction, a multiplication and one
// `ex2.approx` (2 ulp) in place of `expf`'s range reduction; -inf gives 0. The
// difference v - m is formed first, so its error does not grow with |m|, and a
// probability of any weight differs from `expf`'s by a few f32 spacings, far
// below the bf16 spacing it is rounded to.
__device__ __forceinline__ float exp_sub(float v, float m) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;"
      : "=f"(r)
      : "f"(__fmul_rn(__fsub_rn(v, m), 1.4426950408889634f)));
  return r;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One 16 x 8 accumulator tile to device memory. `dst` points at (tile row 0,
// tile column 0) of a row-major matrix of pitch ld; rows at or beyond `rows`
// and columns at or beyond `cols` (both counted from the tile's origin) are
// dropped. Neighbouring lanes trade halves, so that a lane holds four
// consecutive columns of one row: one 16-byte store where `vec` says that
// every row is 16-byte aligned and cols is a multiple of 4.
template <bool STREAM>
__device__ __forceinline__ void store_tile(float* dst, size_t ld, const float (&c)[4],
                                           int rows, int cols, bool vec, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
  const float rx = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
  const float ry = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
  const float4 v = odd ? make_float4(rx, ry, c[2], c[3]) : make_float4(c[0], c[1], rx, ry);
  const int row = odd ? g + 8 : g, col = (t & 2) * 2;
  if (row >= rows || col >= cols) return;
  float* p = dst + (size_t)row * ld + col;
  if (vec) {
    if (STREAM) __stcs(reinterpret_cast<float4*>(p), v);
    else *reinterpret_cast<float4*>(p) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < cols) {
      if (STREAM) __stcs(p + i, e[i]);
      else p[i] = e[i];
    }
}

// ---------------------------------------------------------------- one pass
// NT: score tiles of 8 keys a warp can hold; the kernel takes Nk <= 8 * NT.
template <int HD, int NT, typename T>
__global__ void __launch_bounds__(kAttnThreads)
attention_onepass_kernel(const float* __restrict__ q, const T* __restrict__ kvb,
                         float* __restrict__ out, float* __restrict__ logits, int N, int Nk,
                         int C, int nh, float scale) {
  static_assert(sizeof(T) == 2, "bf16 operands: f32 runs attention_wg_kernel");
  constexpr int kP = HD + kPad<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + NT * 8 * kP;

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int nk16 = (Nk + 15) & ~15;  // keys the products walk over; past Nk they are zeros
  const T* kg = kvb + (size_t)(b * nh + h) * 2 * Nk * HD;
  load_rows<HD, kAttnThreads>(Ks, kg, 0, nk16, Nk, tid);
  load_rows<HD, kAttnThreads>(Vs, kg + (size_t)Nk * HD, 0, nk16, Nk, tid);
  cp_async_commit();

  const float* qb = q + (size_t)b * N * C + h * HD;
  float* ob = out + (size_t)b * N * C + h * HD;
  float* lb = logits ? logits + (size_t)(b * nh + h) * N * Nk : nullptr;
  const bool vec = (Nk & 3) == 0;
  const int ntiles = (N + kQT - 1) / kQT;
  bool loaded = false;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int q0 = tile * kQT + warp * 16;  // this warp's first query
    uint32_t qa[kDSlices<HD, T>][4];
    load_q<HD, T>(qa, qb, C, q0 + g, N, t);
    if (!loaded) {  // the first q loads overlap the copy of K and V
      cp_async_wait<0>();
      __syncthreads();
      loaded = true;
    }
    if (q0 >= N) continue;  // no barrier below: a warp without rows may go on

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; j += 2) {  // nk16 is a multiple of 16: tiles come in pairs
      if (j * 8 < nk16) qk_tiles<HD, 2, T>(&s[j], qa, Ks + j * 8 * kP, lane);
    }
    if (lb != nullptr) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j * 8 < Nk)
          store_tile<true>(lb + (size_t)q0 * Nk + j * 8, Nk, s[j], N - q0, Nk - j * 8, vec, lane);
    }
    // the scaled logit is rounded before the max is subtracted (no fused
    // multiply-add), as in the plain version; keys past Nk count as -inf
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j * 8 < nk16) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = __fmul_rn(s[j][i], scale);
        if (j * 8 + 8 > Nk) {  // only a tile that reaches past the last key needs the mask
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (j * 8 + 2 * t + (i & 1) >= Nk) s[j][i] = -CUDART_INF_F;
        }
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j * 8 < nk16) {
        s[j][0] = exp_sub(s[j][0], m0);
        s[j][1] = exp_sub(s[j][1], m0);
        s[j][2] = exp_sub(s[j][2], m1);
        s[j][3] = exp_sub(s[j][3], m1);
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
    }
    // one division a row; an element is e * (1 / l), within an f32 spacing of e / l
    l0 = 1.0f / quad_sum(l0);
    l1 = 1.0f / quad_sum(l1);

    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (kk * 16 < nk16) {
        // normalised in f32, then rounded: the accumulator tiles 2kk and 2kk + 1
        // are the A fragment of this step of 16 keys
        uint32_t pa[4];
        pa[0] = pack_bf16(__fmul_rn(s[2 * kk][0], l0), __fmul_rn(s[2 * kk][1], l0));
        pa[1] = pack_bf16(__fmul_rn(s[2 * kk][2], l1), __fmul_rn(s[2 * kk][3], l1));
        pa[2] = pack_bf16(__fmul_rn(s[2 * kk + 1][0], l0), __fmul_rn(s[2 * kk + 1][1], l0));
        pa[3] = pack_bf16(__fmul_rn(s[2 * kk + 1][2], l1), __fmul_rn(s[2 * kk + 1][3], l1));
        pv_step<HD>(o, pa, reinterpret_cast<const bf16*>(Vs) + kk * 16 * kP, lane);
      }
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store_tile<false>(ob + (size_t)q0 * C + n * 8, C, o[n], N - q0, 8, true, lane);
  }
  cp_async_wait<0>();  // a block that got no tile still owns its copies
}

// --------------------------------------------------------------- streaming
// A warp owns kMT x 16 queries: every K and V fragment it loads from shared
// memory serves kMT products, and a block reads the keys and values of its head
// from L2 for 128 queries at once. (Measured at stage 4 of the 512 x 512 forward
// on an H100 80GB HBM3 at 700 W: 127 us against 131 us with 16 queries a warp
// and 64 or 128 a block; with the loads or the barriers taken out the kernel
// still takes 110 us. Its warps wait for each other's products and exponentials,
// not for memory: all of a block's warps multiply, then all exponentiate.)
constexpr int kMT = 2;

// s[mt][j] = q[mt] (16 x HD) . K(8 keys at row 8 j of the tile)^T for the whole tile
template <int HD, typename T>
__device__ __forceinline__ void qk_stream(float (&s)[kMT][kKT / 8][4],
                                          const uint32_t (&qa)[kMT][kDSlices<HD, T>][4],
                                          const T* Ks, int lane) {
  constexpr int kE = 16 / (int)sizeof(T);
#pragma unroll
  for (int j = 0; j < kKT / 8; j += 2) {
    uint32_t kb[2][kDSlices<HD, T> / 2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int k2 = 0; k2 < kDSlices<HD, T> / 2; ++k2)
        ldsm_x4(kb[u][k2], Ks + ((j + u) * 8 + (lane & 7)) * (HD + kPad<T>) + k2 * 4 * kE +
                               (lane >> 3) * kE);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        s[mt][j + u][0] = s[mt][j + u][1] = s[mt][j + u][2] = s[mt][j + u][3] = 0.f;
#pragma unroll
    for (int k = 0; k < kDSlices<HD, T>; ++k)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          mma_slice<T>(s[mt][j + u], qa[mt][k], kb[u][k / 2][2 * (k & 1)],
                       kb[u][k / 2][2 * (k & 1) + 1]);
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(kStreamThreads)
attention_stream_kernel(const float* __restrict__ q, const T* __restrict__ kvb,
                        float* __restrict__ out, float* __restrict__ logits, int N, int Nk,
                        int C, int nh, float scale) {
  static_assert(sizeof(T) == 2, "bf16 operands: f32 runs attention_wg_kernel");
  constexpr int kP = HD + kPad<T>;
  constexpr int kTile = kKT * kP;  // elements of one K or V tile
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [kRing] K tiles, then [kRing] V tiles
  T* vring = ring + kRing * kTile;

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kStreamQT + warp * 16 * kMT;  // this warp's first query
  const T* kg = kvb + (size_t)(b * nh + h) * 2 * Nk * HD;
  const T* vg = kg + (size_t)Nk * HD;
  float* lb = logits ? logits + (size_t)(b * nh + h) * N * Nk : nullptr;
  const bool vec = (Nk & 3) == 0;
  const int ntiles = (Nk + kKT - 1) / kKT;

  auto fetch = [&](int tile, bool with_v) {  // one commit group a call, empty past the end
    if (tile < ntiles) {
      load_rows<HD, kStreamThreads>(ring + (tile % kRing) * kTile, kg, tile * kKT, kKT, Nk, tid);
      if (with_v)
        load_rows<HD, kStreamThreads>(vring + (tile % kRing) * kTile, vg, tile * kKT, kKT, Nk,
                                      tid);
    }
    cp_async_commit();
  };

  // The export of pass 1. Straight from the accumulators a store would touch 16
  // rows with 32 bytes each; the warp stages kSW columns of 16 rows at a time in
  // shared memory (the V tiles of the ring, idle in pass 1) and writes whole
  // rows of 128 bytes (64 at hd 32), 16 bytes a lane, with a streaming hint.
  constexpr int kSW = HD / 2, kSP = kSW + 4;  // staged columns, their f32 pitch
  static_assert(kStreamThreads / 32 * 16 * kSP * sizeof(float) <= kRing * kTile * sizeof(T),
                "the warps' staging rows fit the V tiles of the ring");
  auto export_tile = [&](const float (&s)[kKT / 8][4], int row0, int k0) {
    if (lb == nullptr || row0 >= N) return;
    if (!vec) {  // rows are not 16-byte aligned: scalar stores from the accumulators
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j)
        if (k0 + j * 8 < Nk)
          store_tile<true>(lb + (size_t)row0 * Nk + k0 + j * 8, Nk, s[j], N - row0,
                           Nk - k0 - j * 8, false, lane);
      return;
    }
    float* stage = reinterpret_cast<float*>(vring) + warp * 16 * kSP;
    constexpr int kRowLanes = kSW / 4, kRows = 32 / kRowLanes;  // lanes a row, rows a store
#pragma unroll
    for (int part = 0; part < kKT / kSW; ++part) {
#pragma unroll
      for (int jj = 0; jj < kSW / 8; ++jj) {
        const float(&c)[4] = s[part * (kSW / 8) + jj];
        *reinterpret_cast<float2*>(stage + g * kSP + jj * 8 + 2 * t) = make_float2(c[0], c[1]);
        *reinterpret_cast<float2*>(stage + (g + 8) * kSP + jj * 8 + 2 * t) =
            make_float2(c[2], c[3]);
      }
      __syncwarp();
#pragma unroll
      for (int r0 = 0; r0 < 16; r0 += kRows) {
        const int r = r0 + lane / kRowLanes, c = (lane % kRowLanes) * 4;
        const int col = k0 + part * kSW + c;
        if (row0 + r < N && col < Nk)
          __stcs(reinterpret_cast<float4*>(lb + (size_t)(row0 + r) * Nk + col),
                 *reinterpret_cast<const float4*>(stage + r * kSP + c));
      }
      __syncwarp();
    }
  };
  // scaled logits of one tile, keys past Nk as -inf: only the last tile has any
  auto scale_mask = [&](float (&s)[kKT / 8][4], int k0) {
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = __fmul_rn(s[j][i], scale);
      if (k0 + j * 8 + 8 > Nk) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + j * 8 + 2 * t + (i & 1) >= Nk) s[j][i] = -CUDART_INF_F;
      }
    }
  };

  fetch(0, false);
  fetch(1, false);
  uint32_t qa[kMT][kDSlices<HD, T>][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
    load_q<HD, T>(qa[mt], q + (size_t)b * N * C + h * HD, C, q0 + mt * 16 + g, N, t);

  // pass 1: raw logits out, running max and sum of each thread's own columns;
  // [mt][0] is the row g of tile mt, [mt][1] the row g + 8
  float m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    m[mt][0] = m[mt][1] = -CUDART_INF_F;
    l[mt][0] = l[mt][1] = 0.f;
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<1>();
    __syncthreads();  // tile `tile` has landed; every warp is done with tile - 1
    fetch(tile + 2, false);
    const int k0 = tile * kKT;
    float s[kMT][kKT / 8][4];
    qk_stream<HD, T>(s, qa, ring + (tile % kRing) * kTile, lane);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      export_tile(s[mt], q0 + mt * 16, k0);
      scale_mask(s[mt], k0);
      float n0 = m[mt][0], n1 = m[mt][1];
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j) {
        n0 = fmaxf(n0, fmaxf(s[mt][j][0], s[mt][j][1]));
        n1 = fmaxf(n1, fmaxf(s[mt][j][2], s[mt][j][3]));
      }
      // the first tile is full (Nk > kOnePassKeys), so n0 and n1 are finite from
      // here on; the old sum, still 0 beside a max of -inf, is rescaled exactly
      float e0 = 0.f, e1 = 0.f;
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j) {
        e0 += exp_sub(s[mt][j][0], n0) + exp_sub(s[mt][j][1], n0);
        e1 += exp_sub(s[mt][j][2], n1) + exp_sub(s[mt][j][3], n1);
      }
      l[mt][0] = l[mt][0] * expf(m[mt][0] - n0) + e0;
      l[mt][1] = l[mt][1] * expf(m[mt][1] - n1) + e1;
      m[mt][0] = n0;
      m[mt][1] = n1;
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four lanes of a quad share a row: combine their maxima and sums once;
      // one division a row, see the one-pass form
      const float M = quad_max(m[mt][r]);
      l[mt][r] = 1.0f / quad_sum(l[mt][r] * expf(m[mt][r] - M));
      m[mt][r] = M;
    }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free again

  // pass 2: q k^T again, p = exp(s - max) * (1 / sum) in f32, rounded to bf16, o += p v
  fetch(0, true);
  fetch(1, true);
  float o[kMT][HD / 8][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<1>();
    __syncthreads();
    fetch(tile + 2, true);
    const int k0 = tile * kKT;
    float s[kMT][kKT / 8][4];
    qk_stream<HD, T>(s, qa, ring + (tile % kRing) * kTile, lane);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[mt][j][i] = __fmul_rn(exp_sub(__fmul_rn(s[mt][j][i], scale), m[mt][i >> 1]),
                                  l[mt][i >> 1]);
        if (k0 + j * 8 + 8 > Nk) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k0 + j * 8 + 2 * t + (i & 1) >= Nk) s[mt][j][i] = 0.f;
        }
      }
    }
    const T* Vs = vring + (tile % kRing) * kTile;
    uint32_t pa[kMT][kKT / 16][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int kk = 0; kk < kKT / 16; ++kk) {
        pa[mt][kk][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][kk][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][kk][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][kk][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < HD / 16; ++n2) {
        uint32_t vb[4];  // transposed: (keys 0-7 | 8-15) x (d n2*16 .. +7 | +8 .. +15)
        ldsm_x4_trans(vb, reinterpret_cast<const bf16*>(Vs) + (kk * 16 + (lane & 15)) * kP +
                              n2 * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(o[mt][2 * n2], pa[mt][kk], vb[0], vb[1]);
          mma_bf16(o[mt][2 * n2 + 1], pa[mt][kk], vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  float* ob = out + (size_t)b * N * C + h * HD;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int row0 = q0 + mt * 16;
    if (row0 >= N) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store_tile<false>(ob + (size_t)row0 * C + n * 8, C, o[mt][n], N - row0, 8, true, lane);
  }
}

// ------------------------------------------------------------------ launch
template <typename T>
struct AttnArgs {
  const float* q;
  const T* kvb;
  float* out;
  float* logits;
  int B, N, Nk, C, nh;
  float scale;
  cudaStream_t stream;
};

// What a kernel needs once on each device: its dynamic shared memory allowed,
// and the number of its blocks an SM holds at once. Kept per instantiation (the
// caller's static) and per device, so that a launch pays no runtime query. Two
// threads that arrive together write the same values.
constexpr int kMaxDevices = 16;
struct KernelSetup {
  bool done[kMaxDevices];
  int slots[kMaxDevices];  // blocks the whole card holds at once
};

template <typename Kernel>
int prepare(Kernel kernel, int threads, size_t smem, KernelSetup& st, int* slots) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!st.done[dev]) {
    int sms = 0, resident = 0;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads, smem)) != cudaSuccess)
      return (int)err;
    st.slots[dev] = sms * (resident > 0 ? resident : 1);
    st.done[dev] = true;
  }
  *slots = st.slots[dev];
  return 0;
}

// The streaming form: one block for every 128 queries of an (image, head). Every
// block reads all keys of its head twice and all values once, from L2: with 64
// queries a block that traffic (393 MB at stage 4 of the 512 x 512 forward) set
// the pace, so a block holds as many queries as its registers allow.
template <int HD, typename T>
int launch_stream(const AttnArgs<T>& a) {
  static KernelSetup setup;
  constexpr size_t kSmem = kRing * 2 * kKT * sizeof(T) * (HD + kPad<T>);
  int slots = 0;
  const int rc = prepare(attention_stream_kernel<HD, T>, kStreamThreads, kSmem, setup, &slots);
  if (rc != 0) return rc;
  const dim3 grid((a.N + kStreamQT - 1) / kStreamQT, a.nh, a.B);
  attention_stream_kernel<HD, T><<<grid, kStreamThreads, kSmem, a.stream>>>(
      a.q, a.kvb, a.out, a.logits, a.N, a.Nk, a.C, a.nh, a.scale);
  return (int)cudaGetLastError();
}

// The one-pass form: a block walks over `per` query tiles of its (image, head),
// so K and V are copied once for all of them. Every block has the same work and
// nothing balances a last, partly filled wave, so `per` is chosen to make
// waves x (per + the copy, about 0.6 of a tile) smallest, with the blocks that
// the card holds at once read from the occupancy of this kernel.
template <int HD, int NT, typename T>
int launch_onepass(const AttnArgs<T>& a) {
  static KernelSetup setup;
  constexpr size_t kSmem = 2 * NT * 8 * sizeof(T) * (HD + kPad<T>);
  int slots = 0;
  const int rc = prepare(attention_onepass_kernel<HD, NT, T>, kAttnThreads, kSmem, setup, &slots);
  if (rc != 0) return rc;
  const int ntiles = (a.N + kQT - 1) / kQT, heads = a.B * a.nh;
  int best_per = 1;
  float best = 3.0e38f;
  for (int per = 1; per <= ntiles; ++per) {
    const long blocks = (long)((ntiles + per - 1) / per) * heads;
    const float cost = (float)((blocks + slots - 1) / slots) * ((float)per + 0.6f);
    if (cost < best) {
      best = cost;
      best_per = per;
    }
  }
  const dim3 grid((ntiles + best_per - 1) / best_per, a.nh, a.B);
  attention_onepass_kernel<HD, NT, T><<<grid, kAttnThreads, kSmem, a.stream>>>(
      a.q, a.kvb, a.out, a.logits, a.N, a.Nk, a.C, a.nh, a.scale);
  return (int)cudaGetLastError();
}

template <int HD, typename T>
int launch_attention(const float* q, const float* kv, void* kvb, float* out, float* logits,
                     int B, int N, int Nk, int C, int nh, float scale, cudaStream_t stream) {
  const size_t total8 = (size_t)B * Nk * 2 * C / 8;
  T* ws = static_cast<T*>(kvb);
  kv_to_heads_kernel<T><<<(unsigned)((total8 + 255) / 256), 256, 0, stream>>>(kv, ws, total8,
                                                                             Nk, C, nh, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const AttnArgs<T> a{q, ws, out, logits, B, N, Nk, C, nh, scale, stream};
  if (Nk > kOnePassKeys) return launch_stream<HD, T>(a);
  if (Nk <= 64) return launch_onepass<HD, 8, T>(a);
  if (Nk <= 128) return launch_onepass<HD, 16, T>(a);
  return launch_onepass<HD, 32, T>(a);
}

// the f32 operand path, `attention_wg_kernel` (attention_f32.cu, built beside this file)
int attention_f32(const float* q, const float* kv, float* ws, float* out, float* logits, int B,
                  int N, int Nk, int C, int nh, float scale, int queries, int blocks,
                  cudaStream_t st);
int attention_f32_smem(int hd, int queries);

int attention_bf16(const void* q, const void* kv, void* kvb, void* out, void* logits, int B,
                   int N, int Nk, int C, int nh, float scale, cudaStream_t st) {
  const int hd = C / nh;
  if (hd == 64)
    return launch_attention<64, bf16>((const float*)q, (const float*)kv, kvb, (float*)out,
                                      (float*)logits, B, N, Nk, C, nh, scale, st);
  if (hd == 32)
    return launch_attention<32, bf16>((const float*)q, (const float*)kv, kvb, (float*)out,
                                      (float*)logits, B, N, Nk, C, nh, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace k1

// out (B, N, C) = per-head softmax(q k^T * scale) v; q (B, N, C), kv (B, Nk, 2C),
// all f32. logits (B, nh, N, Nk) f32 receives the raw q k^T when not null. kvb is
// a workspace of the wrapper: bf16, B * Nk * 2C elements; f32 (`f32` set), B * C * (Nk +
// Nkp) elements, Nkp = Nk rounded up to 64 (K and V^T head by head).
// C / nh must be 32 or 64, Nk at least 1 (with no key the output is zero by
// definition and the wrapper launches nothing). bf16: up to
// k1_attention_one_pass_keys() keys take the one-pass form, more the streaming form;
// `queries` and `blocks` are not read. f32: the plan, `queries` a block (64 or 128: one
// or two consumer warpgroups) and `blocks` persistent blocks; q 16-byte aligned.
extern "C" int k1_attention(const void* q, const void* kv, void* kvb, void* out, void* logits,
                            int B, int N, int Nk, int C, int nh, float scale, int f32,
                            int queries, int blocks, void* stream) {
  if (B < 1 || N < 1 || Nk < 1 || nh < 1 || C % nh) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return f32 ? k1::attention_f32((const float*)q, (const float*)kv, (float*)kvb, (float*)out,
                                 (float*)logits, B, N, Nk, C, nh, scale, queries, blocks, st)
             : k1::attention_bf16(q, kv, kvb, out, logits, B, N, Nk, C, nh, scale, st);
}

extern "C" int k1_attention_one_pass_keys() { return k1::kOnePassKeys; }

// Bytes of dynamic shared memory of the f32 kernel at head width `hd` with `queries` a
// block; -1 for a geometry it lacks.
extern "C" int k1_attention_wg_smem(int hd, int queries) {
  return k1::attention_f32_smem(hd, queries);
}
