// K4 forward: o = softmax(q k^T * scale) v and the row logsumexp `lse` that the
// backward kernel recomputes the probabilities from.
//
// Replaces: representationlearning_tpu/ops/pallas/attention.py `_flash_fwd_kernel`
//   (:26-51, reached from `_flash_fwd_call` :95): what it computes, not its
//   256 x 256 blocking. The TPU wrapper sends shapes that are no tile multiples
//   to a plain composition; this kernel masks the tails itself and takes any
//   Nq >= 1 and Nk >= 1, D = 32 or 64, f32 or bf16.
// What bounds it on the H100: at the train step's shapes (Nq 6400 / 1600 / 400,
//   Nk 100, D 64, f32) the q read and the o write, 104 MB over the step's 12
//   launches, 0.031 ms at 3.35 TB/s; the f32 products (4.79 GFLOP) come close
//   behind: 0.029 ms as split TF32 (three TF32 products each) at 494.7 TFLOP/s,
//   0.0715 ms as f32 multiply-adds. What binds this kernel under f32 is its
//   instruction stream: a 16-row tile of 100 keys issues 672 `mma.sync` and about
//   as many again to split and load their operands (PERF.md, PR 9).
// What the design does about it:
//   * Products on the tensor cores. bf16: `mma.sync` m16n8k16, exact products,
//     f32 sums; the accumulator of q k^T is the A fragment of p v (p rounded to
//     bf16 first, as the TPU kernel's `p.astype(v.dtype)`). f32: `mma.sync`
//     m16n8k8 TF32 with split operands (3xTF32): x = big + small with big = x
//     truncated to TF32 and small the rest, and a product is small.big +
//     big.small + big.big in f32 sums, about 2^-21 relative (plain TF32, 2^-11,
//     moves a score of 8 by 1e-3). The contraction order inside an 8-wide k step
//     is free, so a lane's accumulator pair (keys 2t, 2t + 1) is its A fragment of
//     p v as it stands (k = t, t + 4) when v's B fragment takes rows 2t and
//     2t + 1; the same freedom lets q and k fragments load as float2. The tile
//     loops run to compile-time ends with no branch, so the NT score tiles (and
//     the D / 8 output tiles) are independent chains that issue back to back.
//   * A key tile that fits Nk: Nk <= 128 is one tile of Nk rounded up to 16 (9 ->
//     16, 100 -> 112) and a single-pass softmax; longer Nk runs tiles of 128 with
//     the online softmax. The tile is a function of Nk alone, so every plan sums
//     in the same order.
//   * K and V of a bh are loaded once per block and stay in shared memory
//     (`cp.async`, 16-byte pieces, zeros past Nk) while the block's warps walk its
//     16-row query tiles; each warp brings its next q tile by `cp.async` into a
//     second stage while it computes the current one. Where K and V do not fit
//     beside the q stages (f32, D 64, Nk > 256) they stream through two
//     shared-memory slots, all warps of the block a key tile at a time.
//   * A grid that fills the card: the wrapper's plan (`ops/attention.py::
//     flash_plan`) gives the warps a block (eight under f32 at the step's large
//     launches, one block an SM) and the blocks, as many as the card holds at once
//     (its occupancy). Block b takes the 16-row tiles [b T / G, (b + 1) T / G) of
//     all T = BH ceil(Nq / 16) tiles in (bh, tile) order, so blocks differ by at
//     most one tile and reload K and V only where their range crosses into the
//     next bh.
//   * The output is staged in the warp's q stage and leaves as whole rows in
//     16-byte stores; `lse` is written once per row.
//   * No float atomics: each output row is summed by one warp in a fixed order,
//     whatever the plan, so every plan and every rerun gives the same bits.
#include "common.cuh"

namespace k4 {

constexpr int kFwdMaxWarps = 8;
constexpr int kFwdLongTile = 128;  // keys a tile where Nk > 128

// ------------------------------------------------------------ warp-level pieces
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------------------------------ the layout
// Pitches in elements. f32: q and k rows at D + 8 (a float2 of lanes (g, t) at g P + 2t
// hits 32 banks in each half-warp), v rows at D + 4 (lanes (g, t) read rows 2t, 2t + 1 at
// column g: 8t + g). bf16: D + 8 everywhere, for `ldmatrix`.
template <typename T, int D>
struct Fwd {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int PQ = D + 8, PK = D + 8, PV = kF32 ? D + 4 : D + 8;
  static constexpr int kE = 16 / sizeof(T);  // elements in 16 bytes
  static constexpr int kCh = D / kE;         // 16-byte pieces a row
};

// keys a tile (a function of Nk alone), key tiles, and the K / V slots in shared
// memory: all tiles at once where they fit beside the q stages (resident), else two
inline void fwd_tiles(int Nk, int D, int bf16, int warps, int& bk, int& nkt, int& slots,
                      int& smem) {
  bk = Nk > kFwdLongTile ? kFwdLongTile : (Nk + 15) / 16 * 16;
  nkt = (Nk + bk - 1) / bk;
  const int e = bf16 ? 2 : 4;
  const int q = warps * 2 * 16 * (D + 8) * e;
  const int kv = bk * ((D + 8) + (bf16 ? D + 8 : D + 4)) * e;
  slots = q + nkt * kv <= kSmemLimit ? nkt : 2;
  smem = q + slots * kv;
}

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int BH, Nq, Nk, nqt;  // nqt: 16-row query tiles a bh
  float c;              // scale * log2(e): scores in units of log2
  int bk, nkt, slots;
};

// keys [kt bk, kt bk + bk) of one bh into slot `slot`, zeros past Nk, by the whole block
template <typename T, int D>
__device__ __forceinline__ void load_kv(const FwdArgs& p, T* Ks, T* Vs, const T* kb, const T* vb,
                                        int kt, int slot) {
  using L = Fwd<T, D>;
  const int k0 = kt * p.bk;
  T* kd = Ks + slot * p.bk * L::PK;
  T* vd = Vs + slot * p.bk * L::PV;
  for (int idx = threadIdx.x; idx < p.bk * L::kCh; idx += blockDim.x) {
    const int r = idx / L::kCh, c = (idx % L::kCh) * L::kE;
    const bool ok = k0 + r < p.Nk;
    const size_t src = (size_t)(ok ? k0 + r : 0) * D + c;
    cp_async16(kd + r * L::PK + c, kb + src, ok);
    cp_async16(vd + r * L::PV + c, vb + src, ok);
  }
}

// 16 query rows from row0 of one bh into a warp's stage, zeros past Nq
template <typename T, int D>
__device__ __forceinline__ void load_q(T* dst, const T* qb, int row0, int Nq, int lane) {
  using L = Fwd<T, D>;
#pragma unroll
  for (int idx = lane; idx < 16 * L::kCh; idx += 32) {
    const int r = idx / L::kCh, c = (idx % L::kCh) * L::kE;
    const bool ok = row0 + r < Nq;
    cp_async16(dst + r * L::PQ + c, qb + (size_t)(ok ? row0 + r : 0) * D + c, ok);
  }
}

// A warp's running state for its 16 rows: this lane holds rows g and g + 8
template <int D>
struct RowState {
  float o[D / 8][4];
  float m[2], l[2];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;
  }
};

// The softmax of one key tile, on score tiles s[j] that hold keys 8j + 2t + b (b < 2) of
// the tile, nk of them real: scale, mask, max, rescale of the running state,
// exponentials in place, running sum.
template <int D, int NT>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4], RowState<D>& st, int nk, float c,
                                             int t) {
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[j][i] = 8 * j + 2 * t + (i & 1) < nk ? s[j][i] * c : -CUDART_INF_F;
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  // every tile holds a real key, so the new max is finite
  const float mn0 = fmaxf(st.m[0], quad_max(mx0)), mn1 = fmaxf(st.m[1], quad_max(mx1));
  const float a0 = exp2_approx(st.m[0] - mn0), a1 = exp2_approx(st.m[1] - mn1);  // 0 at first
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = exp2_approx(s[j][0] - mn0);
    s[j][1] = exp2_approx(s[j][1] - mn0);
    s[j][2] = exp2_approx(s[j][2] - mn1);
    s[j][3] = exp2_approx(s[j][3] - mn1);
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
  st.l[0] = st.l[0] * a0 + quad_sum(l0);
  st.l[1] = st.l[1] * a1 + quad_sum(l1);
  st.m[0] = mn0;
  st.m[1] = mn1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    st.o[n][0] *= a0;
    st.o[n][1] *= a0;
    st.o[n][2] *= a1;
    st.o[n][3] *= a1;
  }
}

// One key tile for one 16-row query tile, f32 operands in 3xTF32. Q: the warp's stage;
// K, V: the tile's slot (8 NT rows, zeros past the tile's nk real keys).
template <int D, int NT>
__device__ __forceinline__ void tile_f32(const float* Q, const float* K, const float* V,
                                         RowState<D>& st, int nk, float c, int lane) {
  using L = Fwd<float, D>;
  const int g = lane >> 2, t = lane & 3;
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  // s = q k^T: k index t <-> d 2t, t + 4 <-> d 2t + 1 of each 8-wide step
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const float2 x0 = *reinterpret_cast<const float2*>(Q + g * L::PQ + 8 * kk + 2 * t);
    const float2 x1 = *reinterpret_cast<const float2*>(Q + (g + 8) * L::PQ + 8 * kk + 2 * t);
    uint32_t ab[4], as[4];
    split_tf32(x0.x, ab[0], as[0]);
    split_tf32(x1.x, ab[1], as[1]);
    split_tf32(x0.y, ab[2], as[2]);
    split_tf32(x1.y, ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 y = *reinterpret_cast<const float2*>(K + (8 * j + g) * L::PK + 8 * kk + 2 * t);
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(y.x, bb0, bs0);
      split_tf32(y.y, bb1, bs1);
      mma_3xtf32(s[j], ab, as, bb0, bb1, bs0, bs1);
    }
  }
  softmax_tile<D, NT>(s, st, nk, c, t);
  // o += p v: the accumulator pair of score tile j (keys 8j + 2t, 8j + 2t + 1) is the A
  // fragment (k t, t + 4); v's B fragment takes rows 8j + 2t and 8j + 2t + 1
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ab[4], as[4];
    split_tf32(s[j][0], ab[0], as[0]);
    split_tf32(s[j][2], ab[1], as[1]);
    split_tf32(s[j][1], ab[2], as[2]);
    split_tf32(s[j][3], ab[3], as[3]);
    const float* v0 = V + (8 * j + 2 * t) * L::PV + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(v0[8 * n], bb0, bs0);
      split_tf32(v0[L::PV + 8 * n], bb1, bs1);
      mma_3xtf32(st.o[n], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// One key tile for one 16-row query tile, bf16 operands
template <int D, int NT>
__device__ __forceinline__ void tile_bf16(const uint32_t (&qa)[D / 16][4], const bf16* K,
                                          const bf16* V, RowState<D>& st, int nk, float c,
                                          int lane) {
  constexpr int P = D + 8;
  const int t = lane & 3;
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t kb[D / 32][4];  // d 0-7, 8-15, 16-23, 24-31 of each 32
#pragma unroll
    for (int k2 = 0; k2 < D / 32; ++k2)
      ldsm_x4(kb[k2], K + (8 * j + (lane & 7)) * P + 32 * k2 + (lane >> 3) * 8);
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      mma_bf16(s[j], qa[k], kb[k / 2][2 * (k & 1)], kb[k / 2][2 * (k & 1) + 1]);
  }
  softmax_tile<D, NT>(s, st, nk, c, t);
  // o += p v, p rounded to bf16: score tiles 2u, 2u + 1 are the A fragment of keys 16u ..
#pragma unroll
  for (int u = 0; u < NT / 2; ++u) {
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * u][0], s[2 * u][1]);
    pa[1] = pack_bf16(s[2 * u][2], s[2 * u][3]);
    pa[2] = pack_bf16(s[2 * u + 1][0], s[2 * u + 1][1]);
    pa[3] = pack_bf16(s[2 * u + 1][2], s[2 * u + 1][3]);
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t vb[4];  // transposed: (keys 0-7 | 8-15) x (d 16 n2 .. + 7 | + 8 .. + 15)
      ldsm_x4_trans(vb, V + (16 * u + (lane & 15)) * P + 16 * n2 + (lane >> 4) * 8);
      mma_bf16(st.o[2 * n2], pa, vb[0], vb[1]);
      mma_bf16(st.o[2 * n2 + 1], pa, vb[2], vb[3]);
    }
  }
}

// o / l in the input dtype staged in the warp's stage S, then whole rows to device
// memory in 16-byte stores; lse = (m + log2 l) ln 2 once a row
template <typename T, int D>
__device__ __forceinline__ void store_rows(const FwdArgs& p, const RowState<D>& st, T* S, int bh,
                                           int row0, int lane) {
  using L = Fwd<T, D>;
  const int g = lane >> 2, t = lane & 3;
  const float i0 = 1.f / st.l[0], i1 = 1.f / st.l[1];
  __syncwarp();  // every lane is done with the q rows in S
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if constexpr (L::kF32) {
      *reinterpret_cast<float2*>(S + g * L::PQ + c) = make_float2(st.o[n][0] * i0, st.o[n][1] * i0);
      *reinterpret_cast<float2*>(S + (g + 8) * L::PQ + c) =
          make_float2(st.o[n][2] * i1, st.o[n][3] * i1);
    } else {
      *reinterpret_cast<uint32_t*>(S + g * L::PQ + c) = pack_bf16(st.o[n][0] * i0, st.o[n][1] * i0);
      *reinterpret_cast<uint32_t*>(S + (g + 8) * L::PQ + c) =
          pack_bf16(st.o[n][2] * i1, st.o[n][3] * i1);
    }
  }
  __syncwarp();
  T* ob = reinterpret_cast<T*>(p.o) + ((size_t)bh * p.Nq + row0) * D;
#pragma unroll
  for (int idx = lane; idx < 16 * L::kCh; idx += 32) {
    const int r = idx / L::kCh, c = (idx % L::kCh) * L::kE;
    if (row0 + r < p.Nq)
      *reinterpret_cast<uint4*>(ob + (size_t)r * D + c) =
          *reinterpret_cast<const uint4*>(S + r * L::PQ + c);
  }
  if (t == 0) {
    float* lb = p.lse + (size_t)bh * p.Nq + row0;
    if (row0 + g < p.Nq) lb[g] = (st.m[0] + log2f(st.l[0])) * 0.6931471805599453f;
    if (row0 + g + 8 < p.Nq) lb[g + 8] = (st.m[1] + log2f(st.l[1])) * 0.6931471805599453f;
  }
  __syncwarp();  // S may take the next q tile
}

// one key tile (slot `slot`, keys kt bk ..) against the warp's q tile in stage Q
template <typename T, int D, int NT>
__device__ __forceinline__ void key_tile(const FwdArgs& p, const T* Q, const T* Ks, const T* Vs,
                                         RowState<D>& st, int kt, int slot, int lane) {
  using L = Fwd<T, D>;
  const int nk = min(p.bk, p.Nk - kt * p.bk);
  const T* K = Ks + slot * p.bk * L::PK;
  const T* V = Vs + slot * p.bk * L::PV;
  if constexpr (L::kF32) {
    tile_f32<D, NT>(Q, K, V, st, nk, p.c, lane);
  } else {
    uint32_t qa[D / 16][4];
    a_frags_bf16<D>(qa, Q, D + 8, lane);
    tile_bf16<D, NT>(qa, K, V, st, nk, p.c, lane);
  }
}

// NT: score tiles of 8 keys a warp holds, the key tile bk / 8
template <typename T, int D, int NT>
__global__ void __launch_bounds__(32 * kFwdMaxWarps)
flash_fwd_kernel(const FwdArgs p) {
  using L = Fwd<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* Qw = reinterpret_cast<T*>(smem_raw) + warp * 2 * 16 * L::PQ;  // this warp's two stages
  T* Ks = reinterpret_cast<T*>(smem_raw) + warps * 2 * 16 * L::PQ;
  T* Vs = Ks + p.slots * p.bk * L::PK;
  const bool resident = p.slots == p.nkt;
  const long long total = (long long)p.BH * p.nqt;
  const long long first = total * blockIdx.x / gridDim.x;
  const long long last = total * (blockIdx.x + 1) / gridDim.x;

  for (long long s0 = first; s0 < last;) {  // one segment of tiles a bh
    const int bh = (int)(s0 / p.nqt);
    const long long s1 = min(last, (long long)(bh + 1) * p.nqt);
    const int t0 = (int)(s0 - (long long)bh * p.nqt), n = (int)(s1 - s0);
    s0 = s1;
    const T* qb = reinterpret_cast<const T*>(p.q) + (size_t)bh * p.Nq * D;
    const T* kb = reinterpret_cast<const T*>(p.k) + (size_t)bh * p.Nk * D;
    const T* vb = reinterpret_cast<const T*>(p.v) + (size_t)bh * p.Nk * D;
    __syncthreads();  // the last segment's readers of K, V and the q stages are done

    if (resident) {
      // all key tiles once; then each warp walks its tiles on its own, the next q tile
      // arriving in the other stage while this one computes
      for (int kt = 0; kt < p.nkt; ++kt) load_kv<T, D>(p, Ks, Vs, kb, vb, kt, kt);
      if (warp < n) load_q<T, D>(Qw, qb, 16 * (t0 + warp), p.Nq, lane);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      int it = 0;
      for (int i = warp; i < n; i += warps, ++it) {
        T* S = Qw + (it & 1) * 16 * L::PQ;
        if (i + warps < n)
          load_q<T, D>(Qw + ((it + 1) & 1) * 16 * L::PQ, qb, 16 * (t0 + i + warps), p.Nq, lane);
        cp_async_commit();
        cp_async_wait<1>();
        __syncwarp();
        RowState<D> st;
        st.init();
        for (int kt = 0; kt < p.nkt; ++kt) key_tile<T, D, NT>(p, S, Ks, Vs, st, kt, kt, lane);
        store_rows<T, D>(p, st, S, bh, 16 * (t0 + i), lane);
      }
      cp_async_wait<0>();
    } else {
      // K and V stream through two slots, the whole block a key tile at a time
      for (int pass = 0; pass * warps < n; ++pass) {
        const int i = pass * warps + warp;
        const bool mine = i < n;
        if (mine) load_q<T, D>(Qw, qb, 16 * (t0 + i), p.Nq, lane);
        load_kv<T, D>(p, Ks, Vs, kb, vb, 0, 0);
        cp_async_commit();
        RowState<D> st;
        st.init();
        for (int kt = 0; kt < p.nkt; ++kt) {
          if (kt + 1 < p.nkt) load_kv<T, D>(p, Ks, Vs, kb, vb, kt + 1, (kt + 1) & 1);
          cp_async_commit();
          cp_async_wait<1>();
          __syncthreads();  // tile kt (and the q tile) have landed for every thread
          if (mine) key_tile<T, D, NT>(p, Qw, Ks, Vs, st, kt, kt & 1, lane);
          __syncthreads();  // slot kt & 1 may take tile kt + 2
        }
        cp_async_wait<0>();
        if (mine) store_rows<T, D>(p, st, Qw, bh, 16 * (t0 + i), lane);
      }
    }
  }
}

template <typename T, int D, int NT>
struct FwdKernel {
  static constexpr auto kernel = flash_fwd_kernel<T, D, NT>;

  // the shared-memory grant, once per instantiation: the largest a block may ask for
  static cudaError_t prepare() {
    static const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    return err;
  }

  static cudaError_t launch(const FwdArgs& p, int warps, int blocks, int smem, cudaStream_t st) {
    const cudaError_t err = prepare();
    if (err != cudaSuccess) return err;
    kernel<<<blocks, 32 * warps, smem, st>>>(p);
    return cudaGetLastError();
  }

  static int blocks_per_sm(int warps, int smem) {
    int n = -1;
    if (prepare() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 32 * warps, smem) != cudaSuccess)
      return -1;
    return n;
  }
};

// calls f with the instantiation for the dtype, D and the key tile bk (16 ... 128)
template <typename T, int D, class F>
cudaError_t with_nt(int bk, F&& f) {
  switch (bk) {
    case 16: return f(FwdKernel<T, D, 2>());
    case 32: return f(FwdKernel<T, D, 4>());
    case 48: return f(FwdKernel<T, D, 6>());
    case 64: return f(FwdKernel<T, D, 8>());
    case 80: return f(FwdKernel<T, D, 10>());
    case 96: return f(FwdKernel<T, D, 12>());
    case 112: return f(FwdKernel<T, D, 14>());
  }
  return f(FwdKernel<T, D, 16>());
}
template <class F>
cudaError_t dispatch(int D, int bf16, int bk, F&& f) {
  if (D == 64) return bf16 ? with_nt<k4::bf16, 64>(bk, f) : with_nt<float, 64>(bk, f);
  return bf16 ? with_nt<k4::bf16, 32>(bk, f) : with_nt<float, 32>(bk, f);
}

inline bool fwd_takes(int Nk, int D, int warps) {
  return Nk >= 1 && (D == 32 || D == 64) && warps >= 1 && warps <= kFwdMaxWarps;
}

}  // namespace k4

// o (BH, Nq, D) in the input dtype and lse (BH, Nq) f32 from q (BH, Nq, D) and
// k, v (BH, Nk, D), all contiguous and 16-byte aligned, f32 or (is_bf16) bf16. D is
// 32 or 64. The plan: `warps` a block (1-8) and `blocks`, the grid.
extern "C" int k4_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int BH, int Nq, int Nk, int D, float scale, int is_bf16, int warps,
                            int blocks, void* stream) {
  using namespace k4;
  if (BH < 1 || BH > 65535 || Nq < 1 || blocks < 1 || !fwd_takes(Nk, D, warps))
    return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  FwdArgs p{q, k, v, o, (float*)lse, BH, Nq, Nk, (Nq + 15) / 16,
            scale * kLog2e, 0, 0, 0};
  int smem = 0;
  fwd_tiles(Nk, D, is_bf16, warps, p.bk, p.nkt, p.slots, smem);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  return (int)dispatch(D, is_bf16, p.bk, [&](auto kf) {
    return decltype(kf)::launch(p, warps, blocks, smem, (cudaStream_t)stream);
  });
}

// Blocks of `warps` warps one SM holds at once for that shape, as the card reports it;
// -1 for what the kernel does not take.
extern "C" int k4_flash_fwd_blocks_per_sm(int Nk, int D, int is_bf16, int warps) {
  using namespace k4;
  if (!fwd_takes(Nk, D, warps)) return -1;
  int bk, nkt, slots, smem;
  fwd_tiles(Nk, D, is_bf16, warps, bk, nkt, slots, smem);
  if (smem > kSmemLimit) return -1;
  int n = -1;
  dispatch(D, is_bf16, bk, [&](auto kf) {
    n = decltype(kf)::blocks_per_sm(warps, smem);
    return cudaSuccess;
  });
  return n;
}
