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
//   (:141-142). Thread blocks here run side by side, so a bh's query tiles are
//   cut into a few runs (shares), each block keeps the dk / dv of its run in
//   registers and writes them once, and a second small kernel adds the shares
//   in share order. No atomics: two runs on the same inputs give the same bits.
// What bounds it on the H100: at the train step's shapes (Nq 6400 / 1600 / 400,
//   Nk 100, D 64, f32) its five products, 10 BH Nq Nk D operations: as split
//   TF32 (three TF32 products each) at 494.7 TFLOP/s they take longer than the
//   reads of q, o, do and the write of dq at 3.35 TB/s. `mma.sync` reaches 268 of
//   those TFLOP/s on the card (tools/time_mma_sync.py); this kernel issues its
//   products at under half that rate, its warps stalling on their own chains.
// What the design does about it:
//   * All five products on the tensor cores (`mma.sync`): bf16 m16n8k16 with f32
//     sums, or f32 operands as 3xTF32 m16n8k8 with the forward's truncating splits
//     (common.cuh), which holds f32 accuracy.
//   * Keys split across warps (the form of FlashAttention-2's backward): a block
//     holds the K and V of one bh's key tile (Nk rounded up to 16, at most 128
//     keys; longer Nk is cut into tiles of 128, each its own block) in shared
//     memory, and warp w owns keys 16w .. 16w + 15. For each query tile of `BQ`
//     rows it computes s^T = K_w q^T and dp^T = V_w do^T with K and V as the A
//     operand, so p^T and ds^T come out with keys as rows: the accumulator pair of
//     a lane (queries 2t, 2t + 1 of an 8-wide tile) is its A fragment of
//     dv += p^T do and dk += ds^T q as it stands (k = t, t + 4), when the B
//     fragment takes query rows 2t and 2t + 1. dk and dv stay in registers for the
//     block's whole run of query tiles.
//   * dq = ds k sums over the keys of every warp: ds goes to shared memory once a
//     query tile, and each warp takes 16-row strips of the tile's dq.
//   * Enough independent products a warp to cover the latency of `mma.sync`: the two
//     products with the same A or B operand run side by side (s and dp, dv and dk: 16
//     accumulator chains), a dq strip is D / 8 chains. An SM holds one block of 7 warps at
//     the step's shapes (shared memory), too few to hide one warp's stalls behind another's.
//   * q, do, o and lse of the next query tile arrive by `cp.async` into a second
//     stage while the block computes the current one; delta is summed from the
//     staged do and o, four lanes a row.
//   * A persistent plan (`ops/attention.py::bwd_plan`): `BQ` rows a tile and
//     `shares` runs of tiles a (bh, key tile), as many blocks as the card holds at
//     once. A bh then has a few dk / dv shares, not one a query tile.
//   * Pitches that make every fragment load free of bank conflicts. f32: rows of
//     D + 4 words, so lanes (g, t) reading (row g, column t) hit 4g + t and lanes
//     reading (row 2t, column g) hit 8t + g; the ds tile at bk + 8 words (float2
//     reads at (row g, column 2t)). bf16: rows of D + 8 for `ldmatrix`.
//   * The sums of a share run in a fixed order, and so does the sum over the
//     shares: a rerun gives the same bits. Plans that cut a bh's queries at the same
//     points give the same bits; one share gives the same bits at every tile height.
#include "common.cuh"

namespace k4 {

constexpr int kBwdKeys = 128;  // keys a block holds at most: 8 warps of 16

// keys a tile, a function of Nk alone (as the forward's)
inline int bwd_key_tile(int Nk) { return Nk > kBwdKeys ? kBwdKeys : (Nk + 15) / 16 * 16; }

// K and V (bk rows each), two stages of q, do and o (BQ rows each) at pitch P, the ds
// tile (BQ x (bk + 8)), two stages of lse and delta
inline int bwd_smem_bytes(int bk, int D, int bf16, int rows) {
  const int e = bf16 ? 2 : 4, P = bf16 ? D + 8 : D + 4;
  return e * (2 * bk * P + 6 * rows * P + rows * (bk + 8)) + 4 * 3 * rows;
}

template <typename T, int D>
struct BwdLayout {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int P = kF32 ? D + 4 : D + 8;
  static constexpr int kE = 16 / sizeof(T);  // elements in 16 bytes
  static constexpr int kCh = D / kE;         // 16-byte pieces a row
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  void* dq;
  void* dk;
  void* dv;
  float* ws_kv;  // (2, BH, shares, Nk, D): the dk and dv shares, where shares > 1
  float* ws_q;   // (BH, nkc, Nq, D): the dq shares of the key tiles, where nkc > 1
  int BH, Nq, Nk, nqt, bk, nkc, shares;
  float scale, c;  // c = scale * log2(e): scores in units of log2
};

// ----------------------------------------------------------- f32, 3xTF32 products
// The warp's two products of a tile side by side, 16 independent accumulator chains:
// s = Ka Qb^T and dp = Va dOb^T over D, Ka / Va the warp's 16 key rows, Qb / dOb the query
// tile; k index t <-> column t, t + 4 <-> column t + 4 of each 8-wide step
template <int D, int NJ>
__device__ __forceinline__ void scores_f32(float (&s)[NJ][4], float (&dp)[NJ][4],
                                           const float* Ka, const float* Va, const float* Qb,
                                           const float* dOb, int lane) {
  constexpr int P = D + 4;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int o = g * P + 8 * kk + t;
    uint32_t kb[4], ks[4], vb[4], vs[4];
    split_tf32(Ka[o], kb[0], ks[0]);
    split_tf32(Ka[o + 8 * P], kb[1], ks[1]);
    split_tf32(Ka[o + 4], kb[2], ks[2]);
    split_tf32(Ka[o + 8 * P + 4], kb[3], ks[3]);
    split_tf32(Va[o], vb[0], vs[0]);
    split_tf32(Va[o + 8 * P], vb[1], vs[1]);
    split_tf32(Va[o + 4], vb[2], vs[2]);
    split_tf32(Va[o + 8 * P + 4], vb[3], vs[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int ob = 8 * j * P + o;
      uint32_t qb0, qs0, qb1, qs1, db0, ds0, db1, ds1;
      split_tf32(Qb[ob], qb0, qs0);
      split_tf32(Qb[ob + 4], qb1, qs1);
      split_tf32(dOb[ob], db0, ds0);
      split_tf32(dOb[ob + 4], db1, ds1);
      mma_3xtf32(s[j], kb, ks, qb0, qb1, qs0, qs1);
      mma_3xtf32(dp[j], vb, vs, db0, db1, ds0, ds1);
    }
  }
}

// dv (16 keys x D) += p dOb and dk += ds Qb, side by side: p and ds are 16 keys x 8 NJ
// queries in accumulator layout, whose pair (queries 2t, 2t + 1) is the A fragment (k t,
// t + 4) when the B fragment takes query rows 2t and 2t + 1
template <int D, int NJ>
__device__ __forceinline__ void accumulate_f32(float (&dv)[D / 8][4], float (&dk)[D / 8][4],
                                               const float (&p)[NJ][4], const float (&ds)[NJ][4],
                                               const float* dOb, const float* Qb, int lane) {
  constexpr int P = D + 4;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t pb[4], ps[4], sb[4], ss[4];
    split_tf32(p[j][0], pb[0], ps[0]);
    split_tf32(p[j][2], pb[1], ps[1]);
    split_tf32(p[j][1], pb[2], ps[2]);
    split_tf32(p[j][3], pb[3], ps[3]);
    split_tf32(ds[j][0], sb[0], ss[0]);
    split_tf32(ds[j][2], sb[1], ss[1]);
    split_tf32(ds[j][1], sb[2], ss[2]);
    split_tf32(ds[j][3], sb[3], ss[3]);
    const int o = (8 * j + 2 * t) * P + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t db0, ds0, db1, ds1, qb0, qs0, qb1, qs1;
      split_tf32(dOb[o + 8 * n], db0, ds0);
      split_tf32(dOb[o + P + 8 * n], db1, ds1);
      split_tf32(Qb[o + 8 * n], qb0, qs0);
      split_tf32(Qb[o + P + 8 * n], qb1, qs1);
      mma_3xtf32(dv[n], pb, ps, db0, db1, ds0, ds1);
      mma_3xtf32(dk[n], sb, ss, qb0, qb1, qs0, qs1);
    }
  }
}

// ----------------------------------------------------------------- bf16 products
// s = Ka Qb^T and dp = Va dOb^T with the A fragments (the warp's 16 key rows) in registers
template <int D, int NJ>
__device__ __forceinline__ void scores_bf16(float (&s)[NJ][4], float (&dp)[NJ][4],
                                            const uint32_t (&ka)[D / 16][4],
                                            const uint32_t (&va)[D / 16][4], const bf16* Qb,
                                            const bf16* dOb, int lane) {
  constexpr int P = D + 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t qf[D / 32][4], df[D / 32][4];  // d 0-7, 8-15, 16-23, 24-31 of each 32
#pragma unroll
    for (int k2 = 0; k2 < D / 32; ++k2) {
      const int o = (8 * j + (lane & 7)) * P + 32 * k2 + (lane >> 3) * 8;
      ldsm_x4(qf[k2], Qb + o);
      ldsm_x4(df[k2], dOb + o);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      mma_bf16(s[j], ka[k], qf[k / 2][2 * (k & 1)], qf[k / 2][2 * (k & 1) + 1]);
      mma_bf16(dp[j], va[k], df[k / 2][2 * (k & 1)], df[k / 2][2 * (k & 1) + 1]);
    }
  }
}

// the A fragment of keys x queries 16u .. 16u + 15 from accumulator tiles 2u, 2u + 1,
// rounded to bf16
template <int NJ>
__device__ __forceinline__ void pack_a_bf16(uint32_t (&a)[4], const float (&x)[NJ][4], int u) {
  a[0] = pack_bf16(x[2 * u][0], x[2 * u][1]);
  a[1] = pack_bf16(x[2 * u][2], x[2 * u][3]);
  a[2] = pack_bf16(x[2 * u + 1][0], x[2 * u + 1][1]);
  a[3] = pack_bf16(x[2 * u + 1][2], x[2 * u + 1][3]);
}

// dv += p dOb and dk += ds Qb, p and ds rounded to bf16
template <int D, int NJ>
__device__ __forceinline__ void accumulate_bf16(float (&dv)[D / 8][4], float (&dk)[D / 8][4],
                                                const float (&p)[NJ][4], const float (&ds)[NJ][4],
                                                const bf16* dOb, const bf16* Qb, int lane) {
  constexpr int P = D + 8;
#pragma unroll
  for (int u = 0; u < NJ / 2; ++u) {
    uint32_t pa[4], sa[4];
    pack_a_bf16<NJ>(pa, p, u);
    pack_a_bf16<NJ>(sa, ds, u);
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      // transposed: (queries 0-7 | 8-15) x (d 16 n2 .. + 7 | + 8 .. + 15)
      const int o = (16 * u + (lane & 15)) * P + 16 * n2 + (lane >> 4) * 8;
      uint32_t df[4], qf[4];
      ldsm_x4_trans(df, dOb + o);
      ldsm_x4_trans(qf, Qb + o);
      mma_bf16(dv[2 * n2], pa, df[0], df[1]);
      mma_bf16(dv[2 * n2 + 1], pa, df[2], df[3]);
      mma_bf16(dk[2 * n2], sa, qf[0], qf[1]);
      mma_bf16(dk[2 * n2 + 1], sa, qf[2], qf[3]);
    }
  }
}

// ------------------------------------------------------------------ stores
template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}

// dq of the tile's rows q0 .. q0 + BQ - 1 = scale ds K over the block's nk keys, a strip of
// 16 rows x D a warp (D / 8 independent chains, each A fragment used D / 8 times); into dq
// where the keys are one tile, else into the key tile's dq share
template <typename T, int D, int BQ>
__device__ __forceinline__ void dq_tile(const BwdArgs& p, const T* dS, int PS, const T* K,
                                        int nk, int q0, int bh, int kc, int warp, int warps,
                                        int lane) {
  using L = BwdLayout<T, D>;
  constexpr int P = L::P;
  const int g = lane >> 2, t = lane & 3;
  for (int m = warp; m < BQ / 16; m += warps) {
    float acc[D / 8][4] = {};
    if constexpr (L::kF32) {
      // A: ds rows g, g + 8, keys 2t, 2t + 1 of each 8 (k t, t + 4); B: K rows 2t, 2t + 1
      const float* a = dS + (16 * m + g) * PS + 2 * t;
      const float* b = K + 2 * t * P + g;
      for (int s8 = 0; s8 < (nk + 7) / 8; ++s8) {  // ds and K are zero past nk
        const float2 x0 = *reinterpret_cast<const float2*>(a + 8 * s8);
        const float2 x1 = *reinterpret_cast<const float2*>(a + 8 * PS + 8 * s8);
        uint32_t ab[4], as[4];
        split_tf32(x0.x, ab[0], as[0]);
        split_tf32(x1.x, ab[1], as[1]);
        split_tf32(x0.y, ab[2], as[2]);
        split_tf32(x1.y, ab[3], as[3]);
        const float* bs = b + 8 * s8 * P;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(bs[8 * n], bb0, bs0);
          split_tf32(bs[P + 8 * n], bb1, bs1);
          mma_3xtf32(acc[n], ab, as, bb0, bb1, bs0, bs1);
        }
      }
    } else {
      for (int s16 = 0; s16 < (nk + 15) / 16; ++s16) {
        uint32_t a[4];
        ldsm_x4(a, dS + (16 * m + (lane & 7) + ((lane >> 3) & 1) * 8) * PS + 16 * s16 +
                       (lane >> 4) * 8);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t b[4];
          ldsm_x4_trans(b, K + (16 * s16 + (lane & 15)) * P + 16 * n2 + (lane >> 4) * 8);
          mma_bf16(acc[2 * n2], a, b[0], b[1]);
          mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + 16 * m + g + 8 * half;
      if (row >= p.Nq) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = 8 * n + 2 * t;
        const float v0 = p.scale * acc[n][2 * half], v1 = p.scale * acc[n][2 * half + 1];
        if (p.nkc == 1)
          store2<T>(reinterpret_cast<T*>(p.dq) + ((size_t)bh * p.Nq + row) * D + col, v0, v1);
        else
          store2<float>(p.ws_q + (((size_t)bh * p.nkc + kc) * p.Nq + row) * D + col, v0, v1);
      }
    }
  }
}

// -------------------------------------------------------------------- the kernel
// Block (s, kc, bh): key tile kc of bh, query tiles [nqt s / shares, nqt (s + 1) / shares);
// bk / 16 warps.
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(32 * kBwdKeys / 16) flash_bwd_kernel(const BwdArgs p) {
  using L = BwdLayout<T, D>;
  constexpr int P = L::P, NJ = BQ / 8, NN = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int s = blockIdx.x, kc = blockIdx.y, bh = blockIdx.z;
  const int k0 = kc * p.bk, nk = min(p.bk, p.Nk - k0);
  const int PS = p.bk + 8;  // pitch of the ds tile
  const int t0 = (int)((long long)p.nqt * s / p.shares);
  const int t1 = (int)((long long)p.nqt * (s + 1) / p.shares);
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + p.bk * P;
  T* St = Vs + p.bk * P;  // two stages of (q, do, o)
  T* dSs = St + 6 * BQ * P;
  float* lse_s = reinterpret_cast<float*>(dSs + BQ * PS);  // two stages
  float* delta_s = lse_s + 2 * BQ;

  const size_t qoff = (size_t)bh * p.Nq * D, koff = ((size_t)bh * p.Nk + k0) * D;
  const T* qb = reinterpret_cast<const T*>(p.q) + qoff;
  const T* db = reinterpret_cast<const T*>(p.dout) + qoff;
  const T* ob = reinterpret_cast<const T*>(p.o) + qoff;
  const float* lb = p.lse + (size_t)bh * p.Nq;

  // K and V of the key tile, zeros past its nk keys
  {
    const T* kb = reinterpret_cast<const T*>(p.k) + koff;
    const T* vb = reinterpret_cast<const T*>(p.v) + koff;
    for (int idx = threadIdx.x; idx < p.bk * L::kCh; idx += blockDim.x) {
      const int r = idx / L::kCh, c = (idx % L::kCh) * L::kE;
      const bool ok = r < nk;
      const size_t src = (size_t)(ok ? r : 0) * D + c;
      cp_async16(Ks + r * P + c, kb + src, ok);
      cp_async16(Vs + r * P + c, vb + src, ok);
    }
  }
  // q, do, o and lse of query tile `tile` into stage `stage`, zeros past Nq
  auto load_tile = [&](int tile, int stage) {
    T* Qd = St + stage * 3 * BQ * P;
    T* Dd = Qd + BQ * P;
    T* Od = Dd + BQ * P;
    const int q0 = tile * BQ;
    for (int idx = threadIdx.x; idx < BQ * L::kCh; idx += blockDim.x) {
      const int r = idx / L::kCh, c = (idx % L::kCh) * L::kE;
      const bool ok = q0 + r < p.Nq;
      const size_t src = (size_t)(ok ? q0 + r : 0) * D + c;
      cp_async16(Qd + r * P + c, qb + src, ok);
      cp_async16(Dd + r * P + c, db + src, ok);
      cp_async16(Od + r * P + c, ob + src, ok);
    }
    for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
      const bool ok = q0 + r < p.Nq;
      cp_async4(lse_s + stage * BQ + r, lb + (ok ? q0 + r : 0), ok);
    }
  };
  load_tile(t0, 0);
  cp_async_commit();

  const int kw = 16 * warp;  // this warp's keys in the tile
  const bool key_ok0 = kw + g < nk, key_ok1 = kw + g + 8 < nk;
  float dk[NN][4], dv[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;
  [[maybe_unused]] uint32_t ka[D / 16][4], va[D / 16][4];  // bf16: K_w and V_w fragments

  for (int tile = t0, i = 0; tile < t1; ++tile, ++i) {
    const int stage = i & 1;
    if (tile + 1 < t1) load_tile(tile + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile (and K, V) have landed; the last tile's dq readers are done
    const T* Qs = St + stage * 3 * BQ * P;
    const T* dOs = Qs + BQ * P;
    const T* Os = dOs + BQ * P;
    const float* lse_t = lse_s + stage * BQ;
    if constexpr (!L::kF32) {
      if (i == 0) {  // once a block
        a_frags_bf16<D>(ka, Ks + kw * P, P, lane);
        a_frags_bf16<D>(va, Vs + kw * P, P, lane);
      }
    }
    // delta = rowsum(do * o), eight rows a warp at a time, four lanes a row
    for (int r0 = 8 * warp; r0 < BQ; r0 += 8 * warps) {
      const int r = r0 + g;
      float a = 0.f;
#pragma unroll
      for (int d = t; d < D; d += 4) a += to_float(dOs[r * P + d]) * to_float(Os[r * P + d]);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      if (t == 0) delta_s[r] = a;
    }
    __syncthreads();

    float sT[NJ][4], dpT[NJ][4];  // s^T and dp^T: rows the warp's keys, columns queries
    if constexpr (L::kF32)
      scores_f32<D, NJ>(sT, dpT, Ks + kw * P, Vs + kw * P, Qs, dOs, lane);
    else
      scores_bf16<D, NJ>(sT, dpT, ka, va, Qs, dOs, lane);
    // p^T = exp(s^T scale - lse) (zero past the keys), ds^T = p^T (dp^T - delta), both
    // rounded to the input dtype; ds into the shared tile as [query][key]
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1);
        const bool ok = (e & 2) ? key_ok1 : key_ok0;
        const float pv = ok ? exp2_approx(fmaf(sT[j][e], p.c, -lse_t[qi] * kLog2e)) : 0.f;
        const float ds = pv * (dpT[j][e] - delta_s[qi]);
        sT[j][e] = round_to<T>(pv);
        dpT[j][e] = round_to<T>(ds);
        dSs[qi * PS + kw + g + 8 * (e >> 1)] = from_float<T>(ds);
      }
    }
    if constexpr (L::kF32)
      accumulate_f32<D, NJ>(dv, dk, sT, dpT, dOs, Qs, lane);
    else
      accumulate_bf16<D, NJ>(dv, dk, sT, dpT, dOs, Qs, lane);
    __syncthreads();  // the ds tile is whole; this stage's readers are done
    dq_tile<T, D, BQ>(p, dSs, PS, Ks, nk, tile * BQ, bh, kc, warp, warps, lane);
  }
  cp_async_wait<0>();

  // dk = scale sum ds^T q and dv = sum p^T do of the run: keys kw + g (+ 8), columns
  // 8n + 2t (+ 1); into dk and dv where the bh has one share, else into this share
  const size_t per = (size_t)p.Nk * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = kw + g + 8 * half;
    if (key >= nk) continue;
    const size_t row = (size_t)(k0 + key) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const float k_a = p.scale * dk[n][2 * half], k_b = p.scale * dk[n][2 * half + 1];
      const float v_a = dv[n][2 * half], v_b = dv[n][2 * half + 1];
      if (p.shares == 1) {
        store2<T>(reinterpret_cast<T*>(p.dk) + bh * per + row + 8 * n, k_a, k_b);
        store2<T>(reinterpret_cast<T*>(p.dv) + bh * per + row + 8 * n, v_a, v_b);
      } else {
        float* wk = p.ws_kv + ((size_t)bh * p.shares + s) * per + row + 8 * n;
        store2<float>(wk, k_a, k_b);
        store2<float>(wk + (size_t)p.BH * p.shares * per, v_a, v_b);
      }
    }
  }
}

// out_a[bh][e] = the sum over the shares c = 0, 1, ... (in that order) of ws[a][bh][c][e],
// for a < 2 where out1 is given, else a = 0; four elements a thread
template <typename T>
__global__ void sum_shares_kernel(const float* __restrict__ ws, T* __restrict__ out0,
                                  T* __restrict__ out1, int BH, int n, long long per4) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long each = (long long)BH * per4;
  if (idx >= (out1 ? 2 : 1) * each) return;
  const int a = idx >= each ? 1 : 0;
  const long long r = idx - a * each, bh = r / per4, e = r % per4;
  const float4* src = reinterpret_cast<const float4*>(ws) + ((a * BH + bh) * n) * per4 + e;
  float4 acc = src[0];
  for (int c = 1; c < n; ++c) {
    const float4 x = src[(long long)c * per4];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  T* out = (a ? out1 : out0) + 4 * r;
  store2<T>(out, acc.x, acc.y);
  store2<T>(out + 2, acc.z, acc.w);
}

template <typename T>
cudaError_t sum_shares(const float* ws, void* out0, void* out1, int BH, int n, size_t per,
                       cudaStream_t st) {
  const long long per4 = (long long)(per / 4), count = (out1 ? 2 : 1) * (long long)BH * per4;
  sum_shares_kernel<T><<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      ws, reinterpret_cast<T*>(out0), reinterpret_cast<T*>(out1), BH, n, per4);
  return cudaGetLastError();
}

template <typename T, int D, int BQ>
struct BwdKernel {
  using Type = T;
  static constexpr auto kernel = flash_bwd_kernel<T, D, BQ>;

  // the shared-memory grant, once per instantiation: the largest a block may ask for
  static cudaError_t prepare() {
    static const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    return err;
  }

  static cudaError_t launch(const BwdArgs& p, int smem, cudaStream_t st) {
    const cudaError_t err = prepare();
    if (err != cudaSuccess) return err;
    kernel<<<dim3(p.shares, p.nkc, p.BH), 32 * (p.bk / 16), smem, st>>>(p);
    return cudaGetLastError();
  }

  static int blocks_per_sm(int bk, int smem) {
    int n = -1;
    if (prepare() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 32 * (bk / 16), smem) !=
            cudaSuccess)
      return -1;
    return n;
  }
};

// calls f with the instantiation for the dtype, D and the query tile (16, 32 or 64 rows)
template <typename T, int D, class F>
cudaError_t bwd_with_rows(int rows, F&& f) {
  if (rows == 16) return f(BwdKernel<T, D, 16>());
  if (rows == 32) return f(BwdKernel<T, D, 32>());
  return f(BwdKernel<T, D, 64>());
}
template <class F>
cudaError_t bwd_dispatch(int D, int bf16, int rows, F&& f) {
  if (D == 64) return bf16 ? bwd_with_rows<k4::bf16, 64>(rows, f) : bwd_with_rows<float, 64>(rows, f);
  return bf16 ? bwd_with_rows<k4::bf16, 32>(rows, f) : bwd_with_rows<float, 32>(rows, f);
}

inline bool bwd_takes(int Nk, int D, int rows) {
  return Nk >= 1 && (D == 32 || D == 64) && (rows == 16 || rows == 32 || rows == 64);
}

}  // namespace k4

// dq (BH, Nq, D), dk, dv (BH, Nk, D) in the input dtype, from q, o, do (BH, Nq, D), k, v
// (BH, Nk, D), all contiguous and 16-byte aligned, f32 or (is_bf16) bf16, and lse (BH, Nq)
// f32. D is 32 or 64. The plan: `rows` a query tile (16, 32 or 64) and `shares` runs of
// query tiles a (bh, key tile), 1 <= shares <= ceil(Nq / rows). ws (16-byte aligned, no
// initial value) holds 2 BH shares Nk D floats where shares > 1, then BH ceil(Nk / 128)
// Nq D floats where Nk > 128.
extern "C" int k4_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* dq, void* dk, void* dv,
                            void* ws, int BH, int Nq, int Nk, int D, float scale, int is_bf16,
                            int rows, int shares, void* stream) {
  using namespace k4;
  if (BH < 1 || BH > 65535 || Nq < 1 || !bwd_takes(Nk, D, rows)) return (int)cudaErrorInvalidValue;
  const int nqt = (Nq + rows - 1) / rows;
  if (shares < 1 || shares > nqt) return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
        reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
        reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
        reinterpret_cast<uintptr_t>(ws)) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  BwdArgs p{q, k, v, o, dout, (const float*)lse, dq, dk, dv, nullptr, nullptr,
            BH, Nq, Nk, nqt, bwd_key_tile(Nk), 0, shares, scale, scale * kLog2e};
  p.nkc = (Nk + p.bk - 1) / p.bk;
  if (p.nkc > 65535) return (int)cudaErrorInvalidValue;
  const size_t kv_floats = shares > 1 ? 2 * (size_t)BH * shares * Nk * D : 0;
  p.ws_kv = (float*)ws;
  p.ws_q = (float*)ws + kv_floats;
  const int smem = bwd_smem_bytes(p.bk, D, is_bf16, rows);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)bwd_dispatch(D, is_bf16, rows, [&](auto kf) {
    using K = decltype(kf);
    using T = typename K::Type;
    cudaError_t err = K::launch(p, smem, st);
    if (err == cudaSuccess && shares > 1)
      err = sum_shares<T>(p.ws_kv, dk, dv, BH, shares, (size_t)Nk * D, st);
    if (err == cudaSuccess && p.nkc > 1)
      err = sum_shares<T>(p.ws_q, dq, nullptr, BH, p.nkc, (size_t)Nq * D, st);
    return err;
  });
}

// Blocks one SM holds at once for that shape and query tile, as the card reports it;
// -1 for what the kernel does not take.
extern "C" int k4_flash_bwd_blocks_per_sm(int Nk, int D, int is_bf16, int rows) {
  using namespace k4;
  if (!bwd_takes(Nk, D, rows)) return -1;
  const int bk = bwd_key_tile(Nk), smem = bwd_smem_bytes(bk, D, is_bf16, rows);
  if (smem > kSmemLimit) return -1;
  int n = -1;
  bwd_dispatch(D, is_bf16, rows, [&](auto kf) {
    n = decltype(kf)::blocks_per_sm(bk, smem);
    return cudaSuccess;
  });
  return n;
}
