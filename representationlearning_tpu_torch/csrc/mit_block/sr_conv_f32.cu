// K1 `sr_conv` with f32 operands, `sr_conv_wg_kernel`, built beside sr_conv.cu (which holds
// the bf16 kernel and the C entry point). Replaces what sr_conv.cu's note says; what bounds
// it and its design are noted below.
#include "../hopper/wgmma.cuh"
#include "common.cuh"

namespace k1 {

// ---- the sr conv with f32 operands: 3xTF32 `wgmma` (sm_90a), csrc/hopper/wgmma.cuh
//
// out = im2col(LN(x)) w_flat^T + bias: M = B Hs Ws patch rows (2,048 at every stage of the
// 512 x 512 forward, 12 to 900 in the WSSS command lines), Nout = C, K = sr^2 C. What bounds
// it on the H100 (8 x 512², PERF.md): the bytes of the tokens at stage 1 (33.5 MB read
// once), the 3xTF32 products at stages 2 and 3; 5-11 us a launch, so the prologue, the
// epilogue and the grid's one wave count as much as the K loop. What holds it at 2.2-3.2
// times that (a clock64 probe of its phases, PERF.md): the K loop's preparation of A (ldmatrix,
// LayerNorm, split) by two consumer warps a scheduler, not the copies (A read from L2 alone
// ran as fast), and the cluster's sum (the partial tiles cross at about 12 bytes a cycle an
// SM).
//
// * A block is BM / 64 consumer warpgroups of 64 rows (BM 128 or 64) and one producer
//   warpgroup; it owns one BM x BN output tile (BN 32 to 192, the n tile of `wgmma`) and one
//   K slice of whole K steps of kWgBK columns. The K slices of a tile are the blocks of one
//   thread-block cluster (at most kSwMaxSlices: above 8, the portable size, the launch
//   allows the H100's non-portable sizes). A cluster lies in one of the card's groups of
//   SMs, so the H100 holds 30 clusters of 4, 15 of 8 and 7 of 10 to 16 at once
//   (`k1_sr_conv_wg_clusters`): the plan takes the most slices whose clusters fit one wave.
// * The producer's first thread walks the slice's K steps through a ring of tensor-map
//   copies guarded by `mbarrier`s (full: landed; ready: the weights are split; empty: the
//   consumers are done). A K step lies in one tap (C % 32 == 0), so its A tile is one box of
//   an im2col tensor map of the token grid (`wg_patch_map`): BM windows of the tap, 32
//   channels each, 128-byte swizzled rows, the walk through the windows done by the copy
//   engine (batch, rows of patches, cropping to full windows, rows past M arriving as zeros);
//   the weights are a box of the (C, K) matrix. Its warps 1-3 write the TF32 small half of
//   the weights into the slot's second B buffer once a copy has landed (`split_stage`).
// * A consumer warp loads its 16 rows of A by `ldmatrix`, applies the LayerNorm in f32 in
//   the plain version's order (`ln_apply`: the statistics of the token of each of its two
//   rows, loaded a step ahead without a branch; the LN weight and bias of the step's
//   channels as four 16-byte loads from a copy in shared memory that the block permutes
//   at its start so that a lane's 8 + 8 values lie together: 16 loads from L1 a step cost
//   the loop a sixth of its time, PERF.md), splits them into TF32 big and small halves and
//   issues the
//   three products of each k slice as m64nBNk8 `wgmma`s, half a step a commit group; a slot
//   is released once both halves of its step have completed, while the next half is in
//   flight (the K loop of `linear_wg_kernel`, gemm_f32.cu).
// * The K slices are summed inside the cluster: block s owns a share of the tile's rows. Once
//   the cluster has met at a barrier (every block done with its ring), each block pushes its
//   partial rows from its accumulators into the owner's ring, slot `slice`, by `st.async`
//   stores that complete on the owner's `sum` barrier; the owner waits for its bytes, adds
//   its slots in slice order, then the bias, and writes each output once. One barrier of the
//   cluster (about 1,300 cycles each on the card) and no remote loads: pulling the partials
//   took a second barrier, so that no block left while another read it, and a chain of
//   remote loads (PERF.md). No workspace, no second kernel and no atomics: a rerun gives
//   equal bits, and `sr_conv_sliced_reference` (ops/mit_block.py) adds in the same order.
// * With two consumer warpgroups `setmaxnreg` gives them 232 registers a thread (the n192
//   tile's accumulators), the producer 40; the first launch checks that ptxas gave the
//   kernel the 168 registers that count assumes.

constexpr int kSwMaxStages = 8;
constexpr int kSwMaxSlices = 16;       // the H100's largest cluster (non-portable)
constexpr int kSwMaxC = 512;           // channels the LayerNorm vectors' copy holds
constexpr int kSwVecBytes = 2 * kSwMaxC * 4;
constexpr int kSwBarBytes = 8 * (3 * kSwMaxStages + 1);   // the ring's barriers, the sum's
constexpr int kSwRegs = 168;           // registers a thread at launch (65536 / 384, to 8)
constexpr int kSwConsumerRegs = 232;   // after `setmaxnreg`: the producer keeps 40

template <int BM, int BN>
__host__ __device__ constexpr int sw_stage_bytes() { return (BM + 2 * BN) * hop::kWgRowBytes; }
template <int BM, int BN>
__host__ __device__ constexpr int sw_stages() {
  const int s = (hop::kWgSmemLimit - 1024 - kSwVecBytes - kSwBarBytes) / sw_stage_bytes<BM, BN>();
  return s > kSwMaxStages ? kSwMaxStages : s;
}
// bytes of dynamic shared memory: 1 KB to align the ring, the ring, the LayerNorm vectors,
// the barriers
template <int BM, int BN>
__host__ __device__ constexpr int sw_smem() {
  return 1024 + sw_stages<BM, BN>() * sw_stage_bytes<BM, BN>() + kSwVecBytes + kSwBarBytes;
}

struct SwArgs {
  const float* stats;   // (tokens, 2): mean, 1 / sqrt(var + eps)
  const float* lnw;
  const float* lnb;
  const float* bias;
  float* out;           // (M, C)
  int C, H, W, sr, Hs, Ws, M;
  int per;              // K steps of a slice (the last may hold fewer, none holds none)
  int steps;            // K steps in all
};

// a K step's channel and tap; a step stays inside one tap
struct SwTap {
  int c0, kx, ky;
};

template <int BM, int BN>
__global__ void __launch_bounds__(128 * (BM / 64 + 1), 1)
sr_conv_wg_kernel(const SwArgs p, const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap) {
  using namespace hop;
  constexpr int CW = BM / 64;   // consumer warpgroups
  constexpr int S = sw_stages<BM, BN>();
  constexpr int kA = BM * kWgRowBytes, kB = BN * kWgRowBytes, kStage = kA + 2 * kB;
  constexpr int kHalf = kWgBK / 16;   // k slices a half step
  constexpr int kPitch = BN + 8;      // floats a row of a pushed partial (no bank conflicts)
  static_assert(S >= 2 && (BM == 64 || BM == 128) && BN % 32 == 0 && BN <= 192 &&
                    (BM + kSwMaxSlices - 1) * kPitch * 4 <= S * kStage,
                "sr_conv geometry");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  // the LayerNorm weight and bias, channel c of chunk q (32 channels) at 32 q + 8 (c % 4) +
  // (c % 32) / 4: lane t's channels t, t + 4, ..., t + 28 of a chunk lie together
  float* lnv = reinterpret_cast<float*>(smem + S * kStage);
  const uint32_t full0 = smem_u32(smem + S * kStage + kSwVecBytes), ready0 = full0 + 8 * S,
                 empty0 = ready0 + 8 * S, sum_bar = full0 + 24 * kSwMaxStages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the cluster is (slices, 1, 1): block x of a cluster is its rank and its K slice
  const int slice = blockIdx.x, slices = gridDim.x;
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
  const int first = slice * p.per, nsteps = min(p.per, p.steps - first);
  const int per_image = p.Hs * p.Ws;
  auto tap_of = [&](int step) {
    const int k0 = step * kWgBK, tap = k0 / p.C;
    return SwTap{k0 - tap * p.C, tap % p.sr, tap / p.sr};
  };
  auto advance = [&](SwTap& at) {
    at.c0 += kWgBK;
    if (at.c0 == p.C) {
      at.c0 = 0;
      if (++at.kx == p.sr) {
        at.kx = 0;
        ++at.ky;
      }
    }
  };

  if (tid == 128 * CW) {   // the producer's copying thread
    tensormap_prefetch(&xmap);
    tensormap_prefetch(&wmap);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(ready0 + 8 * s, kWgSplitThreads);
      mbar_init(empty0 + 8 * s, 4 * CW);
    }
    mbar_init(sum_bar, 1);
    mbar_init_fence();
  }
  for (int c = tid; c < p.C; c += blockDim.x) {
    const int at = (c & ~31) + 8 * (c & 3) + ((c & 31) >> 2);
    lnv[at] = p.lnw[c];
    lnv[kSwMaxC + at] = p.lnb[c];
  }
  __syncthreads();

  if (warp >= 4 * CW) {   // ---- the producer warpgroup
    if constexpr (CW == 2) regs_dec<40>();
    if (warp == 4 * CW) {   // the copies
      if (lane == 0) {
        // the tile's first window: its top-left token (w, h) in image n
        const int n = m0 / per_image, q = m0 - n * per_image;
        const int h = (q / p.Ws) * p.sr, w = (q % p.Ws) * p.sr;
        SwTap at = tap_of(first);
        for (int f = 0; f < nsteps; ++f) {
          const int slot = f % S;
          mbar_wait(empty0 + 8 * slot, ((f / S) & 1) ^ 1);
          unsigned char* stage = smem + slot * kStage;
          mbar_arrive_expect(full0 + 8 * slot, kA + kB);
          tma_load_im2col_4d(stage, &xmap, at.c0, w, h, n, (uint16_t)at.kx, (uint16_t)at.ky,
                             full0 + 8 * slot);
          tma_load_2d(stage + kA, &wmap, (first + f) * kWgBK, n0, full0 + 8 * slot);
          advance(at);
        }
      }
      __syncwarp();
    } else {                // the split of the weights, a step behind the copies
      const int stid = tid - 128 * CW - 32;
      for (int f = 0; f < nsteps; ++f) {
        const int slot = f % S;
        mbar_wait(full0 + 8 * slot, (f / S) & 1);
        unsigned char* stage = smem + slot * kStage;
        split_stage(stage + kA, stage + kA + kB, kB / 16, stid, kWgSplitThreads);
        fence_proxy_async();
        mbar_arrive(ready0 + 8 * slot);
      }
    }
    cluster_sync();   // every block of the cluster is done with its ring
    return;
  }

  // ---- the consumer warpgroups: warp w owns rows 16 w .. 16 w + 15 of the tile, lane (g, t)
  // rows g and g + 8 of them
  if constexpr (CW == 2) regs_inc<kSwConsumerRegs>();
  const int g = lane / 4, t = lane % 4, r0 = 16 * warp;
  // the top-left token of the window of each of this lane's rows (rows past M read row
  // M - 1, whose sums are never stored)
  int corner[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = min(m0 + r0 + g + 8 * hf, p.M - 1), n = r / per_image, q = r - n * per_image;
    corner[hf] = (n * p.H + (q / p.Ws) * p.sr) * p.W + (q % p.Ws) * p.sr;
  }
  // the LayerNorm statistics of the tokens of this lane's rows at tap (kx, ky)
  auto load_stats = [&](int kx, int ky, float (&mu)[2], float (&rs)[2]) {
    const int off = ky * p.W + kx;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float2 st = __ldg(reinterpret_cast<const float2*>(p.stats) + corner[hf] + off);
      mu[hf] = st.x;
      rs[hf] = st.y;
    }
  };

  // `mu`, `rs`: the statistics at the step's tap; `mu_n`, `rs_n`: at the tap after it,
  // loaded every step (the last tap loads a tap of its own row), so that the loop holds no
  // branch: ptxas serialises the products of a loop with branches between them (C7518)
  SwTap at = tap_of(first);
  float mu[2], rs[2], mu_n[2] = {0.f, 0.f}, rs_n[2] = {0.f, 0.f};
  load_stats(at.kx, at.ky, mu, rs);
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t abig[2][kHalf][4], asmall[2][kHalf][4];   // [half][k slice][fragment]
  int pending = -1;
  auto release = [&](int slot) {
    if (slot >= 0 && lane == 0) mbar_arrive(empty0 + 8 * slot);
  };
  for (int ks = 0; ks < nsteps; ++ks) {
    const int slot = ks % S;
    const uint32_t par = (ks / S) & 1;
    // the step's LayerNorm weight and bias of this lane's channels (channels 8 kk + t and
    // + 4 of k slice kk), read while the copy lands
    float lw[2 * kHalf][2], lb[2 * kHalf][2];
    {
      const float4* vw = reinterpret_cast<const float4*>(lnv + at.c0 + 8 * t);
      const float4* vb = reinterpret_cast<const float4*>(lnv + kSwMaxC + at.c0 + 8 * t);
      const float4 w0 = vw[0], w1 = vw[1], b0 = vb[0], b1 = vb[1];
      lw[0][0] = w0.x, lw[0][1] = w0.y, lw[1][0] = w0.z, lw[1][1] = w0.w;
      lw[2][0] = w1.x, lw[2][1] = w1.y, lw[3][0] = w1.z, lw[3][1] = w1.w;
      lb[0][0] = b0.x, lb[0][1] = b0.y, lb[1][0] = b0.z, lb[1][1] = b0.w;
      lb[2][0] = b1.x, lb[2][1] = b1.y, lb[3][0] = b1.z, lb[3][1] = b1.w;
    }
    mbar_wait(full0 + 8 * slot, par);
    {
      const bool fresh = ks > 0 && at.c0 == 0;   // a new tap: its statistics came a step ahead
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mu[hf] = fresh ? mu_n[hf] : mu[hf];
        rs[hf] = fresh ? rs_n[hf] : rs[hf];
      }
      const bool wrap = at.kx + 1 == p.sr;
      load_stats(wrap ? 0 : at.kx + 1, min(at.ky + (wrap ? 1 : 0), p.sr - 1), mu_n, rs_n);
    }
    const unsigned char* stage = smem + slot * kStage;
    const uint64_t db = desc_sw(stage + kA), ds = desc_sw(stage + kA + kB);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int kk = 0; kk < kHalf; ++kk) {
        const int q = kHalf * hf + kk;
        uint32_t x[4];
        ldsm_a(x, stage, r0, q, lane);
        x[0] = __float_as_uint(ln_apply(__uint_as_float(x[0]), mu[0], rs[0], lw[q][0], lb[q][0]));
        x[1] = __float_as_uint(ln_apply(__uint_as_float(x[1]), mu[1], rs[1], lw[q][0], lb[q][0]));
        x[2] = __float_as_uint(ln_apply(__uint_as_float(x[2]), mu[0], rs[0], lw[q][1], lb[q][1]));
        x[3] = __float_as_uint(ln_apply(__uint_as_float(x[3]), mu[1], rs[1], lw[q][1], lb[q][1]));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          abig[hf][kk][i] = tf32_big(x[i]);
          asmall[hf][kk][i] = tf32_small_of(x[i]);
        }
      }
      if (hf == 0) mbar_wait(ready0 + 8 * slot, par);   // the weights' small half
      fence_acc(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kHalf; ++kk) {
        const int s2 = 2 * (kHalf * hf + kk);   // 32 bytes a k slice, in 16-byte units
        mma3<BN>(acc, abig[hf][kk], asmall[hf][kk], db + s2, ds + s2, (ks | hf | kk) != 0);
      }
      wg_commit();
      if (hf == 0) {          // the step before has completed: its slot is free
        wg_wait<1>();
        fence_acc(acc);
        release(pending);
        pending = -1;
      } else if (ks == nsteps - 1) {   // the slice is summed
        wg_wait<0>();
        fence_acc(acc);
        release(slot);
      } else {
        wg_wait<1>();
        fence_acc(acc);
        pending = slot;
      }
    }
    advance(at);
  }

  // ---- the slices summed in the cluster
  wg_wait<0>();   // done already; said again so that ptxas need not insert a wait (C7517)
  fence_acc(acc);
  // block r owns rows [r share, (r + 1) share) of the tile (none where r share >= BM, as
  // with 12 slices of 64 rows); its ring receives them from every block, slot s from block
  // s, rows of kPitch floats
  constexpr int kQ = BN / 4, kGroups = 128 * CW / kQ;   // 16-byte pieces a row; row groups
  const int share = (BM + slices - 1) / slices;
  const int rb = min(BM, slice * share), re = min(BM, rb + share);
  // this thread's piece of the sum: column piece q of rows rb + rg, + kGroups, ...; its bias
  // loaded before the barrier (a piece past C reads the last and is not stored)
  const int q = tid % kQ, rg = tid / kQ;
  const float4 bias4 = __ldg(reinterpret_cast<const float4*>(p.bias + min(n0 + 4 * q, p.C - 4)));
  if (tid == 0) mbar_arrive_expect(sum_bar, (uint32_t)(slices * (re - rb) * BN * 4));
  cluster_sync();   // every block of the cluster is done with its ring
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + g + 8 * hf, owner = row / share;
    const uint32_t at = smem_u32(smem) + (uint32_t)(((slice * share + row - owner * share) * kPitch + 2 * t) * 4);
    const uint32_t ra = cluster_map(at, owner), rbar = cluster_map(sum_bar, owner);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      st_async_f2(ra + 32 * j, acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1], rbar);
  }
  mbar_wait_cluster(sum_bar, 0);   // every block's rows of this block's share have landed
  if (rg >= kGroups || n0 + 4 * q >= p.C) return;
  const float* part = reinterpret_cast<const float*>(smem);
  for (int row = rb + rg; row < re && m0 + row < p.M; row += kGroups) {
    const float* at = part + (row - rb) * kPitch + 4 * q;
    float4 o = *reinterpret_cast<const float4*>(at);
    for (int s2 = 1; s2 < slices; ++s2) {
      const float4 v = *reinterpret_cast<const float4*>(at + s2 * share * kPitch);
      o.x = __fadd_rn(o.x, v.x);
      o.y = __fadd_rn(o.y, v.y);
      o.z = __fadd_rn(o.z, v.z);
      o.w = __fadd_rn(o.w, v.w);
    }
    *reinterpret_cast<float4*>(p.out + (size_t)(m0 + row) * p.C + n0 + 4 * q) =
        make_float4(__fadd_rn(o.x, bias4.x), __fadd_rn(o.y, bias4.y), __fadd_rn(o.z, bias4.z),
                    __fadd_rn(o.w, bias4.w));
  }
}

// One instantiation: its shared memory allowed once per process (and the registers that
// `setmaxnreg` counts on checked), its cluster launch, and the clusters the card holds at once
template <int BM, int BN>
struct SrConvWg {
  static constexpr int kSmem = sw_smem<BM, BN>();
  static constexpr int kThreads = 128 * (BM / 64 + 1);
  static constexpr auto kernel = sr_conv_wg_kernel<BM, BN>;
  static_assert(kSmem <= hop::kWgSmemLimit, "the ring fits a block's shared memory");

  static cudaError_t prepare() {
    static const cudaError_t err = [] {
      cudaFuncAttributes attr;
      cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
      if (e == cudaSuccess && BM == 128 && attr.numRegs != kSwRegs) e = cudaErrorInvalidConfiguration;
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      if (e == cudaSuccess)   // clusters of more than 8 blocks
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      return e;
    }();
    return err;
  }
  // a launch of `grid` blocks in clusters of (grid.x, 1, 1); `attr` outlives the config
  static cudaLaunchConfig_t config(dim3 grid, cudaStream_t st, cudaLaunchAttribute* attr) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = grid.x;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
  }
  static cudaError_t launch(const SwArgs& a, const float* x, const float* w, int B, dim3 grid,
                            cudaStream_t st) {
    cudaError_t err = prepare();
    if (err != cudaSuccess) return err;
    CUtensorMap xm = {}, wm = {};
    err = hop::wg_patch_map(&xm, x, a.C, a.W, a.H, B, a.sr, BM);
    if (err == cudaSuccess) err = hop::wg_tensor_map(&wm, w, a.C, (long long)a.steps * hop::kWgBK, BN);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(grid, st, &attr);
    err = cudaLaunchKernelEx(&cfg, kernel, a, xm, wm);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  static int clusters(int slices) {   // clusters of `slices` blocks the card holds at once
    int n = -1;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(dim3(slices, 1, 1), nullptr, &attr);
    if (prepare() != cudaSuccess || cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
      return -1;
    return n;
  }
};

// `op.template run<BM, BN>()` for the instantiation of (rows, bn), or an invalid value
template <class Op>
int sw_dispatch(int rows, int bn, const Op& op) {
#define SW_TILE(R, N) \
  if (rows == R && bn == N) return op.template run<R, N>();
  SW_TILE(128, 32) SW_TILE(128, 64) SW_TILE(128, 96) SW_TILE(128, 128) SW_TILE(128, 160)
  SW_TILE(128, 192) SW_TILE(64, 32) SW_TILE(64, 64) SW_TILE(64, 96) SW_TILE(64, 128)
  SW_TILE(64, 160) SW_TILE(64, 192)
#undef SW_TILE
  return -(int)cudaErrorInvalidValue;
}

struct SwLaunch {
  const SwArgs& a;
  const float* x;
  const float* w;
  int B;
  dim3 grid;
  cudaStream_t st;
  template <int BM, int BN>
  int run() const { return (int)SrConvWg<BM, BN>::launch(a, x, w, B, grid, st); }
};
struct SwSmem {
  template <int BM, int BN>
  int run() const { return SrConvWg<BM, BN>::kSmem; }
};
struct SwClusters {
  int slices;
  template <int BM, int BN>
  int run() const { return SrConvWg<BM, BN>::clusters(slices); }
};

int sr_conv_f32(const float* x, const float* stats, const float* lnw, const float* lnb,
                const float* w, const float* bias, float* out, int B, int H, int W, int C, int sr,
                int rows, int bn, int slices, cudaStream_t st) {
  if (sr < 1 || sr > 8 || C < hop::kWgBK || C % hop::kWgBK || C > kSwMaxC)
    return (int)cudaErrorInvalidValue;
  const int Hs = H / sr, Ws = W / sr;
  const long long M = (long long)B * Hs * Ws;
  const int steps = sr * sr * C / hop::kWgBK;
  if (M < 1 || M > (1LL << 30) || slices < 1 || slices > kSwMaxSlices || slices > steps ||
      (rows != 64 && rows != 128))
    return (int)cudaErrorInvalidValue;
  const int per = (steps + slices - 1) / slices;
  const long long mtiles = (M + rows - 1) / rows;
  if ((slices - 1) * per >= steps || mtiles > 65535) return (int)cudaErrorInvalidValue;
  const SwArgs a{stats, lnw, lnb, bias, out, C, H, W, sr, Hs, Ws, (int)M, per, steps};
  const dim3 grid(slices, (C + bn - 1) / bn, (unsigned)mtiles);
  const int r = sw_dispatch(rows, bn, SwLaunch{a, x, w, B, grid, st});
  return r < 0 ? -r : r;
}

int sr_conv_f32_smem(int rows, int bn) {
  const int r = sw_dispatch(rows, bn, SwSmem{});
  return r < 0 ? -1 : r;
}

int sr_conv_f32_clusters(int rows, int bn, int slices) {
  if (slices < 1 || slices > kSwMaxSlices) return -1;
  const int r = sw_dispatch(rows, bn, SwClusters{slices});
  return r < 0 ? -1 : r;
}

}  // namespace k1
