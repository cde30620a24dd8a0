// K1 `linear` with f32 operands, `linear_wg_kernel`, built beside gemm.cu (which holds the
// bf16 kernel and the C entry points). Replaces, and is bound by, what gemm.cu's note
// says; its design is noted below.
#include "../hopper/wgmma.cuh"
#include "common.cuh"

namespace k1 {

// ---- linear with f32 operands: 3xTF32 `wgmma` (sm_90a), the building blocks of
// csrc/hopper/wgmma.cuh
//
// A block is BM / 64 consumer warpgroups of 64 rows (BM 128 or 64) and one producer
// warpgroup;
// persistent blocks walk the output tiles b, b + blocks, ... (BM x BN each, the column
// tiles of an M tile next to each other, so that blocks running together share their A
// rows in L2). The producer walks the block's (tile, K step) pairs. Its first thread
// waits for the ring's slot to be empty and starts the tensor-map copies of the step's
// kWgBK columns of A (BM rows, f32 as they lie in device memory) and of the weights (BN
// rows); rows past M or Nout arrive as zeros. Its warps 1-3 follow: once a copy has
// landed they write the TF32 small half of the weights into the slot's second B
// buffer. A consumer warp loads its 16 rows of A by `ldmatrix`, applies the LayerNorm
// to them in registers (`ln_apply`, the statistics of its two rows held a tile, the LN
// weight and bias of the step read through L1 before its copy is awaited), splits them,
// waits for the weights' small half and issues the three products of each k slice as
// m64nBNk8 `wgmma`s, half a step a commit group; it releases the slot once both halves
// have completed, while the next half is in flight. The epilogue works on the
// accumulators: bias, then residual, in f32; lanes t and t ^ 1 swap column pairs so that
// each stores 16-byte pieces (scalar stores where Nout % 4 != 0), while the producer fills
// the ring for the next tile. The bias and residual of a tile are loaded into registers
// before its products, the LayerNorm statistics of the next tile during this one (the
// first tile's are used only once its first copy has landed): at K = 64 a tile's
// products take less time than a load from device memory (loaded where they were used,
// they made the kernel twice as slow as its bytes allow, PERF.md). With two consumer warpgroups `setmaxnreg` gives
// them 232 registers a thread (the 128-column tile's accumulators and residual), the
// producer 40. Every output sums its whole K in one block, K step after K step, in the
// same order whatever the plan: equal bits from every plan.
constexpr int kLwgMaxStages = 8;
constexpr int kLwgRegs = 168;           // registers a thread at launch (65536 / 384, to 8)
constexpr int kLwgConsumerRegs = 232;   // after `setmaxnreg`: the producer keeps 40

template <int BM, int BN>
__host__ __device__ constexpr int lwg_stage_bytes() { return (BM + 2 * BN) * hop::kWgRowBytes; }
template <int BM, int BN>
__host__ __device__ constexpr int lwg_stages() {
  const int s = (hop::kWgSmemLimit - 1024 - 3 * 8 * kLwgMaxStages) / lwg_stage_bytes<BM, BN>();
  return s > kLwgMaxStages ? kLwgMaxStages : s;
}
// bytes of dynamic shared memory: the ring, the barriers, 1 KB to align the ring
template <int BM, int BN>
__host__ __device__ constexpr int lwg_smem() {
  return 1024 + 3 * 8 * kLwgMaxStages + lwg_stages<BM, BN>() * lwg_stage_bytes<BM, BN>();
}

template <int BM, int BN, bool LN>
__global__ void __launch_bounds__(128 * (BM / 64 + 1), 1)
linear_wg_kernel(const LinArgs<float> p, const __grid_constant__ CUtensorMap amap,
                 const __grid_constant__ CUtensorMap wmap) {
  using namespace hop;
  constexpr int CW = BM / 64;   // consumer warpgroups
  constexpr int S = lwg_stages<BM, BN>();
  constexpr int kA = BM * kWgRowBytes, kB = BN * kWgRowBytes, kStage = kA + 2 * kB;
  constexpr int kHalf = kWgBK / 16;   // k slices a half step
  static_assert(S >= 3 && (BM == 64 || BM == 128) && BN % 16 == 0 && kWgBK % 16 == 0,
                "linear geometry");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t full0 = smem_u32(smem + S * kStage), ready0 = full0 + 8 * S,
                 empty0 = ready0 + 8 * S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ksteps = p.K / kWgBK;
  const int ntiles = (p.Nout + BN - 1) / BN, tiles = ((p.M + BM - 1) / BM) * ntiles;
  const int my_tiles = (int)blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = my_tiles * ksteps;
  if (tid == 128 * CW) {   // the producer's copying thread
    tensormap_prefetch(&amap);
    tensormap_prefetch(&wmap);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(ready0 + 8 * s, kWgSplitThreads);
      mbar_init(empty0 + 8 * s, 4 * CW);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * CW) {   // ---- the producer warpgroup
    if constexpr (CW == 2) regs_dec<40>();
    if (warp == 4 * CW) {   // the copies
      if (lane == 0) {
        for (int f = 0; f < total; ++f) {
          const int slot = f % S;
          mbar_wait(empty0 + 8 * slot, ((f / S) & 1) ^ 1);
          const int tile = blockIdx.x + (f / ksteps) * gridDim.x, k0 = (f % ksteps) * kWgBK;
          unsigned char* stage = smem + slot * kStage;
          mbar_arrive_expect(full0 + 8 * slot, kA + kB);
          tma_load_2d(stage, &amap, k0, (tile / ntiles) * BM, full0 + 8 * slot);
          tma_load_2d(stage + kA, &wmap, k0, (tile % ntiles) * BN, full0 + 8 * slot);
        }
      }
    } else {                // the split of the weights, a step behind the copies
      const int stid = tid - 128 * CW - 32;
      for (int f = 0; f < total; ++f) {
        const int slot = f % S;
        mbar_wait(full0 + 8 * slot, (f / S) & 1);
        unsigned char* stage = smem + slot * kStage;
        split_stage(stage + kA, stage + kA + kB, kB / 16, stid, kWgSplitThreads);
        fence_proxy_async();
        mbar_arrive(ready0 + 8 * slot);
      }
    }
    return;
  }

  // ---- the consumer warpgroups: warp w owns rows 16 w .. 16 w + 15 of the tile
  if constexpr (CW == 2) regs_inc<kLwgConsumerRegs>();
  const int g = lane / 4, t = lane % 4, r0 = 16 * warp;
  const float* __restrict__ res = p.res;
  float* __restrict__ out = p.out;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t abig[2][kHalf][4], asmall[2][kHalf][4];   // [half][k slice][fragment]
  // LayerNorm statistics of rows g, g + 8 of this tile and, loaded a tile ahead, of the
  // next. The loads below read clamped addresses rather than choose between a load and a
  // constant: a choice waits for the load where it is made (a chain of latencies at the
  // start of a small product), a clamped row only feeds outputs that are never stored.
  float mu[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f}, mu_n[2] = {0.f, 0.f}, rs_n[2] = {0.f, 0.f};
  auto load_stats = [&](int tile, float (&m)[2], float (&r)[2]) {
    const int rg = (tile / ntiles) * BM + r0 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 st = __ldg(reinterpret_cast<const float2*>(p.stats) + min(rg + 8 * h, p.M - 1));
      m[h] = st.x;
      r[h] = st.y;
    }
  };
  int f = 0, pending = -1;
  auto release = [&](int slot) {
    if (slot >= 0 && lane == 0) mbar_arrive(empty0 + 8 * slot);
  };

  // The epilogue writes 16-byte pieces where rows hold whole ones: lanes t and t ^ 1 swap
  // pairs of columns, so that an even t holds columns 2t .. 2t + 3 of row g of an n8 tile
  // and an odd t columns 2t - 2 .. 2t + 1 of row g + 8 (scalar stores elsewhere)
  const bool quads = (p.Nout & 3) == 0, odd = t & 1;
  for (int k = 0; k < my_tiles; ++k) {
    const int tile = blockIdx.x + k * gridDim.x;
    const int m0 = (tile / ntiles) * BM, n0 = (tile % ntiles) * BN;
    const int rg = m0 + r0 + g, rq = rg + (odd ? 8 : 0);   // this lane's rows, and its row of pieces
    if (LN) {
      if (k == 0) {
        load_stats(tile, mu, rs);   // first used once the tile's first copy has landed
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mu[h] = mu_n[h];
          rs[h] = rs_n[h];
        }
      }
      load_stats(tile + gridDim.x, mu_n, rs_n);   // past the last tile: row M - 1
    }
    // the bias of this lane's column pairs and the residual of its pieces, in flight
    // during the products (16-byte rows only; the scalar epilogue reads its own)
    float2 bb[BN / 8];
    float4 rr[BN / 8];
    if (quads) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = min(n0 + 8 * j + 2 * t, p.Nout - 2);
        bb[j] = __ldg(reinterpret_cast<const float2*>(p.bias + col));
      }
    }
    if (quads && res != nullptr) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c4 = min(n0 + 8 * j + 4 * (t >> 1), p.Nout - 4);
        rr[j] = __ldg(reinterpret_cast<const float4*>(res + (size_t)min(rq, p.M - 1) * p.Nout + c4));
      }
    }
    for (int ks = 0; ks < ksteps; ++ks, ++f) {
      const int slot = f % S;
      const uint32_t par = (f / S) & 1;
      // the step's LayerNorm weight and bias of this lane's columns, in flight while the
      // copy lands (columns 8 kk + t and + 4 of k slice kk)
      float lw[2 * kHalf][2], lb[2 * kHalf][2];
#pragma unroll
      for (int kk = 0; kk < 2 * kHalf; ++kk) {
        const int c = ks * kWgBK + 8 * kk + t;
        lw[kk][0] = LN ? __ldg(p.lnw + c) : 0.f;
        lw[kk][1] = LN ? __ldg(p.lnw + c + 4) : 0.f;
        lb[kk][0] = LN ? __ldg(p.lnb + c) : 0.f;
        lb[kk][1] = LN ? __ldg(p.lnb + c + 4) : 0.f;
      }
      mbar_wait(full0 + 8 * slot, par);
      const unsigned char* stage = smem + slot * kStage;
      const uint64_t db = desc_sw(stage + kA), ds = desc_sw(stage + kA + kB);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int kk = 0; kk < kHalf; ++kk) {
          const int q = kHalf * hf + kk;
          uint32_t x[4];
          ldsm_a(x, stage, r0, q, lane);
          if (LN) {
            x[0] = __float_as_uint(ln_apply(__uint_as_float(x[0]), mu[0], rs[0], lw[q][0], lb[q][0]));
            x[1] = __float_as_uint(ln_apply(__uint_as_float(x[1]), mu[1], rs[1], lw[q][0], lb[q][0]));
            x[2] = __float_as_uint(ln_apply(__uint_as_float(x[2]), mu[0], rs[0], lw[q][1], lb[q][1]));
            x[3] = __float_as_uint(ln_apply(__uint_as_float(x[3]), mu[1], rs[1], lw[q][1], lb[q][1]));
          }
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
        } else if (ks == ksteps - 1) {   // the tile is summed
          wg_wait<0>();
          fence_acc(acc);
          release(slot);
        } else {
          wg_wait<1>();
          fence_acc(acc);
          pending = slot;
        }
      }
    }
    // ---- the epilogue: the bias, then the residual, in f32
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (quads) {
        const float v0 = acc[4 * j] + bb[j].x, v1 = acc[4 * j + 1] + bb[j].y;
        const float v2 = acc[4 * j + 2] + bb[j].x, v3 = acc[4 * j + 3] + bb[j].y;
        const float s0 = __shfl_xor_sync(0xffffffffu, odd ? v0 : v2, 1);
        const float s1 = __shfl_xor_sync(0xffffffffu, odd ? v1 : v3, 1);
        float4 o = odd ? make_float4(s0, s1, v2, v3) : make_float4(v0, v1, s0, s1);
        const int c4 = n0 + 8 * j + 4 * (t >> 1);
        if (res != nullptr) {
          o.x += rr[j].x;
          o.y += rr[j].y;
          o.z += rr[j].z;
          o.w += rr[j].w;
        }
        if (rq < p.M && c4 < p.Nout)
          *reinterpret_cast<float4*>(out + (size_t)rq * p.Nout + c4) = o;
        continue;
      }
      const int col = n0 + 8 * j + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // rows g, g + 8; columns col, col + 1
        const int row = rg + 8 * (e >> 1), c = col + (e & 1);
        if (row >= p.M || c >= p.Nout) continue;
        const size_t at = (size_t)row * p.Nout + c;
        float v = acc[4 * j + e] + p.bias[c];
        if (res != nullptr) v += res[at];
        out[at] = v;
      }
    }
  }
}

// One f32 instantiation: its shared memory allowed once per process, its tensor maps and
// launch of `blocks` persistent blocks, and the blocks an SM holds
template <int BM, int BN, bool LN>
struct LinearWg {
  static constexpr int kSmem = lwg_smem<BM, BN>();
  static constexpr int kThreads = 128 * (BM / 64 + 1);
  static constexpr auto kernel = linear_wg_kernel<BM, BN, LN>;
  static_assert(kSmem <= hop::kWgSmemLimit, "the ring fits a block's shared memory");

  static cudaError_t prepare() {   // and check the registers that `setmaxnreg` counts on
    static const cudaError_t err = [] {
      cudaFuncAttributes attr;
      cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
      if (e == cudaSuccess && BM == 128 && attr.numRegs != kLwgRegs)
        e = cudaErrorInvalidConfiguration;
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      return e;
    }();
    return err;
  }
  static cudaError_t launch(const LinArgs<float>& p, int blocks, cudaStream_t st) {
    cudaError_t err = prepare();
    if (err != cudaSuccess) return err;
    CUtensorMap am = {}, wm = {};
    err = hop::wg_tensor_map(&am, p.a, p.M, p.K, BM);
    if (err == cudaSuccess) err = hop::wg_tensor_map(&wm, p.w, p.Nout, p.K, BN);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, kSmem, st>>>(p, am, wm);
    return cudaGetLastError();
  }
  static int blocks_per_sm() {
    int n = -1;
    if (prepare() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, kSmem) != cudaSuccess)
      return -1;
    return n;
  }
};

// the f32 tiles (rows, columns) by id: 128 x 64 and 128 x 128 with two consumer
// warpgroups, 64 x 64 with one (small products, whose blocks are chains of latencies)
template <int TILE, bool LN>
using LinearWgTile = LinearWg<TILE == 2 ? 64 : 128, TILE == 1 ? 128 : 64, LN>;

int linear_f32(const LinArgs<float>& p, int tile, int blocks, cudaStream_t st) {
  const bool ln = p.stats != nullptr;
  switch (tile) {
    case 0: return (int)(ln ? LinearWgTile<0, true>::launch(p, blocks, st)
                            : LinearWgTile<0, false>::launch(p, blocks, st));
    case 1: return (int)(ln ? LinearWgTile<1, true>::launch(p, blocks, st)
                            : LinearWgTile<1, false>::launch(p, blocks, st));
    case 2: return (int)(ln ? LinearWgTile<2, true>::launch(p, blocks, st)
                            : LinearWgTile<2, false>::launch(p, blocks, st));
    default: return (int)cudaErrorInvalidValue;
  }
}

int linear_f32_blocks_per_sm(int tile, int ln) {
  switch (tile) {
    case 0: return ln ? LinearWgTile<0, true>::blocks_per_sm() : LinearWgTile<0, false>::blocks_per_sm();
    case 1: return ln ? LinearWgTile<1, true>::blocks_per_sm() : LinearWgTile<1, false>::blocks_per_sm();
    case 2: return ln ? LinearWgTile<2, true>::blocks_per_sm() : LinearWgTile<2, false>::blocks_per_sm();
    default: return -1;
  }
}

}  // namespace k1
