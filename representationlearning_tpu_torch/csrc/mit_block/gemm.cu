// K1 part 2: the block's linear layers, out = LN?(a) @ w^T + bias (+ residual), as
// one pipelined tensor-core product with a LayerNorm prologue and a bias/residual
// epilogue, selected at compile time by the operand type: bf16 (the TPU kernel's bf16
// path) runs `linear_kernel` below, on `mma.sync`; float (its f32 default) runs
// `linear_wg_kernel` (gemm_f32.cu, a source of its own so that nvcc builds it side by
// side), 3xTF32 `wgmma` fed by tensor-map copies. (The sr x sr conv of the block has a kernel of its own, sr_conv.cu.)
//
// Replaces: every `_mm` of the TPU kernel's body
//   representationlearning_tpu/ops/pallas/mit_block.py:42-44, reached from
//   `fused_block_pallas` :259 -> `_kernel` :216 -> `_block_math` :62:
//   LN1 -> q (:80-81), kv (:140), proj + residual 1 (:164-165), LN2 -> fc1
//   (:167-168) and fc2 + residual 2 (:183-184).
// What bounds it on the H100: bytes, and the latency of getting them. The
//   products are thin (K = C = 64 ... 512, 2048 for fc2; M up to 8 * 16384 tokens
//   at stage 1): the f32 activations read and the f32 results written weigh more
//   than the tensor-core work (181.6 GFLOP against 2.6 GB for the 40 launches of
//   a 512 x 512 forward), and at K = 64 a tile has only two K steps. Where Nout
//   and K are large (stages 3 and 4), small tiles re-read A and the weights from
//   L2 so often that L2 sets the pace.
// What the design does about it (bf16; float's design is noted at `linear_wg_kernel`):
//   * Tiles from a plan. The wrapper's `linear_plan` (ops/mit_block.py, a function
//     of the shapes only) picks one of three output tiles, 64 x 64 and 64 x 128
//     (four warps, three or four blocks an SM) or 128 x 256 (eight warps, one
//     block an SM, half the L2 traffic of 64 x 128 per product), and the
//     number `per` of M tiles a block walks.
//   * One pipeline across a block's M tiles. The block's (tile, K step) pairs are
//     one sequence; the f32 activations and the bf16 weights of step s + STAGES - 1
//     travel by `cp.async` into a ring of STAGES shared-memory slots while step s
//     is multiplied, so two or three steps are in flight whatever the registers
//     allow, and the next tile's first steps load during this tile's last products
//     and its epilogue. Each thread normalises exactly the A pieces it copied, so
//     it waits for its own copies only; one barrier a step.
//   * LayerNorm as the plain version rounds it (`ln_apply`), so both feed the same
//     bf16 operands to the product; a row's statistics are loaded a tile ahead and
//     the LN weight and bias as float4 a step ahead, in registers.
//   * `ldmatrix` fragments from padded (conflict-free) tiles into `mma.sync`
//     m16n8k16 with f32 sums. Every output sums its whole K in one block, K step
//     after K step: no split of K, no atomics, the same bits from every plan.
//   * A row-wise epilogue: each warp stages eight rows of its accumulators at a
//     time in shared memory of its own and writes them as whole rows of 128 or
//     256 bytes with float4 stores, adding the bias and then the residual (read
//     in the same pattern, before the staging) in f32, in that order, as the plain
//     version does.
#include "common.cuh"

namespace k1 {

constexpr int kLinBK = 32;
// pitch of the bf16 A and B tiles, in elements: a row of 32 and 16 bytes of padding (80
// bytes), so `ldmatrix` is conflict-free; the f32 A ring is bare (converted to the bf16 A
// buffer)
template <typename T>
constexpr int kLinPitch = kLinBK + 16 / (int)sizeof(T);

// bytes of dynamic shared memory: the ring of f32 A steps and of bf16 B steps, the bf16
// A double buffer, and each warp's staging of 8 output rows
template <typename T, int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
constexpr int linear_smem() {
  return STAGES * BM * kLinBK * 4 + STAGES * BN * kLinPitch<T> * (int)sizeof(T) +
         2 * BM * kLinPitch<T> * 2 + WARPS_M * WARPS_N * 8 * (BN / WARPS_N + 8) * 4;
}

template <typename T, int BM, int BN, int WARPS_M, int WARPS_N, int STAGES, int MIN_BLOCKS,
          bool LN>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N, MIN_BLOCKS)
linear_kernel(const LinArgs<T> p) {
  static_assert(sizeof(T) == 2, "bf16 operands: f32 runs linear_wg_kernel");
  constexpr int kAP = kLinBK, kBP = kLinPitch<T>;
  constexpr int kSK = kSliceK<T>;                       // k of one slice of the products
  constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  constexpr int kRowsA = kThreads / 8;                  // A rows a pass: 8 threads a row
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's outputs
  constexpr int MI = WM / 16, NJ = WN / 8;              // its m16n8 tiles
  constexpr int kAIters = BM / kRowsA;                  // 16-byte pieces of an A step a thread
  constexpr int kCPitch = WN + 8;                       // f32 pitch of the staging rows
  constexpr int kLanesRow = WN / 4, kRowsPass = 32 / kLanesRow;
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BM % kRowsA == 0 && STAGES >= 2, "tile");

  extern __shared__ __align__(128) unsigned char smem[];
  float* Af = reinterpret_cast<float*>(smem);                   // [STAGES][BM][kAP] f32
  T* Bs = reinterpret_cast<T*>(Af + STAGES * BM * kAP);         // [STAGES][BN][kBP]
  bf16* As = reinterpret_cast<bf16*>(Bs + STAGES * BN * kBP);   // [2][BM][kBP]
  float* Cs = reinterpret_cast<float*>(As + 2 * BM * kBP);      // [warp][8][kCPitch]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN;
  const int mtiles = (p.M + BM - 1) / BM;
  const int first = blockIdx.y * p.per;
  const int ksteps = p.K / kLinBK;
  const int total = min(p.per, mtiles - first) * ksteps;  // (tile, K step) pairs
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;

  // ---- a step: 32 columns of A (f32) and of the weights (T), one commit group.
  // This thread copies A rows ar + kRowsA * i, columns kc .. kc + 3, and later
  // normalises exactly those, so it waits for its own copies and for no other.
  const int ar = tid >> 3, kc = (tid & 7) * 4;
  int f_s = 0, f_k = 0, f_m0 = first * BM;  // step, K offset and tile of the next fetch
  auto fetch = [&]() {  // empty past the end
    if (f_s < total) {
      const int slot = f_s % STAGES;
      float* da = Af + slot * BM * kAP;
#pragma unroll
      for (int i = 0; i < kAIters; ++i) {
        const int r = ar + kRowsA * i, gm = f_m0 + r;
        const bool ok = gm < p.M;
        cp_async16(da + r * kAP + kc, p.a + (size_t)(ok ? gm : 0) * p.K + f_k + kc, ok);
      }
      T* db = Bs + slot * BN * kBP;
      constexpr int kPieces = kLinBK * (int)sizeof(T) / 16;  // 16-byte pieces a B row
      constexpr int kPer = 16 / (int)sizeof(T);              // elements a piece
#pragma unroll
      for (int idx = tid; idx < BN * kPieces; idx += kThreads) {
        const int r = idx / kPieces, c = (idx % kPieces) * kPer;
        const bool ok = n0 + r < p.Nout;
        cp_async16(db + r * kBP + c, p.w + (size_t)(ok ? n0 + r : 0) * p.K + f_k + c, ok);
      }
      f_k += kLinBK;
      if (f_k == p.K) {
        f_k = 0;
        f_m0 += BM;
      }
      ++f_s;
    }
    cp_async_commit();
  };

  // LayerNorm statistics of this tile's rows and, loaded a tile ahead, of the next;
  // the LN weight and bias of this step and, loaded a step ahead, of the next
  float mu[kAIters] = {}, rs[kAIters] = {}, mu_n[kAIters] = {}, rs_n[kAIters] = {};
  float4 gw = make_float4(0.f, 0.f, 0.f, 0.f), gb = gw, gw_n = gw, gb_n = gw;
  int st_m0 = first * BM, c_k = 0;
  auto load_stats = [&]() {
#pragma unroll
    for (int i = 0; i < kAIters; ++i) {
      const int gm = st_m0 + ar + kRowsA * i;
      if (gm < p.M) {
        const float2 st = __ldg(reinterpret_cast<const float2*>(p.stats + 2 * (size_t)gm));
        mu_n[i] = st.x;
        rs_n[i] = st.y;
      }
    }
    st_m0 += BM;
  };
  auto load_lnw = [&](int k) {
    gw_n = __ldg(reinterpret_cast<const float4*>(p.lnw + k + kc));
    gb_n = __ldg(reinterpret_cast<const float4*>(p.lnb + k + kc));
  };
  // step s of this thread's A pieces: LayerNorm, round to bf16, to the A buffer. A row
  // past M holds zeros or their image: it reaches only rows that are never written.
  auto convert = [&](int s) {
    if (LN) {
      if (c_k == 0) {  // a new tile
#pragma unroll
        for (int i = 0; i < kAIters; ++i) {
          mu[i] = mu_n[i];
          rs[i] = rs_n[i];
        }
        if (s + ksteps < total) load_stats();
      }
      gw = gw_n;
      gb = gb_n;
    }
    c_k = c_k + kLinBK == p.K ? 0 : c_k + kLinBK;
    if (LN) load_lnw(c_k);
    const float* src = Af + (s % STAGES) * BM * kAP;
    bf16* dst = As + (s & 1) * BM * kBP;
#pragma unroll
    for (int i = 0; i < kAIters; ++i) {
      const int r = ar + kRowsA * i;
      const float4 a = *reinterpret_cast<const float4*>(src + r * kAP + kc);
      uint2 v;
      if (LN) {
        v.x = pack_bf16(ln_apply(a.x, mu[i], rs[i], gw.x, gb.x),
                        ln_apply(a.y, mu[i], rs[i], gw.y, gb.y));
        v.y = pack_bf16(ln_apply(a.z, mu[i], rs[i], gw.z, gb.z),
                        ln_apply(a.w, mu[i], rs[i], gw.w, gb.w));
      } else {
        v.x = pack_bf16(a.x, a.y);
        v.y = pack_bf16(a.z, a.w);
      }
      *reinterpret_cast<uint2*>(dst + r * kBP + kc) = v;
    }
  };

  // ---- epilogue: this lane's four columns of every staged row
  const int gq = lane >> 2, t = lane & 3;
  const int er = lane / kLanesRow, ec = (lane % kLanesRow) * 4;
  const int col = n0 + wn + ec;
  const bool vec = (p.Nout & 3) == 0;  // rows are 16-byte aligned
  float4 b4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec && col < p.Nout) b4 = __ldg(reinterpret_cast<const float4*>(p.bias + col));
  float* cw = Cs + warp * 8 * kCPitch;
  const float* __restrict__ res = p.res;
  float* __restrict__ out = p.out;

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  constexpr int kPasses = 8 / kRowsPass;
  auto epilogue = [&](int m0) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row0 = m0 + wm + i * 16 + h * 8 + er;  // this lane's row of pass 0
        float4 r4[kPasses];  // the residual of this lane's rows, in flight during the staging
#pragma unroll
        for (int pass = 0; pass < kPasses; ++pass) {
          const int row = row0 + pass * kRowsPass;
          r4[pass] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (res != nullptr && vec && row < p.M && col < p.Nout)
            r4[pass] = __ldg(reinterpret_cast<const float4*>(res + (size_t)row * p.Nout + col));
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          *reinterpret_cast<float2*>(cw + gq * kCPitch + j * 8 + 2 * t) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        __syncwarp();
#pragma unroll
        for (int pass = 0; pass < kPasses; ++pass) {
          const int r = pass * kRowsPass + er, row = row0 + pass * kRowsPass;
          float4 v = *reinterpret_cast<const float4*>(cw + r * kCPitch + ec);
          if (row >= p.M) continue;
          const size_t at = (size_t)row * p.Nout + col;
          if (vec) {
            if (col >= p.Nout) continue;
            v.x += b4.x;  // the bias, then the residual
            v.y += b4.y;
            v.z += b4.z;
            v.w += b4.w;
            if (res != nullptr) {
              v.x += r4[pass].x;
              v.y += r4[pass].y;
              v.z += r4[pass].z;
              v.w += r4[pass].w;
            }
            *reinterpret_cast<float4*>(out + at) = v;
          } else {
            const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (col + e >= p.Nout) break;
              float o = e4[e] + p.bias[col + e];
              if (res != nullptr) o += res[at + e];
              out[at + e] = o;
            }
          }
        }
        __syncwarp();
      }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  };

  if (LN) {
    load_stats();
    load_lnw(0);
  }
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) fetch();
  int kstep = 0, m0 = first * BM;
  for (int s = 0; s < total; ++s) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of step s have landed
    convert(s);
    __syncthreads();  // A of step s is converted and B of step s has landed for every
                      // thread, and every warp is done with step s - 1: its slots are free
    fetch();          // step s + STAGES - 1, in flight during the products below
    const T* A = As + (s & 1) * BM * kBP;   // A of step s, in bf16
    const T* Bt = Bs + (s % STAGES) * BN * kBP;
#pragma unroll
    for (int kk = 0; kk < kLinBK; kk += kSK) {
      uint32_t af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4(af[i], A + (wm + i * 16 + (lane & 15)) * kBP + kk + (lane >> 4) * (kSK / 2));
#pragma unroll
      for (int j2 = 0; j2 < NJ / 2; ++j2) {
        uint32_t bfr[4];  // output columns 0-7 (first and second half of the slice), then 8-15
        ldsm_x4(bfr, Bt + (wn + j2 * 16 + (lane & 7) + (lane >> 4) * 8) * kBP + kk +
                         ((lane >> 3) & 1) * (kSK / 2));
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_slice<T>(acc[i][2 * j2], af[i], bfr[0], bfr[1]);
          mma_slice<T>(acc[i][2 * j2 + 1], af[i], bfr[2], bfr[3]);
        }
      }
    }
    if (++kstep == ksteps) {  // the tile is summed: write it while the next one loads
      epilogue(m0);
      kstep = 0;
      m0 += BM;
    }
  }
  cp_async_wait<0>();
}

// One instantiation: the kernel, its shared memory and its threads. `prepare` lets it
// take its shared memory (above 48 KB) and asks for the largest carveout, so that
// MIN_BLOCKS blocks fit on an SM.
template <typename T, int BM, int BN, int WARPS_M, int WARPS_N, int STAGES, int MIN_BLOCKS,
          bool LN>
struct Linear {
  static constexpr int kSmem = linear_smem<T, BM, BN, WARPS_M, WARPS_N, STAGES>();
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr auto kernel =
      linear_kernel<T, BM, BN, WARPS_M, WARPS_N, STAGES, MIN_BLOCKS, LN>;
  static_assert(kSmem <= 227 * 1024, "the tile fits a block's shared memory");

  static cudaError_t prepare() {
    static const cudaError_t err = [] {
      cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
      return e;
    }();
    return err;
  }

  static cudaError_t launch(const LinArgs<T>& p, cudaStream_t st) {
    const cudaError_t err = prepare();
    if (err != cudaSuccess) return err;
    const int mtiles = (p.M + BM - 1) / BM;
    const int groups = (mtiles + p.per - 1) / p.per;
    if (groups > 65535) return cudaErrorInvalidValue;
    const dim3 grid((p.Nout + BN - 1) / BN, groups);  // the column tiles of a row group together
    kernel<<<grid, kThreads, kSmem, st>>>(p);
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

// the bf16 tiles: rows, columns, warps (M x N), stages, blocks an SM. Shared memory 54,
// 73, 182 KB.
template <int TILE, bool LN, typename T>
struct LinearTile;
template <bool LN>
struct LinearTile<0, LN, bf16> : Linear<bf16, 64, 64, 2, 2, 3, 4, LN> {};    // 4 warps of 32 x 32
template <bool LN>
struct LinearTile<1, LN, bf16> : Linear<bf16, 64, 128, 2, 2, 3, 3, LN> {};   // 4 warps of 32 x 64
template <bool LN>
struct LinearTile<2, LN, bf16> : Linear<bf16, 128, 256, 2, 4, 4, 1, LN> {};  // 8 warps of 64 x 64

// the f32 operand path, `linear_wg_kernel` (gemm_f32.cu, built beside this file)
int linear_f32(const LinArgs<float>& p, int tile, int blocks, cudaStream_t st);
int linear_f32_blocks_per_sm(int tile, int ln);

template <int TILE, typename T>
cudaError_t run_linear(const LinArgs<T>& p, cudaStream_t st) {
  return p.stats != nullptr ? LinearTile<TILE, true, T>::launch(p, st)
                            : LinearTile<TILE, false, T>::launch(p, st);
}

template <typename T>
int linear_of(const void* a, const void* w, const void* bias, const void* stats,
              const void* lnw, const void* lnb, const void* res, void* out, int M, int Nout,
              int K, int tile, int per, cudaStream_t st) {
  const LinArgs<T> p{(const float*)a, (const T*)w,       (const float*)bias,
                     (const float*)stats, (const float*)lnw, (const float*)lnb,
                     (const float*)res,   (float*)out,       M, Nout, K, per};
  if constexpr (sizeof(T) == 4) {   // `per` is the number of persistent blocks
    return linear_f32(p, tile, per, st);
  } else {
    switch (tile) {
      case 0: return (int)run_linear<0, T>(p, st);
      case 1: return (int)run_linear<1, T>(p, st);
      case 2: return (int)run_linear<2, T>(p, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
}

template <typename T>
int blocks_of(int tile, int ln) {
  if constexpr (sizeof(T) == 4) {
    return linear_f32_blocks_per_sm(tile, ln);
  } else {
    switch (tile) {
      case 0: return ln ? LinearTile<0, true, T>::blocks_per_sm() : LinearTile<0, false, T>::blocks_per_sm();
      case 1: return ln ? LinearTile<1, true, T>::blocks_per_sm() : LinearTile<1, false, T>::blocks_per_sm();
      case 2: return ln ? LinearTile<2, true, T>::blocks_per_sm() : LinearTile<2, false, T>::blocks_per_sm();
      default: return -1;
    }
  }
}

}  // namespace k1

// out[M, Nout] = LN?(a)[M, K] @ w[Nout, K]^T + bias (+ res). LN is applied when
// `stats` is not null. a, res, out f32; w bf16, or f32 where `f32` is set (the
// operand type of the products); K % 32 == 0; a, res, out, bias and the LN weights
// 16-byte aligned. `tile` and `per` come from the wrapper's plan: bf16, the tile (0: 64 x
// 64, 1: 64 x 128, 2: 128 x 256 outputs a block) and the M tiles a block walks; f32, the
// tile (0: 128 x 64, 1: 128 x 128, 2: 64 x 64) and the number of persistent blocks.
extern "C" int k1_linear(const void* a, const void* w, const void* bias, const void* stats,
                         const void* lnw, const void* lnb, const void* res, void* out,
                         int M, int Nout, int K, int tile, int per, int f32, void* stream) {
  using namespace k1;
  if (M < 1 || Nout < 1 || K < kLinBK || K % kLinBK || per < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return f32 ? linear_of<float>(a, w, bias, stats, lnw, lnb, res, out, M, Nout, K, tile, per, st)
             : linear_of<bf16>(a, w, bias, stats, lnw, lnb, res, out, M, Nout, K, tile, per, st);
}

// Blocks of tile `tile` (with the LayerNorm prologue or without, bf16 or f32 operands)
// that one SM holds at once, as the card reports it; -1 for a tile the kernel lacks.
extern "C" int k1_linear_blocks_per_sm(int tile, int ln, int f32) {
  return f32 ? k1::blocks_of<float>(tile, ln) : k1::blocks_of<k1::bf16>(tile, ln);
}
