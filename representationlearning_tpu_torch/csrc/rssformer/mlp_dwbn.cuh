// K5: the RSSFormer MlpDWBN feed-forward block, as two kernels on the padded hidden
// width HP: fc1 and the taps, each with bf16 operands on `mma.sync` (`fc1_kernel`,
// `taps_kernel`) or f32 operands as 3xTF32 `wgmma` (`fc1_wg_kernel` in
// mlp_dwbn_fc1_f32.cu, `taps_wg_kernel` below). mlp_dwbn.cu holds the C entry points and
// the bf16 instantiations, mlp_dwbn_fc1_f32.cu and mlp_dwbn_taps_f32.cu the f32 ones
// (three sources, so that nvcc builds them side by side).
//
// Replaces: `fused_mlp_dwbn_pallas`
//   (representationlearning_tpu/ops/pallas/mlp_dwbn.py:115, call :132), whose body
//   is `_mlp_math` (:52-82): fc1 + bn1 + GELU, the 19 shifted (N, hid) x (hid, hid)
//   products of the 1x1, 3x3 d6 and 3x3 d12 convolutions + bias + bn2 + GELU, and
//   fc2 + bn3 + GELU, with bf16 or f32 operands (its `dtype`, f32 by default) and f32
//   sums, at any hidden width (it takes whole arrays as blocks).
// What bounds it on the H100: operations. At (4, 16384, 32), hid 128, out 32 a call
//   is 2 * 65536 * 128 * (32 + 19 * 128 + 32) = 41.9 GFLOP of tensor-core work
//   against about 18 MB of input, output and weights; in f32 each product is three
//   TF32 products, at half the bf16 rate each.
// What the design does about it: the Pallas kernel holds one whole image, its
//   hidden plane and a copy padded by 12 in VMEM; a Hopper block has 227 KB, and a
//   tile with a halo of 12 would compute fc1 several times over. So `fc1_kernel`
//   writes the hidden plane once, in the operand type (the TPU kernel rounds it to bf16 at each of
//   its 19 uses under bf16: the same rounding, done once), 16.8 MB at hid 128 in bf16
//   that stay in the 50 MB L2.
//
//   Widths. HRNetV2's transformer block runs K5 at hid = 4 dim, dim 18 / 32 / 40 / 48
//   (hid 72 / 128 / 160 / 192). The kernels take HP, hid rounded up to a multiple of
//   32 (96 / 128 / 160 / 192), and the wrapper pads the weights and the six vectors
//   with zeros: a padded hidden feature is gelu(0 * s + 0) = 0 after fc1 and after the
//   taps, and its weight columns in the taps and in fc2 are 0, so padding changes no
//   output. x keeps its cin columns in device memory (rows of 18 f32 are not 16-byte
//   aligned: the bf16 fc1 copies them by 4 bytes), and its rows are padded with zeros to
//   cinp, cin rounded up to 16, in shared memory; fc2 runs over coutp, cout rounded up
//   to 16, and stores only the cout columns.
//
//   `fc1_kernel` (bf16 operands; f32 runs `fc1_wg_kernel`, its note in
//   mlp_dwbn_fc1_f32.cu) alone is bound by bytes (x f32 in, h bf16 out: 25.2 MB a launch at
//   the predict shape, 7.5 us), but its GELU costs as much in instructions (about
//   30 an element over 8.4 M elements: 8 us of the card's issue slots at best).
//   Persistent blocks (grid from the wrapper's `fc1_plan`) walk 16-row tiles, one a
//   warp a step; each warp streams its x tiles through a `cp.async` ring of its
//   own, so loads overlap the products and the epilogue with no block barrier; w1
//   is copied to shared memory once a block and read by `ldmatrix` (its fragments
//   held in registers for the whole walk capped the warps an SM holds and were
//   slower, PERF.md). A fragments are built from f32 with round-to-nearest bf16
//   conversion, as the plain version's `.to(bf16)`. A warp finishes its 16 rows in two halves of
//   HP / 2 features: the epilogue works on the accumulator registers (bias, bn1, a
//   branch-free GELU, bf16 pairs), stages the half rows in shared memory and writes
//   them as whole rows with 16-byte stores. Every plan computes each output by the
//   same instructions: equal bits.
//
//   `taps_kernel` (bf16 operands; f32 runs `taps_wg_kernel`, its note further down) is
//   an implicit GEMM bound by its products (37.8 GFLOP of in-plane taps a launch at
//   the predict shape, hid 128, 38 us at the card's bf16 peak);
//   behind them come the copies into shared memory: each tile of tokens reads all 19
//   tap matrices (B) and its own rows once a tap (A). Persistent blocks (grid from the
//   wrapper's `taps_plan`) walk tiles of 128 or 256 consecutive tokens, all HP hidden
//   features a tile (a larger tile reads B half as often; above HP 128 the
//   accumulators of two 16-row tiles a warp do not fit the registers, so 128 only);
//   eight warps own 16 or 32 rows each and all HP features of them. The K steps, tap
//   then chunk of BK features (a row of 64 or 128 bytes), run through a `cp.async`
//   ring of 3-4 stages with one barrier a step; a step's copies go in parts, one amid
//   the products of each k slice of the step before the one they feed, and the ring
//   runs on across the tiles of a block, so the next tile's first steps load while
//   this one's epilogue runs. A row of A is the row of h the tap shifts to, zeros
//   outside [0, M) (`cp.async` with a source size of 0: no padded copy); the rows
//   that lie outside the plane are masked out of the A fragments, from one mask of
//   in-plane taps a fragment row, made once a tile. Products are `ldmatrix` +
//   `mma_slice` with f32 sums, the next k slice's fragments loading while this one's
//   products run. The epilogue works on the accumulator registers: bias + bn2 + GELU
//   in bf16, which are, as they stand, the A fragments of fc2 (adjacent n8 tiles make
//   one k16 fragment); fc2's weight and the six vectors wait in shared memory, bn3 +
//   GELU apply to fc2's
//   accumulators, and a swap between lane pairs makes whole 16-byte pieces of the f32
//   output (scalar stores where cout is no multiple of 4). The second hidden plane
//   never leaves the registers. Every plan computes each output by the same
//   instructions in the same order: equal bits.
#pragma once

#include "../hopper/wgmma.cuh"
#include "common.cuh"

namespace rss {

constexpr int kTaps = 19;
constexpr int kSmemLimit = 232448;         // dynamic shared memory a block may have

// (dy, dx) of tap t in the order of `_mlp_math`: the 1x1, then d = 6 and d = 12
// over (ky, kx).
__device__ __forceinline__ void tap_offset(int tap, int& dy, int& dx) {
  if (tap == 0) {
    dy = dx = 0;
    return;
  }
  const int t = tap - 1;
  const int d = t < 9 ? 6 : 12;
  const int k = t < 9 ? t : t - 9;
  dy = (k / 3 - 1) * d;
  dx = (k % 3 - 1) * d;
}

// ---- fc1 with bf16 operands: h[M, HP] (bf16) = gelu(bn1(x[M, cin] @ w1[HP, cinp]^T + b1))
//
// A persistent grid: the wrapper's `fc1_plan` gives the warps a block and the steps
// `per` it walks; a step of a block is warps x 16 consecutive rows, one m16 tile a
// warp, and the blocks take consecutive runs of steps. Each warp streams its own
// tiles of x through a ring of two slots by `cp.async` (no block barrier in the
// walk), so the next tile loads while this one is multiplied and written. w1 and the
// three vectors come to shared memory once a block. A warp finishes its tile in two
// halves of HP / 2 features: half the accumulators a lane leave the compiler
// registers to overlap more GELUs (measured faster at HP 128, PERF.md).
constexpr int kFc1Rows = 16;               // rows of x a warp takes a step
constexpr int kFc1MaxWarps = 8;
constexpr int kFc1Stages = 2;

struct Fc1Args {
  const float* x;
  const bf16* w1;
  const float* b1;
  const float* s1;
  const float* t1;
  bf16* h;
  int M, cin, cinp, per;
};

// f32 pitch of the x ring (A fragments read float2 pairs from it)
__host__ __device__ constexpr int fc1_xpitch(int cinp) { return cinp + 8; }
// bf16 pitch of w1 in shared memory
__host__ __device__ constexpr int fc1_wpitch(int cinp) { return cinp + kPadE<bf16>; }
// 32-bit words of a warp's staged half row
template <int HP>
constexpr int kFc1StagePitch = (HP / 2) * 2 / 4 + 4;

// bytes of dynamic shared memory: b1, s1, t1; each warp's ring of f32 x tiles and its
// staged half rows; w1 in bf16
template <int HP>
inline int fc1_smem(int cinp, int warps) {
  return 3 * HP * 4 +
         warps * (kFc1Stages * kFc1Rows * fc1_xpitch(cinp) * 4 + kFc1Rows * kFc1StagePitch<HP> * 4) +
         HP * fc1_wpitch(cinp) * 2;
}

template <int HP>
__global__ void __launch_bounds__(32 * kFc1MaxWarps, 2) fc1_kernel(const Fc1Args p) {
  constexpr int FH = HP / 2, NJ = FH / 8;  // features a warp finishes at a time, n8 tiles
  constexpr int kSK = kSliceK<bf16>, kE = 8;
  constexpr int SP = kFc1StagePitch<HP>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int cin = p.cin, cinp = p.cinp, ks = cinp / kSK;
  const int xp = fc1_xpitch(cinp), wp = fc1_wpitch(cinp);
  float* vec = reinterpret_cast<float*>(smem);                              // b1, s1, t1
  const int per_warp = kFc1Stages * kFc1Rows * xp + kFc1Rows * SP;           // in 4 bytes
  float* ring = vec + 3 * HP + warp * per_warp;
  uint32_t* staged = reinterpret_cast<uint32_t*>(ring + kFc1Stages * kFc1Rows * xp);
  bf16* ws = reinterpret_cast<bf16*>(vec + 3 * HP + warps * per_warp);

  for (int i = threadIdx.x; i < HP * cinp / kE; i += blockDim.x) {
    const int n = i / (cinp / kE), c = (i - n * (cinp / kE)) * kE;
    cp_async16(ws + n * wp + c, p.w1 + (size_t)n * cinp + c);
  }
  for (int i = threadIdx.x; i < 3 * HP / 4; i += blockDim.x) {
    const float* v = i < HP / 4 ? p.b1 : (i < HP / 2 ? p.s1 : p.t1);
    cp_async16(vec + 4 * i, v + 4 * (i % (HP / 4)));
  }
  cp_async_commit();

  // the warp's i-th tile: rows [16 tile, 16 tile + 16) with
  // tile = (blockIdx.x * per + i) * warps + warp; rows past M and columns past cin
  // read as zeros
  const int tiles = (p.M + kFc1Rows - 1) / kFc1Rows;
  auto tile_of = [&](int i) { return (blockIdx.x * p.per + i) * warps + warp; };
  const bool whole = (cin & 3) == 0;  // rows of x are 16-byte aligned
  auto load = [&](int i) {
    const int tile = tile_of(i);
    if (i < p.per && tile < tiles) {
      float* dst = ring + (i % kFc1Stages) * kFc1Rows * xp;
      const int row0 = tile * kFc1Rows;
      if (whole) {
        const int q4 = cinp / 4;
        for (int q = lane; q < kFc1Rows * q4; q += 32) {
          const int r = q / q4, c = (q - r * q4) * 4;
          const bool ok = row0 + r < p.M && c < cin;
          cp_async16(dst + r * xp + c, ok ? p.x + (size_t)(row0 + r) * cin + c : p.x, ok ? 16 : 0);
        }
      } else {
        for (int q = lane; q < kFc1Rows * cinp; q += 32) {
          const int r = q / cinp, c = q - r * cinp;
          const bool ok = row0 + r < p.M && c < cin;
          cp_async4z(dst + r * xp + c, ok ? p.x + (size_t)(row0 + r) * cin + c : p.x, ok);
        }
      }
    }
    cp_async_commit();   // an empty group past the walk keeps the count of groups uniform
  };
  load(0);
  cp_async_wait<1>();   // w1 and the vectors
  __syncthreads();

  // ldmatrix.x4 of w1 rows [n0, n0 + 16) x one k slice: b0, b1 of n tiles n0 / 8 and
  // n0 / 8 + 1
  const bf16* wl = ws + ((lane / 16) * 8 + lane % 8) * wp + ((lane / 8) % 2) * (kSK / 2);

  for (int i = 0; i < p.per; ++i) {
    load(i + 1);   // into the slot this warp emptied a step ago
    cp_async_wait<1>();
    __syncwarp();
    const int tile = tile_of(i);
    if (tile >= tiles) break;   // the grid's last steps may lie past M
    const float* xs = ring + (i % kFc1Stages) * kFc1Rows * xp;
    const int row0 = tile * kFc1Rows;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float acc[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int k = 0; k < ks; ++k) {
        // A from f32, rounded to nearest bf16 as the plain version's .to(bf16)
        uint32_t af[4];
        const float* ak = xs + g * xp + 2 * t + 16 * k;
        const float2 v0 = *reinterpret_cast<const float2*>(ak);
        const float2 v1 = *reinterpret_cast<const float2*>(ak + 8 * xp);
        const float2 v2 = *reinterpret_cast<const float2*>(ak + 8);
        const float2 v3 = *reinterpret_cast<const float2*>(ak + 8 * xp + 8);
        af[0] = pack_bf16(v0.x, v0.y);
        af[1] = pack_bf16(v1.x, v1.y);
        af[2] = pack_bf16(v2.x, v2.y);
        af[3] = pack_bf16(v3.x, v3.y);
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          uint32_t r[4];
          ldsm_x4(r, wl + (FH * half + 8 * j) * wp + kSK * k);
          mma_slice<bf16>(acc[j], af, r[0], r[1]);
          mma_slice<bf16>(acc[j + 1], af, r[2], r[3]);
        }
      }
      // epilogue from the accumulators: (acc + b1) s1 + t1, GELU, bf16 pairs staged as
      // half rows; then they leave as whole rows with 16-byte stores
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = FH * half + 8 * j + 2 * t;
        const float2 b = *reinterpret_cast<const float2*>(vec + col);
        const float2 s = *reinterpret_cast<const float2*>(vec + HP + col);
        const float2 sh = *reinterpret_cast<const float2*>(vec + 2 * HP + col);
        const float e0 = bias_bn_gelu(acc[j][0], b.x, s.x, sh.x);
        const float e1 = bias_bn_gelu(acc[j][1], b.y, s.y, sh.y);
        const float e2 = bias_bn_gelu(acc[j][2], b.x, s.x, sh.x);
        const float e3 = bias_bn_gelu(acc[j][3], b.y, s.y, sh.y);
        staged[g * SP + 4 * j + t] = pack_bf16(e0, e1);
        staged[(g + 8) * SP + 4 * j + t] = pack_bf16(e2, e3);
      }
      __syncwarp();
      constexpr int PR = FH * 2 / 16;   // 16-byte pieces of a half row
#pragma unroll
      for (int q = lane; q < kFc1Rows * PR; q += 32) {
        const int r = q / PR, c = q - r * PR;
        if (row0 + r < p.M)
          *reinterpret_cast<uint4*>(p.h + (size_t)(row0 + r) * HP + FH * half + c * kE) =
              *reinterpret_cast<const uint4*>(staged + r * SP + 4 * c);
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();
}

// lets the kernel take `smem` bytes of dynamic shared memory: once per process,
// instantiation and size (a larger grant covers every smaller one)
template <int HP>
inline cudaError_t fc1_prepare(int smem) {
  static int granted = 48 * 1024;
  if (smem <= granted) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(fc1_kernel<HP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) granted = smem;
  return err;
}

template <int HP>
inline bool fc1_takes(int cin, int cinp, int warps) {
  return cin >= 1 && cinp >= cin && cinp < cin + 16 && cinp <= 256 && cinp % 16 == 0 &&
         warps >= 1 && warps <= kFc1MaxWarps && fc1_smem<HP>(cinp, warps) <= kSmemLimit;
}

// fc1 at HP: launch, or, with `held` given, store there the blocks of that many warps an
// SM holds and launch nothing
template <int HP>
int fc1_at(const Fc1Args& p, int warps, cudaStream_t st, int* held) {
  if (!fc1_takes<HP>(p.cin, p.cinp, warps)) return (int)cudaErrorInvalidValue;
  const int smem = fc1_smem<HP>(p.cinp, warps);
  cudaError_t err = fc1_prepare<HP>(smem);
  if (err != cudaSuccess) return (int)err;
  if (held != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(held, fc1_kernel<HP>, 32 * warps,
                                                              smem);
  const int steps = ((p.M + kFc1Rows - 1) / kFc1Rows + warps - 1) / warps;
  fc1_kernel<HP><<<(steps + p.per - 1) / p.per, 32 * warps, smem, st>>>(p);
  return (int)cudaGetLastError();
}

inline int fc1_run(const Fc1Args& p, int hp, int warps, cudaStream_t st, int* held) {
  switch (hp) {
    case 96: return fc1_at<96>(p, warps, st, held);
    case 128: return fc1_at<128>(p, warps, st, held);
    case 160: return fc1_at<160>(p, warps, st, held);
    case 192: return fc1_at<192>(p, warps, st, held);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- fc1 with f32 operands (`fc1_wg_kernel`, built in mlp_dwbn_fc1_f32.cu): the same
// function, h in f32. x (M, cin) f32, 16-byte aligned where cin % 4 == 0 and 4-byte
// aligned otherwise; w1 (hp, cinp) and the vectors 16-byte aligned. The plan is (tile,
// blocks): the block's tile of hidden features (hp, or 32) and its blocks a tile of
// features; the grid is blocks x (hp / tile).
struct Fc1F32Args {
  const float* x;
  const float* w1;
  const float* b1;
  const float* s1;
  const float* t1;
  float* h;
  int M, cin, cinp, hp;
};
// launch, or, with `held` given, store there the blocks of that tile an SM holds
int fc1_f32_run(const Fc1F32Args& p, int tile, int blocks, cudaStream_t st, int* held);

// ---- taps: out[M, cout] = gelu(bn3(gelu(bn2(sum_t shift_t(h) @ taps[t]^T + dwb)) @ w2^T + b2))
//
// M = B * N tokens on (H, W) grids; h (M, HP) T; taps (19, HP, HP) T as (out, in);
// w2 (coutp, HP) T; coutp % 16 == 0, coutp <= kTapsCoutMax. The wrapper's `taps_plan`
// gives the tile (16 MI rows a warp, eight warps; the ring's stages follow from it)
// and the blocks; block b takes the tiles b, b + blocks, b + 2 blocks, ...
constexpr int kTapsWarps = 8;
constexpr int kTapsThreads = 32 * kTapsWarps;

// K step: a tap's chunk of BK features, a row of 128 bytes where HP allows it (64 bf16,
// 32 f32), else 64 bytes (32 bf16)
template <typename T, int HP>
constexpr int kTapsBK = sizeof(T) == 2 && HP % 64 == 0 ? 64 : 32;
// rows of fc2's weight that shared memory holds: every output of HP 128 in bf16 (the
// kernel's first width), 64 elsewhere (JAX's models take cout = hid / 4)
template <typename T, int HP>
constexpr int kTapsCoutMax = sizeof(T) == 2 && HP == 128 ? 128 : 64;

template <typename T>
struct TapsArgs {
  const T* h;
  const T* taps;
  const float* dwb;
  const float* s2;
  const float* t2;
  const T* w2;
  const float* b2;
  const float* s3;
  const float* t3;
  float* out;
  int M, N, H, W, cout, coutp, tiles;
};

// bytes of dynamic shared memory: `stages` slots of A (tile rows) and B (HP rows),
// each row BK elements and 16 bytes; fc2's weight and the six f32 vectors
template <typename T, int HP>
constexpr int taps_smem(int tile, int stages) {
  return stages * (tile + HP) * (kTapsBK<T, HP> * (int)sizeof(T) + 16) +
         kTapsCoutMax<T, HP> * (HP * (int)sizeof(T) + 16) + 6 * HP * 4;
}
// slots of the ring: four where they fit beside the epilogue's constants, else three
template <typename T, int HP>
constexpr int taps_stages(int tile) {
  return taps_smem<T, HP>(tile, 4) <= kSmemLimit ? 4 : 3;
}

template <typename T, int HP, int MI, int STAGES>
__global__ void __launch_bounds__(kTapsThreads, 1) taps_kernel(const TapsArgs<T> p) {
  constexpr int BK = kTapsBK<T, HP>, kSK = kSliceK<T>, kSlices = BK / kSK;
  constexpr int kLd = BK + kPadE<T>;       // row pitch of the stages, in elements
  constexpr int kLdW = HP + kPadE<T>;      // row pitch of fc2's weight
  constexpr int NT2 = HP / 16;             // pairs of n8 tiles of the hidden features
  constexpr int kChunks = HP / BK, kSteps = kTaps * kChunks;
  constexpr int BM = 16 * MI * kTapsWarps;             // tokens a tile
  constexpr int kE = 16 / (int)sizeof(T);              // elements of a 16-byte piece
  constexpr int kPieces = BK / kE;                     // pieces of a step's row
  constexpr int kRowsPass = kTapsThreads / kPieces;    // rows the block copies at once
  constexpr int RA = BM / kRowsPass;                   // A rows a thread copies a step
  constexpr int RB = (HP + kRowsPass - 1) / kRowsPass; // B rows (the last pass in part)
  constexpr int kFs = HP / kSK;                        // k slices of fc2
  constexpr int kA = BM * kLd, kB = HP * kLd;
  static_assert(HP % BK == 0 && kSlices % 2 == 0 && STAGES >= 3 && BM % kRowsPass == 0,
                "taps geometry");
  static_assert(sizeof(T) == 2, "bf16 operands: f32 runs taps_wg_kernel");
  extern __shared__ __align__(128) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);            // [STAGES][BM][kLd]
  T* Bs = As + STAGES * kA;                      // [STAGES][HP][kLd]
  T* w2s = Bs + STAGES * kB;                     // [kTapsCoutMax][kLdW]
  float* vec = reinterpret_cast<float*>(w2s + kTapsCoutMax<T, HP> * kLdW);  // dwb s2 t2, b2 s3 t3
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int c8 = (tid % kPieces) * kE, r0 = tid / kPieces;  // rows r0 + kRowsPass i, piece c8

  // ---- the copies: step f of the block's walk is tap (f % kSteps) / kChunks, chunk
  // f % kChunks of the block's (f / kSteps)-th tile. A row of A is the token shifted by
  // the tap as it lies in device memory, zeros outside [0, M); what lies outside the
  // plane is masked out of the fragments below. A step's copies go in kSlices parts,
  // one amid the products of each k slice of the step being multiplied, so that the
  // tensor cores never wait for a warp's whole share of copies.
  const int my_tiles = (int)blockIdx.x < p.tiles ? (p.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = my_tiles * kSteps;
  int f = 0, f_slot = 0, f_it = 0, f_m0 = blockIdx.x * BM, f_row = 0;
  const T* f_a = p.h;      // A source of row r0 of step f
  const T* f_b = p.taps;   // B source of row r0 of step f
  auto fetch_part = [&](int q) {
    if (f < total) {
      if (q == 0) {
        int dy, dx;
        tap_offset(f_it / kChunks, dy, dx);
        const int k0 = (f_it % kChunks) * BK + c8;
        f_row = f_m0 + r0 + dy * p.W + dx;
        f_a = p.h + (ptrdiff_t)f_row * HP + k0;   // read only for rows inside [0, M)
        f_b = p.taps + ((size_t)(f_it / kChunks) * HP + r0) * HP + k0;
      }
      T* a = As + f_slot * kA + r0 * kLd + c8;
      T* b = Bs + f_slot * kB + r0 * kLd + c8;
#pragma unroll
      for (int i = q * RA / kSlices; i < (q + 1) * RA / kSlices; ++i) {
        const bool ok = (unsigned)(f_row + kRowsPass * i) < (unsigned)p.M;
        cp_async16(a + kRowsPass * i * kLd, ok ? f_a + (ptrdiff_t)kRowsPass * i * HP : p.h,
                   ok ? 16 : 0);
      }
#pragma unroll
      for (int i = q * RB / kSlices; i < (q + 1) * RB / kSlices; ++i)
        if (HP % kRowsPass == 0 || r0 + kRowsPass * i < HP)
          cp_async16(b + kRowsPass * i * kLd, f_b + (size_t)kRowsPass * i * HP);
      if (q == kSlices - 1 && ++f_it == kSteps) {
        f_it = 0;
        f_m0 += gridDim.x * BM;
      }
    }
    if (q == kSlices - 1) {
      cp_async_commit();   // an empty group past the walk keeps the count of groups uniform
      ++f;
      f_slot = f_slot + 1 == STAGES ? 0 : f_slot + 1;
    }
  };

  float acc[MI][HP / 8][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < HP / 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // ---- the epilogue of the tile at m0, from the accumulators of this warp's rows
  // wm + 16 i + g and + 8
  const int wm = warp * 16 * MI;
  auto epilogue = [&](int m0) {
    // bias + bn2 + GELU in bf16: fc2's A fragment of k slice u, n8 tiles 2u and 2u + 1
    // (hidden features 16u .. 16u + 15)
    uint32_t ha[MI][kFs][4];
#pragma unroll
    for (int j = 0; j < HP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 bb = *reinterpret_cast<const float2*>(vec + col);
      const float2 ss = *reinterpret_cast<const float2*>(vec + HP + col);
      const float2 sh = *reinterpret_cast<const float2*>(vec + 2 * HP + col);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float e0 = bias_bn_gelu(acc[i][j][0], bb.x, ss.x, sh.x);
        const float e1 = bias_bn_gelu(acc[i][j][1], bb.y, ss.y, sh.y);
        const float e2 = bias_bn_gelu(acc[i][j][2], bb.x, ss.x, sh.x);
        const float e3 = bias_bn_gelu(acc[i][j][3], bb.y, ss.y, sh.y);
        ha[i][j / 2][2 * (j % 2)] = pack_bf16(e0, e1);
        ha[i][j / 2][2 * (j % 2) + 1] = pack_bf16(e2, e3);
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
      }
    }
    // fc2, 16 output features at a time, its weight from shared memory
    const bool whole = (p.cout & 3) == 0;   // rows of the output are 16-byte aligned
    for (int n0 = 0; n0 < p.coutp; n0 += 16) {
      float o[MI][2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) o[i][h2][0] = o[i][h2][1] = o[i][h2][2] = o[i][h2][3] = 0.f;
      const T* wl = w2s + (n0 + (lane & 7) + (lane >> 4) * 8) * kLdW + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int u = 0; u < kFs; ++u) {
        uint32_t wb[4];   // outputs n0 .. + 7 (k 0-7, 8-15), then n0 + 8 .. + 15
        ldsm_x4(wb, wl + 16 * u);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_slice<T>(o[i][0], ha[i][u], wb[0], wb[1]);
          mma_slice<T>(o[i][1], ha[i][u], wb[2], wb[3]);
        }
      }
      // bn3 + GELU; lanes t and t ^ 1 swap pairs, so that an even t holds columns
      // 2t .. 2t + 3 of row g and an odd t columns 2t - 2 .. 2t + 1 of row g + 8
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int col = n0 + 8 * h2 + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(vec + 3 * HP + col);
        const float2 ss = *reinterpret_cast<const float2*>(vec + 4 * HP + col);
        const float2 sh = *reinterpret_cast<const float2*>(vec + 5 * HP + col);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const float v0 = bias_bn_gelu(o[i][h2][0], bb.x, ss.x, sh.x);
          const float v1 = bias_bn_gelu(o[i][h2][1], bb.y, ss.y, sh.y);
          const float v2 = bias_bn_gelu(o[i][h2][2], bb.x, ss.x, sh.x);
          const float v3 = bias_bn_gelu(o[i][h2][3], bb.y, ss.y, sh.y);
          const int rg = m0 + wm + 16 * i + g;
          if (!whole) {   // scalar stores of the columns below cout
            const float e[4] = {v0, v1, v2, v3};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int row = rg + (k >> 1) * 8, c = col + (k & 1);
              if (row < p.M && c < p.cout) p.out[(size_t)row * p.cout + c] = e[k];
            }
            continue;
          }
          const bool odd = t & 1;
          const float s0 = __shfl_xor_sync(0xffffffffu, odd ? v0 : v2, 1);
          const float s1 = __shfl_xor_sync(0xffffffffu, odd ? v1 : v3, 1);
          const int row = rg + (odd ? 8 : 0), c4 = col - (odd ? 2 : 0);
          if (row < p.M && c4 < p.cout)
            *reinterpret_cast<float4*>(p.out + (size_t)row * p.cout + c4) =
                odd ? make_float4(s0, s1, v2, v3) : make_float4(v0, v1, s0, s1);
        }
      }
    }
  };

  // ---- the products: the fragments of the next k slice (the next step's first, at a
  // step's last slice) load from shared memory while this slice's products run. Bit tap
  // of `in_plane[i][h]` is set where this lane's row 16 i + g + 8 h of the tile reads
  // inside the plane at that tap; the A fragments of the other rows are zeroed.
  uint32_t in_plane[MI][2];
  auto plane_masks = [&](int m0) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = (m0 + wm + 16 * i + g + 8 * h) % p.N, y = n / p.W, x = n - y * p.W;
        uint32_t m = 0;
#pragma unroll
        for (int tap = 0; tap < kTaps; ++tap) {
          int dy, dx;
          tap_offset(tap, dy, dx);
          m |= (uint32_t)(y + dy >= 0 && y + dy < p.H && x + dx >= 0 && x + dx < p.W) << tap;
        }
        in_plane[i][h] = m;
      }
  };
  uint32_t af[2][MI][4], bfr[2][NT2][4];
  auto load_frags = [&](int buf, int slot, int kk, int tap) {
    const T* A = As + slot * kA + kk;
    const T* Bt = Bs + slot * kB + kk;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      ldsm_x4(af[buf][i], A + (wm + 16 * i + (lane & 15)) * kLd + (lane >> 4) * (kSK / 2));
      const uint32_t keep_g = 0u - ((in_plane[i][0] >> tap) & 1u);   // row g
      const uint32_t keep_g8 = 0u - ((in_plane[i][1] >> tap) & 1u);  // row g + 8
      af[buf][i][0] &= keep_g;
      af[buf][i][1] &= keep_g8;
      af[buf][i][2] &= keep_g;
      af[buf][i][3] &= keep_g8;
    }
#pragma unroll
    for (int j2 = 0; j2 < NT2; ++j2)   // features 16 j2 .. + 7 (both halves of the slice), then + 8 .. + 15
      ldsm_x4(bfr[buf][j2], Bt + (16 * j2 + (lane & 7) + (lane >> 4) * 8) * kLd +
                                ((lane >> 3) & 1) * (kSK / 2));
  };

  // the epilogue's constants travel with step 0's copies
  for (int i = tid; i < p.coutp * (HP / kE); i += kTapsThreads) {
    const int n = i / (HP / kE), c = (i % (HP / kE)) * kE;
    cp_async16(w2s + n * kLdW + c, p.w2 + (size_t)n * HP + c);
  }
  for (int i = tid; i < 6 * HP / 4; i += kTapsThreads) {
    const int v = i / (HP / 4), c = (i % (HP / 4)) * 4;
    const float* src = v == 0 ? p.dwb : v == 1 ? p.s2 : v == 2 ? p.t2
                     : v == 3 ? p.b2 : v == 4 ? p.s3 : p.t3;
    if (v < 3 || c < p.coutp) cp_async16(vec + v * HP + c, src + c);
  }
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i)
#pragma unroll
    for (int q = 0; q < kSlices; ++q) fetch_part(q);
  if (total > 0) {
    cp_async_wait<STAGES - 2>();   // step 0
    __syncthreads();
    plane_masks(blockIdx.x * BM);
    load_frags(0, 0, 0, 0);
  }
  int slot = 0;   // of the step being multiplied, s in the notes below
  for (int k = 0, m0 = blockIdx.x * BM; k < my_tiles; ++k, m0 += gridDim.x * BM) {
    for (int st = 0; st < kSteps; ++st) {
      const int next = slot + 1 == STAGES ? 0 : slot + 1;
#pragma unroll
      for (int kk = 0; kk < kSlices; ++kk) {
        const int cur = kk % 2;
        if (kk + 1 < kSlices) {
          load_frags(cur ^ 1, slot, kSK * (kk + 1), st / kChunks);
        } else {
          // step s + 1: this thread's copies have landed (all but the STAGES - 3 groups
          // committed after its), then every thread's
          cp_async_wait<STAGES - 3>();
          __syncthreads();   // also: every warp has left step s - 1's slot (its last
                             // fragments were loaded at the step's last slice but one)
          if (st + 1 < kSteps) load_frags(0, next, 0, (st + 1) / kChunks);
        }
#pragma unroll
        for (int j2 = 0; j2 < NT2; ++j2) {
          // a part of step s + STAGES - 1's copies, into the slot of step s - 1
          if (j2 == NT2 / 2) fetch_part(kk);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            mma_slice<T>(acc[i][2 * j2], af[cur][i], bfr[cur][j2][0], bfr[cur][j2][1]);
            mma_slice<T>(acc[i][2 * j2 + 1], af[cur][i], bfr[cur][j2][2], bfr[cur][j2][3]);
          }
        }
      }
      slot = next;
    }
    epilogue(m0);   // the tile is summed: finish it while the next one loads
    if (k + 1 < my_tiles) {
      plane_masks(m0 + gridDim.x * BM);
      load_frags(0, slot, 0, 0);
    }
  }
  cp_async_wait<0>();
}

// One instantiation (MI = tile / 128): its shared memory allowed once per process, its
// launch, or, with `held` given, the blocks an SM holds
template <typename T, int HP, int MI>
struct Taps {
  static constexpr int kTile = 128 * MI;
  static constexpr int kStages = taps_stages<T, HP>(kTile);
  static constexpr int kSmem = taps_smem<T, HP>(kTile, kStages);
  static_assert(kSmem <= kSmemLimit, "the tile fits a block's shared memory");

  static cudaError_t prepare() {
    static const cudaError_t err = cudaFuncSetAttribute(
        taps_kernel<T, HP, MI, kStages>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    return err;
  }
  static int run(const TapsArgs<T>& p, int blocks, cudaStream_t st, int* held) {
    const cudaError_t err = prepare();
    if (err != cudaSuccess) return (int)err;
    if (held != nullptr)
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          held, taps_kernel<T, HP, MI, kStages>, kTapsThreads, kSmem);
    if (p.coutp > kTapsCoutMax<T, HP>) return (int)cudaErrorInvalidValue;
    taps_kernel<T, HP, MI, kStages><<<blocks, kTapsThreads, kSmem, st>>>(p);
    return (int)cudaGetLastError();
  }
};

// ---- taps with f32 operands: 3xTF32 `wgmma` (sm_90a), the building blocks of
// csrc/hopper/wgmma.cuh
//
// A block is three warpgroups: two consumers of 64 tokens each (a tile of 128), one
// producer. The producer walks the block's steps (tile, tap, chunk of kWgBK hidden
// features) in the bf16 kernel's order. Its first thread waits for the ring's slot to be
// empty and starts two tensor-map copies into it: the tile's rows shifted by the tap (a
// 2-d map over (M, HP): rows outside [0, M), negative ones too, arrive as zeros) and the
// tap matrix's HP rows of the chunk (a map over (19 HP, HP)). Its warps 1-3 follow: once a
// copy has landed they write the TF32 small half of the tap matrix's chunk into the
// slot's second B buffer and arrive on the slot's ready barrier. A consumer warp
// loads its 16 rows of A from the slot by `ldmatrix` (the swizzle makes it conflict-free),
// zeroes the rows that the tap takes outside the plane (the bf16 kernel's mask of in-plane
// taps), splits them, waits for the tap matrix's small half and issues the three
// products of each k slice as m64nHPk8 `wgmma`s with B from the slot, half a step (two k
// slices) a commit group; it releases the slot once both halves have completed, while the next half is in flight (two register sets of
// A, `wgmma.wait_group 1`). The epilogue is the bf16 kernel's, a warp on its 16 rows:
// bias + bn2 + GELU from the accumulators (the m64nN accumulator of a warp is the m16n8
// layout of `mma.sync`, n8 tile after n8 tile), which become fc2's TF32 A fragments as
// they lie; fc2 (1 / 20 of the products at cout = hid / 4) stays on 3xTF32 `mma.sync`,
// its weight and the six vectors read through L1 (the ring takes the shared memory), then
// bn3 + GELU and the stores. The producer walks on into the next tile while the
// consumers finish this one. `setmaxnreg` gives the consumers 232 registers a thread and
// the producer 40 (the accumulators of HP 192 and fc2's fragments fit without spilling).
constexpr int kTwgTile = 128;       // tokens a tile
constexpr int kTwgThreads = 384;    // warpgroups: two consumers, then the producer
constexpr int kTwgMaxStages = 8;
constexpr int kTwgRegs = 168;       // registers a thread at launch (65536 / 384, rounded to 8)

template <int HP>
__host__ __device__ constexpr int twg_stage_bytes() {   // A, the tap matrix's chunk big and small
  return (kTwgTile + 2 * HP) * hop::kWgRowBytes;
}
template <int HP>
__host__ __device__ constexpr int twg_stages() {   // the barriers and 1 KB of alignment aside
  const int s = (kSmemLimit - 1024 - 3 * 8 * kTwgMaxStages) / twg_stage_bytes<HP>();
  return s > kTwgMaxStages ? kTwgMaxStages : s;
}
template <int HP>
__host__ __device__ constexpr int twg_smem() {
  return 1024 + 3 * 8 * kTwgMaxStages + twg_stages<HP>() * twg_stage_bytes<HP>();
}

template <int HP>
__global__ void __launch_bounds__(kTwgThreads, 1)
taps_wg_kernel(const TapsArgs<float> p, const __grid_constant__ CUtensorMap hmap,
               const __grid_constant__ CUtensorMap tmap) {
  using namespace hop;
  constexpr int S = twg_stages<HP>();
  constexpr int kChunks = HP / kWgBK, kSteps = kTaps * kChunks;
  constexpr int kA = kTwgTile * kWgRowBytes, kB = HP * kWgRowBytes, kStage = kA + 2 * kB;
  constexpr int kHalf = kWgBK / 16;                 // k slices a half step
  constexpr int kFs = HP / 8;                       // k slices of fc2
  static_assert(S >= 3 && HP % kWgBK == 0 && kWgBK % 16 == 0, "taps geometry");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t full0 = smem_u32(smem + S * kStage), ready0 = full0 + 8 * S,
                 empty0 = ready0 + 8 * S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int my_tiles = (int)blockIdx.x < p.tiles ? (p.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = my_tiles * kSteps;
  if (tid == 256) {   // the producer's copying thread
    tensormap_prefetch(&hmap);
    tensormap_prefetch(&tmap);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(ready0 + 8 * s, kWgSplitThreads);
      mbar_init(empty0 + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {   // ---- the producer warpgroup
    regs_dec<40>();
    if (warp == 8) {   // the copies
      if (lane == 0) {
        for (int f = 0; f < total; ++f) {
          const int slot = f % S;
          mbar_wait(empty0 + 8 * slot, ((f / S) & 1) ^ 1);
          const int st = f % kSteps, tap = st / kChunks, k0 = (st % kChunks) * kWgBK;
          const int m0 = (blockIdx.x + (f / kSteps) * gridDim.x) * kTwgTile;
          int dy, dx;
          tap_offset(tap, dy, dx);
          unsigned char* stage = smem + slot * kStage;
          mbar_arrive_expect(full0 + 8 * slot, kA + kB);
          tma_load_2d(stage, &hmap, k0, m0 + dy * p.W + dx, full0 + 8 * slot);
          tma_load_2d(stage + kA, &tmap, k0, tap * HP, full0 + 8 * slot);
        }
      }
    } else {           // the split of the weights, a step behind the copies
      const int stid = tid - 8 * 32 - 32;
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
  regs_inc<232>();
  const int g = lane / 4, t = lane % 4, r0 = 16 * warp;
  float acc[HP / 2];
#pragma unroll
  for (int i = 0; i < HP / 2; ++i) acc[i] = 0.f;
  uint32_t abig[2][kHalf][4], asmall[2][kHalf][4];   // [half][k slice][fragment]
  uint32_t in_plane[2] = {0u, 0u};   // bit tap: rows g, g + 8 read inside the plane
  int f = 0, pending = -1;
  auto release = [&](int slot) {
    if (slot >= 0 && lane == 0) mbar_arrive(empty0 + 8 * slot);
  };

  for (int k = 0; k < my_tiles; ++k) {
    const int m0 = (blockIdx.x + k * gridDim.x) * kTwgTile;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = (m0 + r0 + g + 8 * h) % p.N, y = n / p.W, x = n - y * p.W;
      uint32_t m = 0;
#pragma unroll
      for (int tap = 0; tap < kTaps; ++tap) {
        int dy, dx;
        tap_offset(tap, dy, dx);
        m |= (uint32_t)(y + dy >= 0 && y + dy < p.H && x + dx >= 0 && x + dx < p.W) << tap;
      }
      in_plane[h] = m;
    }
    for (int st = 0; st < kSteps; ++st, ++f) {
      const int slot = f % S;
      const uint32_t par = (f / S) & 1;
      mbar_wait(full0 + 8 * slot, par);
      const int tap = st / kChunks;
      const unsigned char* stage = smem + slot * kStage;
      const uint32_t keep_g = 0u - ((in_plane[0] >> tap) & 1u);
      const uint32_t keep_g8 = 0u - ((in_plane[1] >> tap) & 1u);
      const uint64_t db = desc_sw(stage + kA), ds = desc_sw(stage + kA + kB);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int kk = 0; kk < kHalf; ++kk) {
          uint32_t x[4];
          ldsm_a(x, stage, r0, kHalf * hf + kk, lane);
          x[0] &= keep_g;
          x[1] &= keep_g8;
          x[2] &= keep_g;
          x[3] &= keep_g8;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            abig[hf][kk][i] = tf32_big(x[i]);
            asmall[hf][kk][i] = tf32_small_of(x[i]);
          }
        }
        if (hf == 0) mbar_wait(ready0 + 8 * slot, par);   // the tap matrix's small half
        fence_acc(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kHalf; ++kk) {
          const int s2 = 2 * (kHalf * hf + kk);   // 32 bytes a k slice, in 16-byte units
          mma3<HP>(acc, abig[hf][kk], asmall[hf][kk], db + s2, ds + s2, (st | hf | kk) != 0);
        }
        wg_commit();
        if (hf == 0) {          // the step before has completed: its slot is free
          wg_wait<1>();
          fence_acc(acc);
          release(pending);
          pending = -1;
        } else if (st == kSteps - 1) {   // the tile is summed
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

    // ---- the epilogue of this warp's 16 rows: bias + bn2 + GELU, fc2's A fragment of k
    // slice j taken from n8 tile j, (2t, 2t + 1) as TF32 k (t, t + 4)
    uint32_t ha[kFs][4];
#pragma unroll
    for (int j = 0; j < kFs; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(p.dwb + col));
      const float2 ss = __ldg(reinterpret_cast<const float2*>(p.s2 + col));
      const float2 sh = __ldg(reinterpret_cast<const float2*>(p.t2 + col));
      ha[j][0] = __float_as_uint(bias_bn_gelu(acc[4 * j], bb.x, ss.x, sh.x));
      ha[j][1] = __float_as_uint(bias_bn_gelu(acc[4 * j + 2], bb.x, ss.x, sh.x));
      ha[j][2] = __float_as_uint(bias_bn_gelu(acc[4 * j + 1], bb.y, ss.y, sh.y));
      ha[j][3] = __float_as_uint(bias_bn_gelu(acc[4 * j + 3], bb.y, ss.y, sh.y));
    }
    const bool whole = (p.cout & 3) == 0;   // rows of the output are 16-byte aligned
    for (int n0 = 0; n0 < p.coutp; n0 += 16) {
      float o[2][4] = {};
      // b0 = w2[n][8u + 2t], b1 = w2[n][8u + 2t + 1] for n = n0 + g and n0 + 8 + g
      const float* w0 = p.w2 + (size_t)(n0 + g) * HP + 2 * t;
#pragma unroll
      for (int u = 0; u < kFs; ++u) {
        const float2 wa = __ldg(reinterpret_cast<const float2*>(w0 + 8 * u));
        const float2 wb = __ldg(reinterpret_cast<const float2*>(w0 + 8 * HP + 8 * u));
        mma_slice<float>(o[0], ha[u], __float_as_uint(wa.x), __float_as_uint(wa.y));
        mma_slice<float>(o[1], ha[u], __float_as_uint(wb.x), __float_as_uint(wb.y));
      }
      // bn3 + GELU; lanes t and t ^ 1 swap pairs, so that an even t holds columns
      // 2t .. 2t + 3 of row g and an odd t columns 2t - 2 .. 2t + 1 of row g + 8
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int col = n0 + 8 * h2 + 2 * t;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(p.b2 + col));
        const float2 ss = __ldg(reinterpret_cast<const float2*>(p.s3 + col));
        const float2 sh = __ldg(reinterpret_cast<const float2*>(p.t3 + col));
        const float v0 = bias_bn_gelu(o[h2][0], bb.x, ss.x, sh.x);
        const float v1 = bias_bn_gelu(o[h2][1], bb.y, ss.y, sh.y);
        const float v2 = bias_bn_gelu(o[h2][2], bb.x, ss.x, sh.x);
        const float v3 = bias_bn_gelu(o[h2][3], bb.y, ss.y, sh.y);
        const int rg = m0 + r0 + g;
        if (!whole) {   // scalar stores of the columns below cout
          const float ev[4] = {v0, v1, v2, v3};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = rg + (q >> 1) * 8, c = col + (q & 1);
            if (row < p.M && c < p.cout) p.out[(size_t)row * p.cout + c] = ev[q];
          }
          continue;
        }
        const bool odd = t & 1;
        const float s0 = __shfl_xor_sync(0xffffffffu, odd ? v0 : v2, 1);
        const float s1 = __shfl_xor_sync(0xffffffffu, odd ? v1 : v3, 1);
        const int row = rg + (odd ? 8 : 0), c4 = col - (odd ? 2 : 0);
        if (row < p.M && c4 < p.cout)
          *reinterpret_cast<float4*>(p.out + (size_t)row * p.cout + c4) =
              odd ? make_float4(s0, s1, v2, v3) : make_float4(v0, v1, s0, s1);
      }
    }
  }
}

// The f32 instantiation at HP: its shared memory allowed once per process (and the
// register count that `setmaxnreg` counts on checked), its tensor maps and launch, or,
// with `held` given, the blocks an SM holds
template <int HP>
struct TapsWg {
  static constexpr int kSmem = twg_smem<HP>();
  static_assert(kSmem <= kSmemLimit, "the ring fits a block's shared memory");

  static cudaError_t prepare() {
    static const cudaError_t err = [] {
      cudaFuncAttributes attr;
      cudaError_t e = cudaFuncGetAttributes(&attr, taps_wg_kernel<HP>);
      if (e == cudaSuccess && attr.numRegs != kTwgRegs) e = cudaErrorInvalidConfiguration;
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(taps_wg_kernel<HP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmem);
      return e;
    }();
    return err;
  }
  static int run(const TapsArgs<float>& p, int blocks, cudaStream_t st, int* held) {
    const cudaError_t err = prepare();
    if (err != cudaSuccess) return (int)err;
    if (held != nullptr)
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(held, taps_wg_kernel<HP>,
                                                                kTwgThreads, kSmem);
    if (p.coutp > kTapsCoutMax<float, HP>) return (int)cudaErrorInvalidValue;
    CUtensorMap hm = {}, tm = {};
    cudaError_t e = hop::wg_tensor_map(&hm, p.h, p.M, HP, kTwgTile);
    if (e == cudaSuccess) e = hop::wg_tensor_map(&tm, p.taps, (long long)kTaps * HP, HP, HP);
    if (e != cudaSuccess) return (int)e;
    taps_wg_kernel<HP><<<blocks, kTwgThreads, kSmem, st>>>(p, hm, tm);
    return (int)cudaGetLastError();
  }
};

// the instantiation of (HP, tile): bf16 tiles of 256 tokens up to HP 128, 128 at every
// HP; f32 the wgmma kernel's tile of 128
template <typename T>
int taps_run(const TapsArgs<T>& p, int hp, int tile, int blocks, cudaStream_t st, int* held) {
  if constexpr (sizeof(T) == 4) {
    if (tile != kTwgTile) return (int)cudaErrorInvalidValue;
    switch (hp) {
      case 96: return TapsWg<96>::run(p, blocks, st, held);
      case 128: return TapsWg<128>::run(p, blocks, st, held);
      case 160: return TapsWg<160>::run(p, blocks, st, held);
      case 192: return TapsWg<192>::run(p, blocks, st, held);
    }
    return (int)cudaErrorInvalidValue;
  } else {
    if (tile == 128) {
      switch (hp) {
        case 96: return Taps<T, 96, 1>::run(p, blocks, st, held);
        case 128: return Taps<T, 128, 1>::run(p, blocks, st, held);
        case 160: return Taps<T, 160, 1>::run(p, blocks, st, held);
        case 192: return Taps<T, 192, 1>::run(p, blocks, st, held);
      }
    } else if (tile == 256) {
      switch (hp) {
        case 96: return Taps<T, 96, 2>::run(p, blocks, st, held);
        case 128: return Taps<T, 128, 2>::run(p, blocks, st, held);
      }
    }
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rss
