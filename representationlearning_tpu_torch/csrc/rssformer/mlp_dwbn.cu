// K5: the RSSFormer MlpDWBN feed-forward block, as two kernels.
//
// Replaces: `fused_mlp_dwbn_pallas`
//   (representationlearning_tpu/ops/pallas/mlp_dwbn.py:115, call :132), whose body
//   is `_mlp_math` (:52-82): fc1 + bn1 + GELU, the 19 shifted (N, hid) x (hid, hid)
//   products of the 1x1, 3x3 d6 and 3x3 d12 convolutions + bias + bn2 + GELU, and
//   fc2 + bn3 + GELU, with bf16 operands and f32 sums.
// What bounds it on the H100: operations. At (4, 16384, 32), hid 128, out 32 a call
//   is 2 * 65536 * 128 * (32 + 19 * 128 + 32) = 41.9 GFLOP of tensor-core work
//   against about 18 MB of input, output and weights.
// What the design does about it: the Pallas kernel holds one whole image, its
//   hidden plane and a copy padded by 12 in VMEM; a Hopper block has 227 KB, and a
//   tile with a halo of 12 would compute fc1 several times over. So `fc1_kernel`
//   writes the hidden plane once, already rounded to bf16 (the TPU kernel rounds it
//   to bf16 at each of its 19 uses: the same rounding, done once), 16.8 MB that
//   stay in the 50 MB L2.
//
//   `fc1_kernel` alone is bound by bytes (x f32 in, h bf16 out: 25.2 MB a launch at
//   the predict shape, 7.5 us), but its GELU costs as much in instructions (about
//   30 an element over 8.4 M elements: 8 us of the card's issue slots at best).
//   Persistent blocks (grid from the wrapper's `fc1_plan`) walk 16-row tiles, one a
//   warp a step; each warp streams its x tiles through a `cp.async` ring of its
//   own, so loads overlap the products and the epilogue with no block barrier; w1
//   is copied to shared memory once a block and read by `ldmatrix` (its fragments
//   held in registers for the whole walk capped the warps an SM holds and were
//   slower, PERF.md). A fragments are built from f32 with round-to-nearest bf16
//   conversion, as the plain version's `.to(bf16)`; `mma.sync` m16n8k16 with f32
//   sums; a warp finishes its 16 rows in two halves of 64 features: the epilogue
//   works on the accumulator registers (bias, bn1, a branch-free GELU, bf16 pairs),
//   stages the half rows in shared memory and writes them as whole 128-byte pieces
//   with 16-byte stores. Every plan computes each output by the same instructions:
//   equal bits.
//
//   `taps_kernel` is an implicit GEMM bound by its products (37.8 GFLOP of in-plane
//   taps a launch at the predict shape, 38 us at the card's peak); behind them come
//   the copies into shared memory: each tile of tokens reads all 19 tap matrices (B)
//   and its own rows once a tap (A). Persistent blocks (grid from the wrapper's
//   `taps_plan`) walk tiles of 128 or 256 consecutive tokens, all 128 hidden features
//   a tile (a larger tile reads B half as often); eight warps own 16 or 32 rows each
//   and all 128 features of them. The K steps, tap then chunk of 64, run through a
//   `cp.async` ring of 3-4 stages with one barrier a step; a step's copies go in four
//   parts amid the products of the step before the one they feed, and the ring runs
//   on across the tiles of a block, so the next tile's first steps load while this
//   one's epilogue runs. A row of A is the row of h the tap shifts to, zeros outside
//   [0, M) (`cp.async` with a source size of 0: no padded copy); the rows that lie
//   outside the plane are masked out of the A fragments, from one mask of in-plane
//   taps a fragment row, made once a tile. Products are `ldmatrix` + `mma.sync`
//   m16n8k16 with f32 sums, the next K slice's fragments loading while this one's
//   products run. The epilogue works on the accumulator registers: bias + bn2 + GELU
//   rounded to bf16 pairs, which are, as they stand, the A fragments of fc2 (adjacent
//   n8 tiles make one k16 fragment); fc2's weight and the six vectors wait in shared
//   memory, bn3 + GELU apply to fc2's accumulators, and a swap between lane pairs
//   makes whole 16-byte pieces of the f32 output. The second hidden plane never
//   leaves the registers. Every plan computes each output by the same instructions in
//   the same order: equal bits.
#include "common.cuh"

namespace rss {

constexpr int kHid = 128;            // hidden width both kernels are built for
constexpr int kTaps = 19;

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

// ---- fc1: h[M, 128] (bf16) = gelu(bn1(x[M, cin] @ w1[128, cin]^T + b1)) ----
//
// A persistent grid: the wrapper's `fc1_plan` gives the warps a block and the steps
// `per` it walks; a step of a block is warps x 16 consecutive rows, one m16 tile a
// warp, and the blocks take consecutive runs of steps. Each warp streams its own
// tiles of x through a ring of two slots by `cp.async` (no block barrier in the
// walk), so the next tile loads while this one is multiplied and written. w1 and the
// three vectors come to shared memory once a block. A warp finishes its tile in two
// halves of 64 features: 32 accumulators a lane in place of 64 leave the compiler
// registers to overlap more GELUs (measured faster, PERF.md).
constexpr int kFc1Rows = 16;               // rows of x a warp takes a step
constexpr int kFc1MaxWarps = 8;
constexpr int kFc1Half = kHid / 2;         // features a warp finishes at a time
constexpr int kFc1Pitch = kFc1Half / 2 + 4;  // 32-bit pitch of a warp's staged half rows
constexpr int kFc1Stages = 2;
constexpr int kSmemLimit = 232448;         // dynamic shared memory a block may have

struct Fc1Args {
  const float* x;
  const bf16* w1;
  const float* b1;
  const float* s1;
  const float* t1;
  bf16* h;
  int M, cin, per;
};

// bytes of dynamic shared memory: b1, s1, t1; each warp's ring of f32 x tiles (pitch
// cin + 8) and its staged half rows; w1 in bf16 (pitch cin + 8)
inline int fc1_smem(int cin, int warps) {
  return 3 * kHid * 4 +
         warps * (kFc1Stages * kFc1Rows * (cin + 8) * 4 + kFc1Rows * kFc1Pitch * 4) +
         kHid * (cin + 8) * 2;
}

__global__ void __launch_bounds__(32 * kFc1MaxWarps, 2) fc1_kernel(const Fc1Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int cin = p.cin, ks = cin / 16, xp = cin + 8, q4 = cin / 4;
  float* vec = reinterpret_cast<float*>(smem);                              // b1, s1, t1
  const int per_warp = kFc1Stages * kFc1Rows * xp + kFc1Rows * kFc1Pitch;    // in 4 bytes
  float* ring = vec + 3 * kHid + warp * per_warp;
  uint32_t* staged = reinterpret_cast<uint32_t*>(ring + kFc1Stages * kFc1Rows * xp);
  bf16* ws = reinterpret_cast<bf16*>(vec + 3 * kHid + warps * per_warp);

  for (int i = threadIdx.x; i < kHid * cin / 8; i += blockDim.x) {
    const int n = i / (cin / 8), c = (i - n * (cin / 8)) * 8;
    cp_async16(ws + n * xp + c, p.w1 + (size_t)n * cin + c);
  }
  for (int i = threadIdx.x; i < 3 * kHid / 4; i += blockDim.x) {
    const float* v = i < kHid / 4 ? p.b1 : (i < kHid / 2 ? p.s1 : p.t1);
    cp_async16(vec + 4 * i, v + 4 * (i % (kHid / 4)));
  }
  cp_async_commit();

  // the warp's i-th tile: rows [16 tile, 16 tile + 16) with
  // tile = (blockIdx.x * per + i) * warps + warp; rows past M read as zeros
  const int tiles = (p.M + kFc1Rows - 1) / kFc1Rows;
  auto tile_of = [&](int i) { return (blockIdx.x * p.per + i) * warps + warp; };
  auto load = [&](int i) {
    const int tile = tile_of(i);
    if (i < p.per && tile < tiles) {
      float* dst = ring + (i % kFc1Stages) * kFc1Rows * xp;
      const int row0 = tile * kFc1Rows;
      for (int q = lane; q < kFc1Rows * q4; q += 32) {
        const int r = q / q4, c = (q - r * q4) * 4;
        const bool ok = row0 + r < p.M;
        cp_async16(dst + r * xp + c, ok ? p.x + (size_t)(row0 + r) * cin + c : p.x, ok ? 16 : 0);
      }
    }
    cp_async_commit();   // an empty group past the walk keeps the count of groups uniform
  };
  load(0);
  cp_async_wait<1>();   // w1 and the vectors
  __syncthreads();

  // ldmatrix.x4 of w1 rows [n0, n0 + 16) x k [k0, k0 + 16): b0, b1 of n tiles n0 / 8
  // and n0 / 8 + 1
  const bf16* wl = ws + ((lane / 16) * 8 + lane % 8) * xp + ((lane / 8) % 2) * 8;

  for (int i = 0; i < p.per; ++i) {
    load(i + 1);   // into the slot this warp emptied a step ago
    cp_async_wait<1>();
    __syncwarp();
    const int tile = tile_of(i);
    if (tile >= tiles) break;   // the grid's last steps may lie past M
    const float* a = ring + (i % kFc1Stages) * kFc1Rows * xp + g * xp + 2 * t;
    const int row0 = tile * kFc1Rows;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int k = 0; k < ks; ++k) {
        // A from f32, rounded to nearest bf16 as the plain version's .to(bf16)
        const float* ak = a + 16 * k;
        const float2 v0 = *reinterpret_cast<const float2*>(ak);
        const float2 v1 = *reinterpret_cast<const float2*>(ak + 8 * xp);
        const float2 v2 = *reinterpret_cast<const float2*>(ak + 8);
        const float2 v3 = *reinterpret_cast<const float2*>(ak + 8 * xp + 8);
        const uint32_t af[4] = {pack_bf16(v0.x, v0.y), pack_bf16(v1.x, v1.y),
                                pack_bf16(v2.x, v2.y), pack_bf16(v3.x, v3.y)};
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t r[4];
          ldsm_x4(r, wl + (kFc1Half * half + 8 * j) * xp + 16 * k);
          mma_bf16(acc[j], af, r[0], r[1]);
          mma_bf16(acc[j + 1], af, r[2], r[3]);
        }
      }
      // epilogue from the accumulators: (acc + b1) s1 + t1, GELU, bf16 pairs staged
      // as half rows; then they leave as whole 128-byte pieces with 16-byte stores
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = kFc1Half * half + 8 * j + 2 * t;
        const float2 b = *reinterpret_cast<const float2*>(vec + col);
        const float2 s = *reinterpret_cast<const float2*>(vec + kHid + col);
        const float2 sh = *reinterpret_cast<const float2*>(vec + 2 * kHid + col);
        staged[g * kFc1Pitch + 4 * j + t] = pack_bf16(bias_bn_gelu(acc[j][0], b.x, s.x, sh.x),
                                                      bias_bn_gelu(acc[j][1], b.y, s.y, sh.y));
        staged[(g + 8) * kFc1Pitch + 4 * j + t] =
            pack_bf16(bias_bn_gelu(acc[j][2], b.x, s.x, sh.x),
                      bias_bn_gelu(acc[j][3], b.y, s.y, sh.y));
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kFc1Rows / 4; ++k) {   // 8 pieces of 16 bytes a half row, 4 rows a pass
        const int r = 4 * k + lane / 8, c = lane % 8;
        if (row0 + r < p.M)
          *reinterpret_cast<uint4*>(p.h + (size_t)(row0 + r) * kHid + kFc1Half * half + 8 * c) =
              *reinterpret_cast<const uint4*>(staged + r * kFc1Pitch + 4 * c);
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();
}

// lets the kernel take `smem` bytes of dynamic shared memory: once per process and
// size (a larger grant covers every smaller one)
inline cudaError_t fc1_prepare(int smem) {
  static int granted = 48 * 1024;
  if (smem <= granted) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(fc1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) granted = smem;
  return err;
}

inline bool fc1_takes(int cin, int warps) {
  return cin >= 16 && cin <= 256 && cin % 16 == 0 && warps >= 1 && warps <= kFc1MaxWarps &&
         fc1_smem(cin, warps) <= kSmemLimit;
}

// ---- taps: out[M, cout] = gelu(bn3(gelu(bn2(sum_t shift_t(h) @ taps[t]^T + dwb)) @ w2^T + b2))
//
// M = B * N tokens on (H, W) grids; h (M, 128) bf16; taps (19, 128, 128) bf16 as (out,
// in); w2 (cout, 128) bf16; cout % 16 == 0, cout <= 128. The wrapper's `taps_plan`
// gives the tile (16 MI rows a warp, eight warps; the ring's stages follow from it)
// and the blocks; block b takes the tiles b, b + blocks, b + 2 blocks, ...
constexpr int kTapsWarps = 8;
constexpr int kTapsThreads = 32 * kTapsWarps;
constexpr int kTapsBK = 64;                     // K step: a tap's chunk of 64 features
constexpr int kTapsLd = kTapsBK + 8;            // bf16 row pitch of the stages (144 bytes)
constexpr int kTapsSteps = kTaps * (kHid / kTapsBK);

struct TapsArgs {
  const bf16* h;
  const bf16* taps;
  const float* dwb;
  const float* s2;
  const float* t2;
  const bf16* w2;
  const float* b2;
  const float* s3;
  const float* t3;
  float* out;
  int M, N, H, W, cout, tiles;
};

constexpr int kTapsLdW = kHid + 8;             // bf16 row pitch of fc2's weight (272 bytes)
// fc2's weight (up to 128 rows) and the six vectors of bn2 and bn3, in f32
constexpr int kTapsConstBytes = kHid * kTapsLdW * 2 + 6 * kHid * 4;

// slots of the ring at a tile: four of a 128-token tile; three of a 256-token tile
// (four do not fit beside the epilogue's constants)
constexpr int taps_stages(int tile) { return tile == 128 ? 4 : 3; }

// bytes of dynamic shared memory: the ring's slots of A (tile rows) and B (128 rows),
// then the epilogue's constants
inline int taps_smem(int tile) {
  return taps_stages(tile) * (tile + kHid) * kTapsLd * 2 + kTapsConstBytes;
}

template <int MI, int STAGES>
__global__ void __launch_bounds__(kTapsThreads, 1) taps_kernel(const TapsArgs p) {
  constexpr int BM = 16 * MI * kTapsWarps;       // tokens a tile
  constexpr int RA = BM / 32;                    // A rows a thread copies a step
  constexpr int RB = kHid / 32;                  // B rows a thread copies a step
  constexpr int kA = BM * kTapsLd, kB = kHid * kTapsLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);      // [STAGES][BM][kTapsLd]
  bf16* Bs = As + STAGES * kA;                   // [STAGES][kHid][kTapsLd]
  bf16* w2s = Bs + STAGES * kB;                  // [cout][kTapsLdW]
  float* vec = reinterpret_cast<float*>(w2s + kHid * kTapsLdW);  // dwb s2 t2, then b2 s3 t3
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int c8 = (tid % 8) * 8, r0 = tid / 8;    // this thread copies rows r0 + 32 i, piece c8

  // ---- the copies: step f of the block's walk is tap (f % 38) / 2, chunk f % 2 of the
  // block's (f / 38)-th tile. A row of A is the token shifted by the tap as it lies in
  // device memory, zeros outside [0, M); what lies outside the plane is masked out of the
  // fragments below. A step's copies go in four parts, one amid the products of each K
  // slice of the step being multiplied, so that the tensor cores never wait for a
  // warp's whole share of copies.
  const int my_tiles = (int)blockIdx.x < p.tiles ? (p.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = my_tiles * kTapsSteps;
  int f = 0, f_slot = 0, f_it = 0, f_m0 = blockIdx.x * BM, f_row = 0;
  const bf16* f_a = p.h;      // A source of row r0 of step f
  const bf16* f_b = p.taps;   // B source of row r0 of step f
  auto fetch_part = [&](int q) {
    if (f < total) {
      if (q == 0) {
        int dy, dx;
        tap_offset(f_it / 2, dy, dx);
        const int k0 = (f_it % 2) * kTapsBK + c8;
        f_row = f_m0 + r0 + dy * p.W + dx;
        f_a = p.h + (ptrdiff_t)f_row * kHid + k0;   // read only for rows inside [0, M)
        f_b = p.taps + ((size_t)(f_it / 2) * kHid + r0) * kHid + k0;
      }
      bf16* a = As + f_slot * kA + r0 * kTapsLd + c8;
      bf16* b = Bs + f_slot * kB + r0 * kTapsLd + c8;
#pragma unroll
      for (int i = q * RA / 4; i < (q + 1) * RA / 4; ++i) {
        const bool ok = (unsigned)(f_row + 32 * i) < (unsigned)p.M;
        cp_async16(a + 32 * i * kTapsLd, ok ? f_a + 32 * i * kHid : p.h, ok ? 16 : 0);
      }
#pragma unroll
      for (int i = q * RB / 4; i < (q + 1) * RB / 4; ++i)
        cp_async16(b + 32 * i * kTapsLd, f_b + 32 * i * kHid);
      if (q == 3 && ++f_it == kTapsSteps) {
        f_it = 0;
        f_m0 += gridDim.x * BM;
      }
    }
    if (q == 3) {
      cp_async_commit();   // an empty group past the walk keeps the count of groups uniform
      ++f;
      f_slot = f_slot + 1 == STAGES ? 0 : f_slot + 1;
    }
  };

  float acc[MI][16][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // ---- the epilogue of the tile at m0, from the accumulators of this warp's rows
  // wm + 16 i + g and + 8
  const int wm = warp * 16 * MI;
  auto epilogue = [&](int m0) {
    // bias + bn2 + GELU, rounded to bf16: n8 tiles 2u and 2u + 1 are fc2's A fragment
    // of hidden features 16u .. 16u + 15
    uint32_t ha[MI][8][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 bb = *reinterpret_cast<const float2*>(vec + col);
      const float2 ss = *reinterpret_cast<const float2*>(vec + kHid + col);
      const float2 sh = *reinterpret_cast<const float2*>(vec + 2 * kHid + col);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        ha[i][j / 2][2 * (j % 2)] = pack_bf16(bias_bn_gelu(acc[i][j][0], bb.x, ss.x, sh.x),
                                              bias_bn_gelu(acc[i][j][1], bb.y, ss.y, sh.y));
        ha[i][j / 2][2 * (j % 2) + 1] = pack_bf16(bias_bn_gelu(acc[i][j][2], bb.x, ss.x, sh.x),
                                                  bias_bn_gelu(acc[i][j][3], bb.y, ss.y, sh.y));
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
      }
    }
    // fc2, 16 output features at a time, its weight from shared memory
    for (int n0 = 0; n0 < p.cout; n0 += 16) {
      float o[MI][2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) o[i][h2][0] = o[i][h2][1] = o[i][h2][2] = o[i][h2][3] = 0.f;
      const bf16* wl = w2s + (n0 + (lane & 7) + (lane >> 4) * 8) * kTapsLdW + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        uint32_t wb[4];   // outputs n0 .. + 7 (k 0-7, 8-15), then n0 + 8 .. + 15
        ldsm_x4(wb, wl + 16 * u);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_bf16(o[i][0], ha[i][u], wb[0], wb[1]);
          mma_bf16(o[i][1], ha[i][u], wb[2], wb[3]);
        }
      }
      // bn3 + GELU; lanes t and t ^ 1 swap pairs, so that an even t holds columns
      // 2t .. 2t + 3 of row g and an odd t columns 2t - 2 .. 2t + 1 of row g + 8
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int col = n0 + 8 * h2 + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(vec + 3 * kHid + col);
        const float2 ss = *reinterpret_cast<const float2*>(vec + 4 * kHid + col);
        const float2 sh = *reinterpret_cast<const float2*>(vec + 5 * kHid + col);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const float v0 = bias_bn_gelu(o[i][h2][0], bb.x, ss.x, sh.x);
          const float v1 = bias_bn_gelu(o[i][h2][1], bb.y, ss.y, sh.y);
          const float v2 = bias_bn_gelu(o[i][h2][2], bb.x, ss.x, sh.x);
          const float v3 = bias_bn_gelu(o[i][h2][3], bb.y, ss.y, sh.y);
          const bool odd = t & 1;
          const float s0 = __shfl_xor_sync(0xffffffffu, odd ? v0 : v2, 1);
          const float s1 = __shfl_xor_sync(0xffffffffu, odd ? v1 : v3, 1);
          const int row = m0 + wm + 16 * i + g + (odd ? 8 : 0);
          if (row < p.M)
            *reinterpret_cast<float4*>(p.out + (size_t)row * p.cout + col - (odd ? 2 : 0)) =
                odd ? make_float4(s0, s1, v2, v3) : make_float4(v0, v1, s0, s1);
        }
      }
    }
  };

  // ---- the products: the fragments of the next K slice (the next step's first, at a
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
  uint32_t af[2][MI][4], bfr[2][8][4];
  auto load_frags = [&](int buf, int slot, int kk, int tap) {
    const bf16* A = As + slot * kA + kk;
    const bf16* Bt = Bs + slot * kB + kk;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      ldsm_x4(af[buf][i], A + (wm + 16 * i + (lane & 15)) * kTapsLd + (lane >> 4) * 8);
      const uint32_t keep_g = 0u - ((in_plane[i][0] >> tap) & 1u);   // row g
      const uint32_t keep_g8 = 0u - ((in_plane[i][1] >> tap) & 1u);  // row g + 8
      af[buf][i][0] &= keep_g;
      af[buf][i][1] &= keep_g8;
      af[buf][i][2] &= keep_g;
      af[buf][i][3] &= keep_g8;
    }
#pragma unroll
    for (int j2 = 0; j2 < 8; ++j2)   // features 16 j2 .. + 7 (k 0-7, 8-15), then + 8 .. + 15
      ldsm_x4(bfr[buf][j2],
              Bt + (16 * j2 + (lane & 7) + (lane >> 4) * 8) * kTapsLd + ((lane >> 3) & 1) * 8);
  };

  // the epilogue's constants travel with step 0's copies
  for (int i = tid; i < p.cout * (kHid / 8); i += kTapsThreads) {
    const int n = i / (kHid / 8), c = (i % (kHid / 8)) * 8;
    cp_async16(w2s + n * kTapsLdW + c, p.w2 + (size_t)n * kHid + c);
  }
  for (int i = tid; i < 6 * kHid / 4; i += kTapsThreads) {
    const int v = i / (kHid / 4), c = (i % (kHid / 4)) * 4;
    const float* src = v == 0 ? p.dwb : v == 1 ? p.s2 : v == 2 ? p.t2
                     : v == 3 ? p.b2 : v == 4 ? p.s3 : p.t3;
    if (v < 3 || c < p.cout) cp_async16(vec + v * kHid + c, src + c);
  }
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) fetch_part(q);
  if (total > 0) {
    cp_async_wait<STAGES - 2>();   // step 0
    __syncthreads();
    plane_masks(blockIdx.x * BM);
    load_frags(0, 0, 0, 0);
  }
  int slot = 0;   // of the step being multiplied, s in the notes below
  for (int k = 0, m0 = blockIdx.x * BM; k < my_tiles; ++k, m0 += gridDim.x * BM) {
    for (int st = 0; st < kTapsSteps; ++st) {
      const int next = slot + 1 == STAGES ? 0 : slot + 1;
#pragma unroll
      for (int kk = 0; kk < kTapsBK / 16; ++kk) {
        const int cur = kk % 2;
        if (kk + 1 < kTapsBK / 16) {
          load_frags(cur ^ 1, slot, 16 * (kk + 1), st / 2);
        } else {
          // step s + 1: this thread's copies have landed (all but the STAGES - 3 groups
          // committed after its), then every thread's
          cp_async_wait<STAGES - 3>();
          __syncthreads();   // also: every warp has left step s - 1's slot (its last
                             // fragments were loaded at slice 2 of step s - 1)
          if (st + 1 < kTapsSteps) load_frags(0, next, 0, (st + 1) / 2);
        }
#pragma unroll
        for (int j2 = 0; j2 < 8; ++j2) {
          // a part of step s + STAGES - 1's copies, into the slot of step s - 1
          if (j2 == 4) fetch_part(kk);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            mma_bf16(acc[i][2 * j2], af[cur][i], bfr[cur][j2][0], bfr[cur][j2][1]);
            mma_bf16(acc[i][2 * j2 + 1], af[cur][i], bfr[cur][j2][2], bfr[cur][j2][3]);
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

using TapsKernel = void (*)(const TapsArgs);

// the instantiation of a tile, or nullptr for one the kernel does not have
inline TapsKernel taps_kernel_of(int tile) {
  return tile == 128   ? taps_kernel<1, taps_stages(128)>
         : tile == 256 ? taps_kernel<2, taps_stages(256)>
                       : nullptr;
}

// lets the instantiation take its dynamic shared memory: once per process and tile
inline cudaError_t taps_prepare(int tile) {
  static bool granted[2] = {};
  bool& done = granted[tile == 256];
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      taps_kernel_of(tile), cudaFuncAttributeMaxDynamicSharedMemorySize, taps_smem(tile));
  if (err == cudaSuccess) done = true;
  return err;
}

}  // namespace rss

// h (M, 128) bf16 from x (M, cin) f32 and w1 (128, cin) bf16; all 16-byte aligned.
// `warps` and `per` (steps a block walks) come from the wrapper's plan.
extern "C" int k5_mlp_fc1(const void* x, const void* w1, const void* b1, const void* s1,
                          const void* t1, void* h, int M, int cin, int warps, int per,
                          void* stream) {
  using namespace rss;
  if (M < 1 || per < 1 || !fc1_takes(cin, warps)) return (int)cudaErrorInvalidValue;
  const Fc1Args p{(const float*)x, (const bf16*)w1, (const float*)b1, (const float*)s1,
                  (const float*)t1, (bf16*)h, M, cin, per};
  const int steps = ((M + kFc1Rows - 1) / kFc1Rows + warps - 1) / warps;
  const int smem = fc1_smem(cin, warps);
  const cudaError_t err = fc1_prepare(smem);
  if (err != cudaSuccess) return (int)err;
  fc1_kernel<<<(steps + per - 1) / per, 32 * warps, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Blocks of fc1 with that many warps one SM holds at once, as the card reports it;
// -1 for a width or warp count the kernel does not take.
extern "C" int k5_fc1_blocks_per_sm(int cin, int warps) {
  using namespace rss;
  if (!fc1_takes(cin, warps)) return -1;
  const int smem = fc1_smem(cin, warps);
  int n = -1;
  if (fc1_prepare(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fc1_kernel, 32 * warps, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

// out (B * H * W, cout) f32 from h (B * H * W, 128) bf16; every pointer 16-byte
// aligned. `tile` and `blocks` come from the wrapper's plan.
extern "C" int k5_mlp_taps(const void* h, const void* taps, const void* dwb, const void* s2,
                           const void* t2, const void* w2, const void* b2, const void* s3,
                           const void* t3, void* out, int B, int H, int W, int cout, int tile,
                           int blocks, void* stream) {
  using namespace rss;
  const TapsKernel kernel = taps_kernel_of(tile);
  if (B < 1 || H < 1 || W < 1 || cout < 16 || cout > kHid || cout % 16 || blocks < 1 ||
      kernel == nullptr)
    return (int)cudaErrorInvalidValue;
  const int N = H * W, M = B * N;
  const TapsArgs p{(const bf16*)h, (const bf16*)taps, (const float*)dwb, (const float*)s2,
                   (const float*)t2, (const bf16*)w2, (const float*)b2, (const float*)s3,
                   (const float*)t3, (float*)out, M, N, H, W, cout, (M + tile - 1) / tile};
  const cudaError_t err = taps_prepare(tile);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kTapsThreads, taps_smem(tile), (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Blocks of the taps kernel at that tile one SM holds at once, as the card reports it;
// -1 for a tile the kernel does not have.
extern "C" int k5_taps_blocks_per_sm(int tile) {
  using namespace rss;
  const TapsKernel kernel = taps_kernel_of(tile);
  int n = -1;
  if (kernel == nullptr || taps_prepare(tile) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kTapsThreads, taps_smem(tile)) !=
          cudaSuccess)
    return -1;
  return n;
}
