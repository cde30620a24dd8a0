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
//   `taps_kernel` is an implicit GEMM: a block owns 128 consecutive tokens and all
//   128 hidden features, and walks 19 taps x 2 chunks of K = 64. Each A row is the
//   hidden vector of the token shifted by the tap, or zeros where that lies outside
//   the plane (`cp.async` with a source size of 0: no padded copy). A and B tiles
//   are double-buffered with `cp.async`; eight warps multiply with WMMA (bf16
//   mma.sync, f32 accumulators, 32 x 64 a warp). The epilogue adds the bias,
//   applies bn2 and GELU, leaves the tile in shared memory as bf16, multiplies it by
//   fc2's weight from shared memory and applies bn3 and GELU, so the second hidden
//   plane never reaches device memory.
#include <mma.h>

#include "common.cuh"

namespace rss {

namespace wmma = nvcuda::wmma;

constexpr int kHid = 128;            // hidden width both kernels are built for
constexpr int kBM = 128;             // tokens a block
constexpr int kBK = 64;              // K step of the tap GEMM
constexpr int kLd = kBK + 8;         // bf16 row pitch of the A/B stages (144 bytes)
constexpr int kLdH = kHid + 8;       // bf16 row pitch of the hidden tile and of fc2's weight
constexpr int kLdS = 20;             // f32 row pitch of a warp's 16 x 16 scratch
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTaps = 19;
constexpr int kChunks = kHid / kBK;
constexpr int kIters = kTaps * kChunks;
constexpr int kStageElems = kBM * kLd;                       // one A (or B) stage
constexpr int kPipeBytes = 4 * kStageElems * (int)sizeof(bf16);  // 2 x (A + B)
constexpr int kScratchBytes = kWarps * 16 * kLdS * (int)sizeof(float);

static_assert(kBM * kLdH * 2 * (int)sizeof(bf16) <= kPipeBytes,
              "the hidden tile and fc2's weight reuse the pipeline stages");

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

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using AFrag = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using BFrag = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;

// One K step of a warp's 32 x 64 tile: a rows [wm, wm + 32), b features [wn, wn + 64).
__device__ __forceinline__ void warp_mma(AccFrag (&acc)[2][4], const bf16* a, int lda,
                                         const bf16* b, int ldb, int wm, int wn, int kk) {
  AFrag af[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(af[i], a + (wm + i * 16) * lda + kk, lda);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    BFrag bfr;
    wmma::load_matrix_sync(bfr, b + (wn + j * 16) * ldb + kk, ldb);
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
  }
}

// A 16 x 16 accumulator through the warp's scratch: lane l then holds the eight
// values of row l / 2, columns (l % 2) * 8 .. + 8, after bias, BN affine and GELU.
__device__ __forceinline__ void frag_epilogue(const AccFrag& acc, float* scratch, int lane,
                                              const float* bias, const float* scale,
                                              const float* shift, int col0, float (&v)[8]) {
  wmma::store_matrix_sync(scratch, acc, kLdS, wmma::mem_row_major);
  __syncwarp();
  const int rr = lane >> 1, cc = (lane & 1) * 8;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = col0 + cc + e;
    v[e] = bias_bn_gelu(scratch[rr * kLdS + cc + e], __ldg(bias + c), __ldg(scale + c),
                        __ldg(shift + c));
  }
  __syncwarp();
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  __align__(16) __nv_bfloat162 h[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  return *reinterpret_cast<const uint4*>(h);
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

// out[M, cout] = gelu(bn3(gelu(bn2(sum_t shift_t(h) @ taps[t]^T + dwb)) @ w2^T + b2)),
// M = B * N tokens on (H, W) grids; h (M, 128) bf16; taps (19, 128, 128) bf16 as
// (out, in); w2 (cout, 128) bf16; cout % 16 == 0, cout <= 128.
__global__ void __launch_bounds__(kThreads, 2)
taps_kernel(const bf16* __restrict__ h, const bf16* __restrict__ taps,
            const float* __restrict__ dwb, const float* __restrict__ s2,
            const float* __restrict__ t2, const bf16* __restrict__ w2,
            const float* __restrict__ b2, const float* __restrict__ s3,
            const float* __restrict__ t3, float* __restrict__ out, int M, int N, int H,
            int W, int cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);        // [2][kBM][kLd]
  bf16* Bs = As + 2 * kStageElems;                 // [2][kHid][kLd]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* scratch = reinterpret_cast<float*>(smem + kPipeBytes) + warp * 16 * kLdS;
  const int m0 = blockIdx.x * kBM;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  // the four A rows (and B rows) this thread copies in every stage, 16 bytes each
  const int c8 = (tid & 7) * 8;
  int ry[4], rx[4], rtok[4];
  bool rok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + (tid >> 3) + 32 * i;
    rok[i] = gm < M;
    const int n = gm % N;
    ry[i] = n / W;
    rx[i] = n - ry[i] * W;
    rtok[i] = gm;
  }

  auto load = [&](int stage, int it) {
    const int tap = it / kChunks, k0 = (it - tap * kChunks) * kBK;
    int dy, dx;
    tap_offset(tap, dy, dx);
    bf16* a = As + stage * kStageElems;
    bf16* b = Bs + stage * kStageElems;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 3) + 32 * i;
      const int yy = ry[i] + dy, xx = rx[i] + dx;
      const bool ok = rok[i] && yy >= 0 && yy < H && xx >= 0 && xx < W;
      const bf16* src = ok ? h + (size_t)(rtok[i] + dy * W + dx) * kHid + k0 + c8 : h;
      cp_async16(a + r * kLd + c8, src, ok ? 16 : 0);   // 0 bytes read: the row is zeros
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = (tid >> 3) + 32 * i;
      cp_async16(b + n * kLd + c8, taps + ((size_t)tap * kHid + n) * kHid + k0 + c8, 16);
    }
    cp_async_commit();
  };

  AccFrag acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load(0, 0);
  for (int it = 0; it < kIters; ++it) {
    if (it + 1 < kIters) {
      load((it + 1) & 1, it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a = As + (it & 1) * kStageElems;
    const bf16* b = Bs + (it & 1) * kStageElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) warp_mma(acc, a, kLd, b, kLd, wm, wn, kk);
    __syncthreads();
  }

  // the stages are free: the hidden tile and fc2's weight take their place
  bf16* h2 = reinterpret_cast<bf16*>(smem);
  bf16* w2s = h2 + kBM * kLdH;
  for (int idx = tid; idx < cout * (kHid / 8); idx += kThreads) {
    const int n = idx / (kHid / 8), c = (idx % (kHid / 8)) * 8;
    *reinterpret_cast<uint4*>(w2s + n * kLdH + c) =
        *reinterpret_cast<const uint4*>(w2 + (size_t)n * kHid + c);
  }
  const int rr = lane >> 1, cc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v[8];
      const int col0 = wn + j * 16;
      frag_epilogue(acc[i][j], scratch, lane, dwb, s2, t2, col0, v);
      *reinterpret_cast<uint4*>(h2 + (wm + i * 16 + rr) * kLdH + col0 + cc) = pack8(v);
    }
  __syncthreads();

  // fc2: warp w owns rows [16 w, 16 w + 16) of the tile, 16 output features at a time
  const int gm = m0 + warp * 16 + rr;
  for (int nf = 0; nf < cout / 16; ++nf) {
    AccFrag o;
    wmma::fill_fragment(o, 0.0f);
#pragma unroll
    for (int kk = 0; kk < kHid; kk += 16) {
      AFrag af;
      BFrag bfr;
      wmma::load_matrix_sync(af, h2 + warp * 16 * kLdH + kk, kLdH);
      wmma::load_matrix_sync(bfr, w2s + nf * 16 * kLdH + kk, kLdH);
      wmma::mma_sync(o, af, bfr, o);
    }
    float v[8];
    frag_epilogue(o, scratch, lane, b2, s3, t3, nf * 16, v);
    if (gm < M) {
      float4* dst = reinterpret_cast<float4*>(out + (size_t)gm * cout + nf * 16 + cc);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
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

extern "C" int k5_mlp_taps(const void* h, const void* taps, const void* dwb, const void* s2,
                           const void* t2, const void* w2, const void* b2, const void* s3,
                           const void* t3, void* out, int B, int H, int W, int cout,
                           void* stream) {
  const int smem = rss::kPipeBytes + rss::kScratchBytes;
  cudaError_t err = cudaFuncSetAttribute(rss::taps_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int N = H * W, M = B * N;
  rss::taps_kernel<<<(M + rss::kBM - 1) / rss::kBM, rss::kThreads, smem,
                     (cudaStream_t)stream>>>(
      (const rss::bf16*)h, (const rss::bf16*)taps, (const float*)dwb, (const float*)s2,
      (const float*)t2, (const rss::bf16*)w2, (const float*)b2, (const float*)s3,
      (const float*)t3, (float*)out, M, N, H, W, cout);
  return (int)cudaGetLastError();
}
