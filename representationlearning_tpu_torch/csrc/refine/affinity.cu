// K2: dilated-neighbour affinity weights for VARM / PAR / PAMR.
//
// Replaces: the TPU kernel `affinity_pallas`
//   (representationlearning_tpu/ops/pallas/affinity.py:134, body `_kernel` :46).
// What it computes, per pixel (b, y, x), over the K = 8 * n_dil taps in order:
//   nb_k[c] = img[b, c, clamp(y + dy d), clamp(x + dx d)]
//   mean, unbiased variance of nb over K per channel (two passes)
//   inv[c]  = scale / (sqrt(var / (K - 1)) + 1e-8)
//   a_k     = -mean_c((|nb_k[c] - centre[c]| * inv[c])^2)
//   out_k   = softmax_k(a) + w2 * pos[k]              (par)
//           = softmax_k(a)                            (pamr)
//           = softmax_k(a) - w2 * softmax_k(t)        (varm)
//   t_k     = mean_c(d1^2 + d2^2), d1 / d2 the difference of nb_k to the same
//             tap of the next output row / column (zero on the last one).
// What bounds it on the H100: device-memory bytes in principle, the (B, K, H, W)
//   f32 output being K / 3 times the input; in practice the instructions of the three
//   passes over the taps (mean, variance, logits) and the shared-memory reads they
//   make, and in varm mode the variation's two more neighbours a tap.
// What the design does about it: a block stages its tile of 32 columns x ROWS rows
//   of the three planes, plus the halo its taps and the variation's next row and
//   column reach, in shared memory by one tensor-map copy (the copy engine: none of the
//   load-store queue that the tap reads use), the places outside the image taking the
//   nearest image element's value, so replicate padding costs the tap loops nothing.
//   One thread a pixel:
//   - the logits stay in registers (a compile-time count of taps HELD * 8 with the
//     run-time n_dil <= HELD), the variations in shared memory (one column a
//     thread), so each is computed once; the max, sum and write passes read them;
//   - one correctly rounded reciprocal a softmax, then one product an output;
//   - each of the K planes is written once, a warp's 32 values of a row in one
//     line, with streaming stores.
//   Every operation is rounded as written (explicit intrinsics, no contraction left
//   to the compiler), so every plan gives the same bits. The variation rounds each
//   square and sum on its own as the plain version's elementwise ops do: on raw
//   0..255 images t reaches 1e5, where one f32 spacing (0.008) is a percent of
//   exp(t - tmax). A pixel whose neighbours all equal the centre gets exactly zero
//   logits and a uniform softmax, whatever `inv` is.
#include "common.cuh"

namespace refine {

constexpr int kPar = 0, kPamr = 1, kVarm = 2;
// Kernels holding six dilations stage a fixed box: 32 columns, a halo of kHalo6 each
// side and the next column (kPitch6 floats, the next 16 bytes), ROWS + 2 * kHalo6 + 1
// rows (the halo and the next row).
constexpr int kHalo6 = 24;
constexpr int kPitch6 = 32 + 2 * kHalo6 + 4;

struct AffArgs {
  const float* img;
  float* out;
  int H, W, n_dil;
  int hy, hx4, srows, pitch;  // staged halo (x: a multiple of 4), rows and pitch
  int vec;                    // the image's rows are 16-byte aligned: staged by a tensor map
  float scale, w2, rk, rk1;   // rk = 1 / K, rk1 = 1 / (K - 1)
  int tap_off[kMaxTaps];      // staged offset of tap k from its pixel, bytes
  float pos[kMaxTaps];        // par: PAR's position softmax
};

template <int MODE, int ROWS, int HELD>
__global__ void __launch_bounds__(32 * ROWS, HELD <= 6 ? 16 / ROWS : 1)
affinity_kernel(const AffArgs a, const __grid_constant__ CUtensorMap img_map) {
  extern __shared__ __align__(128) float smem[];
  const unsigned bar = smem_addr(smem);  // an mbarrier in the first 128 bytes
  float* const sm = smem + 32;           // then the three staged planes
  constexpr int NT = 32 * ROWS;
  constexpr bool FIXED = HELD <= 6;  // strides and halo known at compile time
  const int pitch = FIXED ? kPitch6 : a.pitch;
  const int srows = FIXED ? ROWS + 2 * kHalo6 + 1 : a.srows;
  const int hy = FIXED ? kHalo6 : a.hy, hx = FIXED ? kHalo6 : a.hx4;
  const int scols = 32 + 2 * hx + 1;
  const int plane = srows * pitch;
  const int lane = threadIdx.x, wr = threadIdx.y, tid = wr * 32 + lane;
  const int b = blockIdx.z, y = blockIdx.y * ROWS + wr, x = blockIdx.x * 32 + lane;
  const int HW = a.H * a.W, K = 8 * a.n_dil;
  const int y0 = blockIdx.y * ROWS - hy, x0 = blockIdx.x * 32 - hx;
  // The tile, its halo and the next row and column of the three planes: one
  // tensor-map copy where the image's rows are 16-byte aligned (what lies outside the
  // image arrives as zeros and takes the value of the nearest image element), clamped
  // loads by every thread elsewhere.
  if (a.vec) {
    if (tid == 0) {
      mbar_init(bar, 1);
      mbar_init_fence();
      mbar_arrive_expect(bar, 4 * 3 * plane);
      tma_box(sm, &img_map, x0, y0, 3 * b, bar);
    }
    __syncthreads();  // the mbarrier is made before anyone waits on it
    mbar_wait(bar, 0);
    const int top = max(0, -y0), bottom = max(0, y0 + srows - a.H);
    const int left = max(0, -x0), right = max(0, x0 + scols - a.W);
    if (top | bottom | left | right) {
      auto fix = [&](int r, int c) {
        const int from = (clampi(y0 + r, a.H - 1) - y0) * pitch + clampi(x0 + c, a.W - 1) - x0;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) sm[ch * plane + r * pitch + c] = sm[ch * plane + from];
      };
      for (int r = wr; r < srows; r += ROWS) {  // a warp a row
        if (r < top || r >= srows - bottom) {
          for (int c = lane; c < scols; c += 32) fix(r, c);
        } else {
          for (int c = lane; c < left + right; c += 32)
            fix(r, c < left ? c : scols - right + c - left);
        }
      }
    }
  } else {
    const float* img = a.img + (size_t)b * 3 * HW;
    for (int ch = 0; ch < 3; ++ch)
      for (int r = wr; r < srows; r += ROWS) {
        const float* row = img + ch * HW + clampi(y0 + r, a.H - 1) * a.W;
        for (int c = lane; c < scols; c += 32)
          sm[ch * plane + r * pitch + c] = row[clampi(x0 + c, a.W - 1)];
      }
  }
  __syncthreads();
  // this pixel in channel 0; channel c lies c * plane floats on, tap k tap_off[k] bytes
  const char* sb = reinterpret_cast<const char*>(sm + (wr + hy) * pitch + lane + hx);
  auto at = [&](int off, int c) {
    return *reinterpret_cast<const float*>(sb + off + 4 * c * plane);
  };
  float ctr[3], mean[3], inv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) ctr[c] = at(0, c), mean[c] = 0.f, inv[c] = 0.f;

  // mean over the K neighbours
#pragma unroll
  for (int i = 0; i < HELD; ++i)
    if (i < a.n_dil) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 3; ++c) mean[c] = __fadd_rn(mean[c], at(a.tap_off[8 * i + j], c));
    }
#pragma unroll
  for (int c = 0; c < 3; ++c) mean[c] = __fmul_rn(mean[c], a.rk);

  // unbiased variance -> inv = scale / (std + 1e-8)
#pragma unroll
  for (int i = 0; i < HELD; ++i)
    if (i < a.n_dil) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float df = __fsub_rn(at(a.tap_off[8 * i + j], c), mean[c]);
          inv[c] = __fmaf_rn(df, df, inv[c]);
        }
    }
#pragma unroll
  for (int c = 0; c < 3; ++c)
    inv[c] = __fdiv_rn(a.scale, __fadd_rn(__fsqrt_rn(__fmul_rn(inv[c], a.rk1)), 1e-8f));

  // the logits (registers) and, in varm mode, the variations (shared memory)
  float* tv = sm + 3 * plane + tid;  // t_k at tv[k * NT]
  const bool last_row = y >= a.H - 1, last_col = x >= a.W - 1;
  float lg[8 * HELD];
  float amax = -INFINITY, tmax = -INFINITY;
#pragma unroll
  for (int i = 0; i < HELD; ++i)
    if (i < a.n_dil) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = 8 * i + j, off = a.tap_off[k];
        float sq = 0.f, t = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float v = at(off, c);
          const float e = __fmul_rn(fabsf(__fsub_rn(v, ctr[c])), inv[c]);
          sq = __fmaf_rn(e, e, sq);
          if (MODE == kVarm) {
            // the same tap seen from the next output row / column: staged one row /
            // column further on (clamp(y + 1 + oy), not clamp(y + oy) + 1)
            const float d1 = last_row ? 0.f : __fsub_rn(v, at(off + 4 * pitch, c));
            const float d2 = last_col ? 0.f : __fsub_rn(v, at(off + 4, c));
            const float u = __fadd_rn(__fmul_rn(d1, d1), __fmul_rn(d2, d2));
            t = c == 0 ? u : __fadd_rn(t, u);
          }
        }
        lg[k] = __fmul_rn(-sq, 1.0f / 3.0f);
        amax = fmaxf(amax, lg[k]);
        if (MODE == kVarm) {
          t = __fmul_rn(t, 1.0f / 3.0f);
          tv[k * NT] = t;
          tmax = fmaxf(tmax, t);
        }
      }
    }

  // the softmax denominators; exponentials kept where their arguments were
  float asum = 0.f, tsum = 0.f;
#pragma unroll
  for (int i = 0; i < HELD; ++i)
    if (i < a.n_dil) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = 8 * i + j;
        lg[k] = __expf(__fsub_rn(lg[k], amax));
        asum = __fadd_rn(asum, lg[k]);
        if (MODE == kVarm) {
          const float e = __expf(__fsub_rn(tv[k * NT], tmax));
          tv[k * NT] = e;
          tsum = __fadd_rn(tsum, e);
        }
      }
    }
  if (y >= a.H || x >= a.W) return;
  const float ra = __frcp_rn(asum), rt = MODE == kVarm ? __frcp_rn(tsum) : 0.f;

  // each weight once: plane k, row y, coalesced along x, not kept in cache
  float* o = a.out + (size_t)b * K * HW + y * a.W + x;
#pragma unroll
  for (int i = 0; i < HELD; ++i)
    if (i < a.n_dil) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = 8 * i + j;
        float r = __fmul_rn(lg[k], ra);
        if (MODE == kPar) r = __fadd_rn(r, __fmul_rn(a.w2, a.pos[k]));
        if (MODE == kVarm) r = __fsub_rn(r, __fmul_rn(a.w2, __fmul_rn(tv[k * NT], rt)));
        __stcs(o + k * HW, r);
      }
    }
}

using AffKernel = void (*)(AffArgs, CUtensorMap);

// (mode, rows a block, dilations held) -> its instantiation, or nullptr for a plan
// the kernel does not have; `slot` numbers the (rows, held) pairs
template <int MODE>
inline AffKernel affinity_of(int rows, int held, int* slot) {
  *slot = held == kMaxDilations ? 3 : rows == 4 ? 0 : rows == 8 ? 1 : 2;
  if (held == 6 && rows == 4) return affinity_kernel<MODE, 4, 6>;
  if (held == 6 && rows == 8) return affinity_kernel<MODE, 8, 6>;
  if (held == 6 && rows == 16) return affinity_kernel<MODE, 16, 6>;
  if (held == kMaxDilations && rows == 4) return affinity_kernel<MODE, 4, kMaxDilations>;
  return nullptr;
}

inline AffKernel affinity_kernel_of(int mode, int rows, int held, int* slot) {
  return mode == kPar ? affinity_of<kPar>(rows, held, slot)
         : mode == kPamr ? affinity_of<kPamr>(rows, held, slot)
         : mode == kVarm ? affinity_of<kVarm>(rows, held, slot)
                         : nullptr;
}

// lets an instantiation take `smem` bytes of dynamic shared memory: once per process
// and size (a larger grant covers every smaller one)
inline cudaError_t affinity_prepare(AffKernel kernel, int mode, int slot, int smem) {
  static int granted[3][4] = {};
  int& g = granted[mode][slot];
  if (smem <= (g > 48 * 1024 ? g : 48 * 1024)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) g = smem;
  return err;
}

}  // namespace refine

// imgs (B, 3, H, W) f32 -> out (B, 8 * n_dil, H, W) f32. `dilations` and `pos`
// (8 * n_dil floats, read in par mode only) are host arrays; `rows` and `held` come
// from the wrapper's plan (`ops/affinity.py::affinity_plan`).
extern "C" int k2_affinity(const void* imgs, void* out, int B, int H, int W,
                           const int* dilations, int n_dil, int mode, float scale,
                           float w2, const float* pos, int rows, int held, void* stream) {
  using namespace refine;
  int slot = 0;
  const AffKernel kernel = affinity_kernel_of(mode, rows, held, &slot);
  if (kernel == nullptr || n_dil < 1 || n_dil > held || B < 1 || H < 1 || W < 1 ||
      B > 65535 || 8LL * n_dil * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int max_d = max_dilation(dilations, n_dil), K = 8 * n_dil;
  AffArgs a;
  a.img = (const float*)imgs;
  a.out = (float*)out;
  a.H = H, a.W = W, a.n_dil = n_dil;
  a.hy = halo(max_d, H), a.hx4 = halo4(halo(max_d, W));
  const bool fixed = held <= 6;  // the kernel's strides and halo are its constants
  if (fixed && (a.hy > kHalo6 || a.hx4 > kHalo6)) return (int)cudaErrorInvalidValue;
  // the tile, its halo and the next row; the same columns in rows of 16-byte pieces
  a.srows = fixed ? rows + 2 * kHalo6 + 1 : rows + 2 * a.hy + 1;
  a.pitch = fixed ? kPitch6 : 32 + 2 * a.hx4 + 4;
  a.vec = W % 4 == 0 && (size_t)imgs % 16 == 0 && a.srows <= 256 && a.pitch <= 256;
  a.scale = scale, a.w2 = w2;
  a.rk = 1.0f / (float)K, a.rk1 = 1.0f / (float)(K - 1);
  tap_offsets(dilations, n_dil, H, W, a.pitch, a.tap_off);
  for (int k = 0; k < kMaxTaps; ++k) a.pos[k] = mode == kPar && k < K ? pos[k] : 0.f;
  // an mbarrier (128 bytes), the three staged planes and, in varm mode, the variations
  const long long smem =
      128 + 4LL * (3LL * a.srows * a.pitch + (mode == kVarm ? K * 32LL * rows : 0));
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap map = {};
  if (a.vec) {
    const cudaError_t err = plane_tensor_map(&map, a.img, 3 * B, H, W, a.srows, a.pitch, 3);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaError_t err = affinity_prepare(kernel, mode, slot, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + 31) / 32, (H + rows - 1) / rows, B);
  kernel<<<grid, dim3(32, rows), (size_t)smem, (cudaStream_t)stream>>>(a, map);
  return (int)cudaGetLastError();
}

// Blocks of an instantiation with `smem` bytes one SM holds at once, as the card
// reports it; -1 for a plan the kernel does not have.
extern "C" int k2_affinity_blocks_per_sm(int mode, int rows, int held, int smem) {
  using namespace refine;
  int slot = 0;
  const AffKernel kernel = affinity_kernel_of(mode, rows, held, &slot);
  int n = -1;
  if (kernel == nullptr || smem > kSmemLimit ||
      affinity_prepare(kernel, mode, slot, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 32 * rows, smem) != cudaSuccess)
    return -1;
  return n;
}
