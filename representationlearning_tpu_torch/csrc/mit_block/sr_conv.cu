// K1 part 2b: the spatial-reduction conv of the block, the stride-sr sr x sr
// conv of LN(x) on the token grid, as an implicit-im2col tensor-core product split
// along K. This file holds the kernel with bf16 operands (`mma.sync`) and the C entry
// point; with f32 operands the entry point launches `sr_conv_wg_kernel` (3xTF32
// `wgmma`, its K slices summed inside a thread-block cluster; sr_conv_f32.cu, a source
// of its own so that nvcc builds it side by side).
//
// Replaces: the sr x sr stride-sr patch conv + bias of the TPU kernel
//   representationlearning_tpu/ops/pallas/mit_block.py:85-135 ("taps"), reached
//   from `fused_block_pallas` :259 -> `_kernel` :216 -> `_block_math` :62.
// What bounds it on the H100: bytes. The product is thin and deep: M = B Hs Ws
//   patch rows (2,048 at every stage of the 512 x 512 forward, 16 to 3,600 in
//   the CAM forwards), Nout = C = 64 / 128 / 320, K = sr^2 C = 4,096 / 2,048 /
//   1,280; 1 GFLOP beside 33.5 / 16.8 / 10.5 MB of f32 activations that are
//   read once. What it really waits for is latency: tiled over M and Nout
//   alone the grid is a few dozen blocks, each walking a long K alone.
// What the design of the bf16 kernel does about it:
//   * Split K, deterministically. The wrapper's plan (`sr_conv_plan` in
//     ops/mit_block.py, a function of the shapes only) cuts K into slices of
//     whole K steps so that the grid fills the card's 132 SMs; the block of
//     slice s writes its 64 x BN partial tile to slice s of a workspace (a few
//     MB: it stays in L2) and `sr_reduce_kernel` adds the slices in slice order,
//     then the bias. No atomics: two runs give equal bits. With one slice the
//     block adds the bias and writes the result itself.
//   * A pipelined K loop. The bf16 weights of K step k + 2 travel by `cp.async`
//     into a ring of three shared-memory stages; the f32 activations of step
//     k + 1 are loaded into registers before the products of step k are issued
//     and are normalised, rounded and stored to the other of two shared-memory
//     buffers after them, so loads are in flight during the products. One
//     barrier a step.
//   * Addresses once. A thread owns four patch rows; the token at the patch's
//     corner is found once, before the loop (the only divisions), and a K step
//     moves (channel, kx, ky) forward with additions. The LayerNorm statistics
//     of a row's token are reloaded only when the tap changes.
//   * A read once where it can be: the block tile is 64 x 128 outputs for
//     C > 64 (one column tile at C = 128, three at C = 320, whose repeats come
//     from L2), 64 x 64 at C <= 64.
//   * `mma.sync` m16n8k16 with `ldmatrix` fragments from padded (conflict-free)
//     tiles; LayerNorm is applied step by step as the plain version rounds it,
//     so both feed the same bf16 operands to the product.
#include "common.cuh"

namespace k1 {

constexpr int kSrBM = 64, kSrBK = 32;
// pitch of the A and B tiles in elements: 32 and 16 bytes of padding (80 bytes),
// conflict-free for `ldmatrix`
constexpr int kSrPitch = kSrBK + 8;
constexpr int kSrThreads = 128;      // 2 x 2 warps, a warp owns 32 x BN / 2 outputs
constexpr int kSrRing = 3;

// bytes of dynamic shared memory: two A tiles and a ring of kSrRing B tiles
template <int BN>
constexpr int sr_smem() {
  return (2 * kSrBM + kSrRing * BN) * kSrPitch * (int)sizeof(bf16);
}

struct SrGeo {
  int C, H, W, sr, Hs, Ws, M, K;
  int steps_per_slice;  // K steps of 32 a slice
};

template <int BN>
__global__ void __launch_bounds__(kSrThreads)
sr_conv_kernel(const float* __restrict__ x, const float* __restrict__ stats,
               const float* __restrict__ lnw, const float* __restrict__ lnb,
               const bf16* __restrict__ Wt, const float* __restrict__ bias,
               float* __restrict__ dst, SrGeo g) {
  constexpr int kNT = BN / 16;  // 8-column accumulator tiles a warp
  constexpr int kP = kSrPitch, kSK = kSliceK<bf16>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As0 = reinterpret_cast<bf16*>(smem);    // [2][kSrBM * kP]
  bf16* Bs0 = As0 + 2 * kSrBM * kP;             // [kSrRing][BN * kP]
  auto As = [&](int i) { return As0 + i * kSrBM * kP; };
  auto Bs = [&](int i) { return Bs0 + i * BN * kP; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * kSrBM, n0 = blockIdx.y * BN, slice = blockIdx.z;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * (BN / 2);
  const int total_steps = g.K / kSrBK;
  const int first = slice * g.steps_per_slice;
  const int nsteps = min(g.steps_per_slice, total_steps - first);

  // this thread's part of an A tile: rows (tid / 8) + 16 i, columns kc .. kc + 3
  const int kc = (tid & 7) * 4;
  int corner[4];  // token at the top left of the patch of row i, -1 past M
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + (tid >> 3) + 16 * i;
    corner[i] = -1;
    if (gm < g.M) {
      const int per = g.Hs * g.Ws, b = gm / per, p = gm - b * per;
      const int pi = p / g.Ws, pj = p - pi * g.Ws;
      corner[i] = (b * g.H + pi * g.sr) * g.W + pj * g.sr;
    }
  }
  // column k = (ky * sr + kx) * C + c; a K step stays inside one tap (C % 32 == 0)
  int c0, kx, ky;
  {
    const int k0 = first * kSrBK, tap = k0 / g.C;
    c0 = k0 - tap * g.C;
    ky = tap / g.sr;
    kx = tap - ky * g.sr;
  }
  float4 a[4];
  float mu[4], rs[4];
  float4 gw, gb;
  bool new_tap = true;

  auto load_a = [&]() {  // the step at (c0, kx, ky) into registers, then move on
    const int off = ky * g.W + kx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (corner[i] >= 0) {
        const size_t tok = (size_t)(corner[i] + off);
        a[i] = *reinterpret_cast<const float4*>(x + tok * g.C + c0 + kc);
        if (new_tap) {
          const float2 st = *reinterpret_cast<const float2*>(stats + 2 * tok);
          mu[i] = st.x;
          rs[i] = st.y;
        }
      }
    }
    gw = __ldg(reinterpret_cast<const float4*>(lnw + c0 + kc));
    gb = __ldg(reinterpret_cast<const float4*>(lnb + c0 + kc));
    c0 += kSrBK;
    new_tap = c0 == g.C;
    if (new_tap) {
      c0 = 0;
      if (++kx == g.sr) {
        kx = 0;
        ++ky;
      }
    }
  };
  auto store_a = [&](bf16* dstA) {  // LayerNorm, rounded to bf16, to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 n = make_float4(0.f, 0.f, 0.f, 0.f);
      if (corner[i] >= 0)
        n = make_float4(ln_apply(a[i].x, mu[i], rs[i], gw.x, gb.x),
                        ln_apply(a[i].y, mu[i], rs[i], gw.y, gb.y),
                        ln_apply(a[i].z, mu[i], rs[i], gw.z, gb.z),
                        ln_apply(a[i].w, mu[i], rs[i], gw.w, gb.w));
      bf16* at = dstA + ((tid >> 3) + 16 * i) * kP + kc;
      *reinterpret_cast<uint2*>(at) = make_uint2(pack_bf16(n.x, n.y), pack_bf16(n.z, n.w));
    }
  };
  auto fetch_b = [&](int step) {  // one commit group a call, empty past the end
    if (step < nsteps) {
      bf16* d = Bs(step % kSrRing);
      const bf16* src = Wt + (size_t)(first + step) * kSrBK;
      constexpr int kPieces = kSrBK * (int)sizeof(bf16) / 16, kPer = 16 / (int)sizeof(bf16);
      for (int idx = tid; idx < BN * kPieces; idx += kSrThreads) {
        const int r = idx / kPieces, c = (idx % kPieces) * kPer;
        const bool ok = n0 + r < g.C;
        cp_async16(d + r * kP + c, src + (size_t)(ok ? n0 + r : 0) * g.K + c, ok);
      }
    }
    cp_async_commit();
  };

  float acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  fetch_b(0);
  fetch_b(1);
  load_a();
  store_a(As(0));
  for (int step = 0; step < nsteps; ++step) {
    const bool more = step + 1 < nsteps;
    if (more) load_a();  // in flight during the products below
    cp_async_wait<1>();
    __syncthreads();  // B of this step has landed, A of this step is stored, and every
                      // warp is done with the step before: its buffers are free
    fetch_b(step + 2);
    const bf16* A = As(step & 1);
    const bf16* Bt = Bs(step % kSrRing);
#pragma unroll
    for (int kk = 0; kk < kSrBK; kk += kSK) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], A + (wm + i * 16 + (lane & 15)) * kP + kk + (lane >> 4) * (kSK / 2));
#pragma unroll
      for (int j2 = 0; j2 < kNT / 2; ++j2) {
        uint32_t bf[4];  // output columns 0-7 (first and second half of the slice), then 8-15
        ldsm_x4(bf, Bt + (wn + j2 * 16 + (lane & 7) + (lane >> 4) * 8) * kP + kk +
                        ((lane >> 3) & 1) * (kSK / 2));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_slice<bf16>(acc[i][2 * j2], af[i], bf[0], bf[1]);
          mma_slice<bf16>(acc[i][2 * j2 + 1], af[i], bf[2], bf[3]);
        }
      }
    }
    if (more) store_a(As((step + 1) & 1));
  }
  cp_async_wait<0>();

  // one slice: the result with its bias; more: this slice's share of the workspace
  const bool whole = gridDim.z == 1;
  float* o = dst + (whole ? (size_t)0 : (size_t)slice * g.M * g.C);
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
      if (col >= g.C) continue;
      const float b0 = whole ? bias[col] : 0.f, b1 = whole ? bias[col + 1] : 0.f;
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int row = m0 + wm + i * 16 + gq + hlf * 8;
        if (row < g.M)
          *reinterpret_cast<float2*>(o + (size_t)row * g.C + col) =
              make_float2(acc[i][j][2 * hlf] + b0, acc[i][j][2 * hlf + 1] + b1);
      }
    }
}

// out = ((slice 0 + slice 1) + ... + slice S-1) + bias, four outputs a thread
__global__ void sr_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                                 float* __restrict__ out, size_t total4, int C, int slices) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total4) return;
  const float4* p = reinterpret_cast<const float4*>(ws) + idx;
  float4 v = p[0];
  for (int s = 1; s < slices; ++s) {
    const float4 u = p[(size_t)s * total4];
    v.x = __fadd_rn(v.x, u.x);
    v.y = __fadd_rn(v.y, u.y);
    v.z = __fadd_rn(v.z, u.z);
    v.w = __fadd_rn(v.w, u.w);
  }
  const float4 b = *reinterpret_cast<const float4*>(bias + (idx * 4) % C);
  reinterpret_cast<float4*>(out)[idx] =
      make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
}

// lets the instantiation take its dynamic shared memory, once
template <int BN>
cudaError_t sr_prepare() {
  static const cudaError_t err = cudaFuncSetAttribute(
      sr_conv_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, sr_smem<BN>());
  return err;
}

cudaError_t sr_launch(const float* x, const float* stats, const float* lnw, const float* lnb,
                      const void* w, const float* bias, float* dst, const SrGeo& g, int bn,
                      dim3 grid, cudaStream_t st) {
  if (bn == 64) {
    const cudaError_t err = sr_prepare<64>();
    if (err != cudaSuccess) return err;
    sr_conv_kernel<64><<<grid, kSrThreads, sr_smem<64>(), st>>>(
        x, stats, lnw, lnb, (const bf16*)w, bias, dst, g);
  } else {
    const cudaError_t err = sr_prepare<128>();
    if (err != cudaSuccess) return err;
    sr_conv_kernel<128><<<grid, kSrThreads, sr_smem<128>(), st>>>(
        x, stats, lnw, lnb, (const bf16*)w, bias, dst, g);
  }
  return cudaGetLastError();
}

// the f32 operand path, `sr_conv_wg_kernel` (sr_conv_f32.cu, built beside this file)
int sr_conv_f32(const float* x, const float* stats, const float* lnw, const float* lnb,
                const float* w, const float* bias, float* out, int B, int H, int W, int C, int sr,
                int rows, int bn, int slices, cudaStream_t st);
int sr_conv_f32_smem(int rows, int bn);
int sr_conv_f32_clusters(int rows, int bn, int slices);

}  // namespace k1

// out[B * Hs * Ws, C] = im2col(LN(x))[., sr*sr*C] @ w[C, sr*sr*C]^T + bias: the
// stride-sr sr x sr conv over the (H, W) token grid of x (B, H*W, C), cropped to
// full windows. w is the OHWI weight flattened to (C, sr*sr*C), bf16, or f32 where
// `f32` is set (the operand type of the products); C % 32 == 0.
// The plan is the wrapper's: bf16, `bn` (64 or 128) the width of a block's output tile
// (`rows` 64) and `slices` the number of K slices; with slices > 1, `ws` holds slices *
// M * C floats and a second kernel adds them. f32, a tile of `rows` x `bn` (64 or 128 x
// 32 to 192) and `slices` K slices (at most 16), the blocks of one cluster: one kernel, no
// workspace.
extern "C" int k1_sr_conv(const void* x, const void* stats, const void* lnw, const void* lnb,
                          const void* w, const void* bias, void* ws, void* out, int B, int H,
                          int W, int C, int sr, int rows, int bn, int slices, int f32,
                          void* stream) {
  using namespace k1;
  cudaStream_t st = (cudaStream_t)stream;
  if (f32)
    return sr_conv_f32((const float*)x, (const float*)stats, (const float*)lnw,
                       (const float*)lnb, (const float*)w, (const float*)bias, (float*)out, B, H,
                       W, C, sr, rows, bn, slices, st);
  const int Hs = H / sr, Ws = W / sr;
  const int M = B * Hs * Ws, K = sr * sr * C, steps = K / kSrBK;
  if (M < 1 || C % kSrBK || slices < 1 || slices > steps || rows != kSrBM ||
      (bn != 64 && bn != 128) || (slices > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int per = (steps + slices - 1) / slices;
  if ((slices - 1) * per >= steps) return (int)cudaErrorInvalidValue;  // an empty slice
  const SrGeo g{C, H, W, sr, Hs, Ws, M, K, per};
  const dim3 grid((M + kSrBM - 1) / kSrBM, (C + bn - 1) / bn, slices);
  float* dst = slices > 1 ? (float*)ws : (float*)out;
  cudaError_t err = sr_launch((const float*)x, (const float*)stats, (const float*)lnw,
                              (const float*)lnb, w, (const float*)bias, dst, g, bn, grid, st);
  if (err != cudaSuccess || slices == 1) return (int)err;
  const size_t total4 = (size_t)M * C / 4;
  sr_reduce_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, st>>>(
      (const float*)ws, (const float*)bias, (float*)out, total4, C, slices);
  return (int)cudaGetLastError();
}

// the f32 kernel's dynamic shared memory at a tile, and the clusters of `slices` blocks
// the card holds at once (-1 for a tile it lacks)
extern "C" int k1_sr_conv_wg_smem(int rows, int bn) { return k1::sr_conv_f32_smem(rows, bn); }
extern "C" int k1_sr_conv_wg_clusters(int rows, int bn, int slices) {
  return k1::sr_conv_f32_clusters(rows, bn, slices);
}
