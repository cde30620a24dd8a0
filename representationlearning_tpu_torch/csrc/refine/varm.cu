// K3: one iteration of the VARM / PAR mask propagation.
//
// Replaces: the TPU kernel `varm_propagate_pallas`
//   (representationlearning_tpu/ops/pallas/varm.py:91, body `_kernel` :35).
// What it computes:
//   dst[b, c, y, x] = sum_k ref[b, k, y, x] * src[b, c, clamp(y + dy_k d_k), clamp(x + dx_k d_k)]
//   summed in tap order starting from the k = 0 term, f32. The wrapper launches
//   it `num_iter` times, ping-ponging between two buffers.
// What bounds it on the H100: reads inside the SM. Each output takes K mask values
//   at scattered (dilated) offsets and K weights, one multiply and one add each (no
//   fused multiply-add: the result must equal the plain version bit for bit). Device
//   memory (ref, masks in and out: 20.5 us at 8 x 18 x 160^2) and the f32 instruction rate
//   (10.6 us) sit below the shared-memory reads of K mask values an output (23.9 us).
// What the design does about it: the TPU kernel keeps whole planes in VMEM for all
//   iterations; 227 KB of shared memory holds two 160^2 planes at most, so a launch is
//   one iteration. Persistent blocks walk a contiguous range of steps, each a tile of
//   32 columns x TR rows and PLANES of its planes (kPlanes2, or one for the kernel of
//   one pixel a thread), tile-major:
//   - a thread owns two pixels side by side (or one) and holds their K weights in
//     registers for every plane of the tile in its range, so `ref` is read about once
//     an iteration; in the last step of a tile the next tile's weights replace each
//     dilation's right after its taps, so their loads run under the step;
//   - each step's planes, tile plus halo, arrive in a ring slot by one tensor-map copy
//     (started by one thread, completing on the slot's mbarrier): the copy engine, not
//     the load-store queue that the tap reads use; what lies outside the plane arrives
//     as zeros and takes the nearest plane element's value before the slot is read, so
//     replicate padding costs the tap loop nothing;
//   - the tap loop adds from shared memory at offsets fixed per launch (`tap_offsets`,
//     a uniform register each); an even column offset reads a thread's two pixels with
//     one 8-byte load, and a warp's loads touch every bank once;
//   - neighbouring blocks walk their ranges in opposite directions, flipped every
//     iteration, so a tile shared by two blocks has its weights loaded twice close in
//     time (the second from L2).
//   Each product and each sum is rounded on its own (`__fmul_rn`, `__fadd_rn`), in the
//   plain version's order, so the result equals the plain version bit for bit at every
//   plan.
#include "common.cuh"

namespace refine {

// Kernels holding two pixels a thread keep 2 * 8 * kHeld2 weights in registers and
// stage a fixed box: 32 columns and a halo of kHalo2 each side, kPitch2 floats a row.
constexpr int kHeld2 = 6;
constexpr int kHalo2 = 24;
constexpr int kPitch2 = 32 + 2 * kHalo2;
constexpr int kStages = 2;   // a ring of staged slots: one copy in flight while one is read
constexpr int kPlanes2 = 3;  // planes a step of the two-pixel kernels: a weight serves them all

struct VarmArgs {
  const float* src;
  const float* ref;
  float* dst;
  int C, H, W, n_dil;
  int hy, hx4, pitch, srows;  // staged halo (x: a multiple of 4), row pitch, rows
  int tiles_x, tiles_y;       // tiles along x and y
  int units;                  // B * tiles * ceil(C / planes a step)
  int vec;                    // bit 0: src rows 16-byte aligned; bits 1, 2: dst, ref rows 8
  int flip;                   // the iteration's parity: which blocks walk their range backwards
  unsigned odd;               // bit i: dilation i's column offset is odd
  int tap_off[kMaxTaps];      // staged offset of tap k from its pixel, bytes
};

// One dilation's 8 taps into the sums of the step's PLANES planes. Two pixels a
// thread sit side by side, so an even column offset reads both with one 8-byte load; ODD: the taps
// with a column offset read them one by one.
#define K3_DILATION_TAPS(ODD)                                                        \
  _Pragma("unroll") for (int j = 0; j < 8; ++j) {                                     \
    const int k = 8 * i + j;                                                          \
    _Pragma("unroll") for (int pl = 0; pl < PLANES; ++pl) {                          \
      const float* q = reinterpret_cast<const float*>(sb + a.tap_off[k]) + pl * pstride; \
      float v0, v1 = 0.f;                                                             \
      if (P == 1) {                                                                   \
        v0 = q[0];                                                                    \
      } else if (ODD && tap_dx(j) != 0) {                                             \
        v0 = q[0], v1 = q[1];                                                         \
      } else {                                                                        \
        const float2 v = *reinterpret_cast<const float2*>(q);                         \
        v0 = v.x, v1 = v.y;                                                           \
      }                                                                               \
      const float t0 = __fmul_rn(v0, w[0][k]); /* the k = 0 term starts the sum */    \
      acc[pl][0] = k == 0 ? t0 : __fadd_rn(acc[pl][0], t0);                           \
      if (P == 2) {                                                                   \
        const float t1 = __fmul_rn(v1, w[P - 1][k]);                                  \
        acc[pl][P - 1] = k == 0 ? t1 : __fadd_rn(acc[pl][P - 1], t1);                 \
      }                                                                               \
    }                                                                                 \
  }

template <int WARPS, int P, int HELD, int PLANES>
__global__ void __launch_bounds__(32 * WARPS, P == 2 ? 16 / WARPS : 1)
varm_iter_kernel(const VarmArgs a, const __grid_constant__ CUtensorMap src_map) {
  extern __shared__ __align__(128) float smem[];
  const unsigned bar0 = smem_addr(smem);  // the ring's mbarriers in the first 128 bytes
  float* const sm = smem + 32;            // then its slots
  constexpr int TR = P == 2 ? 2 * WARPS : WARPS;  // tile rows
  const int pitch = P == 2 ? kPitch2 : a.pitch;
  const int srows = P == 2 ? TR + 2 * kHalo2 : a.srows;
  const int hy = P == 2 ? kHalo2 : a.hy, hx = P == 2 ? kHalo2 : a.hx4;
  const int scols = 32 + 2 * hx;
  const int pstride = srows * pitch;                              // a plane of a slot
  const int slot_elems = (PLANES * pstride + 31) / 32 * 32;      // slots 128-byte aligned
  const int lane = threadIdx.x, wr = threadIdx.y;
  // a thread's pixels: two side by side (16 threads a row, a warp two rows), or one
  const int ly = P == 2 ? 2 * wr + (lane >> 4) : wr, lx = P == 2 ? 2 * (lane & 15) : lane;
  const int begin = (int)((long long)a.units * blockIdx.x / gridDim.x);
  const int end = (int)((long long)a.units * (blockIdx.x + 1) / gridDim.x);
  const int n = end - begin;
  if (n <= 0) return;
  // Neighbouring blocks walk their ranges in opposite directions, so the two blocks
  // that share a tile load its weights at about the same time (the second load finds
  // them in L2); the directions flip every iteration, so a block starts where it
  // ended, on weights the previous launch left in L2.
  const int dir = ((blockIdx.x ^ a.flip) & 1) ? -1 : 1;
  const int HW = a.H * a.W, K = 8 * a.n_dil, CP = (a.C + PLANES - 1) / PLANES;

  // a step's unit: planes PLANES * cp and on, of tile (tx, ty) of image b, stepped
  // along the walk (tile-major) without divisions
  struct Unit {
    int cp, tx, ty, b;
  };
  auto unit_of = [&](int u) {
    const int tile = u / CP, t = tile % (a.tiles_x * a.tiles_y);
    return Unit{u - tile * CP, t % a.tiles_x, t / a.tiles_x, tile / (a.tiles_x * a.tiles_y)};
  };
  auto advance = [&](Unit& q) {
    q.cp += dir;
    if (q.cp == CP || q.cp < 0) {
      q.cp = dir > 0 ? 0 : CP - 1;
      q.tx += dir;
      if (q.tx == a.tiles_x || q.tx < 0) {
        q.tx = dir > 0 ? 0 : a.tiles_x - 1;
        q.ty += dir;
        if (q.ty == a.tiles_y || q.ty < 0) q.ty = dir > 0 ? 0 : a.tiles_y - 1, q.b += dir;
      }
    }
  };
  const int first_cp = dir > 0 ? 0 : CP - 1;  // a tile's first unit along the walk

  // A unit's tile + halo of its planes into ring slot `slot`, completing on the slot's
  // mbarrier. Planes with 16-byte aligned rows go by one tensor-map copy (a box
  // `pitch` wide, `srows` high, PLANES deep), started by one thread; what lies outside
  // the plane arrives as zeros and is filled in from the plane's edge when the slot
  // is read (`fill_edges`). Other planes are copied by every thread, clamped.
  auto stage = [&](const Unit& q, int slot) {
    float* buf = sm + slot * slot_elems;
    const unsigned bar = bar0 + 8 * slot;
    const int y0 = q.ty * TR - hy, x0 = q.tx * 32 - hx, c0 = PLANES * q.cp;
    if (a.vec & 1) {
      if (wr == 0 && lane == 0) {
        mbar_arrive_expect(bar, 4 * PLANES * pstride);
        tma_box(buf, &src_map, x0, y0, q.b * a.C + c0, bar);
      }
    } else {
      for (int pl = 0; pl < PLANES && c0 + pl < a.C; ++pl) {
        const float* plane = a.src + (size_t)(q.b * a.C + c0 + pl) * HW;
        for (int r = wr; r < srows; r += WARPS) {
          const float* row = plane + clampi(y0 + r, a.H - 1) * a.W;
          for (int c = lane; c < scols; c += 32)
            buf[pl * pstride + r * pitch + c] = row[clampi(x0 + c, a.W - 1)];
        }
      }
      if (wr == 0 && lane == 0) mbar_arrive(bar);  // read after the next barrier
    }
  };
  // the staged elements of a tensor-map slot that lie outside the plane: each takes
  // the value of the nearest plane element, staged in the same slot (a warp a row:
  // rows above and below the plane whole, the others where they lie left or right)
  auto fill_edges = [&](const Unit& q, int slot) {
    const int y0 = q.ty * TR - hy, x0 = q.tx * 32 - hx;
    const int top = max(0, -y0), bottom = max(0, y0 + srows - a.H);
    const int left = max(0, -x0), right = max(0, x0 + scols - a.W);
    if (!(a.vec & 1) || (top | bottom | left | right) == 0) return;
    float* buf = sm + slot * slot_elems;
    auto fix = [&](int r, int c) {
      const int from = (clampi(y0 + r, a.H - 1) - y0) * pitch + clampi(x0 + c, a.W - 1) - x0;
#pragma unroll
      for (int pl = 0; pl < PLANES; ++pl)
        buf[pl * pstride + r * pitch + c] = buf[pl * pstride + from];
    };
    for (int r = wr; r < srows; r += WARPS) {  // a warp a row
      if (r < top || r >= srows - bottom) {
        for (int c = lane; c < scols; c += 32) fix(r, c);
      } else {
        for (int c = lane; c < left + right; c += 32)
          fix(r, c < left ? c : scols - right + c - left);
      }
    }
    fence_proxy_async();  // these writes before later copies into the slot
  };

  // A tile's pixels, and their weights into registers. In the last step of a tile
  // the next tile's weights replace each dilation's right after its taps, so their
  // loads run under the rest of the step.
  struct Pixels {
    int pix;
    bool in0, in1, pair;  // pair: both weights of a thread by one 8-byte load
  };
  auto pixels_of = [&](const Unit& q) {
    const int x = q.tx * 32 + lx, y = q.ty * TR + ly;
    Pixels t;
    t.in0 = y < a.H && x < a.W;
    t.in1 = P == 2 && y < a.H && x + 1 < a.W;
    t.pix = t.in0 ? y * a.W + x : 0;
    t.pair = P == 2 && t.in1 && (a.vec & 4) && !(t.pix & 1);
    return t;
  };
  float w[P][8 * HELD];
  auto load_weights = [&](const Pixels& t, int b, int i) {  // dilation i's 8 taps
    const float* rb = a.ref + (size_t)b * K * HW + t.pix;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* q = rb + (8 * i + j) * HW;
      if (t.pair) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(q));
        w[0][8 * i + j] = v.x, w[P - 1][8 * i + j] = v.y;
      } else {
        w[0][8 * i + j] = t.in0 ? __ldg(q) : 0.f;
        if (P == 2) w[P - 1][8 * i + j] = t.in1 ? __ldg(q + 1) : 0.f;
      }
    }
  };

  if (wr == 0 && lane == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bar0 + 8 * st, 1);
    mbar_init_fence();
  }
  __syncthreads();
  Unit cur = unit_of(dir > 0 ? begin : end - 1), ahead = cur;  // computed, staged next
  for (int st = 0; st < kStages - 1 && st < n; ++st) {
    stage(ahead, st);
    advance(ahead);
  }
  Pixels px = pixels_of(cur);
#pragma unroll
  for (int i = 0; i < HELD; ++i)
    if (i < a.n_dil) load_weights(px, cur.b, i);

  for (int step = 0; step < n; ++step) {
    const int slot = step % kStages;
    mbar_wait(bar0 + 8 * slot, (step / kStages) & 1);
    fill_edges(cur, slot);
    // the slot is whole, and every thread is done with the one the next copies fill
    __syncthreads();
    if (step + kStages - 1 < n) {
      stage(ahead, (step + kStages - 1) % kStages);
      advance(ahead);
    }
    Unit next = cur;
    advance(next);
    const bool reload = step + 1 < n && next.cp == first_cp;  // the next step starts a tile
    const Pixels npx = reload ? pixels_of(next) : px;

    const char* sb = reinterpret_cast<const char*>(
        sm + slot * slot_elems + (ly + hy) * pitch + lx + hx);
    float acc[PLANES][P];
#pragma unroll
    for (int i = 0; i < HELD; ++i) {
      if (i < a.n_dil) {
        if (P == 2 && ((a.odd >> i) & 1)) {
          K3_DILATION_TAPS(true)
        } else {
          K3_DILATION_TAPS(false)
        }
        if (reload) load_weights(npx, next.b, i);
      }
    }
#pragma unroll
    for (int pl = 0; pl < PLANES; ++pl) {
      const int c = PLANES * cur.cp + pl;
      if (c >= a.C) break;
      float* o = a.dst + (size_t)(cur.b * a.C + c) * HW + px.pix;
      if (P == 2 && px.in1 && (a.vec & 2) && !(px.pix & 1)) {
        *reinterpret_cast<float2*>(o) = make_float2(acc[pl][0], acc[pl][P - 1]);
      } else {
        if (px.in0) o[0] = acc[pl][0];
        if (P == 2 && px.in1) o[1] = acc[pl][P - 1];
      }
    }
    cur = next;
    px = npx;
  }
}

#undef K3_DILATION_TAPS

using VarmKernel = void (*)(VarmArgs, CUtensorMap);

// (tile rows, pixels a thread) -> its instantiation, or nullptr for a plan the
// kernel does not have; `slot` numbers the instantiations
inline VarmKernel varm_kernel_of(int tile_rows, int pixels, int* slot) {
  *slot = pixels == 1 ? 3 : tile_rows == 32 ? 0 : tile_rows == 16 ? 1 : 2;
  if (pixels == 2 && tile_rows == 32) return varm_iter_kernel<16, 2, kHeld2, kPlanes2>;
  if (pixels == 2 && tile_rows == 16) return varm_iter_kernel<8, 2, kHeld2, kPlanes2>;
  if (pixels == 2 && tile_rows == 8) return varm_iter_kernel<4, 2, kHeld2, kPlanes2>;
  if (pixels == 1 && tile_rows == 8) return varm_iter_kernel<8, 1, kMaxDilations, 1>;
  return nullptr;
}

// lets an instantiation take `smem` bytes of dynamic shared memory: once per process
// and size (a larger grant covers every smaller one)
inline cudaError_t varm_prepare(VarmKernel kernel, int slot, int smem) {
  static int granted[4] = {48 * 1024, 48 * 1024, 48 * 1024, 48 * 1024};
  if (smem <= granted[slot]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) granted[slot] = smem;
  return err;
}

// The launch's geometry from the shapes and the plan; false if the kernel does not
// take them. Shared memory: the ring's mbarriers (128 bytes), then kStages slots of
// a step's staged planes, each slot 128-byte aligned.
inline bool varm_geometry(int H, int W, const int* dilations, int n_dil, int tile_rows,
                          int pixels, VarmArgs* a, long long* smem) {
  const int max_d = max_dilation(dilations, n_dil);
  a->hy = halo(max_d, H), a->hx4 = halo4(halo(max_d, W));
  if (pixels == 2) {
    if (a->hy > kHalo2 || a->hx4 > kHalo2) return false;
    a->pitch = kPitch2, a->srows = tile_rows + 2 * kHalo2;
  } else {
    a->pitch = 32 + 2 * a->hx4, a->srows = tile_rows + 2 * a->hy;
  }
  const int planes = pixels == 2 ? kPlanes2 : 1;
  *smem = 128 + 4LL * kStages * ((planes * (long long)a->srows * a->pitch + 31) / 32 * 32);
  return *smem <= kSmemLimit;
}

}  // namespace refine

// src, dst (B, C, H, W) f32, distinct buffers; ref (B, 8 * n_dil, H, W) f32.
// `dilations` is a host array; `tile_rows`, `pixels` and `blocks` come from the
// wrapper's plan (`ops/varm.py::varm_plan`); `iteration` counts the launches of a
// propagation (it orders the blocks' walks, not the result).
extern "C" int k3_varm_iter(const void* src, const void* ref, void* dst, int B, int C,
                            int H, int W, const int* dilations, int n_dil, int tile_rows,
                            int pixels, int blocks, int iteration, void* stream) {
  using namespace refine;
  int slot = 0;
  const VarmKernel kernel = varm_kernel_of(tile_rows, pixels, &slot);
  if (kernel == nullptr || n_dil < 1 || n_dil > (pixels == 2 ? kHeld2 : kMaxDilations) ||
      B < 1 || C < 1 || H < 1 || W < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  VarmArgs a;
  long long smem = 0;
  if (!varm_geometry(H, W, dilations, n_dil, tile_rows, pixels, &a, &smem))
    return (int)cudaErrorInvalidValue;
  a.src = (const float*)src;
  a.ref = (const float*)ref;
  a.dst = (float*)dst;
  a.C = C, a.H = H, a.W = W, a.n_dil = n_dil;
  a.tiles_x = (W + 31) / 32;
  a.tiles_y = (H + tile_rows - 1) / tile_rows;
  const int planes = pixels == 2 ? kPlanes2 : 1;
  const long long units = (long long)B * a.tiles_x * a.tiles_y * ((C + planes - 1) / planes);
  if (units >= (1LL << 31) || 8LL * n_dil * H * W >= (1LL << 31) ||
      (long long)B * C * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  a.units = (int)units;
  a.flip = iteration & 1;
  a.vec = (W % 4 == 0 && (size_t)src % 16 == 0 ? 1 : 0) |
          (W % 2 == 0 && (size_t)dst % 8 == 0 ? 2 : 0) |
          (W % 2 == 0 && (size_t)ref % 8 == 0 ? 4 : 0);
  if (a.srows > 256 || a.pitch > 256) a.vec &= ~1;  // a tensor map's box is at most 256 a side
  a.odd = tap_offsets(dilations, n_dil, H, W, a.pitch, a.tap_off);
  CUtensorMap map = {};
  if (a.vec & 1) {
    const cudaError_t err = plane_tensor_map(&map, a.src, B * C, H, W, a.srows, a.pitch, planes);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaError_t err = varm_prepare(kernel, slot, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(32, tile_rows / pixels);  // two rows of pixel pairs a warp, or one row of pixels
  const int grid = (int)(blocks < units ? blocks : units);
  kernel<<<grid, block, (size_t)smem, (cudaStream_t)stream>>>(a, map);
  return (int)cudaGetLastError();
}

// Blocks of an instantiation with `smem` bytes one SM holds at once, as the card
// reports it; -1 for a plan the kernel does not have.
extern "C" int k3_varm_blocks_per_sm(int tile_rows, int pixels, int smem) {
  using namespace refine;
  int slot = 0;
  const VarmKernel kernel = varm_kernel_of(tile_rows, pixels, &slot);
  int n = -1;
  if (kernel == nullptr || smem > kSmemLimit || varm_prepare(kernel, slot, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 32 * tile_rows / pixels, smem) !=
          cudaSuccess)
    return -1;
  return n;
}
