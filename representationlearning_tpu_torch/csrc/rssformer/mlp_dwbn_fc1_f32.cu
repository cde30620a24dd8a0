// K5 `fc1` with f32 operands, `fc1_wg_kernel`: h (M, hp) f32 = gelu(bn1(x w1^T + b1)), a
// source of its own so that nvcc builds it beside mlp_dwbn.cu and mlp_dwbn_taps_f32.cu.
//
// Replaces: step (1) of `_mlp_math` (representationlearning_tpu/ops/pallas/mlp_dwbn.py:52-82)
//   inside `fused_mlp_dwbn_pallas` (:115, call :132), with f32 operands, the Pallas kernel's
//   default.
// What bounds it on the H100: bytes. At HRNetV2's widths (cin 18 / 32 / 40 / 48 -> hp 96 /
//   128 / 160 / 192) a launch at 8 x 128^2 tokens reads 9-25 MB of x and writes 50-101 MB
//   of h, 18-38 us at 3.35 TB/s. Next to it come the issue slots of the epilogue (bias, bn1
//   and the GELU, about 30 instructions an element: 21 us at w48 if every slot of the card
//   issued one) and the tensor cores (3xTF32 of cinp = 48: 7.2 GFLOP at w48, 15 us at the
//   487 TFLOP/s of TF32 `wgmma`). All three are within a factor of two of one another, so
//   the design keeps them asynchronous to each other.
// What the design does about it (csrc/hopper/wgmma.cuh's blocks):
//   * Persistent blocks of two consumer warpgroups and a producer warpgroup walk 128-row tiles
//     (block b takes tiles b, b + blocks, ...); a consumer takes one 64-row half of a tile
//     at a time, the halves alternating between the two, so that one's products run while
//     the other's epilogue issues. A block computes `NB` hidden features of h (all hp, or
//     32 where hp x cinp of w1 does not fit beside the ring: the grid's second dimension
//     walks the slices). The plan (NB, blocks) is one wave; every plan gives each output
//     by the same instructions in the same order: equal bits.
//   * w1's slice arrives once a block by tensor-map copies (128-byte swizzle, K-major, 32
//     columns a chunk, zeros past cinp) and is split once into TF32 big and small halves in
//     shared memory: it is the B operand of every product of the launch.
//   * x streams through a ring of 64-row stages, as many as the shared memory left holds.
//     Rows of 16-byte multiples (cin % 4 == 0) come by a 2-d tensor map, 32-column boxes
//     with the 128-byte swizzle, zeros past cin and past M from the map itself, read by
//     `ldmatrix`. Other rows (cin 18: 72 bytes) come as the half tile's contiguous bytes by
//     one `cp.async.bulk` of their 16-byte pieces, with the few 4-byte words of a ragged
//     head (x 4-byte aligned) or tail copied by the producer's lane; a consumer reads
//     them as 32-bit words and zeroes the columns past cin in registers.
//   * A comes from registers, split there; a k slice of 8 features is three m64nNBk8
//     `wgmma`s (small.big, big.small, big.big), a pair of slices a commit group, the next
//     pair's A loading while one is in flight. Pairs past cin are skipped (an odd count of
//     slices runs one of zeros: the issue of every `wgmma` stays unconditional, which ptxas
//     needs to keep them asynchronous). `setmaxnreg` gives the consumers 232 registers a
//     thread (HP 192's accumulators and the GELUs in flight), the producer 40.
//   * The epilogue works on the accumulators: bias, bn1 and the GELU (`bias_bn_gelu`, the
//     bf16 kernel's rounding), 32 features at a time into a swizzled 16 x 32 staging box of
//     the warp, stored by a 2-d tensor-map store that clips rows past M. A warp has two
//     boxes; `cp.async.bulk.wait_group.read` runs only before a box is written again, so
//     stores drain while the next features and the next tile's products run. The ring slot
//     is released before the epilogue, so the producer refills it meanwhile.
#include "mlp_dwbn.cuh"

namespace rss {

constexpr int kF1Sub = 64;                  // rows of x a consumer warpgroup takes at a time
constexpr int kF1Consumers = 2;             // consumer warpgroups a block
constexpr int kF1Tile = kF1Consumers * kF1Sub;   // rows of a block's tile: a part a consumer
constexpr int kF1Threads = 128 * (kF1Consumers + 1);   // the consumers, then the producer
constexpr int kF1Regs = 168;                // registers a thread at launch (65536 / 384, to 8)
constexpr int kF1ConsumerRegs = 232, kF1ProducerRegs = 40;   // after `setmaxnreg`
constexpr int kF1MaxStages = 32;
constexpr int kF1Bufs = 2;                  // staging boxes of a consumer warp
constexpr int kF1Box = 16 * hop::kWgRowBytes;   // a staging box: 16 rows x 32 f32

// Shared memory at a width of cin and a tile of NB hidden features, from a 1024-byte aligned
// base: the barriers (full and empty a stage, w1's) and b1, s1, t1 of the tile (`header`);
// w1's chunks big, then small (NB rows of 128 bytes each); eight warps' staging boxes; the
// ring, as many stages as fit (at most kF1MaxStages; a stage of at least 4 KB, so that
// a block takes more than half an SM's shared memory: one block an SM).
// `ops/mlp_dwbn.py::_fc1_f32_layout` counts the same.
struct F1Layout {
  int nch;      // chunks of 32 columns of w1 (and of x, by map)
  bool by_map;  // x by tensor map (rows of 16-byte multiples), else by bulk copy
  int stage;    // bytes of a ring stage
  int header;
  int stages;
  int smem;     // bytes of dynamic shared memory, 1 KB of alignment included
};
__host__ __device__ inline F1Layout f1_layout(int cin, int nb) {
  F1Layout L;
  L.nch = (cin + 31) / 32;
  L.by_map = cin % 4 == 0;
  const int rows = (kF1Sub * cin * 4 + 16 + 1023) / 1024 * 1024;   // by bulk copy
  L.stage = L.by_map ? L.nch * kF1Sub * hop::kWgRowBytes : (rows > 4096 ? rows : 4096);
  L.header = 1024 + (12 * nb + 1023) / 1024 * 1024;
  const int fixed = 1024 + L.header + 2 * L.nch * nb * hop::kWgRowBytes +
                    4 * kF1Consumers * kF1Bufs * kF1Box;
  const int s = (kSmemLimit - fixed) / L.stage;
  L.stages = s > kF1MaxStages ? kF1MaxStages : s;
  L.smem = fixed + L.stages * L.stage;
  return L;
}

template <int NB>
__global__ void __launch_bounds__(kF1Threads, 1)
fc1_wg_kernel(const Fc1F32Args p, const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap hmap) {
  using namespace hop;
  constexpr int kW = NB * kWgRowBytes;        // a chunk of w1
  constexpr int kXc = kF1Sub * kWgRowBytes;   // a chunk of x, by map
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const F1Layout L = f1_layout(p.cin, NB);
  const uint32_t full0 = smem_u32(smem), empty0 = full0 + 8 * kF1MaxStages,
                 wbar = empty0 + 8 * kF1MaxStages;
  float* vec = reinterpret_cast<float*>(smem + 1024);   // b1, s1, t1 of the tile's features
  unsigned char* wbig = smem + L.header;
  unsigned char* wsmall = wbig + L.nch * kW;
  unsigned char* stg = wsmall + L.nch * kW;
  unsigned char* ring = stg + 4 * kF1Consumers * kF1Bufs * kF1Box;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.y * NB;
  const uint32_t off = (uint32_t)reinterpret_cast<uintptr_t>(p.x) & 15u;   // bulk: x's offset

  // the block's parts f = 0, 1, ...: tile blockIdx.x + (f / kF1Consumers) gridDim.x, part
  // f % kF1Consumers, consumer f % kF1Consumers (the last tile's last parts may lie past M:
  // no one takes them)
  const int tiles = (p.M + kF1Tile - 1) / kF1Tile;
  const int mine = (int)blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto row_of = [&](int f) {
    return (blockIdx.x + (f / kF1Consumers) * gridDim.x) * kF1Tile + (f % kF1Consumers) * kF1Sub;
  };
  int parts = kF1Consumers * mine;
  while (parts > 0 && row_of(parts - 1) >= p.M) --parts;

  if (tid == 128 * kF1Consumers) {   // the producer's lane
    if (L.by_map) tensormap_prefetch(&xmap);
    tensormap_prefetch(&wmap);
    tensormap_prefetch(&hmap);
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);   // a warp of the consuming warpgroup each
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * kF1Consumers) {   // ---- the producer warpgroup: its first lane starts every copy
    regs_dec<kF1ProducerRegs>();
    if (warp == 4 * kF1Consumers && lane == 0) {
      mbar_arrive_expect(wbar, L.nch * kW);
      for (int q = 0; q < L.nch; ++q) tma_load_2d(wbig + q * kW, &wmap, 32 * q, n0, wbar);
      const size_t pitch = (size_t)p.cin * 4;   // bytes of a row of x
      for (int f = 0; f < parts; ++f) {
        const int slot = f % L.stages;
        mbar_wait(empty0 + 8 * slot, ((f / L.stages) & 1) ^ 1);
        unsigned char* stage = ring + slot * L.stage;
        const uint32_t full = full0 + 8 * slot;
        const int row0 = row_of(f);
        if (L.by_map) {
          mbar_arrive_expect(full, L.nch * kXc);
          for (int q = 0; q < L.nch; ++q) tma_load_2d(stage + q * kXc, &xmap, 32 * q, row0, full);
        } else {
          // bytes [s, e) of x, element 0 at stage + off: 16-byte pieces [lo, hi) by one bulk
          // copy, the words before and after by this lane (seen by the consumers through the
          // barrier's arrival)
          const uintptr_t s = reinterpret_cast<uintptr_t>(p.x) + (size_t)row0 * pitch;
          const uintptr_t e = s + (size_t)min(kF1Sub, p.M - row0) * pitch;
          const uintptr_t up = (s + 15) & ~(uintptr_t)15, down = e & ~(uintptr_t)15;
          const uintptr_t lo = up < e ? up : e, hi = down > lo ? down : lo;
          unsigned char* d = stage + off;
          for (uintptr_t a = s; a < lo; a += 4)
            *reinterpret_cast<float*>(d + (a - s)) = __ldg(reinterpret_cast<const float*>(a));
          for (uintptr_t a = hi; a < e; a += 4)
            *reinterpret_cast<float*>(d + (a - s)) = __ldg(reinterpret_cast<const float*>(a));
          mbar_arrive_expect(full, (uint32_t)(hi - lo));
          if (hi > lo)
            bulk_load(d + (lo - s), reinterpret_cast<const void*>(lo), (uint32_t)(hi - lo), full);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups: warp w of a warpgroup owns rows 16 (w % 4) .. + 15 of a half
  regs_inc<kF1ConsumerRegs>();
  const int wg = warp / 4, g = lane / 4, t = lane % 4, r0 = 16 * (warp % 4);
  for (int i = tid; i < 3 * NB; i += 128 * kF1Consumers) {
    const int v = i / NB, c = n0 + i % NB;
    vec[i] = __ldg((v == 0 ? p.b1 : v == 1 ? p.s1 : p.t1) + c);
  }
  mbar_wait(wbar, 0);
  split_stage(wbig, wsmall, L.nch * kW / 16, tid, 128 * kF1Consumers);
  fence_proxy_async();
  named_sync(1, 128 * kF1Consumers);

  const int cin = p.cin, pairs = (cin + 15) / 16;   // pairs of k slices of 8 features
  const bool by_map = L.by_map;
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  uint32_t ab[2][4], as[2][4], nb[2][4], ns[2][4];   // A big and small: this pair, the next
  unsigned char* boxes = stg + warp * kF1Bufs * kF1Box;
  int stores = 0;

  for (int f = wg; f < parts; f += kF1Consumers) {
    const int slot = f % L.stages;
    mbar_wait(full0 + 8 * slot, (f / L.stages) & 1);
    const unsigned char* stage = ring + slot * L.stage;
    const float* xr = reinterpret_cast<const float*>(stage + off) + (r0 + g) * cin;   // bulk: row g
    // A of k slices 2 pr and 2 pr + 1, split in registers (zeros past cin)
    auto load_pair = [&](int pr, uint32_t (&big)[2][4], uint32_t (&small)[2][4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 2 * pr + h;
        uint32_t x[4];
        if (by_map) {
          ldsm_a(x, stage + (k >> 2) * kXc, r0, k & 3, lane);
        } else {   // a0 (row g, k t), a1 (row g + 8, k t), a2, a3 the same at k t + 4
          const int c0 = 8 * k + t, c1 = c0 + 4;
          x[0] = c0 < cin ? __float_as_uint(xr[c0]) : 0u;
          x[1] = c0 < cin ? __float_as_uint(xr[8 * cin + c0]) : 0u;
          x[2] = c1 < cin ? __float_as_uint(xr[c1]) : 0u;
          x[3] = c1 < cin ? __float_as_uint(xr[8 * cin + c1]) : 0u;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          big[h][i] = tf32_big(x[i]);
          small[h][i] = tf32_small_of(x[i]);
        }
      }
    };
    load_pair(0, ab, as);
    for (int pr = 0; pr < pairs; ++pr) {
      fence_acc(acc);
      wg_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 2 * pr + h, at = (k >> 2) * kW;   // slice k: chunk k / 4, 32 bytes a slice
        mma3<NB>(acc, ab[h], as[h], desc_sw(wbig + at) + 2 * (k & 3),
                 desc_sw(wsmall + at) + 2 * (k & 3), (pr | h) != 0);
      }
      wg_commit();
      if (pr + 1 < pairs) load_pair(pr + 1, nb, ns);   // while this pair is in flight
      wg_wait<0>();
      fence_acc(acc);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ab[h][i] = nb[h][i];
          as[h][i] = ns[h][i];
        }
    }
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);   // the half is summed: its slot is free

    // ---- the epilogue of this warp's 16 rows, 32 features a box: element (r, c) of a box
    // at row r, 16-byte piece (c / 4) ^ (r % 8), the 128-byte swizzle of the map
    const int row = row_of(f) + r0;
#pragma unroll
    for (int c = 0; c < NB / 32; ++c) {
      unsigned char* box = boxes + (stores & 1) * kF1Box;
      if (lane == 0) bulk_wait_read<kF1Bufs - 1>();   // the box's last store has read it
      __syncwarp();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * c + jj, col = 8 * j + 2 * t;
        const float2 b = *reinterpret_cast<const float2*>(vec + col);
        const float2 s = *reinterpret_cast<const float2*>(vec + NB + col);
        const float2 sh = *reinterpret_cast<const float2*>(vec + 2 * NB + col);
        const int at = (((2 * jj + (t >> 1)) ^ g) << 4) + 8 * (t & 1);
        *reinterpret_cast<float2*>(box + g * kWgRowBytes + at) =
            make_float2(bias_bn_gelu(acc[4 * j], b.x, s.x, sh.x),
                        bias_bn_gelu(acc[4 * j + 1], b.y, s.y, sh.y));
        *reinterpret_cast<float2*>(box + (g + 8) * kWgRowBytes + at) =
            make_float2(bias_bn_gelu(acc[4 * j + 2], b.x, s.x, sh.x),
                        bias_bn_gelu(acc[4 * j + 3], b.y, s.y, sh.y));
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        tma_store_2d(&hmap, box, n0 + 32 * c, row);
        bulk_commit();
      }
      ++stores;
    }
  }
  if (lane == 0) bulk_wait<0>();   // the last stores have landed
}

// One tile width: the shared memory it may take (once per process, the register count that
// `setmaxnreg` counts on checked), its tensor maps and launch, or, with `held` given, the blocks an SM holds
template <int NB>
struct Fc1Wg {
  static cudaError_t prepare() {   // and check the registers that `setmaxnreg` counts on
    static const cudaError_t err = [] {
      cudaFuncAttributes attr;
      cudaError_t e = cudaFuncGetAttributes(&attr, fc1_wg_kernel<NB>);
      if (e == cudaSuccess && attr.numRegs != kF1Regs) e = cudaErrorInvalidConfiguration;
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(fc1_wg_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemLimit);
      return e;
    }();
    return err;
  }
  static int run(const Fc1F32Args& p, int blocks, cudaStream_t st, int* held) {
    const cudaError_t prepared = prepare();
    if (prepared != cudaSuccess) return (int)prepared;
    const F1Layout L = f1_layout(p.cin, NB);
    if (held != nullptr)
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(held, fc1_wg_kernel<NB>,
                                                                kF1Threads, L.smem);
    CUtensorMap xm = {}, wm = {}, hm = {};
    cudaError_t e = L.by_map ? hop::wg_tensor_map(&xm, p.x, p.M, p.cin, kF1Sub) : cudaSuccess;
    if (e == cudaSuccess) e = hop::wg_tensor_map(&wm, p.w1, p.hp, p.cinp, NB);
    if (e == cudaSuccess) e = hop::wg_tensor_map(&hm, p.h, p.M, p.hp, 16);
    if (e != cudaSuccess) return (int)e;
    fc1_wg_kernel<NB><<<dim3(blocks, p.hp / NB), kF1Threads, L.smem, st>>>(p, xm, wm, hm);
    return (int)cudaGetLastError();
  }
};

int fc1_f32_run(const Fc1F32Args& p, int tile, int blocks, cudaStream_t st, int* held) {
  const bool widths = p.cin >= 1 && p.cin <= 256 && p.cinp == (p.cin + 15) / 16 * 16 &&
                      (p.hp == 96 || p.hp == 128 || p.hp == 160 || p.hp == 192);
  if (!widths || !(tile == p.hp || tile == 32) || blocks < 1 || f1_layout(p.cin, tile).stages < 2)
    return (int)cudaErrorInvalidValue;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p.x);
  if (held == nullptr && (a & (p.cin % 4 == 0 ? 15 : 3)) != 0) return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 32: return Fc1Wg<32>::run(p, blocks, st, held);
    case 96: return Fc1Wg<96>::run(p, blocks, st, held);
    case 128: return Fc1Wg<128>::run(p, blocks, st, held);
    case 160: return Fc1Wg<160>::run(p, blocks, st, held);
    default: return Fc1Wg<192>::run(p, blocks, st, held);
  }
}

}  // namespace rss
