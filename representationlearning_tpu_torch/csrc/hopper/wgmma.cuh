// Hopper building blocks of the 3xTF32 `wgmma` kernels: K1's f32 `linear`
// (csrc/mit_block/gemm.cu) and K5's f32 `taps` (csrc/rssformer/mlp_dwbn.cuh). Both are
// GEMMs with f32 sums whose products run here as
//   * a ring of shared-memory stages filled by the tensor-memory accelerator (TMA):
//     one 2-d tensor map a matrix, boxes of kWgBK f32 columns (rows of 128 bytes,
//     128-byte swizzle: 64-byte rows took 15-25% longer, PERF.md), elements outside
//     the tensor arriving as zeros; each stage guarded by `mbarrier`s (full: the copy
//     landed; ready: the weights are split; empty: the consumers are done with it);
//   * `wgmma.mma_async` m64nNk8 .tf32, A from registers (the consumer's prologue
//     touches A anyway: LayerNorm in `linear`, the in-plane mask in `taps`), B from
//     shared memory through a descriptor. Both operands are K-major.
//   * 3xTF32: an f32 operand x is big + small, big = x with its 13 low mantissa bits
//     cleared (a TF32 value) and small = x - big (exact). A product is
//     small(a) big(b) + big(a) small(b) + big(a) big(b), issued in that order, as
//     `mma_slice` of csrc/{mit_block,rssformer}/common.cuh does on `mma.sync`. The
//     weights are split in shared memory by the producer warpgroup's warps 1-3 once a
//     stage has landed, small into the stage's second B buffer (a launch-free place:
//     the weights change between calls, and the wrapper would need a launch of its
//     own to split them).
// K5's f32 `fc1` (csrc/rssformer/mlp_dwbn_fc1_f32.cu) holds its weights in shared memory,
// split once a block, and stores by 2-d tensor maps.
// K1's f32 `attention` (csrc/mit_block/attention_f32.cu) takes the same blocks, with 3-d
// tensor maps (one box a head), TMA stores, a named barrier and the n32 product. K1's f32
// `sr_conv` (csrc/mit_block/sr_conv_f32.cu) stages its A operand through an im2col tensor
// map (the stride-sr patches of an NHWC token grid, one box a K step) and sums its K
// slices across a thread-block cluster: `st.async` stores into another block's shared
// memory, completing on its `mbarrier`.
// Nothing here depends on the kernel that includes it; it uses no PyTorch header.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hop {

constexpr int kWgBK = 32;                  // f32 columns of a stage
constexpr int kWgRowBytes = 4 * kWgBK;     // a stage's row: 128 bytes, the swizzle's span
constexpr int kWgSmemLimit = 232448;
constexpr int kWgSplitThreads = 96;        // the producer's warps 1-3 split the weights

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
// returns once the phase of parity `parity` has completed (at once for parity 1 on a
// fresh barrier: the "previous" phase counts as completed)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
// the same for a barrier that other blocks of the cluster complete (`st.async`): what they
// stored before is seen after it returns
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
// this thread's earlier shared-memory writes, made visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- TMA: the box of a 2-d tensor map whose inner (column) corner is x and outer (row)
// corner y, into `dst` (1024-byte aligned), completing on `bar`; rows or columns outside
// the tensor, negative y included, arrive as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// the same for a 3-d tensor map: inner corner x, then y, then z
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int x, int y, int z,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

// An im2col box of a 4-d (C, W, H, N) tensor map: `pixels` (the map's) pixels of
// kWgBK channels from channel c, the walk starting at the window whose top-left element
// is (w, h, n) and going on through the map's bounding box (W fastest, then H, then N,
// by its traversal strides), each pixel displaced by the filter offset (dw, dh); pixels
// outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load_im2col_4d(void* dst, const CUtensorMap* map, int c, int w,
                                                   int h, int n, uint16_t dw, uint16_t dh,
                                                   uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c), "r"(w), "r"(h), "r"(n), "r"(bar),
      "h"(dw), "h"(dh)
      : "memory");
}

// A box of shared memory (1024-byte aligned, laid out as a load of the same map lays it)
// to a 3-d tensor map at corner (x, y, z); elements outside the tensor are not written.
// The copy reads the box after this thread's call returns: the writing threads fence
// (`fence_proxy_async`) and meet at a barrier before it, and the box is written again
// only after `bulk_wait_read`.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int x, int y,
                                             int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];" ::"l"(
          reinterpret_cast<unsigned long long>(map)),
      "r"(x), "r"(y), "r"(z), "r"(smem_u32(src))
      : "memory");
}
// the same for a 2-d tensor map at corner (x, y)
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];" ::"l"(
          reinterpret_cast<unsigned long long>(map)),
      "r"(x), "r"(y), "r"(smem_u32(src))
      : "memory");
}
// `bytes` contiguous bytes of device memory into shared memory (both 16-byte aligned, bytes a
// multiple of 16), completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// this thread's stores committed before have read their shared memory (all but N groups)
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
// ... and have completed
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

// a named barrier: `threads` threads (a multiple of 32) meet at barrier `id` (1-15; 0 is
// __syncthreads')
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// ---- thread-block clusters: every thread of every block of the cluster arrives (release)
// and waits (acquire), so shared-memory writes before the barrier are seen by the
// cluster's other blocks after it; the calling warp is converged
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;" ::: "memory");
}
// the address of this block's shared-memory byte `addr` in block `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// two floats into another block's shared memory (`addr` and `bar` mapped by `cluster_map`),
// the store completing `bar`'s transaction count by 8 bytes
__device__ __forceinline__ void st_async_f2(uint32_t addr, float a, float b, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];"
               ::"r"(addr), "f"(a), "f"(b), "r"(bar)
               : "memory");
}

// brings a tensor map (a kernel parameter) into the copy engine's cache ahead of its first use
__device__ __forceinline__ void tensormap_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<unsigned long long>(map))
               : "memory");
}

// `cuTensorMapEncodeTiled` (libcuda), fetched once through the runtime's entry-point query
// (the library links the runtime only); null where the driver lacks it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || encode == nullptr) {
      encode = nullptr;
      return err != cudaSuccess ? err : cudaErrorNotSupported;
    }
  }
  *fn = encode;
  return cudaSuccess;
}

// A tensor map of an f32 matrix of `rows` x `cols` (row-major, rows 16-byte aligned),
// read in boxes of `box_rows` x kWgBK with the 128-byte swizzle that the wgmma
// descriptors below name
inline cudaError_t wg_tensor_map(CUtensorMap* map, const float* base, long long rows,
                                 long long cols, int box_rows) {
  EncodeTiled encode;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kWgBK, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A tensor map of an f32 array of d2 x d1 x d0 elements (d0 innermost; the pitches of d1 and
// d2 in bytes, multiples of 16), in boxes of 1 x `box1` x kWgBK with the 128-byte swizzle;
// elements outside the array are read as zeros and not written
inline cudaError_t wg_tensor_map_3d(CUtensorMap* map, const float* base, long long d0,
                                    long long d1, long long d2, long long pitch1,
                                    long long pitch2, int box1) {
  EncodeTiled encode;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch1, (cuuint64_t)pitch2};
  const cuuint32_t box[3] = {(cuuint32_t)kWgBK, (cuuint32_t)box1, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// `cuTensorMapEncodeIm2col` (libcuda), fetched as `encode_tiled` fetches its sibling
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);
inline cudaError_t encode_im2col(EncodeIm2col* fn) {
  static EncodeIm2col encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeIm2col", reinterpret_cast<void**>(&encode), cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || encode == nullptr) {
      encode = nullptr;
      return err != cudaSuccess ? err : cudaErrorNotSupported;
    }
  }
  *fn = encode;
  return cudaSuccess;
}

// An im2col tensor map of the f32 token grid of n images of h x w tokens of c channels
// (NHWC, c % 4 == 0), read as the patches of a stride-`s` s x s conv without padding: the
// bounding box holds the windows' top-left tokens that leave a whole window inside the
// image (rows and columns 0, s, 2s, ... up to h - s and w - s, so the grid is cropped to
// full windows), a box is `pixels` windows of kWgBK channels, rows of 128 bytes with the
// 128-byte swizzle that the wgmma descriptors and `ldsm_a` read; windows past the last
// image arrive as zeros
inline cudaError_t wg_patch_map(CUtensorMap* map, const float* base, long long c, long long w,
                                long long h, long long n, int s, int pixels) {
  EncodeIm2col encode;
  const cudaError_t err = encode_im2col(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 4, (cuuint64_t)(c * w) * 4,
                                 (cuuint64_t)(c * w * h) * 4};
  const int lower[2] = {0, 0}, upper[2] = {1 - s, 1 - s};
  const cuuint32_t step[4] = {1, (cuuint32_t)s, (cuuint32_t)s, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base),
                            dims, strides, lower, upper, (cuuint32_t)kWgBK, (cuuint32_t)pixels,
                            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The 128-byte swizzle of a box of 128-byte rows, the TMA's and wgmma's (CUTLASS's
// Swizzle<3, 4, 3>): the 16-byte piece c of row r lies at piece c ^ (r % 8).
__device__ __forceinline__ int sw_at(int r, int c) { return r * kWgRowBytes + ((c ^ (r & 7)) << 4); }

// ldmatrix of the TF32 A fragment of k slice kk (8 columns) of 16 rows [r0, r0 + 16) of a
// swizzled stage: lane (g, t) receives a0 (row g, k t), a1 (row g + 8, k t), a2 (row g,
// k t + 4), a3 (row g + 8, k t + 4), the wgmma and `mma.sync` A layout of a warp
__device__ __forceinline__ void ldsm_a(uint32_t (&r)[4], const unsigned char* tile, int r0,
                                       int kk, int lane) {
  const int row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8, piece = 2 * kk + (lane >> 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(tile + sw_at(row, piece))));
}

// big and small of a TF32 split
__device__ __forceinline__ uint32_t tf32_big(uint32_t x) { return x & 0xffffe000u; }
__device__ __forceinline__ uint32_t tf32_small_of(uint32_t x) {
  return __float_as_uint(__fsub_rn(__uint_as_float(x), __uint_as_float(x & 0xffffe000u)));
}

// The small half of the weights of a landed stage, into `small` at the same positions
// (the split is element by element, so the swizzle carries over); big is the weights as
// they lie, the tensor cores reading a TF32 operand's upper 19 bits (as `mma.sync` does:
// clearing them in place first gave the same results and took longer, PERF.md). `n16`
// 16-byte pieces, walked by `threads` threads from `tid`.
__device__ __forceinline__ void split_stage(const unsigned char* big, unsigned char* small,
                                            int n16, int tid, int threads) {
  for (int i = tid; i < n16; i += threads) {
    const uint4 v = reinterpret_cast<const uint4*>(big)[i];
    reinterpret_cast<uint4*>(small)[i] = make_uint4(tf32_small_of(v.x), tf32_small_of(v.y),
                                                    tf32_small_of(v.z), tf32_small_of(v.w));
  }
}

// registers a thread of this warpgroup may hold from here on (setmaxnreg): fewer for the
// producer, more for the consumers; the block's total stays what it was launched with
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// ---- wgmma
// The descriptor of a K-major operand of 128-byte swizzled rows at `p` (the stage's row
// 0, plus 32 bytes a k slice): leading offset unused (1), 8-row groups 1024 bytes apart,
// layout type 1 (the 128-byte swizzle)
__device__ __forceinline__ uint64_t desc_sw(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3ffff) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of the accumulators across a
// wgmma fence, commit or wait (CUTLASS's warpgroup_fence_operand)
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a b over one k8 slice, m64nNk8, TF32 operands, f32 sums; a from registers (the
// warp's 16 rows as `ldsm_a` gives them), b through its descriptor; d is the m64nN
// accumulator: d[4j .. 4j + 1] (row g, columns 8j + 2t, + 1), d[4j + 2 .. + 3] (row g + 8).
// `scale_d` 0 overwrites d. One specialisation a width: the asm lists the N / 2
// accumulators.
template <int N>
struct Tf32Rs;

template <>
struct Tf32Rs<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Tf32Rs<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Tf32Rs<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Tf32Rs<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Tf32Rs<160> {
  static __device__ __forceinline__ void mma(float (&d)[80], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, {%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Tf32Rs<192> {
  static __device__ __forceinline__ void mma(float (&d)[96], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// The three TF32 products of one k slice: a's halves in registers, b's big and small
// halves in shared memory
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 2], const uint32_t (&abig)[4],
                                     const uint32_t (&asmall)[4], uint64_t bbig, uint64_t bsmall,
                                     int scale_d) {
  Tf32Rs<N>::mma(d, asmall, bbig, scale_d);
  Tf32Rs<N>::mma(d, abig, bsmall, 1);
  Tf32Rs<N>::mma(d, abig, bbig, 1);
}

}  // namespace hop
