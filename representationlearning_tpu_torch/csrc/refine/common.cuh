// Shared helpers of the refinement kernels K2 (affinity) and K3 (propagation).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace refine {

constexpr int kMaxDilations = 16;
constexpr int kMaxTaps = 8 * kMaxDilations;
constexpr int kSmemLimit = 227 * 1024;  // dynamic shared memory a block may ask for

// The 8 neighbour offsets in the reference order (row-major 3 x 3 minus the
// centre), the `OFFSETS` of representationlearning_tpu_torch/ops/neighbors.py.
// Tap k = 8 * i + j reads (y + tap_dy(j) * d[i], x + tap_dx(j) * d[i]).
__host__ __device__ __forceinline__ constexpr int tap_dy(int j) {
  return (j < 4 ? j : j + 1) / 3 - 1;
}
__host__ __device__ __forceinline__ constexpr int tap_dx(int j) {
  return (j < 4 ? j : j + 1) % 3 - 1;
}

// Replicate padding is index clamping.
__host__ __device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// The largest dilation, and the halo of a staged tile along an axis of `n` pixels:
// an offset beyond n - 1 clamps to the same pixel as n - 1 does, so a tile never
// needs more than n - 1 pixels of halo whatever the dilations are.
inline int max_dilation(const int* d, int n) {
  int m = 0;
  for (int i = 0; i < n; ++i) m = d[i] > m ? d[i] : m;
  return m;
}
inline int halo(int max_d, int n) { return max_d < n - 1 ? max_d : n - 1; }

// A staged tile starts its columns at a multiple of 4 from the pixels' first column,
// so that rows copy in 16-byte pieces: the halo along x rounded up to 4.
inline int halo4(int h) { return (h + 3) / 4 * 4; }

// Offset, in bytes, of each tap from the pixel it belongs to, in a tile staged with
// `pitch` floats a row; every offset clamped to the plane's extent as `halo` is.
// Taps past n_dil are 0. Bit i of the result: dilation i's column offset is odd.
inline unsigned tap_offsets(const int* d, int n_dil, int H, int W, int pitch, int* off) {
  unsigned odd = 0;
  for (int k = 0; k < kMaxTaps; ++k) {
    const int i = k / 8, j = k % 8;
    off[k] = i < n_dil ? 4 * (tap_dy(j) * halo(d[i], H) * pitch + tap_dx(j) * halo(d[i], W)) : 0;
    if (i < n_dil && (halo(d[i], W) & 1)) odd |= 1u << i;
  }
  return odd;
}

// mbarriers and tensor-map copies (the copy engine: no load-store queue entries a lane).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
// orders this thread's earlier shared-memory accesses before later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// The box of a 3-d tensor map at (x, y, z) into shared `dst` (128-byte aligned),
// completing on mbarrier `bar`; elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_box(float* dst, const CUtensorMap* map, int x, int y, int z,
                                        unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

// A tensor map of `planes` f32 planes of H x W (rows 16-byte aligned) read in boxes
// of `box_planes` x `box_rows` x `box_cols`, made by `cuTensorMapEncodeTiled` (fetched
// once through the runtime's entry-point query, so the library links the runtime only).
inline cudaError_t plane_tensor_map(CUtensorMap* map, const float* base, int planes, int H,
                                    int W, int box_rows, int box_cols, int box_planes) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || encode == nullptr) {
      encode = nullptr;
      return err != cudaSuccess ? err : cudaErrorNotSupported;
    }
  }
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)H * W * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, (cuuint32_t)box_planes};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace refine
