// Shared helpers of the refinement kernels K2 (affinity) and K3 (propagation).
#pragma once

#include <cuda_runtime.h>

namespace refine {

constexpr int kMaxDilations = 16;
constexpr int kMaxTaps = 8 * kMaxDilations;

// The 8 neighbour offsets in the reference order (row-major 3 x 3 minus the
// centre), the `OFFSETS` of representationlearning_tpu_torch/ops/neighbors.py.
// Tap k = 8 * i + j reads (y + tap_dy(j) * d[i], x + tap_dx(j) * d[i]); with the
// loop over j unrolled both are compile-time constants.
__device__ __forceinline__ constexpr int tap_dy(int j) { return (j < 4 ? j : j + 1) / 3 - 1; }
__device__ __forceinline__ constexpr int tap_dx(int j) { return (j < 4 ? j : j + 1) % 3 - 1; }

// The run-time dilation list, passed to a kernel by value.
struct Dilations {
  int n;
  int d[kMaxDilations];
};

// Replicate padding is index clamping.
__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

}  // namespace refine
