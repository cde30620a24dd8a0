"""Measures the rates of the card's tensor-core instructions: `mma.sync` (TF32 m16n8k8 and
bf16 m16n8k16) and `wgmma.mma_async` (TF32 m64n128k8 and bf16 m64n128k16, A from
registers or from shared memory, B from shared memory), f32 sums.

K4's kernels (``csrc/attention/flash_{fwd,bwd}.cu``) run their products as `mma.sync`,
f32 operands as three TF32 products each; K1's f32 `linear` and K5's f32 `taps` run them
as `wgmma` with A from registers (``csrc/hopper/wgmma.cuh``). The `mma.sync` kernel does
nothing but `mma.sync` on registers: every SM holds `--warps` warps of eight independent
chains, each warp issuing `--iters` rounds of eight products. The `wgmma` kernel runs two
warpgroups a block, one block an SM, each issuing `--iters` groups of eight m64n128
products on one accumulator (a group in flight while the next is issued), B (and A where
it comes from shared memory) a zeroed 128-byte-swizzled tile. It prints, for each
instruction, the time, the products issued, the rate in TFLOP/s and the clocks an SM
takes for one product at the card's highest SM clock (`nvidia-smi` `clocks.max.sm`; a
lower clock under load means fewer), beside the card's name and power limit. The rate is
the ceiling of a kernel whose time is those products; the TF32 `wgmma` rate checks the
494.7 TFLOP/s that the 3xTF32 bounds divide by.

Usage, from the root of the repository: ``python tools/time_mma_sync.py [--warps 8]
[--iters 4096] [--out DIR]``. It needs a CUDA card and `nvcc` (``ops/_build.find_nvcc``),
and imports no JAX.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// eight independent accumulator chains a warp; the operands change with the round, so no
// product can be hoisted, and every result reaches the output
template <int BF16>
__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4], b0 = threadIdx.x, b1 = threadIdx.x * 3u;
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x + i;
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (BF16)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                     "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0 + j), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                     "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0 + j), "r"(b1));
    }
    b1 += 1u;
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// ---- wgmma: two warpgroups a block, each with one m64n128 accumulator
__device__ __forceinline__ uint64_t wg_desc(const void* p) {   // K-major, 128-byte swizzle
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3ffff) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory"); }
@WGMMA@
// KIND: 0 tf32 A in registers, 1 tf32 A in shared memory, 2 bf16 registers, 3 bf16 shared
template <int KIND>
__global__ void __launch_bounds__(256, 1) wgmma_loop(float* out, int iters) {
  extern __shared__ __align__(1024) unsigned char smem[];   // A 64 x 128 B, B 128 x 128 B
  for (int i = threadIdx.x; i < (64 + 128) * 128 / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const uint64_t da = wg_desc(smem), db = wg_desc(smem + 64 * 128);
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x + i;
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    wg_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint64_t k = 2 * (j % 4);   // 32 bytes a k slice
      if (KIND == 0) wg_tf32_rs(d, a, db + k);
      if (KIND == 1) wg_tf32_ss(d, da + k, db + k);
      if (KIND == 2) wg_bf16_rs(d, a, db + k);
      if (KIND == 3) wg_bf16_ss(d, da + k, db + k);
    }
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" float time_wgmma(int kind, int blocks, int iters) {
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * 256);
  const int smem = (64 + 128) * 128;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = -1.f;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    switch (kind) {
      case 0: wgmma_loop<0><<<blocks, 256, smem>>>(out, iters); break;
      case 1: wgmma_loop<1><<<blocks, 256, smem>>>(out, iters); break;
      case 2: wgmma_loop<2><<<blocks, 256, smem>>>(out, iters); break;
      default: wgmma_loop<3><<<blocks, 256, smem>>>(out, iters); break;
    }
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}

// milliseconds of one launch of `blocks` blocks of `threads` threads, after a warm-up
extern "C" float time_mma(int bf16, int blocks, int threads, int iters) {
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * threads);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = -1.f;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    if (bf16) mma_loop<1><<<blocks, threads>>>(out, iters);
    else mma_loop<0><<<blocks, threads>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
"""


def _wgmma(name: str, shape: str, types: str, a_regs: bool, tail: str) -> str:
    """A device function issuing one m64n128 `wgmma` on the 64 accumulators d."""
    acc = ", ".join(f"%{i}" for i in range(64))
    a_op, a_in = ("{%64, %65, %66, %67}", '"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])') \
        if a_regs else ("%64", '"l"(a)')
    b = 68 if a_regs else 65
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(64))
    a_decl = "const uint32_t (&a)[4]" if a_regs else "uint64_t a"
    return (f"__device__ __forceinline__ void {name}(float (&d)[64], {a_decl}, uint64_t b) {{\n"
            f'  asm volatile("{{\\n .reg .pred p;\\n setp.ne.b32 p, %{b + 1}, 0;\\n'
            f' wgmma.mma_async.sync.aligned.{shape}.f32.{types} {{{acc}}}, {a_op}, '
            f'%{b}, p, {tail};\\n}}\\n" : {outs} : {a_in}, "l"(b), "r"(1));\n}}\n')


def wgmma_source() -> str:
    return (_wgmma("wg_tf32_rs", "m64n128k8", "tf32.tf32", True, "1, 1")
            + _wgmma("wg_tf32_ss", "m64n128k8", "tf32.tf32", False, "1, 1")
            + _wgmma("wg_bf16_rs", "m64n128k16", "bf16.bf16", True, "1, 1, 0")
            + _wgmma("wg_bf16_ss", "m64n128k16", "bf16.bf16", False, "1, 1, 0, 0"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warps", type=int, default=8, help="warps an SM")
    ap.add_argument("--iters", type=int, default=4096)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times the card only", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from representationlearning_tpu_torch.ops import _build

    card = cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "mma.cu"), os.path.join(tmp, "libmma.so")
        with open(src, "w") as f:
            f.write(SOURCE.replace("@WGMMA@", wgmma_source()))
        subprocess.run([_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
        mma = ctypes.CDLL(lib)
        mma.time_mma.restype = ctypes.c_float
        mma.time_mma.argtypes = [ctypes.c_int] * 4
        mma.time_wgmma.restype = ctypes.c_float
        mma.time_wgmma.argtypes = [ctypes.c_int] * 3
        res = {"card": card, "sms": sms, "warps_an_sm": args.warps, "shapes": {}}
        threads = 32 * args.warps
        for name, bf16, flop in (("tf32 m16n8k8", 0, 2 * 16 * 8 * 8),
                                 ("bf16 m16n8k16", 1, 2 * 16 * 8 * 16)):
            ms = mma.time_mma(bf16, sms, threads, args.iters)
            clock = cs.run_cmd(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"]).strip()
            count = sms * args.warps * args.iters * 8
            tflops = count * flop / (ms * 1e-3) / 1e12
            per_sm = ms * 1e-3 * float(clock) * 1e6 / (count / sms)
            res["shapes"][name] = {"ms": ms, "products": count, "tflops": tflops,
                                   "max_sm_clock_mhz": float(clock), "clocks_an_sm_a_product": per_sm}
            print(f"{card}: mma.sync {name}, {args.warps} warps an SM: {ms:.3f} ms for {count} "
                  f"products, {tflops:.1f} TFLOP/s, {per_sm:.2f} SM clocks a product "
                  f"at {clock} MHz")
        for kind, (name, flop) in enumerate((("wgmma tf32 m64n128k8, A in registers", 2 * 64 * 128 * 8),
                                             ("wgmma tf32 m64n128k8, A in shared memory", 2 * 64 * 128 * 8),
                                             ("wgmma bf16 m64n128k16, A in registers", 2 * 64 * 128 * 16),
                                             ("wgmma bf16 m64n128k16, A in shared memory", 2 * 64 * 128 * 16))):
            ms = mma.time_wgmma(kind, sms, args.iters)
            count = sms * 2 * args.iters * 8
            tflops = count * flop / (ms * 1e-3) / 1e12
            per_sm = ms * 1e-3 * float(clock) * 1e6 / (count / sms)
            res["shapes"][name] = {"ms": ms, "products": count, "tflops": tflops,
                                   "max_sm_clock_mhz": float(clock), "clocks_an_sm_a_product": per_sm}
            print(f"{card}: {name}, two warpgroups an SM: {ms:.3f} ms for {count} products, "
                  f"{tflops:.1f} TFLOP/s, {per_sm:.2f} SM clocks a product at {clock} MHz")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "mma_sync_rate.json"), "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
