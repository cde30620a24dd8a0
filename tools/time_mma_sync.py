"""Measures the rate of `mma.sync` on the card: TF32 m16n8k8 and bf16 m16n8k16, f32 sums.

K4's kernels (``csrc/attention/flash_{fwd,bwd}.cu``) run their products as `mma.sync`,
f32 operands as three TF32 products each. This times a kernel that does nothing but
`mma.sync` on registers: every SM holds `--warps` warps of eight independent chains,
each warp issuing `--iters` rounds of eight products. It prints, for each shape, the
time, the products issued, the rate in TFLOP/s and the clocks an SM takes for one
product at the card's highest SM clock (`nvidia-smi` `clocks.max.sm`; a lower clock under
load means fewer), beside the card's name and power limit. The rate is the ceiling of a kernel whose time is its `mma.sync` products.

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
            f.write(SOURCE)
        subprocess.run([_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
        mma = ctypes.CDLL(lib)
        mma.time_mma.restype = ctypes.c_float
        mma.time_mma.argtypes = [ctypes.c_int] * 4
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
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "mma_sync_rate.json"), "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
