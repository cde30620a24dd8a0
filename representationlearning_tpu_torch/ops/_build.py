"""Build and load the port's hand-written CUDA kernels.

The sources under ``representationlearning_tpu_torch/csrc/`` are compiled with
``nvcc`` into a shared library with a plain C interface and loaded with
``ctypes``. The build happens at first use, into ``representationlearning_tpu_torch/
_build/<hash>/``, keyed by a hash of the sources and the flags, so an edited
source rebuilds and an unchanged one loads what is there. Every source of a
library is compiled by an ``nvcc`` of its own, all started together, and the
objects are linked at the end. Nothing here runs at import time: the CPU paths
never call ``load_library``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types; every pointer and the stream are c_void_p
SIGNATURES = {
    "mit_block": {
        "k1_ln_stats": (_P, _P, _I, _I, _P),
        # a, w, bias, stats, ln_w, ln_b, residual, out, M, Nout, K, tile, per, f32, stream
        "k1_linear": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        "k1_linear_blocks_per_sm": (_I, _I, _I),   # tile, LayerNorm prologue, f32
        # x, stats, ln_w, ln_b, w, bias, workspace, out, B, H, W, C, sr, rows, columns,
        # slices, f32, stream
        "k1_sr_conv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        "k1_sr_conv_wg_smem": (_I, _I),           # f32: rows, columns of the tile
        "k1_sr_conv_wg_clusters": (_I, _I, _I),   # f32: rows, columns, blocks a cluster
        # q, kv, workspace, out, logits, B, N, Nk, C, nh, scale, f32, queries, blocks, stream
        "k1_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
        "k1_attention_one_pass_keys": (),
        "k1_attention_wg_smem": (_I, _I),   # head width, queries a block
        # f, w, bias, out, B, H, W, hid, columns a thread, rows a thread, stream
        "k1_dwconv_gelu": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        "k1_gelu_as_mismatches": (),   # a check of the tests: returns a count
    },
    "refine": {
        # imgs, out, B, H, W, dilations (host), n_dil, mode, scale, w2, pos (host), rows,
        # held, stream
        "k2_affinity": (_P, _P, _I, _I, _I, _P, _I, _I, _F, _F, _P, _I, _I, _P),
        "k2_affinity_blocks_per_sm": (_I, _I, _I, _I),   # mode, rows, held, smem
        # src, ref, dst, B, C, H, W, dilations (host), n_dil, tile rows, pixels, blocks,
        # iteration, stream
        "k3_varm_iter": (_P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P),
        "k3_varm_blocks_per_sm": (_I, _I, _I),   # tile rows, pixels, smem
    },
    "attention": {
        # q, k, v, o, lse, BH, Nq, Nk, D, scale, is_bf16, warps, blocks, stream
        "k4_flash_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P),
        "k4_flash_fwd_blocks_per_sm": (_I, _I, _I, _I),  # Nk, D, is_bf16, warps
        # q, k, v, o, do, lse, dq, dk, dv, ws, BH, Nq, Nk, D, scale, is_bf16, rows, shares,
        # stream
        "k4_flash_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                         _I, _P),
        "k4_flash_bwd_blocks_per_sm": (_I, _I, _I, _I),  # Nk, D, is_bf16, rows
    },
    "rssformer": {
        # x, w1, b1, scale1, shift1, h, M, Cin, padded Cin, padded hid, f32, plan (bf16:
        # warps, steps a block; f32: tile of hidden features, blocks), stream
        "k5_mlp_fc1": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
        "k5_fc1_blocks_per_sm": (_I, _I, _I, _I, _I),   # Cin, padded Cin, padded hid, f32, warps / tile
        # h, taps, dw_bias, scale2, shift2, w2, b2, scale3, shift3, out, B, H, W, Cout,
        # padded Cout, padded hid, f32, tile, blocks, stream
        "k5_mlp_taps": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _P),
        "k5_taps_blocks_per_sm": (_I, _I, _I),   # padded hid, f32, tile
        # q, k, v, out, NW, T, C, nh, round_bf16, windows, warps, stages, blocks, stream
        "k6_isa_core": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        "k6_isa_blocks_per_sm": (_I, _I, _I, _I, _I, _I, _I),  # T, C, nh, bf16, plan
    },
}

_locks = {name: threading.Lock() for name in SIGNATURES}  # libraries build side by side
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, dict] = {}  # name -> {"path", "ptxas"} of this process


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or NVCC to build the CUDA kernels")


def _sources(name: str) -> list[Path]:
    d = CSRC / name
    srcs = sorted(d.glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources under {d}")
    return srcs


# headers of csrc/ that more than one library includes (the Hopper building blocks)
SHARED_HEADERS = ("hopper",)


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for d in (name, *SHARED_HEADERS):
        for p in sorted((CSRC / d).glob("*.cu*")):
            h.update(f"{d}/{p.name}".encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(name: str, out: Path) -> str:
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    log = []
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for src in _sources(name):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", os.path.join(tmp, src.stem + ".o"), str(src)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        link = [nvcc, "-shared", "-o", os.path.join(tmp, out.name),
                *(cmd[-2] for cmd, _ in jobs)]
        results = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in jobs]
        for cmd, text, rc in results:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
            log.append(text)
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(link)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(link[3], out)  # atomic: a concurrent build sees the old or the new file
    return "".join(log)


def _built(name: str) -> Path:
    """The library of ``csrc/<name>/``, compiled first if it is not in the build
    directory yet; the caller holds ``_locks[name]``."""
    path = BUILD_DIR / _digest(name) / f"lib{name}.so"
    if not path.exists():
        log = path.with_suffix(".ptxas.txt")  # what `-Xptxas -v` said when it was built
        log.parent.mkdir(parents=True, exist_ok=True)
        log.write_text(_compile(name, path))
    return path


def build_all() -> dict[str, Path]:
    """Compile every library that ``load_library`` would load, side by side, and
    load none of them: a process that must not create a CUDA context (the
    bench's parent) builds once for the processes it starts."""
    def build(name: str) -> Path:
        with _locks[name]:
            return _built(name)

    names = sorted(SIGNATURES)
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load_library(name: str = "mit_block") -> ctypes.CDLL:
    """Build (if needed) and load the kernels of ``csrc/<name>/``."""
    with _locks[name]:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = _built(name)
        log = path.with_suffix(".ptxas.txt")
        ptxas = log.read_text() if log.exists() else ""
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        build_log[name] = {"path": str(path), "ptxas": ptxas}
        _libs[name] = lib
        return lib


def compute_dtype(dtype, kernel: str) -> None:
    """Refuse an operand type of the products that the CUDA kernels lack: K1, K5 and
    K6 take float32 (3xTF32 products in K1 and K5, f32 multiply-adds in K6) and
    bfloat16."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"{kernel} takes compute dtype float32 or bfloat16, got {dtype}")


def check(err: int, fn: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")
