"""Host C++ (OpenMP) permutohedral lattice with ctypes bindings, the port's own
copy of ``representationlearning_tpu/native/`` (``permutohedral.cc`` is the same
file byte for byte): the role the reference's C++/SWIG extension plays
(`SCD-AAAI2023/wrapper/bilateralfilter/`).

``bilateral_filter_batch_native(images, inputs, sigma_rgb, sigma_xy)`` computes
the unnormalised 5-D Gaussian transform of ``ops/bilateral.py`` on the host with
the lattice's own amplitude (the exact sum x ``LATTICE_GAIN_5D``), OpenMP over
the batch. Arrays are numpy and channel-last, as the C interface takes them.

The library is built at first use with ``g++ -O3 -fopenmp -shared -fPIC`` into
``representationlearning_tpu_torch/_build/<hash>/`` (git-ignored), keyed by a hash
of the source and the flags, as ``ops/_build.py`` keys the CUDA libraries. A
failed build raises; nothing falls back to another filter.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "permutohedral.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libpermutohedral.so"


def _build() -> Path:
    path = library_path()
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed ({r.returncode}) building {SRC.name}:\n{r.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent build sees the old or the new file
    return path


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            lib.bilateral_filter.argtypes = [
                f32p, f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float,
            ]
            lib.bilateral_filter.restype = None
            lib.bilateral_filter_batch.argtypes = [
                f32p, f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ]
            lib.bilateral_filter_batch.restype = None
            _lib = lib
        return _lib


def bilateral_filter_native(image: np.ndarray, inputs: np.ndarray,
                            sigma_rgb: float, sigma_xy: float) -> np.ndarray:
    """image (H, W, 3) in [0, 255]; inputs (H, W, K) -> (H, W, K)."""
    lib = load()
    image = np.ascontiguousarray(image, np.float32)
    inputs = np.ascontiguousarray(inputs, np.float32)
    H, W, K = inputs.shape
    if image.shape != (H, W, 3):
        raise ValueError(f"image {image.shape} does not match inputs {inputs.shape}")
    out = np.empty_like(inputs)
    lib.bilateral_filter(image, inputs, out, H, W, K, float(sigma_rgb), float(sigma_xy))
    return out


def bilateral_filter_batch_native(images: np.ndarray, inputs: np.ndarray,
                                  sigma_rgb: float, sigma_xy: float) -> np.ndarray:
    """images (N, H, W, 3); inputs (N, H, W, K) -> (N, H, W, K), OpenMP over N."""
    lib = load()
    images = np.ascontiguousarray(images, np.float32)
    inputs = np.ascontiguousarray(inputs, np.float32)
    N, H, W, K = inputs.shape
    if images.shape != (N, H, W, 3):
        raise ValueError(f"images {images.shape} do not match inputs {inputs.shape}")
    out = np.empty_like(inputs)
    lib.bilateral_filter_batch(images, inputs, out, N, K, H, W,
                               float(sigma_rgb), float(sigma_xy))
    return out
