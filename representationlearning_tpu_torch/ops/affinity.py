"""Kernel K2: the VARM / PAR / PAMR affinity weights
(`SCD-AAAI2023/network/VARM.py:40-84`, `RML/network/PAR.py:65-91`).

The counterpart of ``representationlearning_tpu/ops/pallas/affinity.py``
(``affinity_pallas``). From a 3-channel image it computes, per pixel, a softmax
over the K dilated neighbours of the negative squared colour distance, scaled by
the unbiased standard deviation of those neighbours, and then

    par    + w2 * softmax(position affinity)   (scale 1 / w1)
    pamr   nothing                             (scale 1 / w1)
    varm   - w2 * softmax(local variation)     (scale 4)

Images are (B, 3, H, W) f32, the weights (B, K, H, W) f32: channel-first, the
layout ``ops/varm.py`` (K3) consumes. ``affinity`` launches the CUDA kernel
(``csrc/refine/affinity.cu``) on a CUDA tensor and runs ``affinity_reference``,
the plain PyTorch composition over the materialised neighbour tensor, on a CPU
tensor. Nothing falls back: a build or launch failure raises.

The kernel sums over K in tap order where the plain version reduces in torch's
order, so the two agree to rounding (about 1e-6 on weights in [-w2, 1 + w2]),
not bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from . import _build
from .neighbors import DIST, dilated_neighbors

MODES = {"par": 0, "pamr": 1, "varm": 2}
MAX_DILATIONS = 16  # the kernel takes the dilation list as a by-value parameter

# launches of the kernel since the last reset; the wrapper adds one per launch
LAUNCHES = {"affinity": 0}


def reset_launches() -> None:
    LAUNCHES["affinity"] = 0


def _pos_softmax(dilations: Sequence[int], w1: float) -> tuple:
    """PAR's position-affinity softmax (`PAR.py:49-63`): a K-vector constant."""
    pos = np.concatenate([DIST * d for d in dilations]).astype(np.float64)
    pa = -((pos / (pos.std(ddof=1) + 1e-8)) / w1) ** 2
    ex = np.exp(pa - pa.max())
    return tuple((ex / ex.sum()).astype(np.float32).tolist())


def _scale(mode: str, w1: float) -> float:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {sorted(MODES)}")
    return 4.0 if mode == "varm" else 1.0 / w1


def local_variation(nb: torch.Tensor) -> torch.Tensor:
    """Squared difference of the neighbour tensor (B, K, C, H, W) to its next
    output row and column, the last one replicated (`VARM.py:66-70`), averaged
    over the channels -> (B, K, 1, H, W)."""
    t1 = torch.cat([nb[..., 1:, :], nb[..., -1:, :]], dim=-2)
    t2 = torch.cat([nb[..., 1:], nb[..., -1:]], dim=-1)
    return ((nb - t1) ** 2 + (nb - t2) ** 2).mean(dim=2, keepdim=True)


def affinity_reference(imgs: torch.Tensor, dilations: Sequence[int], mode: str,
                       w1: float = 0.3, w2: float = 0.01) -> torch.Tensor:
    """Plain PyTorch K2 on any device: imgs (B, 3, H, W) -> (B, K, H, W) f32."""
    scale = _scale(mode, w1)
    imgs = imgs.float()
    nb = dilated_neighbors(imgs, dilations)                        # (B, K, 3, H, W)
    std = nb.std(dim=1, keepdim=True, unbiased=True)
    aff = -(((nb - imgs[:, None]).abs() / (std + 1e-8)) * scale) ** 2
    ref = torch.softmax(aff.mean(dim=2), dim=1)                    # (B, K, H, W)
    if mode == "par":
        pos = torch.tensor(_pos_softmax(dilations, w1), device=imgs.device)
        ref = ref + w2 * pos[None, :, None, None]
    elif mode == "varm":
        ref = ref - w2 * torch.softmax(local_variation(nb)[:, :, 0], dim=1)
    return ref


def affinity(imgs: torch.Tensor, dilations: Sequence[int], mode: str, w1: float = 0.3,
             w2: float = 0.01) -> torch.Tensor:
    """K2 dispatcher: imgs (B, 3, H, W) f32 -> affinity weights (B, K, H, W) f32."""
    if not imgs.is_cuda:
        return affinity_reference(imgs, dilations, mode, w1, w2)
    scale = _scale(mode, w1)
    dilations = tuple(int(d) for d in dilations)
    if not 0 < len(dilations) <= MAX_DILATIONS or min(dilations) < 1:
        raise ValueError(f"affinity: 1 to {MAX_DILATIONS} dilations >= 1, got {dilations}")
    if imgs.ndim != 4 or imgs.shape[1] != 3:
        raise ValueError(f"affinity: imgs must be (B, 3, H, W), got {tuple(imgs.shape)}")
    if imgs.dtype != torch.float32:
        raise TypeError(f"affinity: dtype {imgs.dtype}, the kernel takes float32")
    if not imgs.is_contiguous():
        raise ValueError("affinity: imgs not contiguous")
    B, _, H, W = imgs.shape
    K = 8 * len(dilations)
    out = torch.empty((B, K, H, W), device=imgs.device, dtype=torch.float32)
    if out.numel():
        pos = _pos_softmax(dilations, w1) if mode == "par" else (0.0,) * K
        lib = _build.load_library("refine")
        with torch.cuda.device(imgs.device):
            err = lib.k2_affinity(
                imgs.data_ptr(), out.data_ptr(), B, H, W,
                (ctypes.c_int * len(dilations))(*dilations), len(dilations), MODES[mode],
                scale, w2, (ctypes.c_float * K)(*pos),
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, "k2_affinity")
        LAUNCHES["affinity"] += 1
    return out
