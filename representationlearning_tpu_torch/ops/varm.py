"""Kernel K3: the VARM / PAR mask-propagation loop
(`SCD-AAAI2023/network/VARM.py:86-89`).

The counterpart of ``representationlearning_tpu/ops/pallas/varm.py``
(``varm_propagate_pallas``): ``num_iter`` times

    m'[b, c, y, x] = sum_k ref[b, k, y, x] * m[b, c, clamp(y + dy_k d_k), clamp(x + dx_k d_k)]

summed in tap order starting from the k = 0 term, in f32. Masks are (B, C, H, W),
the weights channel-first (B, K, H, W) as K2 (``ops/affinity.py``) writes them,
or (B, K, 1, H, W) as a plain affinity with a kept channel axis produces them.

``varm_propagate`` launches the CUDA kernel (``csrc/refine/varm.cu``) once per
iteration on a CUDA tensor, ping-ponging between two buffers, and runs
``varm_propagate_reference`` on a CPU tensor. The kernel multiplies and adds
without fusing the two, in the same order as the plain version, so on the same
inputs the two are equal bit for bit. Nothing falls back: a build or launch
failure raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build
from .affinity import MAX_DILATIONS
from .neighbors import shifted_views

# launches of the kernel since the last reset: one per iteration
LAUNCHES = {"varm_propagate": 0}


def reset_launches() -> None:
    LAUNCHES["varm_propagate"] = 0


def _channel_first(ref: torch.Tensor, K: int) -> torch.Tensor:
    """(B, K, H, W), or (B, K, 1, H, W) with its unit axis dropped (a view)."""
    if ref.ndim == 5:
        if ref.shape[2] != 1:
            raise ValueError(f"ref (B, K, 1, H, W) expected, got {tuple(ref.shape)}")
        ref = ref[:, :, 0]
    if ref.ndim != 4 or ref.shape[1] != K:
        raise ValueError(f"ref must hold K = {K} taps on axis 1, got {tuple(ref.shape)}")
    return ref


def varm_propagate_reference(masks: torch.Tensor, ref: torch.Tensor,
                             dilations: Sequence[int], num_iter: int) -> torch.Tensor:
    """Plain PyTorch K3 on any device: a running sum over the K shifted views,
    without materialising the (B, K, C, H, W) neighbour tensor."""
    ref = _channel_first(ref, 8 * len(dilations))
    for _ in range(num_iter):
        acc = None
        for k, nb in enumerate(shifted_views(masks, dilations)):
            term = nb * ref[:, k: k + 1]
            acc = term if acc is None else acc + term
        masks = acc
    return masks


def varm_propagate(masks: torch.Tensor, ref: torch.Tensor, dilations: Sequence[int],
                   num_iter: int) -> torch.Tensor:
    """K3 dispatcher: masks (B, C, H, W) f32, ref (B, K, H, W) or (B, K, 1, H, W)
    f32 -> the propagated masks (B, C, H, W)."""
    if not masks.is_cuda:
        return varm_propagate_reference(masks, ref, dilations, num_iter)
    dilations = tuple(int(d) for d in dilations)
    if not 0 < len(dilations) <= MAX_DILATIONS or min(dilations) < 1:
        raise ValueError(f"varm_propagate: 1 to {MAX_DILATIONS} dilations >= 1, "
                         f"got {dilations}")
    ref = _channel_first(ref, 8 * len(dilations))
    if masks.ndim != 4:
        raise ValueError(f"varm_propagate: masks must be (B, C, H, W), got "
                         f"{tuple(masks.shape)}")
    B, C, H, W = masks.shape
    if ref.device != masks.device:
        raise ValueError(f"varm_propagate: ref on {ref.device}, masks on {masks.device}")
    if tuple(ref.shape) != (B, ref.shape[1], H, W):
        raise ValueError(f"varm_propagate: ref {tuple(ref.shape)} does not match masks "
                         f"{tuple(masks.shape)}")
    if masks.dtype != torch.float32 or ref.dtype != torch.float32:
        raise TypeError(f"varm_propagate: dtypes {masks.dtype}, {ref.dtype}; the kernel "
                        "takes float32")
    if not masks.is_contiguous():
        raise ValueError("varm_propagate: masks not contiguous")
    if num_iter <= 0 or not masks.numel():
        return masks
    ref = ref.contiguous()  # once, outside the iteration loop
    dil = (ctypes.c_int * len(dilations))(*dilations)
    lib = _build.load_library("refine")
    src, bufs = masks, (torch.empty_like(masks), torch.empty_like(masks))
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(num_iter):
            dst = bufs[i % 2]
            err = lib.k3_varm_iter(src.data_ptr(), ref.data_ptr(), dst.data_ptr(),
                                   B, C, H, W, dil, len(dilations), stream)
            _build.check(err, "k3_varm_iter")
            LAUNCHES["varm_propagate"] += 1
            src = dst
    return src
