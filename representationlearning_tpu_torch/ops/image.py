"""Image ops on the inference and pseudo-label paths (the port of the matching
part of ``representationlearning_tpu/ops/image.py``). Tensors are NCHW; every
function works on the last two axes (H, W) and runs where its input lives.

The JAX package hand-builds torch's bilinear taps; here ``F.interpolate`` is the
semantics itself. The TPU routing choices ``resize_bilinear_auto`` and
``resize_bilinear_mm`` are not ported: every call site uses ``resize_bilinear``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """``F.interpolate(mode='bilinear')`` of (..., H, W), computed in f32 and
    returned in x's dtype, as the JAX version does."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-2:]) == size:
        return x
    lead = x.shape[:-2]
    xf = x.float().reshape((-1, 1) + tuple(x.shape[-2:])) if x.ndim != 4 else x.float()
    out = F.interpolate(xf, size=size, mode="bilinear", align_corners=align_corners)
    return out.reshape(lead + size).to(x.dtype)


def adaptive_max_pool_11(x: torch.Tensor) -> torch.Tensor:
    """``F.adaptive_max_pool2d(x, (1, 1))``: max over H, W, keepdims."""
    return x.amax(dim=(-2, -1), keepdim=True)


def adaptive_avg_pool_11(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(-2, -1), keepdim=True)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """``F.interpolate(mode='nearest')`` of (..., H, W): src index =
    floor(i * in / out), computed in f32 as torch does. Any dtype (labels too)."""
    H_out, W_out = int(size[0]), int(size[1])
    H_in, W_in = x.shape[-2:]
    if (H_out, W_out) == (H_in, W_in):
        return x

    def index(n_out: int, n_in: int) -> torch.Tensor:
        i = torch.arange(n_out, dtype=torch.float32, device=x.device) * (n_in / n_out)
        return i.floor().long().clamp_(0, n_in - 1)

    return x.index_select(-2, index(H_out, H_in)).index_select(-1, index(W_out, W_in))


def interpolate(x: torch.Tensor, size=None, scale_factor=None, mode: str = "bilinear",
                align_corners: bool = False) -> torch.Tensor:
    """Dispatcher with ``F.interpolate``'s signature over the two resizes above."""
    if size is None:
        sf = scale_factor if isinstance(scale_factor, (tuple, list)) else \
            (scale_factor, scale_factor)
        size = (int(x.shape[-2] * sf[0]), int(x.shape[-1] * sf[1]))
    if mode == "bilinear":
        return resize_bilinear(x, size, align_corners=align_corners)
    if mode == "nearest":
        return resize_nearest(x, size)
    raise ValueError(f"unsupported mode {mode!r}")


def flip_lr(x: torch.Tensor) -> torch.Tensor:
    """Horizontal flip: the W axis of (..., H, W)."""
    return x.flip(-1)


def minmax_normalize_cam(cam: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Reference CAM normalisation (`utils/camutils.py:110-111`):
    cam += max(-cam); cam /= max(cam) + eps, maxes over H, W per (B, C)."""
    cam = cam + adaptive_max_pool_11(-cam)
    return cam / (adaptive_max_pool_11(cam) + eps)


def grid_sample_bilinear(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``F.grid_sample(x, grid, mode='bilinear', padding_mode='border',
    align_corners=True)``: x (N, C, H, W), grid (N, Hg, Wg, 2) holding (x, y) in
    [-1, 1] -> (N, C, Hg, Wg). Differentiable in x."""
    return F.grid_sample(x, grid.to(x.dtype), mode="bilinear", padding_mode="border",
                         align_corners=True)


def pad_replicate(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Replicate-pad H and W of (N, C, H, W) by `pad` on each side."""
    return F.pad(x, (pad, pad, pad, pad), mode="replicate")


def torch_std(x: torch.Tensor, axis, keepdims: bool = False) -> torch.Tensor:
    """``torch.std`` with its default, the unbiased estimate (ddof = 1)."""
    return x.std(dim=axis, unbiased=True, keepdim=keepdims)
