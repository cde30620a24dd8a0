"""Image ops on the inference path (the port of the matching part of
``representationlearning_tpu/ops/image.py``). Tensors are NCHW.

The JAX package hand-builds torch's bilinear taps; here ``F.interpolate`` is the
semantics itself. The TPU routing choice ``resize_bilinear_auto`` is not ported.
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
