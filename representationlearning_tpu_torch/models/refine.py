"""Pixel-adaptive refinement: VARM (SCD), PAR / PAMR (RML), the port of
``representationlearning_tpu/models/refine.py``.

Parity targets:
- VARM (`SCD-AAAI2023/network/VARM.py:24-90`): 8-neighbour dilated affinity from image
  self-similarity MINUS a local-variation term (w2 = 0.01), sharpness factor 4,
  10 propagation iterations.
- PAR (`RML/network/PAR.py:27-91`): the same affinity with sharpness 1 / w1 (w1 = 0.3)
  PLUS w2 * softmax(position affinity).
- PAMR (`RML/network/PAR.py:93-147`): image affinity only.

Tensors are NCHW: images (B, 3, H, W), masks (B, C, h, w), weights (B, K, H, W)
with K = 8 * len(dilations). The three ``*_refine`` functions compute the
weights with kernel K2 (``ops/affinity.py``) and propagate with kernel K3
(``ops/varm.py``): the CUDA kernels for CUDA tensors of any H, W, C and
dilations, their plain versions for CPU tensors. ``par_variant_refine`` has no
affinity kernel in the JAX package either: its weights are plain PyTorch and
only its propagation goes through K3. Refinement runs without gradients in
every trainer, so neither kernel has a backward.
"""
from __future__ import annotations

import torch

from ..ops import affinity as _aff
from ..ops import varm as _varm
from ..ops.image import resize_bilinear
from ..ops.neighbors import dilated_neighbors

VARM_DILATIONS = (1, 2, 4, 8, 12, 24)


def propagate(masks, ref, dilations, num_iter):
    """Mask propagation through K3: the CUDA kernel for CUDA tensors, the plain
    loop for CPU tensors."""
    return _varm.varm_propagate(masks, ref, tuple(dilations), num_iter)


def _refine(imgs, masks, dilations, num_iter, mode, w1, w2):
    masks = resize_bilinear(masks, imgs.shape[-2:], align_corners=True)
    ref = _aff.affinity(imgs, tuple(dilations), mode, w1=w1, w2=w2)
    return propagate(masks.float().contiguous(), ref, dilations, num_iter)


@torch.no_grad()
def varm_refine(imgs: torch.Tensor, masks: torch.Tensor,
                dilations: tuple = VARM_DILATIONS, num_iter: int = 10,
                w2: float = 0.01) -> torch.Tensor:
    """VARM: refine `masks` (B, C, h, w) against `imgs` (B, 3, H, W) -> (B, C, H, W)."""
    return _refine(imgs, masks, dilations, num_iter, "varm", 0.3, w2)


@torch.no_grad()
def par_refine(imgs: torch.Tensor, masks: torch.Tensor, dilations: tuple = VARM_DILATIONS,
               num_iter: int = 10, w1: float = 0.3, w2: float = 0.01) -> torch.Tensor:
    """PAR: image affinity + w2 * position affinity (`RML/network/PAR.py:65-91`)."""
    return _refine(imgs, masks, dilations, num_iter, "par", w1, w2)


@torch.no_grad()
def pamr_refine(imgs: torch.Tensor, masks: torch.Tensor, dilations: tuple = VARM_DILATIONS,
                num_iter: int = 10, w1: float = 0.3) -> torch.Tensor:
    """PAMR: image affinity only (`RML/network/PAR.py:131-147`)."""
    return _refine(imgs, masks, dilations, num_iter, "pamr", w1, 0.0)


@torch.no_grad()
def par_variant_refine(imgs: torch.Tensor, masks: torch.Tensor,
                       dilations: tuple = VARM_DILATIONS, num_iter: int = 10,
                       w1: float = 0.3, w2: float = 0.01, norm: str = "std",
                       extra: str = "none", clamp: bool = False) -> torch.Tensor:
    """The PAR experiment zoo (`RML/backbone/PAR.py:27-1511`, about 20 classes)
    reduced to its structurally distinct axes as switches:

    - norm: "std" -> |diff| / (std + eps) / w1 (PAR1/PAR2*/PAR3*), "w1" -> |diff| / w1
      (PAR1a), "bare" -> |diff| (PAR1b)
    - extra: "none" (PAR1 family), "pos" -> + w2 * softmax(position affinity) (PAR),
      "+var" -> + w2 * softmax(local variation) (PAR3 with w2 = 1.0, PAR3a with
      w2 = 0.01), "-var" -> - w2 * softmax(local variation) (PAR3b family, VARM's
      shape), "/var" -> the ratio form (PAR3e)
    - clamp: clamp the mixed affinity at 0 (PAR3bb)

    The remaining sweep names reduce to these axes up to a global output scale,
    which the downstream argmax does not see (PARITY.md lists them). The weights
    here are plain PyTorch, (B, K, 1, H, W); the propagation is K3.
    """
    masks = resize_bilinear(masks, imgs.shape[-2:], align_corners=True)
    imgs = imgs.float()
    nb = dilated_neighbors(imgs, dilations)                        # (B, K, 3, H, W)
    diff = (nb - imgs[:, None]).abs()
    if norm == "std":
        a = diff / (nb.std(dim=1, keepdim=True, unbiased=True) + 1e-8) / w1
    elif norm == "w1":
        a = diff / w1
    else:
        a = diff
    ref = torch.softmax((-(a ** 2)).mean(dim=2, keepdim=True), dim=1)

    if extra == "pos":
        pos = torch.tensor(_aff._pos_softmax(dilations, w1), device=imgs.device)
        ref = ref + w2 * pos[None, :, None, None, None]
    elif extra in ("+var", "-var", "/var"):
        sv = torch.softmax(_aff.local_variation(nb), dim=1)
        if extra == "/var":  # PAR3e ratio form (`PAR.py:1152-1225`)
            ref = ref / sv
        else:
            ref = ref + (w2 * sv if extra == "+var" else -w2 * sv)
    if clamp:
        ref = ref.clamp_min(0.0)
    return propagate(masks.float().contiguous(), ref, dilations, num_iter)
