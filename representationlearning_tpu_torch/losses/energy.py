"""DenseEnergy (CRF relaxation) loss, the port of
``representationlearning_tpu/losses/energy.py`` (`SCD-AAAI2023/utils/losses.py:35-116`):
the bilateral filter runs on the device (``ops/bilateral.py``), and the gradient
is the reference's hand-written one (grad = -2 A S / N * ROI, `losses.py:86-91`)
as a ``torch.autograd.Function``.

Pipeline (`get_energy_loss` + `DenseEnergyLoss.forward`):
  denormalise the image -> downscale (image / ROI / label nearest, probabilities
  bilinear) -> Gate = clamp(ROI - max_cls(prob), 0) with unlabeled pixels forced
  to 1 -> S = prob * ROI; AS = bilateral(S) * Gate; loss = -w * dot(S, AS) / N

Maps are NCHW; rois (N, H, W); the gate (N, 1, H, W). Under a data group
(``parallel/collectives.py``) N is the global batch: the loss is this rank's share.
"""
from __future__ import annotations

import torch

from ..ops.bilateral import bilateral_filter_batch
from ..ops.image import resize_bilinear, resize_nearest
from ..parallel import collectives as C


class _DenseEnergy(torch.autograd.Function):
    """-dot(S, AS) / N with S = seg * roi, AS = bilateral(S) * gate. The gradient
    goes to the segmentation only and treats AS as the symmetric filter of S:
    grad_seg = -2 g AS / N * roi; images, rois and gate get none."""

    @staticmethod
    def forward(ctx, images, segmentations, rois, gate, sigma_rgb, sigma_xy, method):
        N = C.global_batch(segmentations.shape[0])
        S = segmentations * rois[:, None]
        AS = bilateral_filter_batch(images, S, sigma_rgb, sigma_xy, method=method)
        AS = AS * gate
        ctx.save_for_backward(AS, rois)
        ctx.N = N
        return -(S * AS).sum() / N

    @staticmethod
    def backward(ctx, g):
        AS, rois = ctx.saved_tensors
        grad_seg = -2.0 * g * AS / ctx.N * rois[:, None]
        return None, grad_seg, None, None, None, None, None


def _dense_energy(images, segmentations, rois, gate, sigma_rgb, sigma_xy, method):
    return _DenseEnergy.apply(images, segmentations, rois, gate, sigma_rgb, sigma_xy, method)


def dense_energy_loss(images: torch.Tensor, probs: torch.Tensor, rois: torch.Tensor,
                      seg_label: torch.Tensor, weight: float = 1e-7, sigma_rgb: float = 15.0,
                      sigma_xy: float = 100.0, scale_factor: float = 0.5,
                      ignore_index: int = 255, method: str = "grid") -> torch.Tensor:
    """`DenseEnergyLoss.forward` (`losses.py:94-111`). images: denormalised RGB
    (N, 3, H, W) in [0, 255]; probs: softmax seg probabilities (N, C, H, W); rois:
    (N, H, W) crop mask; seg_label (N, H, W)."""
    H, W = images.shape[-2:]
    h, w = int(H * scale_factor), int(W * scale_factor)
    imgs = resize_nearest(images, (h, w))  # F.interpolate's default mode
    segs = resize_bilinear(probs, (h, w), align_corners=False)
    rois_s = resize_nearest(rois, (h, w))
    unlabeled = resize_nearest(seg_label, (h, w)) == ignore_index

    # Gate (`losses.py:61-68`): ROI minus the per-pixel max probability,
    # unlabeled pixels forced to 1
    gate = rois_s - segs.amax(dim=1)
    gate = torch.where(unlabeled, torch.ones_like(gate), gate)
    gate = gate.clamp(min=0.0)[:, None]

    return weight * _dense_energy(imgs, segs, rois_s, gate, sigma_rgb,
                                  sigma_xy * scale_factor, method)


def get_energy_loss(img_normalized: torch.Tensor, logit: torch.Tensor, label: torch.Tensor,
                    img_box: torch.Tensor, mean=(123.675, 116.28, 103.53),
                    std=(58.395, 57.12, 57.375), **kw) -> torch.Tensor:
    """`get_energy_loss` (`losses.py:35-50`): denormalise, box mask, seg softmax.
    img_normalized (N, 3, H, W), logit (N, C, H, W), label (N, H, W), img_box (N, 4)
    as (y0, y1, x0, x1)."""
    H, W = img_normalized.shape[-2:]
    probs = torch.softmax(logit, dim=1)
    rows = torch.arange(H, device=logit.device)[None, :, None]
    cols = torch.arange(W, device=logit.device)[None, None, :]
    box = img_box[:, :, None, None]
    crop_mask = ((rows >= box[:, 0]) & (rows < box[:, 1])
                 & (cols >= box[:, 2]) & (cols < box[:, 3])).float()
    img = img_normalized * img_normalized.new_tensor(std)[None, :, None, None] \
        + img_normalized.new_tensor(mean)[None, :, None, None]
    return dense_energy_loss(img, probs, crop_mask, label, **kw)
