"""The inference half of the SCD end-to-end WSSS trainer, the port of the
matching part of ``representationlearning_tpu/train/scd.py``
(`SCD-AAAI2023/scripts/dist_train_voc.py:95-146,311-336`):

- ``scd_pseudo_labels``: multi-scale flip CAMs -> pseudo labels -> background-
  aware VARM refinement -> pairwise affinity labels, the part of the train step
  that runs without gradients;
- ``make_scd_eval_step``: the validation forward.

The losses, the optimiser and the train step itself are not ported yet; the
train step will call ``scd_pseudo_labels`` for its labels. Tensors are NCHW.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device
from ..models.refine import varm_refine
from ..ops.image import resize_bilinear
from ..wsss import camutils as CU


class SCDConfig(NamedTuple):
    num_classes: int = 21
    crop_size: int = 320
    cam_scales: tuple = (1.0, 0.5, 1.5)
    bkg_score: float = 0.45
    high_thre: float = 0.55
    low_thre: float = 0.35
    ignore_index: int = 255
    cam_iters: int = 2000
    varm_dilations: tuple = (1, 2, 4, 8, 12, 24)
    varm_iters: int = 10
    energy_weight: float = 1e-7
    w_seg: float = 0.1
    w_energy: float = 0.01
    w_aux: float = 0.1
    w_corr: float = 0.1
    w_er: float = 0.1
    corr_samples: int = 40
    mean: tuple = (123.675, 116.28, 103.53)
    std: tuple = (58.395, 57.12, 57.375)
    attn_radius: int = 8
    # cap on the present classes per image for the refine gather
    # (camutils.refine_cams_with_bkg_v2): None = all; VOC images have at most
    # about 6, so 8 bounds the propagated channels
    max_present: int | None = None
    energy_method: str = "grid"


def _attn_mask(cfg: SCDConfig, device: torch.device | str | None = None) -> torch.Tensor:
    """The radius mask over the stride-16 token grid of a training crop, on the
    card unless the caller names another device."""
    s = cfg.crop_size // 16
    return torch.from_numpy(CU.get_mask_by_radius(s, s, cfg.attn_radius)).to(
        resolve_device(device))


def _down_size(h: int, stride: int = 16) -> int:
    """`dist_train_voc.py:89-93` get_down_size: feature-grid extent at stride 16."""
    return h // stride + 1 - (h % stride == 0)


@torch.no_grad()
def scd_pseudo_labels(cam_model, images: torch.Tensor, cls_label: torch.Tensor,
                      img_box: torch.Tensor, cfg: SCDConfig,
                      attn_mask: torch.Tensor | None = None):
    """The label half of the SCD train step, without gradients.

    cam_model(x, cam_only=True) -> (cam, attn_pred or None): a TSCD, usually the
    fused twin with ``collect_attns="none"``. images (B, 3, H, W) normalised,
    cls_label (B, C - 1) one-hot, img_box (B, 4) as (y0, y1, x0, x1). attn_mask
    is ``_attn_mask(cfg, images.device)`` unless the caller made it once.

    Returns (cams (B, C - 1, H, W), pseudo_label (B, H, W), refined_label
    (B, H, W), ref_label (B, N, N)), N = (crop_size / 16)^2.
    """
    def cam_fn(x):
        return cam_model(x, cam_only=True)

    # multi-scale CAMs (`dist_train_voc.py:311-324`)
    cams, _ = CU.multi_scale_cam_with_ref_mat(cam_fn, images, cfg.cam_scales)

    # pseudo labels + VARM refine (`:312,334`)
    _, pseudo_label = CU.cam_to_label(
        cams, cls_label, img_box, ignore_mid=True, bkg_score=cfg.bkg_score,
        high_thre=cfg.high_thre, low_thre=cfg.low_thre, ignore_index=cfg.ignore_index)
    std = images.new_tensor(cfg.std)[None, :, None, None]
    mean = images.new_tensor(cfg.mean)[None, :, None, None]
    inputs_denorm = images * std + mean

    def refine_fn(im, m):
        return varm_refine(im, m, dilations=cfg.varm_dilations, num_iter=cfg.varm_iters)

    refined_label = CU.refine_cams_with_bkg_v2(
        refine_fn, inputs_denorm, cams, cls_label, img_box, high_thre=cfg.high_thre,
        low_thre=cfg.low_thre, ignore_index=cfg.ignore_index, max_present=cfg.max_present)

    if attn_mask is None:
        attn_mask = _attn_mask(cfg, images.device)
    ref_label = CU.cams_to_refine_label(refined_label, mask=attn_mask,
                                        ignore_index=cfg.ignore_index, down=16)
    return cams, pseudo_label, refined_label, ref_label


def make_scd_eval_step(model, cfg: SCDConfig, device: torch.device | str | None = None):
    """Validation forward (`dist_train_voc.py:95-146`): seg argmax + multi-scale CAM
    pseudo labels + affinity-propagated "ref" labels (the reference's third score
    stream, `:122-142`). ``model`` is a TSCD that exports its attention maps
    (``collect_attns="last2"``). The step takes a batch dict (image (B, 3, H, W),
    cls_label (B, C - 1)) on ``device``, the card unless the caller names another,
    and returns tensors there; metric accumulation happens outside."""
    device = resolve_device(device)
    masks: dict[tuple[int, int], torch.Tensor] = {}  # radius masks by grid size

    @torch.no_grad()
    def eval_step(batch):
        inputs = batch["image"].to(device)
        cls_labels = batch["cls_label"].to(device)
        H, W = inputs.shape[-2:]
        cls_logits, segs, _, attn_pred = model(inputs)
        segs_up = resize_bilinear(segs, (H, W), align_corners=False)
        cams = CU.multi_scale_cam(lambda x: model(x, cam_only=True), inputs, cfg.cam_scales)
        cam_label = CU.cam_to_label(cams, cls_labels, img_box=None, bkg_score=cfg.bkg_score)
        # ref stream (`:122-130`): the raw (not class-masked) CAM down to the
        # stride-16 grid, random-walked through the predicted affinity under a
        # radius mask; bkg_score is hard-coded 0.35 in the reference call
        h16, w16 = _down_size(H), _down_size(W)
        if (h16, w16) not in masks:
            masks[h16, w16] = torch.from_numpy(
                CU.get_mask_by_radius(h16, w16, cfg.attn_radius)).to(device)
        cam16 = resize_bilinear(cams, (h16, w16), align_corners=False)
        ref_cam = CU.propagate_ref_cam_with_bkg(cam16, attn_pred, cls_labels, bkg_score=0.35,
                                                mask=masks[h16, w16])
        ref_cam = resize_bilinear(ref_cam, (H, W), align_corners=False)
        return {
            "seg_pred": segs_up.argmax(1),
            "cam_label": cam_label,
            "ref_label": ref_cam.argmax(1),
            "cls_pred": (cls_logits > 0).int(),
        }

    return eval_step
