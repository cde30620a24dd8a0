"""CAM utilities, the port of ``representationlearning_tpu/wsss/camutils.py``
(parity with `SCD-AAAI2023/utils/camutils.py`).

As in the JAX package the reference's per-image loops and valid-class gathers
(`:185-199,318-325`) are batched channel-masked ops (softmax / argmax with the
absent classes at the most negative float), which is exactly equivalent.
Tensors are NCHW: images (B, 3, H, W), cams (B, C_fg, H, W), class labels
(B, C_fg), label maps (B, H, W) int64, affinities (B, N, N). Every function runs
where its inputs live; ``get_mask_by_radius`` returns numpy, as in the JAX
package, and the caller places it.

Model contract: ``cam_fn(inputs) -> (cam (B, C_fg, h, w), attn_pred or None)`` is
the ``cam_only`` forward of a TSCD-style model.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..ops.crf import crf_inference_label
from ..ops.image import flip_lr, minmax_normalize_cam, resize_bilinear, resize_nearest


def _single_scale_cam(cam_fn, inputs, size):
    """Forward [x; flip(x)] through cam_only, resize to `size`, max over the
    flips, relu (`camutils.py:89-96`). Returns (cam, attn_pred of the cat batch)."""
    b = inputs.shape[0]
    cam, ref = cam_fn(torch.cat([inputs, flip_lr(inputs)], dim=0))
    cam = resize_bilinear(cam, size, align_corners=False)
    cam = torch.maximum(cam[:b], flip_lr(cam[b:]))
    return torch.relu(cam), ref


def multi_scale_cam(cam_fn: Callable, inputs: torch.Tensor, scales: Sequence[float]):
    """Multi-scale + flip CAM inference (`camutils.py:85-113`): scale 1 always
    computed, flips max-reduced, scales summed, min-max normalised."""
    return multi_scale_cam_with_ref_mat(cam_fn, inputs, scales)[0]


@torch.no_grad()
def multi_scale_cam_with_ref_mat(cam_fn: Callable, inputs: torch.Tensor,
                                 scales: Sequence[float]):
    """Also returns the attn_pred ("ref mat") of the largest scale
    (`camutils.py:115-147`, max over `scales` at `:146`)."""
    H, W = inputs.shape[-2:]
    cam_sum, base_ref = _single_scale_cam(cam_fn, inputs, (H, W))
    refs = [base_ref]
    for s in scales:
        if s == 1.0:
            continue
        si = resize_bilinear(inputs, (int(s * H), int(s * W)), align_corners=False)
        c, r = _single_scale_cam(cam_fn, si, (H, W))
        cam_sum = cam_sum + c
        refs.append(r)
    # the ref of position argmax(scales) in the [base, non-1 scales...] list, which
    # is the largest scale for the reference's configs
    order = [1.0] + [s for s in scales if s != 1.0]
    return minmax_normalize_cam(cam_sum), refs[int(np.argmax(order))]


def cam_to_label(cam: torch.Tensor, cls_label: torch.Tensor,
                 img_box: torch.Tensor | None = None, ignore_mid: bool = False,
                 bkg_score: float = 0.45, high_thre: float = 0.55, low_thre: float = 0.35,
                 ignore_index: int = 255):
    """CAM -> pseudo label (`camutils.py:8-28`). cam (B, C_fg, H, W) normalised;
    cls_label (B, C_fg) one-hot. Returns (valid_cam, pseudo_label) when img_box
    is given, else the pseudo label alone."""
    valid_cam = cls_label[:, :, None, None] * cam
    cam_value, pseudo = valid_cam.max(dim=1)
    pseudo = pseudo + 1
    pseudo = pseudo.masked_fill(cam_value <= bkg_score, 0)
    if img_box is None:
        return pseudo
    if ignore_mid:
        pseudo = pseudo.masked_fill(cam_value <= high_thre, ignore_index)
        pseudo = pseudo.masked_fill(cam_value <= low_thre, 0)
    return valid_cam, ignore_outside_box(pseudo, img_box, ignore_index)


def ignore_outside_box(label: torch.Tensor, img_box: torch.Tensor, ignore_index: int = 255):
    """Mask the pixels outside each sample's valid-image box (y0, y1, x0, x1)
    (`camutils.py:30-37`)."""
    _, H, W = label.shape
    rows = torch.arange(H, device=label.device)[None, :, None]
    cols = torch.arange(W, device=label.device)[None, None, :]
    box = img_box.to(label.device)[:, :, None, None]
    inside = (rows >= box[:, 0]) & (rows < box[:, 1]) & (cols >= box[:, 2]) & (cols < box[:, 3])
    return torch.where(inside, label, ignore_index)


@torch.no_grad()
def refine_cams_with_bkg_v2(refine_fn: Callable, images_denorm: torch.Tensor,
                            cams: torch.Tensor, cls_labels: torch.Tensor,
                            img_box: torch.Tensor, high_thre: float = 0.55,
                            low_thre: float = 0.35, ignore_index: int = 255,
                            down_scale: int = 2, max_present: int | None = None):
    """Background-aware VARM refinement (`camutils.py:161-201`), batched: the
    reference's per-image valid-key gather / softmax is a channel mask with the
    most negative float as logit; propagation is linear per channel, so masked
    channels stay about 0 and the argmax is the same.

    refine_fn(images, masks) -> refined masks (e.g. ``models.refine.varm_refine``).
    cams (B, C_fg, H, W); returns the refined pseudo label (B, H, W) in
    {0..C_fg, ignore}.

    max_present: cap on the present classes per image. The reference's per-image
    loop (`camutils.py:183-193`) refines only the classes PRESENT in each image
    (VOC: 1-3 of 20). With max_present = P the present classes are gathered per
    image (stable class order, the reference's valid-key order) and only P
    foreground channels are propagated: identical to the full path PROVIDED
    every image has at most P present classes. The caller owns that bound; a
    violated bound silently drops the excess classes from refinement.

    Both threshold stacks go through ONE refine call: propagation is independent
    per channel (the affinity depends on the image only), so the channel concat
    is exact and halves the cost; the reference runs the module twice
    (`camutils.py:168-171`).
    """
    B, Cf, H, W = cams.shape
    small = (H // down_scale, W // down_scale)
    imgs_small = resize_bilinear(images_denorm, small, align_corners=False)

    idx = None
    if max_present is not None and max_present < Cf:
        # present classes first, in class order: `torch.where(cls_label == 1)`'s keys
        idx = torch.argsort(1.0 - cls_labels, dim=1, stable=True)[:, :max_present]
        cams = torch.gather(cams, 1, idx[:, :, None, None].expand(-1, -1, H, W))
        cls_labels = torch.gather(cls_labels, 1, idx)
        Cf = max_present

    valid = torch.cat([cls_labels.new_ones((B, 1)), cls_labels], dim=1) > 0   # (B, C)
    valid = valid[:, :, None, None]
    neg_inf = torch.finfo(cams.dtype).min

    def probs_for(bkg_value):
        cwb = torch.cat([cams.new_full((B, 1, H, W), bkg_value), cams], dim=1)
        cwb_small = resize_bilinear(cwb, small, align_corners=False)
        return torch.softmax(cwb_small.masked_fill(~valid, neg_inf), dim=1)

    both = refine_fn(imgs_small, torch.cat([probs_for(high_thre), probs_for(low_thre)], dim=1))
    C = Cf + 1

    def label_of(ref):
        ref = resize_bilinear(ref, (H, W), align_corners=False)
        lbl = ref.masked_fill(~valid, neg_inf).argmax(dim=1)
        if idx is None:
            return lbl
        # compact foreground slots back to class ids; background stays 0
        ids = torch.cat([idx.new_zeros((B, 1)), idx + 1], dim=1)              # (B, P + 1)
        return torch.gather(ids, 1, lbl.flatten(1)).reshape(B, H, W)

    label_h = label_of(both[:, :C])
    label_l = label_of(both[:, C:])

    # combination (`camutils.py:196-199`): confident foreground from the high-bkg
    # pass, background only where both passes agree on it, everything else ignore;
    # outside the valid box ignore
    refined = label_h.masked_fill(label_h == 0, ignore_index)
    refined = refined.masked_fill((label_h + label_l) == 0, 0)
    return ignore_outside_box(refined, img_box, ignore_index)


def cams_to_refine_label(cam_label: torch.Tensor, mask: torch.Tensor | None = None,
                         ignore_index: int = 255, down: int = 16):
    """Pairwise affinity label of a pseudo-label map (`camutils.py:238-257`):
    nearest-downsample by `down`, (B, N, N) with 1 where the classes match;
    positions under `mask == 0` and any pair touching an ignored pixel ->
    ignore_index."""
    B, H, W = cam_label.shape
    lab = resize_nearest(cam_label, (H // down, W // down)).reshape(B, -1)    # (B, N)
    eq = (lab[:, None, :] == lab[:, :, None]).long()
    if mask is not None:
        eq = eq.masked_fill(mask[None] == 0, ignore_index)
    ign = lab == ignore_index
    return eq.masked_fill(ign[:, None, :] | ign[:, :, None], ignore_index)


def _column_normalized_sq(ref, mask, eps):
    if mask is not None:
        ref = ref.masked_fill(mask[None] == 0, 0.0)
    ref = ref ** 2
    return ref / (ref.sum(dim=1, keepdim=True) + eps)  # torch dim=1 of (B, N, N)


def propagate_ref_cam_with_bkg(cams: torch.Tensor, ref: torch.Tensor,
                               cls_labels: torch.Tensor, bkg_score: float,
                               mask: torch.Tensor | None = None):
    """Random-walk CAM propagation through the predicted affinity
    (`camutils.py:287-327` `propagte_ref_cam_with_bkg`): ref^2, column-normalised
    (+ 1e-1), per-image valid-class softmax of [bkg; cams], then (C, N) @ (N, N).
    cams (B, C_fg, h, w) at the affinity resolution; ref (B, N, N), N = h * w.
    Returns (B, C_fg + 1, h, w)."""
    B, Cf, h, w = cams.shape
    cwb = torch.cat([cams.new_full((B, 1, h, w), bkg_score), cams], dim=1)
    valid = (torch.cat([cls_labels.new_ones((B, 1)), cls_labels], dim=1) > 0)[:, :, None]
    ref = _column_normalized_sq(ref.float(), mask, 1e-1)
    logits = cwb.reshape(B, Cf + 1, h * w).masked_fill(~valid, torch.finfo(cams.dtype).min)
    rw = torch.softmax(logits, dim=1).float() @ ref
    return rw.masked_fill(~valid, 0.0).reshape(B, Cf + 1, h, w)


def get_mask_by_radius(h: int, w: int, radius: int = 8) -> np.ndarray:
    """Pairwise radius mask over the h * w token grid (`dist_train_voc.py:160-178`),
    vectorised."""
    ys, xs = np.mgrid[0:h, 0:w]
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    m = (np.abs(ys[:, None] - ys[None, :]) <= radius) & \
        (np.abs(xs[:, None] - xs[None, :]) <= radius)
    return m.astype(np.float32)


def propagate_ref_cam(cams: torch.Tensor, ref: torch.Tensor,
                      mask: torch.Tensor | None = None):
    """Random-walk propagation WITHOUT the background channel
    (`camutils.py:259-285` `propagte_ref_cam`): ref^2, column-normalised (+ 1e-4),
    full-channel matmul. cams (B, C, h, w); ref (B, N, N)."""
    B, C, h, w = cams.shape
    ref = _column_normalized_sq(ref.float(), mask, 1e-4)
    return (cams.reshape(B, C, h * w).float() @ ref).reshape(B, C, h, w)


def cams_to_label_resized(cam_label: torch.Tensor, mask: torch.Tensor | None = None,
                          ignore_index: int = 255, size=(400, 400)):
    """`cams_to_label` (`camutils.py:330-351`): nearest-resize the label map to a
    fixed grid, optionally masking positions to ignore."""
    lab = resize_nearest(cam_label, size).long()
    if mask is not None:
        lab = lab.masked_fill(mask[None] == 0, ignore_index)
    return lab


def cam_to_fg_bg_label(images_norm: torch.Tensor, cams: torch.Tensor, cls_label: torch.Tensor,
                       bg_thre: float = 0.3, fg_thre: float = 0.6,
                       mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375),
                       crf_method: str = "grid") -> torch.Tensor:
    """CRF-refined confident fg / bg labels (`camutils.py:39-83`): per image, the
    present classes' CAMs (resized to the image) padded with a low (``bg_thre``)
    and a high (``fg_thre``) background plane, each argmax refined by
    ``crf_inference_label``; the high pass's classes, with 1 where it says
    background and 0 where both passes do. images_norm (B, 3, H, W), cams (B, C_fg,
    h, w), cls_label (B, C_fg) -> (B, H, W) f32. A host loop over the images, as
    in the JAX package; the CRF runs on the inputs' device."""
    B, _, H, W = images_norm.shape
    dev = images_norm.device
    m = torch.tensor(mean, dtype=torch.float32, device=dev)[:, None, None]
    s = torch.tensor(std, dtype=torch.float32, device=dev)[:, None, None]
    imgs = images_norm.float() * s + m
    cams = resize_bilinear(cams.float(), (H, W), align_corners=False)
    out = torch.ones((B, H, W), dtype=torch.float32, device=dev)
    for i in range(B):
        keys = torch.cat([torch.ones(1, device=dev), cls_label[i].float()]).nonzero()[:, 0]
        valid = cams[i][keys[1:] - 1]
        passes = []
        for thre in (bg_thre, fg_thre):
            padded = torch.cat([torch.full((1, H, W), thre, device=dev), valid])
            lab = crf_inference_label(imgs[i], padded.argmax(0), n_labels=max(len(keys), 2),
                                      method=crf_method)
            passes.append(keys[lab])
        lt_m, ht_m = passes
        o = ht_m.float()
        o[ht_m == 0] = 1.0
        o[(ht_m + lt_m) == 0] = 0.0
        out[i] = o
    return out
