"""The classification half of the on-device augmentation chain, the port of
``representationlearning_tpu/data/device_transforms.py`` (`VOC12ClsDataset.__getitem__`):
scale jitter, horizontal flip, pad and random crop, normalise, as ONE inverse-warp
gather per batch on the tensors' device (the scaled and padded canvas is never
made). Tensors are NCHW.

Randomness is split from the math: ``sample_cls_decisions`` draws every random
number from an explicit ``torch.Generator``; ``augment_cls_batch`` is
deterministic given the decisions, so the same decisions give the JAX package's
result. The flip is always drawn (p = 0.5), as in the JAX chain.

Input contract: raw uint8 images placed top-left on a static (B, 3, S, S) canvas
(``pad_to_canvas``) with the true sizes in ``hw`` (B, 2). Taps are clipped to
[0, h - 1] x [0, w - 1], so the canvas padding is never read.

The segmentation and LoveDA halves and the photometric distortion are not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# `data/transforms.py` of the JAX package
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


class DeviceAugConfig(NamedTuple):
    """Knobs mirroring `VOC12ClsDataset` / `VOC12SegDataset` construction: the JAX
    package's fields, in its order, with its defaults. The classification chain
    reads `crop_size`, `scale_range`, `crop_tries` and `mean_rgb`; it draws the
    flip whatever `fliplr` says, as the JAX chain does. The other fields belong to
    the segmentation half and the photometric distortion, which are not ported."""

    crop_size: int = 320
    scale_range: tuple[float, float] | None = (0.5, 2.0)
    fliplr: bool = True
    photometric: bool = False
    cat_max_ratio: float = 0.75
    crop_tries: int = 10
    num_classes: int = 21
    ignore_index: int = 255
    mean_rgb: tuple[float, float, float] = (0.0, 0.0, 0.0)   # the crop's fill
    # photometric parameters (`transforms.py::PhotoMetricDistortion`)
    brightness_delta: float = 32.0
    contrast_range: tuple[float, float] = (0.5, 1.5)
    saturation_range: tuple[float, float] = (0.5, 1.5)
    hue_delta: int = 18


def pad_to_canvas(images, size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Host collation: place variable-size (h, w, 3) uint8 images top-left on a
    static canvas. Returns (images (B, 3, S, S) uint8, hw (B, 2) int32)."""
    out = np.zeros((len(images), 3, size, size), np.uint8)
    hw = np.zeros((len(images), 2), np.int32)
    for b, img in enumerate(images):
        h, w = min(img.shape[0], size), min(img.shape[1], size)
        out[b, :, :h, :w] = img[:h, :w].transpose(2, 0, 1)
        hw[b] = (h, w)
    return torch.from_numpy(out), torch.from_numpy(hw)


def sample_cls_decisions(batch: int, cfg: DeviceAugConfig,
                         generator: torch.Generator | None = None,
                         device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """The draws of the classification chain (scale, flip, pad and crop placement)
    as raw uniforms, from ``generator`` (a CPU one), moved to ``device``. Integer
    offsets are floor(u * choices) inside ``augment_cls_batch``."""
    lo, hi = cfg.scale_range if cfg.scale_range else (1.0, 1.0)
    d = {"scale": lo + (hi - lo) * torch.rand((batch,), generator=generator),
         "flip": torch.rand((batch,), generator=generator) > 0.5,
         "pad_u": torch.rand((batch, 2), generator=generator),
         "crop_u": torch.rand((batch, cfg.crop_tries, 2), generator=generator)}
    return {k: v.to(device) for k, v in d.items()}


def _axis_coords(i, off, pad, scaled, true, flip):
    """Crop-axis indices i (crop,) -> source coordinates through pad and scale (and
    flip), per sample: off, pad, scaled, true (B,), flip (B,) bool. Returns (src
    (B, crop) f32 clipped to [0, true - 1], in-image mask (B, crop))."""
    scaled_f, true_f = scaled.float()[:, None], true.float()[:, None]
    v = (off[:, None] + i[None]).float() - pad.float()[:, None]   # scaled-image coordinate
    mask = (v >= 0) & (v < scaled_f)
    v = torch.where(flip[:, None], scaled_f - 1.0 - v, v)
    src = (v + 0.5) * (true_f / scaled_f) - 0.5
    return torch.minimum(src.clamp(min=0.0), true_f - 1.0), mask


def _gather(img, idx, axis):
    """img (B, C, ...) indexed along `axis` (2 or 3) by idx (B, n) per sample."""
    shape = list(img.shape)
    shape[axis] = idx.shape[1]
    view = [idx.shape[0], 1, 1, 1]
    view[axis] = idx.shape[1]
    return img.gather(axis, idx.reshape(view).expand(shape))


def _warp_one(img, h, w, sh, sw, pad_hw, off_hw, flip, crop, fill, nearest):
    """Inverse-warp each sample of a batch (the JAX ``_warp_one`` over the batch):
    crop pixel -> source pixel. img (B, C, S, S) f32; h, w, sh, sw (B,); pad_hw,
    off_hw (B, 2); flip (B,). The scaled (sh, sw) image sits at pad_hw on a
    max(crop, s) canvas; the crop window starts at off_hw. Returns (B, C, crop,
    crop), ``fill`` (C,) outside the image."""
    i = torch.arange(crop, device=img.device)
    ys, ym = _axis_coords(i, off_hw[:, 0], pad_hw[:, 0], sh, h, torch.zeros_like(flip))
    xs, xm = _axis_coords(i, off_hw[:, 1], pad_hw[:, 1], sw, w, flip)
    if nearest:
        out = _gather(_gather(img, ys.round().long(), 2), xs.round().long(), 3)
    else:
        y0 = ys.floor().long()
        y1 = torch.minimum(y0 + 1, (h - 1).long()[:, None])
        wy = (ys - y0)[:, None, :, None]
        rows = _gather(img, y0, 2) * (1.0 - wy) + _gather(img, y1, 2) * wy   # (B, C, crop, S)
        x0 = xs.floor().long()
        x1 = torch.minimum(x0 + 1, (w - 1).long()[:, None])
        wx = (xs - x0)[:, None, None, :]
        out = _gather(rows, x0, 3) * (1.0 - wx) + _gather(rows, x1, 3) * wx
    m = (ym[:, :, None] & xm[:, None, :])[:, None]
    return torch.where(m, out, torch.as_tensor(fill, dtype=out.dtype,
                                               device=out.device)[None, :, None, None])


def _geometry(hw, scale, pad_u, crop_u, crop):
    """Per-sample integer geometry: scaled size, pad offset and the crop offsets of
    every try; floor(u * choices) matches the host's integers(0, choices)."""
    h, w = hw[..., 0], hw[..., 1]
    sh = torch.floor(scale * h).int().clamp(min=1)
    sw = torch.floor(scale * w).int().clamp(min=1)
    Hc, Wc = sh.clamp(min=crop), sw.clamp(min=crop)
    pad = torch.stack([torch.floor(pad_u[..., 0] * (Hc - sh + 1).float()),
                       torch.floor(pad_u[..., 1] * (Wc - sw + 1).float())], -1).int()
    offs = torch.stack([torch.floor(crop_u[..., 0] * (Hc - crop + 1)[..., None].float()),
                        torch.floor(crop_u[..., 1] * (Wc - crop + 1)[..., None].float())],
                       -1).int()   # (B, K, 2)
    return sh, sw, pad, offs


def _img_box(pad, off, sh, sw, crop):
    """Crop-relative valid region [h0, h1, w0, w1] per sample (`transforms.py:131-139`)."""
    return torch.stack([(pad[:, 0] - off[:, 0]).clamp(0, crop),
                        (pad[:, 0] + sh - off[:, 0]).clamp(0, crop),
                        (pad[:, 1] - off[:, 1]).clamp(0, crop),
                        (pad[:, 1] + sw - off[:, 1]).clamp(0, crop)], dim=1).int()


def normalize_img_j(img: torch.Tensor) -> torch.Tensor:
    """`transforms.py::normalize_img` of (B, 3, H, W)."""
    mean = img.new_tensor(IMAGENET_MEAN)[:, None, None]
    std = img.new_tensor(IMAGENET_STD)[:, None, None]
    return (img - mean) / std


def augment_cls_batch(images: torch.Tensor, hw: torch.Tensor, decisions: dict,
                      cfg: DeviceAugConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The classification chain: scale jitter -> flip -> pad and random crop
    (``mean_rgb`` fill) -> normalise. images (B, 3, S, S) uint8 and hw (B, 2) on
    one device, decisions from ``sample_cls_decisions`` there. Returns (images
    (B, 3, crop, crop) f32 normalised, img_box (B, 4) int32)."""
    crop = cfg.crop_size
    sh, sw, pad, offs = _geometry(hw, decisions["scale"], decisions["pad_u"],
                                  decisions["crop_u"], crop)
    off = offs[:, 0]   # the classification chain takes the first try
    out = _warp_one(images.float(), hw[:, 0], hw[:, 1], sh, sw, pad, off, decisions["flip"],
                    crop, cfg.mean_rgb, nearest=False)
    return normalize_img_j(out), _img_box(pad, off, sh, sw, crop)


def augment_raw_batch(batch: dict, cfg: DeviceAugConfig,
                      generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """A train step's raw batch dict(raw (B, 3, S, S) uint8, hw (B, 2), cls_label)
    on its device as the batch the losses take, dict(image, img_box, cls_label):
    the decisions drawn from ``generator`` (a CPU one), then the chain."""
    raw = batch["raw"]
    dec = sample_cls_decisions(raw.shape[0], cfg, generator, raw.device)
    image, box = augment_cls_batch(raw, batch["hw"], dec, cfg)
    return {"image": image, "img_box": box, "cls_label": batch["cls_label"]}
