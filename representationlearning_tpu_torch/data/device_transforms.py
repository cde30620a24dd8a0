"""The on-device augmentation chains, the port of
``representationlearning_tpu/data/device_transforms.py``: the classification chain
(`VOC12ClsDataset.__getitem__`: scale jitter, horizontal flip, pad and random crop,
normalise), the segmentation chain (`VOC12SegDataset.__getitem__`: flip, the
photometric distortion, the crop with the ``cat_max_ratio`` retry, normalise) and
the LoveDA chain (`data/loveda.py::LoveDADataset`'s train transforms: random crop,
OneOf flip / flip / rot90, ShiftScaleRotate, normalise). Each spatial step is an
inverse-warp gather on the tensors' device over the whole batch (the scaled and
padded canvas is never made). Images are NCHW.

Randomness is split from the math: ``sample_*_decisions`` draw every random number
from an explicit ``torch.Generator``; the ``augment_*_batch`` functions are
deterministic given the decisions, so the same decisions give the JAX package's
result. The JAX chains ``vmap`` a per-sample function; here every step takes the
batch at once.

Input contract: raw uint8 images placed top-left on a static (B, 3, S, S) canvas
(``pad_to_canvas``) with the true sizes in ``hw`` (B, 2), labels on a (B, S, S)
canvas filled with the ignore index. Taps are clipped to [0, h - 1] x [0, w - 1],
so the canvas padding is never read.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..parallel import collectives as C

# `data/transforms.py` of the JAX package
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


class DeviceAugConfig(NamedTuple):
    """Knobs mirroring `VOC12ClsDataset` / `VOC12SegDataset` construction: the JAX
    package's fields, in its order, with its defaults. The classification chain
    reads `crop_size`, `scale_range`, `crop_tries` and `mean_rgb`; it draws the
    flip whatever `fliplr` says, as the JAX chain does. The segmentation chain reads
    `crop_size`, `cat_max_ratio`, `crop_tries`, `num_classes`, `ignore_index` and
    the photometric ranges; it applies the distortion its decisions switch on,
    whatever `photometric` says, as the JAX chain does."""

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


def pad_to_canvas(images, size: int, labels=None, ignore_index: int = 255):
    """Host collation: place variable-size (h, w, 3) uint8 images top-left on a
    static canvas, cut to it. Returns (images (B, 3, S, S) uint8, hw (B, 2) int32),
    and with ``labels`` (each (h, w)) also labels (B, S, S) int32 filled with
    ``ignore_index``."""
    out = np.zeros((len(images), 3, size, size), np.uint8)
    hw = np.zeros((len(images), 2), np.int32)
    lab = None if labels is None else np.full((len(images), size, size), ignore_index, np.int32)
    for b, img in enumerate(images):
        h, w = min(img.shape[0], size), min(img.shape[1], size)
        out[b, :, :h, :w] = img[:h, :w].transpose(2, 0, 1)
        hw[b] = (h, w)
        if lab is not None:
            lab[b, :h, :w] = labels[b][:h, :w]
    if lab is None:
        return torch.from_numpy(out), torch.from_numpy(hw)
    return torch.from_numpy(out), torch.from_numpy(hw), torch.from_numpy(lab)


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


def sample_seg_decisions(batch: int, cfg: DeviceAugConfig,
                         generator: torch.Generator | None = None,
                         device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """The draws of the segmentation chain (flip, pad and crop placement, then the
    photometric gates and factors in the host's order), from ``generator`` (a CPU
    one), moved to ``device``; the JAX draws' ranges (``hue_delta`` an integer in
    [-hue_delta, hue_delta), as a float)."""
    d = sample_cls_decisions(batch, cfg._replace(scale_range=None), generator)

    def u(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand((batch,), generator=generator)

    d.update({
        "bright_on": u() < 0.5,
        "bright_delta": u(-cfg.brightness_delta, cfg.brightness_delta),
        "mode": (u() < 0.5).int(),
        "contrast_on": u() < 0.5,
        "contrast_alpha": u(*cfg.contrast_range),
        "sat_on": u() < 0.5,
        "sat_alpha": u(*cfg.saturation_range),
        "hue_on": u() < 0.5,
        "hue_delta": torch.randint(-cfg.hue_delta, cfg.hue_delta, (batch,),
                                   generator=generator).float(),
    })
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


def _label_windows(label, h, w, sh, sw, pad, offs, flip, crop, fill):
    """The nearest warp of integer labels (B, S, S) into K windows a sample: offs
    (B, K, 2) crop offsets, the rest per sample as in ``_warp_one``. Returns
    (B, K, crop, crop) in label's dtype, ``fill`` outside the image."""
    B, K = offs.shape[:2]

    def rep(t):
        return t.repeat_interleave(K, 0)

    i = torch.arange(crop, device=label.device)
    ys, ym = _axis_coords(i, offs[..., 0].reshape(-1), rep(pad[:, 0]), rep(sh), rep(h),
                          torch.zeros(B * K, dtype=torch.bool, device=label.device))
    xs, xm = _axis_coords(i, offs[..., 1].reshape(-1), rep(pad[:, 1]), rep(sw), rep(w),
                          rep(flip))
    b = rep(torch.arange(B, device=label.device))
    win = label[b[:, None, None], ys.round().long()[:, :, None], xs.round().long()[:, None, :]]
    win = torch.where(ym[:, :, None] & xm[:, None, :], win, torch.full_like(win, fill))
    return win.view(B, K, crop, crop)


def _pick_crop_try(label, h, w, sh, sw, pad, offs, flip, cfg: DeviceAugConfig):
    """The ``cat_max_ratio`` retry (`transforms.py:117-127`) for each sample: the
    first of the K tries whose window holds more than one class and no class on
    ``cat_max_ratio`` of its counted pixels or more, else the LAST try. Every try
    is scored (the host stops at the first that passes, which selects the same
    one); the flip is folded into each window as in the final crop. label (B, S,
    S), offs (B, K, 2); returns the chosen offsets (B, 2)."""
    K = offs.shape[1]
    win = _label_windows(label, h, w, sh, sw, pad, offs, flip, cfg.crop_size, cfg.ignore_index)
    counts = torch.stack([(win == c).sum((2, 3)) for c in range(cfg.num_classes)], -1)
    ok = ((counts > 0).sum(-1) > 1) & (counts.amax(-1) < cfg.cat_max_ratio * counts.sum(-1))
    tries = torch.arange(K, device=offs.device)
    first = torch.where(ok, tries, K).amin(1)
    idx = torch.where(first < K, first, K - 1)
    return offs[torch.arange(offs.shape[0], device=offs.device), idx]


def _rgb_to_hsv_cv_j(img: torch.Tensor) -> torch.Tensor:
    """OpenCV's RGB -> HSV of float pixels in [0, 255] (B, 3, H, W): H in [0, 180),
    S and V in [0, 255]."""
    arr = img / 255.0
    r, g, b = arr.unbind(1)
    maxc, minc = arr.amax(1), arr.amin(1)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-12), 0.0)
    rc, gc, bc = (torch.where(delta > 0, (maxc - c) / delta.clamp(min=1e-12), 0.0)
                  for c in (r, g, b))
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    return torch.stack([h * 180.0, s * 255.0, maxc * 255.0], 1)


def _hsv_to_rgb_cv_j(hsv: torch.Tensor) -> torch.Tensor:
    """The inverse, truncated to uint8 values as the host's conversion back is."""
    h = (hsv[:, 0] / 180.0) % 1.0
    s = (hsv[:, 1] / 255.0).clamp(0, 1)
    v = (hsv[:, 2] / 255.0).clamp(0, 1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    sector = (i.long() % 6)[None]

    def pick(*c):
        return torch.stack(c).gather(0, sector)[0]

    rgb = torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                       pick(p, p, t, v, v, q)], 1)
    return torch.floor(rgb * 255.0)


def _quant(x: torch.Tensor) -> torch.Tensor:
    """The host's ``_convert``: clip to [0, 255], then uint8 truncation."""
    return torch.floor(x.clamp(0.0, 255.0))


def photometric_distort(img: torch.Tensor, d: dict) -> torch.Tensor:
    """`PhotoMetricDistortion.__call__` on a batch: img (B, 3, H, W) f32 holding
    uint8 values, d the segmentation decisions (each (B,)). Brightness, contrast
    first (mode 1), saturation and hue through HSV, contrast last (mode 0), each
    where its gate is on, each quantised to uint8 values as the host's is."""
    def per(k):
        return d[k].view(-1, 1, 1, 1)

    def contrast(x):
        return _quant(x * per("contrast_alpha"))

    img = torch.floor(img.clamp(0.0, 255.0))   # host: astype(np.uint8)
    img = torch.where(per("bright_on"), _quant(img + per("bright_delta")), img)
    img = torch.where(per("contrast_on") & (per("mode") == 1), contrast(img), img)
    hsv = _rgb_to_hsv_cv_j(img)
    sat = torch.where(per("sat_on")[:, 0], (hsv[:, 1] * per("sat_alpha")[:, 0]).clamp(0, 255),
                      hsv[:, 1])
    hsv = torch.stack([hsv[:, 0], sat, hsv[:, 2]], 1)
    img = torch.where(per("sat_on"), _hsv_to_rgb_cv_j(hsv), img)
    hsv = _rgb_to_hsv_cv_j(img)
    hue = torch.where(per("hue_on")[:, 0], (hsv[:, 0] + per("hue_delta")[:, 0]) % 180.0,
                      hsv[:, 0])
    hsv = torch.stack([hue, hsv[:, 1], hsv[:, 2]], 1)
    img = torch.where(per("hue_on"), _hsv_to_rgb_cv_j(hsv), img)
    return torch.where(per("contrast_on") & (per("mode") == 0), contrast(img), img)


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


def augment_seg_batch(images: torch.Tensor, hw: torch.Tensor, labels: torch.Tensor,
                      decisions: dict, cfg: DeviceAugConfig):
    """The segmentation chain: flip -> photometric distortion -> crop with the
    ``cat_max_ratio`` retry (IMAGENET_MEAN fill, ``ignore_index`` labels) ->
    normalise. images (B, 3, S, S) uint8, hw (B, 2), labels (B, S, S) integer,
    decisions from ``sample_seg_decisions``, all on one device. Returns (images
    (B, 3, crop, crop) f32 normalised, labels (B, crop, crop) int32, img_box (B, 4)
    int32)."""
    crop, B = cfg.crop_size, images.shape[0]
    h, w, flip = hw[:, 0], hw[:, 1], decisions["flip"]
    sh, sw, pad, offs = _geometry(hw, torch.ones(B, device=images.device), decisions["pad_u"],
                                  decisions["crop_u"], crop)
    img = photometric_distort(images.float(), decisions)
    off = (_pick_crop_try(labels, h, w, sh, sw, pad, offs, flip, cfg) if cfg.cat_max_ratio
           else offs[:, 0])
    out = _warp_one(img, h, w, sh, sw, pad, off, flip, crop, IMAGENET_MEAN, nearest=False)
    lab = _label_windows(labels, h, w, sh, sw, pad, off[:, None], flip, crop, cfg.ignore_index)
    return normalize_img_j(out), lab[:, 0].int(), _img_box(pad, off, sh, sw, crop)


def augment_raw_batch(batch: dict, cfg: DeviceAugConfig,
                      generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """A train step's raw batch dict(raw (B, 3, S, S) uint8, hw (B, 2), cls_label)
    on its device as the batch the losses take, dict(image, img_box, cls_label):
    the decisions drawn from ``generator`` (a CPU one), then the chain. Under a
    data group (``parallel/collectives.py``) the decisions of the global batch are
    drawn and this rank takes its rows."""
    raw = batch["raw"]
    total, rows = C.global_rows(raw.shape[0])
    dec = {k: v[rows] for k, v in sample_cls_decisions(total, cfg, generator, raw.device).items()}
    image, box = augment_cls_batch(raw, batch["hw"], dec, cfg)
    return {"image": image, "img_box": box, "cls_label": batch["cls_label"]}


class LoveDAAugConfig(NamedTuple):
    """`data/loveda.py::LoveDADataset`'s train chain on the device: random crop ->
    OneOf{hflip, vflip, rot90} p = .75 -> ShiftScaleRotate p = .2 -> normalise."""

    crop_size: int = 512
    flip_rot_p: float = 0.75
    affine_p: float = 0.2
    rotate_limit: float = 45.0
    scale_limit: float = 0.2
    shift_limit: float = 0.0625
    cat_max_ratio: float = 0.75
    crop_tries: int = 10
    num_classes: int = 7
    ignore_index: int = -1


def sample_loveda_decisions(batch: int, cfg: LoveDAAugConfig,
                            generator: torch.Generator | None = None,
                            device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """The nine draws of the LoveDA chain, the JAX draws' ranges, from
    ``generator`` (a CPU one), moved to ``device``: pad and crop placement, the
    OneOf gate, its op (0 fliplr, 1 flipud, 2 rot90) and k in [1, 4), the
    ShiftScaleRotate gate, angle, scale and (x, y) shift."""
    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=generator)

    d = {"pad_u": u(batch, 2), "crop_u": u(batch, cfg.crop_tries, 2),
         "fr_on": u(batch) < cfg.flip_rot_p,
         "op": torch.randint(0, 3, (batch,), generator=generator, dtype=torch.int32),
         "rot_k": torch.randint(1, 4, (batch,), generator=generator, dtype=torch.int32),
         "ssr_on": u(batch) < cfg.affine_p,
         "angle": u(batch, lo=-cfg.rotate_limit, hi=cfg.rotate_limit),
         "ssr_scale": 1.0 + u(batch, lo=-cfg.scale_limit, hi=cfg.scale_limit),
         "shift": u(batch, 2, lo=-cfg.shift_limit, hi=cfg.shift_limit)}
    return {k: v.to(device) for k, v in d.items()}


def _reflect101(i: torch.Tensor, n: int) -> torch.Tensor:
    """BORDER_REFLECT_101's index fold (cv2: ...cba|abcd|cba...)."""
    if n == 1:
        return torch.zeros_like(i)
    p = 2 * n - 2
    m = torch.remainder(i, p)
    return torch.where(m < n, m, p - m)


def _affine_source_coords(H: int, W: int, angle, scale, shift):
    """The source coordinates (sx, sy), each (B, H, W) f32, that
    ``cv2.warpAffine(getRotationMatrix2D((W/2, H/2), angle, scale) + shift)`` reads
    for every output pixel: the analytic inverse of the forward matrix, as cv2
    inverts it. angle (degrees), scale (B,), shift (B, 2) as (x, y) shares of the
    side."""
    rad = angle * (math.pi / 180.0)
    a, b = scale * torch.cos(rad), scale * torch.sin(rad)
    cx, cy = W / 2.0, H / 2.0
    tx = (1.0 - a) * cx - b * cy + shift[:, 0] * W
    ty = b * cx + (1.0 - a) * cy + shift[:, 1] * H
    det = a * a + b * b
    ia, ib = (a / det)[:, None, None], (b / det)[:, None, None]  # inv([[a, b], [-b, a]])
    x = torch.arange(W, dtype=torch.float32, device=rad.device)[None, None, :] - tx[:, None, None]
    y = torch.arange(H, dtype=torch.float32, device=rad.device)[None, :, None] - ty[:, None, None]
    return ia * x - ib * y, ib * x + ia * y


def _affine_reflect_warp(img: torch.Tensor, angle, scale, shift, nearest: bool) -> torch.Tensor:
    """``cv2.warpAffine(..., BORDER_REFLECT_101)`` of (B, C, H, W) per sample:
    bilinear taps, or with ``nearest`` the tap at floor(s + 0.5)."""
    B, C, H, W = img.shape
    sx, sy = _affine_source_coords(H, W, angle, scale, shift)
    flat = img.reshape(B, C, H * W)

    def tap(yy, xx):
        idx = (_reflect101(yy, H) * W + _reflect101(xx, W)).reshape(B, 1, H * W)
        return flat.gather(2, idx.expand(B, C, H * W)).view(B, C, H, W)

    if nearest:
        return tap(torch.floor(sy + 0.5).long(), torch.floor(sx + 0.5).long())
    x0, y0 = torch.floor(sx).long(), torch.floor(sy).long()
    wx, wy = (sx - x0)[:, None], (sy - y0)[:, None]
    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _one_of_flip_rot(img: torch.Tensor, mask: torch.Tensor, on, op, k):
    """OneOf{fliplr, flipud, rot90(k)} on square (B, C, n, n) crops, per sample:
    op 0 flips the columns, 1 the rows, 2 rotates by k quarter turns as
    ``np.rot90`` does; nothing where ``on`` is false."""
    idx = torch.where(op < 2, op, 2 + (k - 1)).long()
    batch = torch.arange(img.shape[0], device=img.device)

    def sel(x):
        cands = torch.stack([x.flip(3), x.flip(2)] + [torch.rot90(x, r, (2, 3))
                                                       for r in (1, 2, 3)])
        return torch.where(on.view(-1, 1, 1, 1), cands[idx, batch], x)

    return sel(img), sel(mask)


def augment_loveda_batch(images: torch.Tensor, hw: torch.Tensor, masks: torch.Tensor,
                         decisions: dict, cfg: LoveDAAugConfig):
    """The LoveDA train chain: crop with the ``cat_max_ratio`` retry (0 fill,
    ``ignore_index`` masks) -> OneOf flip / rot90 -> ShiftScaleRotate -> normalise.
    images (B, 3, S, S) uint8, hw (B, 2), masks (B, S, S) integer filled with
    ``ignore_index``, decisions from ``sample_loveda_decisions``, all on one device.
    Returns (images (B, 3, crop, crop) f32 normalised, masks (B, crop, crop) int32)."""
    crop, B = cfg.crop_size, images.shape[0]
    h, w = hw[:, 0], hw[:, 1]
    sh, sw, pad, offs = _geometry(hw, torch.ones(B, device=images.device), decisions["pad_u"],
                                  decisions["crop_u"], crop)
    crop_cfg = DeviceAugConfig(crop_size=crop, num_classes=cfg.num_classes,
                               ignore_index=cfg.ignore_index, cat_max_ratio=cfg.cat_max_ratio,
                               crop_tries=cfg.crop_tries)
    noflip = torch.zeros(B, dtype=torch.bool, device=images.device)
    off = _pick_crop_try(masks, h, w, sh, sw, pad, offs, noflip, crop_cfg)
    ic = _warp_one(images.float(), h, w, sh, sw, pad, off, noflip, crop, (0.0, 0.0, 0.0),
                   nearest=False)
    mc = _label_windows(masks, h, w, sh, sw, pad, off[:, None], noflip, crop,
                        cfg.ignore_index).float()                     # (B, 1, crop, crop)
    ic, mc = _one_of_flip_rot(ic, mc, decisions["fr_on"], decisions["op"], decisions["rot_k"])
    ssr = decisions["ssr_on"].view(-1, 1, 1, 1)
    args = (decisions["angle"], decisions["ssr_scale"], decisions["shift"])
    ic = torch.where(ssr, _affine_reflect_warp(ic, *args, nearest=False), ic)
    mc = torch.where(ssr, _affine_reflect_warp(mc, *args, nearest=True), mc)
    return normalize_img_j(ic), mc[:, 0].int()
