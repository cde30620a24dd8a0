"""Host-side augmentation chain, the port's copy of
``representationlearning_tpu/data/transforms.py``: the reference's semantics with
explicit RNG, on numpy arrays.

Reference: `SCD-AAAI2023/datasets/transforms.py` (shared by RML). Behaviors preserved:
- normalize with mean [123.675,116.28,103.53] / std [58.395,57.12,57.375] (`:8-15`)
- random scaling in a ratio range, PIL bilinear for image / nearest for label (`:17-42`)
- short-side resize (`:44-56`), random resize to a max-side range (`:58-64`)
- lr/ud flips at p=0.5, rot90 k in {1,2,3} (`:66-107`)
- random crop with zero/mean padding, 10-try cat_max_ratio 0.75 retry, and the `img_box`
  valid-region tracker the trainer uses to mask losses (`:110-167`)
- PhotoMetricDistortion: brightness/contrast/saturation/hue in HSV (`:169-265`)

All functions take an explicit `rng: np.random.Generator` (JAX-style key discipline on
the host side) instead of the reference's impure global `random`/`np.random`.

Pillow (the rescale) and OpenCV (`shift_scale_rotate`) are imported where they are
used, so that importing this module needs neither.
"""
from __future__ import annotations

import numpy as np

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def normalize_img(img: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    arr = np.asarray(img, dtype=np.float32)
    out = np.empty_like(arr)
    for c in range(3):
        out[..., c] = (arr[..., c] - mean[c]) / std[c]
    return out


def denormalize_img(img: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    arr = np.asarray(img, dtype=np.float32)
    out = np.empty_like(arr)
    for c in range(3):
        out[..., c] = arr[..., c] * std[c] + mean[c]
    return out


def _rescale(image: np.ndarray, label: np.ndarray | None, scale: float):
    from PIL import Image

    h, w = image.shape[:2]
    new_wh = (int(scale * w), int(scale * h))
    new_image = np.asarray(
        Image.fromarray(image.astype(np.uint8)).resize(new_wh, resample=Image.BILINEAR)
    ).astype(np.float32)
    if label is None:
        return new_image
    new_label = np.asarray(Image.fromarray(label).resize(new_wh, resample=Image.NEAREST))
    return new_image, new_label


def random_scaling(rng: np.random.Generator, image, label=None, scale_range=(0.5, 2.0)):
    ratio = rng.uniform(scale_range[0], scale_range[1])
    return _rescale(image, label, ratio)


def img_resize_short(image: np.ndarray, min_size: int = 512) -> np.ndarray:
    h, w = image.shape[:2]
    if min(h, w) >= min_size:
        return image
    return _rescale(image, None, float(min_size) / min(h, w))


def random_fliplr(rng: np.random.Generator, image, label=None):
    if rng.random() > 0.5:
        image = np.fliplr(image)
        if label is not None:
            label = np.fliplr(label)
    return image if label is None else (image, label)


def random_flipud(rng: np.random.Generator, image, label=None):
    if rng.random() > 0.5:
        image = np.flipud(image)
        if label is not None:
            label = np.flipud(label)
    return image if label is None else (image, label)


def random_rot90(rng: np.random.Generator, image, label=None):
    k = int(rng.integers(1, 4))
    image = np.rot90(image, k).copy()
    if label is None:
        return image
    return image, np.rot90(label, k).copy()


def random_crop(
    rng: np.random.Generator,
    image: np.ndarray,
    label: np.ndarray | None = None,
    crop_size: int = 512,
    mean_rgb=(0.0, 0.0, 0.0),
    ignore_index: int = 255,
    cat_max_ratio: float = 0.75,
):
    """Pad-to-crop then random window, retrying up to 10 times until no single class
    (excluding ignore) dominates more than `cat_max_ratio` of the window. Returns
    (image, [label,] img_box) where img_box = [h0, h1, w0, w1] marks the region of the
    crop covered by real image pixels (the trainer masks losses outside it)."""
    h, w = image.shape[:2]
    H, W = max(crop_size, h), max(crop_size, w)

    pad_image = np.empty((H, W, 3), dtype=np.float32)
    pad_image[..., 0] = mean_rgb[0]
    pad_image[..., 1] = mean_rgb[1]
    pad_image[..., 2] = mean_rgb[2]
    H_pad = int(rng.integers(0, H - h + 1))
    W_pad = int(rng.integers(0, W - w + 1))
    pad_image[H_pad : H_pad + h, W_pad : W_pad + w] = image

    pad_label = None
    if label is not None:
        pad_label = np.full((H, W), ignore_index, dtype=np.float32)
        pad_label[H_pad : H_pad + h, W_pad : W_pad + w] = label

    H_start = W_start = 0
    for _ in range(10):
        H_start = int(rng.integers(0, H - crop_size + 1))
        W_start = int(rng.integers(0, W - crop_size + 1))
        if pad_label is None:
            break
        window = pad_label[H_start : H_start + crop_size, W_start : W_start + crop_size]
        index, cnt = np.unique(window, return_counts=True)
        cnt = cnt[index != ignore_index]
        if len(cnt) > 1 and np.max(cnt) / np.sum(cnt) < cat_max_ratio:
            break
    H_end, W_end = H_start + crop_size, W_start + crop_size

    crop = pad_image[H_start:H_end, W_start:W_end]
    img_box = np.asarray(
        [
            max(H_pad - H_start, 0),
            min(H_end, H_pad + h) - H_start,
            max(W_pad - W_start, 0),
            min(W_end, W_pad + w) - W_start,
        ],
        dtype=np.int32,
    )
    # Note: the reference stores absolute H_end/min(...) without subtracting H_start for
    # the end coordinates (`transforms.py:152-155`) but then indexes the *crop* with
    # them; since H_start/W_start are re-randomized within the pad the training loop only
    # works because crops equal the pad size in the common (img <= crop) case. We store
    # crop-relative coordinates, which is the intended semantics.
    if label is None:
        return crop, img_box
    crop_label = pad_label[H_start:H_end, W_start:W_end]
    return crop, crop_label, img_box


# --------------------------------------------------------------------------- HSV utils
def _rgb_to_hsv_cv(img: np.ndarray) -> np.ndarray:
    """OpenCV-convention HSV for uint8 RGB input: H in [0,180), S,V in [0,255]."""
    arr = img.astype(np.float32) / 255.0
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    maxc = np.max(arr, axis=-1)
    minc = np.min(arr, axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        rc = np.where(delta > 0, (maxc - r) / np.maximum(delta, 1e-12), 0.0)
        gc = np.where(delta > 0, (maxc - g) / np.maximum(delta, 1e-12), 0.0)
        bc = np.where(delta > 0, (maxc - b) / np.maximum(delta, 1e-12), 0.0)
    h = np.where(maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    return np.stack([h * 180.0, s * 255.0, v * 255.0], axis=-1).astype(np.float32)


def _hsv_to_rgb_cv(hsv: np.ndarray) -> np.ndarray:
    h = (hsv[..., 0] / 180.0) % 1.0
    s = np.clip(hsv[..., 1] / 255.0, 0, 1)
    v = np.clip(hsv[..., 2] / 255.0, 0, 1)
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(int) % 6
    conds = [i == k for k in range(6)]
    r = np.select(conds, [v, q, p, p, t, v])
    g = np.select(conds, [t, v, v, q, p, p])
    b = np.select(conds, [p, p, t, v, v, q])
    return (np.stack([r, g, b], axis=-1) * 255.0).astype(np.uint8)


class PhotoMetricDistortion:
    """mmseg-style photometric distortion (`transforms.py:169-265`): random brightness,
    contrast (before or after color ops), saturation, hue — each applied with p=0.5."""

    def __init__(
        self,
        brightness_delta: float = 32,
        contrast_range=(0.5, 1.5),
        saturation_range=(0.5, 1.5),
        hue_delta: int = 18,
    ):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta

    @staticmethod
    def _convert(img, alpha=1.0, beta=0.0):
        return np.clip(img.astype(np.float32) * alpha + beta, 0, 255).astype(np.uint8)

    def __call__(self, rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
        img = np.asarray(img, dtype=np.uint8)
        if rng.integers(2):
            img = self._convert(img, beta=rng.uniform(-self.brightness_delta, self.brightness_delta))
        mode = int(rng.integers(2))
        if mode == 1 and rng.integers(2):
            img = self._convert(img, alpha=rng.uniform(self.contrast_lower, self.contrast_upper))
        if rng.integers(2):
            hsv = _rgb_to_hsv_cv(img)
            hsv[..., 1] = np.clip(
                hsv[..., 1] * rng.uniform(self.saturation_lower, self.saturation_upper), 0, 255
            )
            img = _hsv_to_rgb_cv(hsv)
        if rng.integers(2):
            hsv = _rgb_to_hsv_cv(img)
            hsv[..., 0] = (hsv[..., 0] + rng.integers(-self.hue_delta, self.hue_delta)) % 180
            img = _hsv_to_rgb_cv(hsv)
        if mode == 0 and rng.integers(2):
            img = self._convert(img, alpha=rng.uniform(self.contrast_lower, self.contrast_upper))
        return img


def shift_scale_rotate(
    rng: np.random.Generator,
    image: np.ndarray,
    mask: np.ndarray | None = None,
    shift_limit: float = 0.0625,
    scale_limit: float = 0.2,
    rotate_limit: float = 45.0,
):
    """albumentations.ShiftScaleRotate with its exact cv2 semantics
    (`RSSFormer-TIP2023/configs/base/loveda.py:30`): ONE affine warp combining
    rotation about the image center (cv2.getRotationMatrix2D at (w/2, h/2)),
    isotropic scale in [1-s, 1+s] and shift in [-d, +d] of the side length;
    BORDER_REFLECT_101, INTER_LINEAR for the image and INTER_NEAREST for the
    mask (so labels never blend). Replaces the round-2 approximation
    (scale-jitter + re-crop) that had no rotation and crop-style borders."""
    import cv2

    angle = float(rng.uniform(-rotate_limit, rotate_limit))
    scale = 1.0 + float(rng.uniform(-scale_limit, scale_limit))
    dx = float(rng.uniform(-shift_limit, shift_limit))
    dy = float(rng.uniform(-shift_limit, shift_limit))
    h, w = image.shape[:2]
    M = cv2.getRotationMatrix2D((w / 2, h / 2), angle, scale)
    M[0, 2] += dx * w
    M[1, 2] += dy * h
    out = cv2.warpAffine(image.astype(np.float32), M, (w, h),
                         flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REFLECT_101)
    if mask is None:
        return out
    m32 = mask.astype(np.float32)
    new_mask = cv2.warpAffine(m32, M, (w, h), flags=cv2.INTER_NEAREST,
                              borderMode=cv2.BORDER_REFLECT_101)
    return out, new_mask.astype(mask.dtype)
