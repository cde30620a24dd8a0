"""Visualization utilities, the port's copy of
``representationlearning_tpu/utils/visualize.py``. Parity with
`SCD-AAAI2023/utils/imutils.py` (VOC bit-twiddled colormap, CAM-jet overlays,
attention grids, label colormaps) and `RSSFormer-TIP2023/module/viz.py` (palette PNG
writer), matplotlib/torchvision-free. Pillow is imported only where a resize needs it;
the palette PNG is written with `zlib` (`utils/events.py`).
"""
from __future__ import annotations

import numpy as np

from ..data.transforms import denormalize_img
from .events import write_png_palette


def colormap(N: int = 256, normalized: bool = False) -> np.ndarray:
    """VOC bit-twiddle colormap (`imutils.py:113-130`)."""
    def bitget(v, idx):
        return (v & (1 << idx)) != 0

    cmap = np.zeros((N, 3), np.float32 if normalized else np.uint8)
    for i in range(N):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= bitget(c, 0) << (7 - j)
            g |= bitget(c, 1) << (7 - j)
            b |= bitget(c, 2) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap / 255.0 if normalized else cmap


def encode_cmap(label: np.ndarray) -> np.ndarray:
    """(H, W) int labels -> (H, W, 3) uint8 VOC colors (`imutils.py:7-9`)."""
    return colormap()[np.asarray(label).astype(np.int32) % 256]


_JET_STOPS = np.array([
    (0.0, (0, 0, 128)), (0.125, (0, 0, 255)), (0.375, (0, 255, 255)),
    (0.625, (255, 255, 0)), (0.875, (255, 0, 0)), (1.0, (128, 0, 0)),
], dtype=object)


def jet(v: np.ndarray) -> np.ndarray:
    """matplotlib-style 'jet' colormap for values in [0, 1] -> uint8 RGB."""
    v = np.clip(np.asarray(v, np.float32), 0.0, 1.0)
    xs = np.array([s[0] for s in _JET_STOPS], np.float32)
    cs = np.array([s[1] for s in _JET_STOPS], np.float32)
    out = np.empty(v.shape + (3,), np.float32)
    for ch in range(3):
        out[..., ch] = np.interp(v, xs, cs[:, ch])
    return out.astype(np.uint8)


def cam_overlay(images_norm: np.ndarray, cams: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """CAM heatmap overlay (`imutils.py:26-46` tensorboard_image): denormalize images,
    max over CAM channels, jet-colorize, alpha-blend. NHWC in, uint8 NHWC out."""
    imgs = denormalize_img(np.asarray(images_norm)).clip(0, 255).astype(np.uint8)
    cam_max = np.asarray(cams).max(axis=-1)
    heat = jet(cam_max)
    if heat.shape[1:3] != imgs.shape[1:3]:
        from PIL import Image

        heat = np.stack([
            np.asarray(Image.fromarray(h).resize(imgs.shape[2:0:-1], Image.BILINEAR))
            for h in heat
        ])
    return (heat * alpha + imgs * (1 - alpha)).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 2, pad: int = 2) -> np.ndarray:
    """torchvision make_grid equivalent for NHWC uint8."""
    n, H, W, C = images.shape
    ncol = nrow
    nr = (n + ncol - 1) // ncol
    grid = np.zeros((nr * (H + pad) + pad, ncol * (W + pad) + pad, C), images.dtype)
    for i, img in enumerate(images):
        r, c = divmod(i, ncol)
        y = pad + r * (H + pad)
        x = pad + c * (W + pad)
        grid[y : y + H, x : x + W] = img
    return grid


def attention_grid(attn: np.ndarray, query_pix: int, size=(112, 112)) -> np.ndarray:
    """Per-query-pixel attention map visualization (`imutils.py:55-112`
    tensorboard_attn/attn2): attn (B, N, N) -> heatmaps of row `query_pix`."""
    B, N, _ = attn.shape
    h = w = int(np.sqrt(N))
    rows = attn[:, query_pix, :].reshape(B, h, w)
    rows = rows - rows.min(axis=(1, 2), keepdims=True)
    rows = rows / (rows.max(axis=(1, 2), keepdims=True) + 1e-8)
    from PIL import Image

    maps = np.stack([
        np.asarray(Image.fromarray(jet(r)).resize(size[::-1], Image.BILINEAR)) for r in rows
    ])
    return make_grid(maps, nrow=min(B, 4))


def save_palette_png(label: np.ndarray, path: str, palette=None) -> None:
    """Palette PNG writer (`RSSFormer module/viz.py:6-24`, WaveCAM's pseudo-label
    PNGs): the labels as uint8 indices, ``palette`` (default the VOC colormap) as
    the PLTE chunk, written with ``zlib`` (no Pillow)."""
    pal = palette if palette is not None else colormap()
    write_png_palette(path, np.asarray(label).astype(np.uint8), pal)
