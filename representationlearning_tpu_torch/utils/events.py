"""Observability sink, the port's copy of ``representationlearning_tpu/utils/events.py``:
the TensorBoard-equivalent writer.

The reference logs scalars and CAM/attention image grids every 200 iters through
`torch.utils.tensorboard` (`SCD-AAAI2023/scripts/dist_train_voc.py:250,393-413`).
The sink always writes dependency-free artifacts:
  - scalars to `<logdir>/scalars.csv` (step,tag,value — trivially plottable/greppable)
  - images to `<logdir>/images/<tag>_<step>.png`, 8-bit RGB PNGs written with
    `zlib` and `struct` (no Pillow, so a machine without it still writes them)
and, when the tensorboard package is importable, mirrors both into real
TensorBoard event files under `<logdir>` so `tensorboard --logdir` works exactly
like the reference's (its image summaries need Pillow; without it only the
scalars are mirrored).
"""
from __future__ import annotations

import csv
import os
import struct
import zlib
from typing import Mapping

import numpy as np


def _try_tb_writer(logdir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=logdir)
    except Exception:
        return None


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _write_png(path: str, rows: np.ndarray, colour_type: int, *chunks: bytes) -> None:
    """(H, W * channels) uint8 rows as an 8-bit PNG of ``colour_type``: one IHDR,
    the ``chunks`` given, one IDAT of the rows, each behind filter byte 0 (none),
    one IEND."""
    h, n = rows.shape
    width = n // (3 if colour_type == 2 else 1)
    data = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, h, 8, colour_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr) + b"".join(chunks)
                + _png_chunk(b"IDAT", zlib.compress(data.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def write_png_rgb(path: str, arr: np.ndarray) -> None:
    """An (H, W, 3) uint8 array as an 8-bit truecolour PNG (colour type 2)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w, c = arr.shape
    if c != 3:
        raise ValueError(f"write_png_rgb takes (H, W, 3), got {arr.shape}")
    _write_png(path, arr.reshape(h, w * 3), 2)


def write_png_palette(path: str, index: np.ndarray, palette: np.ndarray) -> None:
    """An (H, W) uint8 index array as an 8-bit palette PNG (colour type 3) whose
    PLTE chunk holds ``palette``'s first 256 (r, g, b) entries."""
    index = np.ascontiguousarray(index, dtype=np.uint8)
    if index.ndim != 2:
        raise ValueError(f"write_png_palette takes (H, W), got {index.shape}")
    pal = np.asarray(palette, np.uint8).reshape(-1)[: 256 * 3]
    pal = pal[: len(pal) - len(pal) % 3]
    if not len(pal):
        raise ValueError("write_png_palette needs at least one palette entry")
    _write_png(path, index, 3, _png_chunk(b"PLTE", pal.tobytes()))


class MetricsWriter:
    """Scalar + image event writer with a TensorBoard-like interface."""

    def __init__(self, logdir: str, tensorboard: bool = True):
        self.logdir = logdir
        self.img_dir = os.path.join(logdir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self._path = os.path.join(logdir, "scalars.csv")
        new = not os.path.exists(self._path)
        self._fh = open(self._path, "a", newline="")
        self._csv = csv.writer(self._fh)
        if new:
            self._csv.writerow(["step", "tag", "value"])
        self._tb = _try_tb_writer(logdir) if tensorboard else None

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._csv.writerow([int(step), tag, float(value)])
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def add_scalars(self, scalars: Mapping[str, float], step: int,
                    prefix: str = "") -> None:
        for k, v in scalars.items():
            self.add_scalar(prefix + k, v, step)

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """image: (H, W, 3) float [0,1] or uint8, or (H, W) label map."""
        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        path = os.path.join(self.img_dir, f"{tag.replace('/', '_')}_{int(step):07d}.png")
        write_png_rgb(path, arr)
        if self._tb is not None:
            try:
                self._tb.add_image(tag, arr, int(step), dataformats="HWC")
            except ImportError:  # TensorBoard encodes its image summaries with Pillow
                pass

    def flush(self) -> None:
        self._fh.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
