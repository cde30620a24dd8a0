"""DRFL paired medical dataset, the port of ``representationlearning_tpu/data/medical.py``
(parity with `DRFL-EAAI2023/dataset/dataset.py`): paired dirs `images/ masks/ sr/`;
a shared random crop (256) and flip applied identically to image (A), mask (B),
and SR prior (C); grayscale masks; normalize to [-1, 1] (`:156-211`). The SR
prior is stored at 2x resolution (the engine's L1 target for the 2x `out2` head).

Synthetic fallback generates blob masks + a blurred 2x "SR prior" so the recipe
runs dataless.

Plain numpy, NHWC, the JAX package's arrays bit for bit; the trainer
(``train/drfl.py::drfl_batch``) moves a batch to the device as NCHW tensors.
PIL and scipy are imported where they are used: the synthetic path needs no PIL.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from ..core.registry import DATASETS


def _normalize_pm1(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32) / 127.5 - 1.0


class SyntheticMedicalSource:
    def __init__(self, n: int = 8, size: int = 64):
        self.n = n
        self.size = size

    def __len__(self):
        return self.n

    def get(self, idx: int):
        rng = np.random.default_rng(999 + idx)
        s = self.size
        img = rng.integers(20, 120, (s, s, 3)).astype(np.uint8)
        mask = np.zeros((s, s), np.uint8)
        cy, cx = rng.integers(s // 4, 3 * s // 4, 2)
        r = rng.integers(s // 8, s // 4)
        ys, xs = np.ogrid[:s, :s]
        blob = (ys - cy) ** 2 + (xs - cx) ** 2 <= r * r
        mask[blob] = 255
        img[blob] = img[blob] + 80
        # SR prior: smoothed mask at 2x
        sr = np.kron(mask, np.ones((2, 2), np.uint8))
        k = np.ones((3, 3)) / 9.0
        from scipy import ndimage  # available via sklearn dependency chain

        sr = ndimage.convolve(sr.astype(np.float32), k, mode="nearest").astype(np.uint8)
        return f"med_{idx:04d}", img, mask, sr


class PairedDirSource:
    """`GetDataset` (`dataset.py:81-134`)."""

    def __init__(self, root: str, image_dir="images", mask_dir="masks", sr_dir="sr"):
        from PIL import Image  # noqa: F401

        self.files = sorted(
            glob.glob(os.path.join(root, image_dir, "*"))
        )
        self.root = root
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.sr_dir = sr_dir

    def __len__(self):
        return len(self.files)

    def get(self, idx: int):
        from PIL import Image

        p = self.files[idx]
        name = os.path.basename(p)
        img = np.asarray(Image.open(p).convert("RGB"))
        mask = np.asarray(Image.open(os.path.join(self.root, self.mask_dir, name)).convert("L"))
        sr = np.asarray(Image.open(os.path.join(self.root, self.sr_dir, name)).convert("L"))
        return name, img, mask, sr


@DATASETS.register("drfl_paired")
class DRFLPairedDataset:
    def __init__(self, root: str | None = None, crop_size: int = 256, no_flip: bool = True,
                 seed: int = 0, synthetic_n: int = 8, synthetic_size: int = 64):
        if root and os.path.isdir(os.path.join(root, "images")):
            self.source = PairedDirSource(root)
        else:
            self.source = SyntheticMedicalSource(synthetic_n, synthetic_size)
        self.crop_size = crop_size
        self.no_flip = no_flip
        self.seed = seed

    def __len__(self):
        return len(self.source)

    def __getitem__(self, idx: int):
        name, img, mask, sr = self.source.get(idx)
        rng = np.random.default_rng((self.seed << 14) ^ idx)
        H, W = img.shape[:2]
        cs = min(self.crop_size, H, W)
        # shared crop applied identically to A/B and (2x coords) to C (`dataset.py:156-211`)
        y0 = int(rng.integers(0, H - cs + 1))
        x0 = int(rng.integers(0, W - cs + 1))
        img = img[y0 : y0 + cs, x0 : x0 + cs]
        mask = mask[y0 : y0 + cs, x0 : x0 + cs]
        sr = sr[2 * y0 : 2 * (y0 + cs), 2 * x0 : 2 * (x0 + cs)]
        if not self.no_flip and rng.random() > 0.5:
            img, mask, sr = np.fliplr(img), np.fliplr(mask), np.fliplr(sr)
        A = _normalize_pm1(img)
        B = _normalize_pm1(mask)[..., None]
        C = _normalize_pm1(sr)[..., None]
        return {"name": name, "A": A, "B": B, "C": C}


def collate_drfl(samples):
    return {
        "name": [s["name"] for s in samples],
        "A": np.stack([s["A"] for s in samples]),
        "B": np.stack([s["B"] for s in samples]),
        "C": np.stack([s["C"] for s in samples]),
    }
