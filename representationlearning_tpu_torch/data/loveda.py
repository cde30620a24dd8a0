"""LoveDA dataset (RSSFormer), the port's copy of ``representationlearning_tpu/data/loveda.py``
(parity with `RSSFormer-TIP2023/data/loveda.py`).

- urban + rural image / mask directory globbing (`:53-94`); masks stored 1..7 become
  label - 1 with ignore -1 (`:125-128` mask.astype - 1)
- train transforms (`configs/base/loveda.py:18-36`): RandomCrop 512, OneOf{hflip,
  vflip, rot90} p = .75, ShiftScaleRotate p = .2 (cv2's warp, `data/transforms.py`),
  Normalize(mean / std, max_pixel 1)
- eval: normalise only
- ``raw=True``: the raw uint8 image and its mask on a static canvas for the
  on-device chain (`data/device_transforms.py::augment_loveda_batch`)

Without a directory a deterministic synthetic source stands in, as for VOC, so
tests and benches run without the dataset. Samples are numpy arrays in the JAX
package's layout (images (H, W, 3)), but for ``raw=True``, whose canvases are the
NCHW tensors of ``device_transforms.pad_to_canvas``. Pillow is imported only to
read files, OpenCV only by ShiftScaleRotate.
"""
from __future__ import annotations

import glob
import os
from collections import OrderedDict

import numpy as np

from ..core.registry import DATASETS
from . import transforms as T
from .voc import SyntheticSegSource

COLOR_MAP = OrderedDict(
    Background=(255, 255, 255), Building=(255, 0, 0), Road=(255, 255, 0),
    Water=(0, 0, 255), Barren=(159, 129, 183), Forest=(0, 255, 0),
    Agricultural=(255, 195, 128),
)
LABEL_MAP = OrderedDict(
    Background=0, Building=1, Road=2, Water=3, Barren=4, Forest=5, Agricultural=6
)
NUM_LOVEDA_CLASSES = 7


class LoveDASource:
    def __init__(self, image_dirs, mask_dirs=None):
        image_dirs = image_dirs if isinstance(image_dirs, (list, tuple)) else [image_dirs]
        mask_dirs = mask_dirs if isinstance(mask_dirs, (list, tuple)) else [mask_dirs] * len(image_dirs)
        self.pairs = []
        for idir, mdir in zip(image_dirs, mask_dirs):
            for p in sorted(glob.glob(os.path.join(idir, "*.png")) + glob.glob(os.path.join(idir, "*.tif"))):
                name = os.path.basename(p)
                mp = os.path.join(mdir, name) if mdir else None
                self.pairs.append((p, mp if mp and os.path.exists(mp) else None))

    def __len__(self):
        return len(self.pairs)

    def get(self, idx):
        from PIL import Image

        ip, mp = self.pairs[idx]
        img = np.asarray(Image.open(ip).convert("RGB"))
        if mp:
            mask = np.asarray(Image.open(mp)).astype(np.int64) - 1  # ignore -> -1
        else:
            mask = np.full(img.shape[:2], -1, np.int64)
        return os.path.basename(ip), img, mask


class _SyntheticLoveDA:
    def __init__(self, n=16, size=(128, 128)):
        self.inner = SyntheticSegSource(n=n, size=size, num_classes=NUM_LOVEDA_CLASSES)

    def __len__(self):
        return len(self.inner)

    def get(self, idx):
        name, img, mask = self.inner.get(idx)
        return name, img, mask.astype(np.int64)


@DATASETS.register("LoveDALoader")
class LoveDADataset:
    def __init__(
        self,
        image_dir=None,
        mask_dir=None,
        training: bool = True,
        crop_size: int = 512,
        scale_limit: float = 0.2,
        shift_limit: float = 0.0625,
        affine_p: float = 0.2,
        flip_rot_p: float = 0.75,
        seed: int = 0,
        synthetic_n: int = 16,
        synthetic_size=(128, 128),
        raw: bool = False,
        canvas_size: int = 1024,
    ):
        if image_dir and any(os.path.isdir(d) for d in
                             (image_dir if isinstance(image_dir, (list, tuple)) else [image_dir])):
            self.source = LoveDASource(image_dir, mask_dir)
        else:
            self.source = _SyntheticLoveDA(synthetic_n, synthetic_size)
        self.training = training
        self.crop_size = crop_size
        self.scale_limit = scale_limit
        self.shift_limit = shift_limit
        self.affine_p = affine_p
        self.flip_rot_p = flip_rot_p
        self.seed = seed
        self.raw = raw
        self.canvas_size = canvas_size

    def __len__(self):
        return len(self.source)

    def __getitem__(self, idx):
        name, img, mask = self.source.get(idx)
        if self.raw:
            # the on-device chain's input: the raw uint8 canvas (3, S, S), the true
            # (h, w) and the mask canvas (S, S) int32 filled with -1
            from .device_transforms import pad_to_canvas

            canvas, hw, lab = pad_to_canvas([img], self.canvas_size,
                                            [mask.astype(np.int32)], ignore_index=-1)
            return name, canvas[0], hw[0], lab[0]
        rng = np.random.default_rng((self.seed << 18) ^ idx)
        img = img.astype(np.float32)
        if self.training:
            img, mask, _ = T.random_crop(
                rng, img, mask.astype(np.float32), crop_size=self.crop_size,
                mean_rgb=(0, 0, 0), ignore_index=-1,
            )
            mask = mask.astype(np.int64)
            if rng.random() < self.flip_rot_p:
                op = rng.integers(3)
                if op == 0:
                    img, mask = np.fliplr(img), np.fliplr(mask)
                elif op == 1:
                    img, mask = np.flipud(img), np.flipud(mask)
                else:
                    k = int(rng.integers(1, 4))
                    img, mask = np.rot90(img, k), np.rot90(mask, k)
            if rng.random() < self.affine_p:
                # ShiftScaleRotate(0.0625, 0.2, 45) p=.2 (`configs/base/loveda.py:30`)
                img, mask2 = T.shift_scale_rotate(
                    rng, np.ascontiguousarray(img),
                    np.ascontiguousarray(mask).astype(np.int32),
                    scale_limit=self.scale_limit,
                )
                mask = mask2.astype(np.int64)
        img = T.normalize_img(np.ascontiguousarray(img))
        return name, img, np.ascontiguousarray(mask)


def collate_loveda(samples):
    return (
        [s[0] for s in samples],
        np.stack([s[1] for s in samples]),
        np.stack([s[2] for s in samples]),
    )
