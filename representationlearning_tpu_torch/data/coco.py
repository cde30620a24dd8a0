"""COCO-14 datasets for the WSSS trainers, the port's copy of
``representationlearning_tpu/data/coco.py``. Parity with `SCD-AAAI2023/datasets/coco.py`:
the same sample shapes as the VOC datasets, the train/val directory split (`:39-46`),
grayscale images stacked to RGB (`:19-23` robust_read_image); and with the WaveCAM
COCO dataloaders (`mscoco/dataloader.py`, 91->81 category compaction). Samples are
numpy, as in `data/voc.py`; Pillow is imported only to read files.
"""
from __future__ import annotations

import os

import numpy as np

from ..core.registry import DATASETS
from . import transforms as T
from .voc import SyntheticSegSource, cls_onehot_from_mask, raw_canvas

NUM_COCO_CLASSES = 81  # 80 things + background


def robust_read_image(path: str) -> np.ndarray:
    """Grayscale fix (`coco.py:19-23`)."""
    from PIL import Image

    img = np.asarray(Image.open(path))
    if img.ndim < 3:
        img = np.stack((img, img, img), axis=-1)
    return img[..., :3]


# COCO 91 -> 80 contiguous category compaction (WaveCAM `mscoco/annToMask.py`)
COCO_CATEGORY_MAP = {
    cid: i for i, cid in enumerate(
        [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
         23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44,
         46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
         65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88,
         89, 90]
    )
}


class CocoSource:
    """train/val split dirs (`coco.py:39-46`): images under
    `{root}/JPEGImages/{split}2014`, masks `{root}/SegmentationClass/{split}2014`."""

    def __init__(self, root_dir: str, name_list_dir: str, split: str = "train"):
        sub = f"{split}2014"
        self.img_dir = os.path.join(root_dir, "JPEGImages", sub)
        self.label_dir = os.path.join(root_dir, "SegmentationClass", sub)
        list_path = os.path.join(name_list_dir, split + ".txt")
        self.names = [l.strip().split()[0] for l in open(list_path) if l.strip()]

    def __len__(self):
        return len(self.names)

    def get(self, idx: int):
        from PIL import Image

        name = self.names[idx]
        img = robust_read_image(os.path.join(self.img_dir, name + ".jpg"))
        lp = os.path.join(self.label_dir, name + ".png")
        mask = (np.asarray(Image.open(lp)) if os.path.exists(lp)
                else np.zeros(img.shape[:2], np.uint8))
        return name, img, mask


def make_coco_source(root_dir=None, name_list_dir=None, split="train",
                     num_classes=NUM_COCO_CLASSES,
                     synthetic_size=(96, 128), synthetic_n=32):
    if root_dir and os.path.isdir(os.path.join(root_dir, "JPEGImages")):
        return CocoSource(root_dir, name_list_dir, split)
    return SyntheticSegSource(n=synthetic_n, size=synthetic_size,
                              num_classes=num_classes)


@DATASETS.register("coco_cls")
class CocoClsDataset:
    """Same sample shape as VOC12ClsDataset but 80 fg classes (`coco.py:70-150`)."""

    def __init__(self, root_dir=None, name_list_dir=None, split="train",
                 crop_size: int = 320, rescale_range=(0.5, 2.0), img_fliplr=True,
                 ignore_index: int = 255, num_classes: int = NUM_COCO_CLASSES,
                 aug: bool = True, seed: int = 0, **source_kw):
        self.source = make_coco_source(root_dir, name_list_dir, split,
                                       num_classes=num_classes, **source_kw)
        self.crop_size = crop_size
        self.rescale_range = rescale_range
        self.img_fliplr = img_fliplr
        self.ignore_index = ignore_index
        self.num_classes = num_classes
        self.aug = aug
        self.seed = seed

    def __len__(self):
        return len(self.source)

    def __getitem__(self, idx: int):
        name, image, mask = self.source.get(idx)
        cls_label = cls_onehot_from_mask(mask, self.num_classes, self.ignore_index)
        rng = np.random.default_rng((self.seed << 20) ^ idx)
        image = image.astype(np.float32)
        if self.aug:
            if self.rescale_range:
                image = T.random_scaling(rng, image, scale_range=self.rescale_range)
            if self.img_fliplr:
                image = T.random_fliplr(rng, image)
            image, img_box = T.random_crop(rng, image, None, crop_size=self.crop_size,
                                           mean_rgb=(0, 0, 0), ignore_index=self.ignore_index)
        else:
            img_box = np.array([0, image.shape[0], 0, image.shape[1]], np.int32)
        image = T.normalize_img(image)
        return name, image, cls_label.astype(np.float32), img_box.astype(np.int32)


@DATASETS.register("coco_cls_raw")
class CocoClsRawDataset:
    """Raw-canvas twin of `CocoClsDataset` for the fused on-device augmentation
    chain (`data/device_transforms.py`), mirroring `VOC12ClsRawDataset`: the host
    only pastes the raw uint8 image on a static canvas; scale/flip/pad/crop/
    normalize run jitted into the train step. Returns (name, canvas u8 (S,S,3),
    hw (2,), cls_onehot)."""

    def __init__(self, root_dir=None, name_list_dir=None, split="train",
                 canvas_size: int = 512, ignore_index: int = 255,
                 num_classes: int = NUM_COCO_CLASSES, **source_kw):
        self.source = make_coco_source(root_dir, name_list_dir, split,
                                       num_classes=num_classes, **source_kw)
        self.canvas_size = canvas_size
        self.ignore_index = ignore_index
        self.num_classes = num_classes

    def __len__(self):
        return len(self.source)

    def __getitem__(self, idx: int):
        name, image, mask = self.source.get(idx)
        cls_label = cls_onehot_from_mask(mask, self.num_classes, self.ignore_index)
        canvas, hw = raw_canvas(image, self.canvas_size)
        return name, canvas, hw, cls_label.astype(np.float32)


@DATASETS.register("coco_seg")
class CocoSegDataset:
    def __init__(self, root_dir=None, name_list_dir=None, split="val",
                 crop_size: int | None = 320, img_fliplr=True, ignore_index: int = 255,
                 num_classes: int = NUM_COCO_CLASSES, aug: bool = False, seed: int = 0,
                 **source_kw):
        self.source = make_coco_source(root_dir, name_list_dir, split,
                                       num_classes=num_classes, **source_kw)
        self.crop_size = crop_size
        self.img_fliplr = img_fliplr
        self.ignore_index = ignore_index
        self.num_classes = num_classes
        self.aug = aug
        self.seed = seed
        self.photometric = T.PhotoMetricDistortion()

    def __len__(self):
        return len(self.source)

    def __getitem__(self, idx: int):
        name, image, label = self.source.get(idx)
        cls_label = cls_onehot_from_mask(label, self.num_classes, self.ignore_index)
        rng = np.random.default_rng((self.seed << 20) ^ idx)
        image = image.astype(np.float32)
        if self.aug:
            if self.img_fliplr:
                image, label = T.random_fliplr(rng, image, label)
            image = self.photometric(rng, image.astype(np.uint8)).astype(np.float32)
            if self.crop_size:
                image, label, _ = T.random_crop(
                    rng, image, label, crop_size=self.crop_size,
                    mean_rgb=T.IMAGENET_MEAN, ignore_index=self.ignore_index,
                )
        image = T.normalize_img(image)
        return name, image, np.asarray(label), cls_label.astype(np.float32)
