"""VOC12 datasets for the WSSS trainers, the port's copy of
``representationlearning_tpu/data/voc.py`` (parity with `SCD-AAAI2023/datasets/voc.py`).

- `VOC12ClsDataset` (aug): rescale(0.5-2.0) -> fliplr -> random-crop(mean_rgb=0) with
  img_box -> normalize; returns (name, image NHWC, cls_onehot(20), img_box)
  (`voc.py:61-149`; note photometric jitter is commented out in the reference cls path).
- `VOC12SegDataset` (aug): fliplr -> photometric -> random-crop(mean_rgb=imagenet) ->
  normalize; returns (name, image, seg_label, cls_onehot) (`voc.py:152-221`).
- class labels come from the mask when no precomputed one-hot file exists
  (`voc.py:124-136` _to_onehot).

When `root_dir` is None or missing, a deterministic synthetic dataset is generated so
tests/benches run without the real VOCdevkit (blobs of per-class color).

Samples are numpy arrays laid out as the JAX package's (images (H, W, 3)); the
command lines turn batches into NCHW tensors. Pillow is imported only to read files.
"""
from __future__ import annotations

import os

import numpy as np

from ..core.registry import DATASETS
from . import transforms as T

NUM_VOC_CLASSES = 21  # incl. background


def _read_image(path: str) -> np.ndarray:
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"))
    return img


def _read_label(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path))


def cls_onehot_from_mask(label_mask: np.ndarray, num_classes: int = NUM_VOC_CLASSES,
                         ignore_index: int = 255) -> np.ndarray:
    """`_to_onehot` (`voc.py:124-136`): classes present excluding bg/ignore; the returned
    vector is foreground-only (num_classes-1,) matching `cls_labels_onehot.npy`."""
    present = np.unique(label_mask).astype(np.int32)
    present = present[(present != ignore_index) & (present != 0)]
    onehot = np.zeros((num_classes,), np.uint8)
    onehot[present] = 1
    return onehot[1:]


class SyntheticSegSource:
    """Deterministic synthetic (image, mask) pairs: colored blobs per class."""

    def __init__(self, n: int = 32, size=(96, 128), num_classes: int = NUM_VOC_CLASSES):
        self.n = n
        self.size = size
        self.num_classes = num_classes

    def __len__(self):
        return self.n

    def get(self, idx: int):
        rng = np.random.default_rng(1234 + idx)
        H, W = self.size
        mask = np.zeros((H, W), np.uint8)
        img = rng.integers(0, 60, (H, W, 3)).astype(np.uint8)
        for _ in range(rng.integers(1, 4)):
            c = int(rng.integers(1, self.num_classes))
            cy, cx = rng.integers(0, H), rng.integers(0, W)
            ry, rx = rng.integers(H // 8, H // 3), rng.integers(W // 8, W // 3)
            ys, xs = np.ogrid[:H, :W]
            blob = ((ys - cy) / max(ry, 1)) ** 2 + ((xs - cx) / max(rx, 1)) ** 2 <= 1.0
            mask[blob] = c
            color = np.array([37 * c % 256, 91 * c % 256, 53 * c % 256], np.uint8)
            img[blob] = color + rng.integers(-10, 10, 3)
        return f"synthetic_{idx:06d}", img, mask


class VOC12Source:
    """Filesystem reader (`voc.py:20-58`): JPEGImages + SegmentationClassAug."""

    def __init__(self, root_dir: str, name_list_dir: str, split: str = "train_aug"):
        self.img_dir = os.path.join(root_dir, "JPEGImages")
        self.label_dir = os.path.join(root_dir, "SegmentationClassAug")
        list_path = os.path.join(name_list_dir, split + ".txt")
        self.names = [l.strip().split()[0] for l in open(list_path) if l.strip()]

    def __len__(self):
        return len(self.names)

    def get(self, idx: int):
        name = self.names[idx]
        img = _read_image(os.path.join(self.img_dir, name + ".jpg"))
        lp = os.path.join(self.label_dir, name + ".png")
        mask = _read_label(lp) if os.path.exists(lp) else np.zeros(img.shape[:2], np.uint8)
        return name, img, mask


def raw_canvas(image: np.ndarray, size: int) -> tuple[np.ndarray, np.ndarray]:
    """One sample of the on-device chain's host collation (the JAX package's
    `pad_to_canvas`, in numpy): the raw uint8 image top-left on an (S, S, 3)
    canvas, cut to it, and its (h, w) on the canvas."""
    h, w = min(image.shape[0], size), min(image.shape[1], size)
    canvas = np.zeros((size, size, 3), np.uint8)
    canvas[:h, :w] = image[:h, :w]
    return canvas, np.array([h, w], np.int32)


def make_source(root_dir=None, name_list_dir=None, split="train_aug",
                synthetic_size=(96, 128), synthetic_n=32, num_classes=NUM_VOC_CLASSES):
    if root_dir and os.path.isdir(os.path.join(root_dir, "JPEGImages")):
        return VOC12Source(root_dir, name_list_dir, split)
    return SyntheticSegSource(n=synthetic_n, size=synthetic_size, num_classes=num_classes)


@DATASETS.register("voc12_cls")
class VOC12ClsDataset:
    """Classification-supervision dataset for the SCD/RML trainers."""

    def __init__(
        self,
        root_dir=None,
        name_list_dir=None,
        split="train_aug",
        crop_size: int = 320,
        rescale_range=(0.5, 2.0),
        img_fliplr: bool = True,
        ignore_index: int = 255,
        num_classes: int = NUM_VOC_CLASSES,
        aug: bool = True,
        seed: int = 0,
        **source_kw,
    ):
        self.source = make_source(root_dir, name_list_dir, split,
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
            image, img_box = T.random_crop(
                rng, image, None, crop_size=self.crop_size,
                mean_rgb=(0, 0, 0), ignore_index=self.ignore_index,
            )
        else:
            img_box = np.array([0, image.shape[0], 0, image.shape[1]], np.int32)
        image = T.normalize_img(image)
        return name, image, cls_label.astype(np.float32), img_box.astype(np.int32)


@DATASETS.register("voc12_cls_raw")
class VOC12ClsRawDataset:
    """Raw-canvas twin of `VOC12ClsDataset` for the fused ON-DEVICE
    augmentation chain (`data/device_transforms.py`, the north star's
    "augmentation chain becomes fused JAX/XLA transforms"): the host does no
    augmentation at all — it pastes the raw uint8 image on a static canvas and
    ships it; scale-jitter/flip/pad/crop/normalize run as one jitted program
    fused into the train step. Returns (name, canvas u8 (S,S,3), hw (2,),
    cls_onehot)."""

    def __init__(self, root_dir=None, name_list_dir=None, split="train_aug",
                 canvas_size: int = 512, ignore_index: int = 255,
                 num_classes: int = NUM_VOC_CLASSES, **source_kw):
        self.source = make_source(root_dir, name_list_dir, split,
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


@DATASETS.register("voc12_seg")
class VOC12SegDataset:
    """Segmentation-supervision dataset (val/eval path of the SCD trainer)."""

    def __init__(
        self,
        root_dir=None,
        name_list_dir=None,
        split="val",
        crop_size: int | None = 320,
        img_fliplr: bool = True,
        ignore_index: int = 255,
        num_classes: int = NUM_VOC_CLASSES,
        aug: bool = False,
        seed: int = 0,
        **source_kw,
    ):
        self.source = make_source(root_dir, name_list_dir, split,
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


class BatchLoader:
    """Minimal epoch-reshuffling batch iterator (replaces DataLoader+DistributedSampler;
    a rank's command line moves its batch to its device). Collates fixed-size
    samples into numpy batches; infinite when `loop=True` with per-epoch reshuffle
    (the reference reseeds its sampler on exhaustion, `dist_train_voc.py:298-303`).
    ``batch_size`` is the global batch; with ``shard=(rank, world)`` every rank
    draws the same order from the seed and loads only its contiguous rows of each
    batch, so the ranks' batches are the one-rank batch split."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 loop: bool = True, drop_last: bool = True, shard: tuple[int, int] = (0, 1)):
        rank, world = shard
        if batch_size % world:
            raise ValueError(f"global batch {batch_size} not divisible by {world} ranks")
        self.ds = dataset
        self.bs = batch_size
        self.rows = slice(rank * batch_size // world, (rank + 1) * batch_size // world)
        self.shuffle = shuffle
        self.seed = seed
        self.loop = loop
        self.drop_last = drop_last

    def __iter__(self):
        epoch = 0
        while True:
            order = np.arange(len(self.ds))
            if self.shuffle:
                np.random.default_rng(self.seed + epoch).shuffle(order)
            for i in range(0, len(order) - (self.bs - 1 if self.drop_last else 0), self.bs):
                idxs = order[i : i + self.bs][self.rows]
                samples = [self.ds[int(j)] for j in idxs]
                yield tuple(
                    np.stack([s[k] for s in samples])
                    if isinstance(samples[0][k], np.ndarray)
                    else [s[k] for s in samples]
                    for k in range(len(samples[0]))
                )
            if not self.loop:
                return
            epoch += 1


def kfold_indices(n: int, k: int = 10, fold: int = -1, seed: int = 2333):
    """Cross-validation split (RSSFormer `CrossValSamplerGenerator`,
    `configs/base/loveda.py` CV=dict(k=10, i=-1)): fold i yields (train_idx, val_idx);
    fold == -1 means no split (all indices train, none val)."""
    idx = np.arange(n)
    if fold < 0:
        return idx, np.empty((0,), np.int64)
    rng = np.random.default_rng(seed)
    rng.shuffle(idx)
    chunks = np.array_split(idx, k)
    val = chunks[fold % k]
    train = np.concatenate([c for j, c in enumerate(chunks) if j != fold % k])
    return train, val
