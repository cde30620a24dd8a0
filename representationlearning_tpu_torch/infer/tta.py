"""Test-time augmentation with exact inverse transforms, the port of
``representationlearning_tpu/infer/tta.py`` (`RSSFormer-TIP2023/module/tta.py`).

Inputs are NCHW; ``tta(model_fn, image, transforms)`` averages the
inverse-transformed outputs (`tta.py:12-24`). Scale is bilinear with
align_corners=True both ways (`:118-135`).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..ops.image import resize_bilinear


class Transform:
    def transform(self, x):
        raise NotImplementedError

    def inv_transform(self, x):
        raise NotImplementedError


class Identity(Transform):
    def transform(self, x):
        return x

    def inv_transform(self, x):
        return x


class Rotate90k(Transform):
    def __init__(self, k: int = 1):
        assert k in (1, 2, 3)
        self.k = k

    def transform(self, x):
        return torch.rot90(x, self.k, dims=(-2, -1))

    def inv_transform(self, x):
        return torch.rot90(x, 4 - self.k, dims=(-2, -1))


class HorizontalFlip(Transform):
    def transform(self, x):
        return x.flip(-1)

    def inv_transform(self, x):
        return x.flip(-1)


class VerticalFlip(Transform):
    def transform(self, x):
        return x.flip(-2)

    def inv_transform(self, x):
        return x.flip(-2)


class Transpose(Transform):
    def transform(self, x):
        return x.transpose(-2, -1)

    def inv_transform(self, x):
        return x.transpose(-2, -1)


class Scale(Transform):
    def __init__(self, size=None, scale_factor: float | None = None):
        self.size = size
        self.scale_factor = scale_factor
        self._orig = None

    def transform(self, x):
        self._orig = tuple(x.shape[-2:])
        if self.size is not None:
            size = self.size
        else:
            size = (int(x.shape[-2] * self.scale_factor), int(x.shape[-1] * self.scale_factor))
        return resize_bilinear(x, size, align_corners=True)

    def inv_transform(self, x):
        return resize_bilinear(x, self._orig, align_corners=True)


def default_tta_config(scales=(0.5, 0.75, 1.0, 1.25, 1.5, 1.75)):
    """RSSFormer eval TTA set (`eval.py:58-65`)."""
    return [Scale(scale_factor=s) for s in scales]


def full_tta_config():
    return [
        Identity(), HorizontalFlip(), VerticalFlip(), Transpose(),
        Rotate90k(1), Rotate90k(2), Rotate90k(3),
    ]


def tta(model_fn: Callable, image: torch.Tensor, transforms: Sequence[Transform]) -> torch.Tensor:
    """Average of inverse-transformed model outputs over the TTA set."""
    outs = [t.inv_transform(model_fn(t.transform(image))) for t in transforms]
    return sum(outs) / len(outs)
