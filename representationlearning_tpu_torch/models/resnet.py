"""ResNet-50 backbone and the WaveCAM CAM network, the port of
``representationlearning_tpu/models/resnet.py`` (parity with
`WaveCAM-TMM2023/net/resnet50.py` and `net/resnet50_cam.py`).

Modules carry the reference's state_dict names, the ones
``convert/torch2jax.py::convert_wavecam_net`` consumes: ``resnet50.conv1``,
``resnet50.bn1``, ``resnet50.layer{l}.{b}.conv{1,2,3}`` / ``bn{1,2,3}``,
``resnet50.layer{l}.0.downsample.{0,1}`` and ``classifier`` (20, 2048, 1, 1, no
bias), so a reference checkpoint loads as it is.

Reference specifics kept:
- ``FrozenBatchNorm`` (the reference's FixedBatchNorm, `resnet50.py:10-13`) always
  normalises with its running statistics, under ``.train()`` too:
  ``(x - mean) * rsqrt(var + 1e-5) * weight + bias``, in f32;
- stride 16 is strides (2, 2, 2, 1); stride 8 is strides (2, 2, 1, 1) with
  dilations (1, 1, 2, 2), and the first block of every layer uses dilation 1
  (`resnet50.py:90`);
- ``dtype`` is the operand type of every backbone convolution (bf16: input and
  weight cast, the result bf16, f32 sums inside), as ``TorchConv(dtype=)``; the
  f32 parameters of ``FrozenBatchNorm`` then promote the stream back to f32, so
  the ReLUs and the residual adds run in f32. The classifier and ``cam`` run in
  f32.

Maps are NCHW. Not ported: the JAX package's ``s2d_stem``, a space-to-depth
lowering of the stem for the TPU's matrix unit.

``Net`` is built on the card: ``device=None`` means ``torch.device("cuda")`` and
construction raises where there is none; the CPU is the caller's explicit choice
(``device="cpu"``). The initial weights depend on the generator only.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..core.registry import MODELS
from ..ops.image import adaptive_avg_pool_11, adaptive_max_pool_11
from .layers import conv2d, init_weights, lecun_normal_init


class FrozenBatchNorm(nn.BatchNorm2d):
    """BatchNorm with frozen running statistics: inference mode always, f32 out
    (f64 for an f64 input). ``weight`` / ``bias`` are parameters, the statistics
    buffers; eps 1e-5."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps)
        shape = (-1, 1, 1)
        x = x if x.dtype == torch.float64 else x.float()
        return ((x - self.running_mean.view(shape)) * inv.view(shape)
                * self.weight.view(shape) + self.bias.view(shape))


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, dtype=None):
        super().__init__()
        self.dtype = dtype
        d = dilation
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, padding=d, dilation=d, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
            FrozenBatchNorm(planes * 4)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(conv2d(self.conv1, x, self.dtype)))
        out = torch.relu(self.bn2(conv2d(self.conv2, out, self.dtype)))
        out = self.bn3(conv2d(self.conv3, out, self.dtype))
        if self.downsample is not None:
            res = self.downsample[1](conv2d(self.downsample[0], x, self.dtype))
        else:
            res = x
        return torch.relu(out + res)


def resnet50_config(stride: int = 16) -> dict:
    if stride == 16:
        return dict(strides=(2, 2, 2, 1), dilations=(1, 1, 1, 1))
    return dict(strides=(2, 2, 1, 1), dilations=(1, 1, 2, 2))


class ResNet50Backbone(nn.Module):
    """Returns the four layer features (stage 1 = stem + layer1, as in
    `resnet50_cam.py:14-22`); with ``return_stem=True`` the 64-channel stem
    output (after the max pool) comes first, the tap IRN takes
    (`resnet50_irn.py:15`)."""

    LAYERS = ((64, 3), (128, 4), (256, 6), (512, 3))

    def __init__(self, strides: Sequence[int] = (2, 2, 2, 1),
                 dilations: Sequence[int] = (1, 1, 1, 1), return_stem: bool = False,
                 dtype=None):
        super().__init__()
        self.return_stem, self.dtype = return_stem, dtype
        self.conv1 = nn.Conv2d(3, 64, 7, strides[0], padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        inplanes = 64
        for i, (planes, blocks) in enumerate(self.LAYERS):
            stride = 1 if i == 0 else strides[i]
            needs_ds = stride != 1 or inplanes != planes * 4
            layer = [Bottleneck(inplanes, planes, stride, 1, needs_ds, dtype)]
            layer += [Bottleneck(planes * 4, planes, 1, dilations[i], False, dtype)
                      for _ in range(1, blocks)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
            inplanes = planes * 4

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = torch.relu(self.bn1(conv2d(self.conv1, x, self.dtype)))
        x = F.max_pool2d(x, 3, 2, 1)   # torch MaxPool2d(3, 2, 1)
        feats = [x] if self.return_stem else []
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            feats.append(x)
        return feats


@MODELS.register("wavecam_net")
class Net(nn.Module):
    """The WaveCAM multilabel classifier and its CAM paths (`resnet50_cam.py:9-147`)."""

    def __init__(self, stride: int = 16, n_classes: int = 20, dtype=torch.float32,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.stride = stride   # the features' stride, 16 or 8
        with resolve_device(device):  # parameters and buffers are created there
            self.resnet50 = ResNet50Backbone(dtype=dtype, **resnet50_config(stride))
            self.classifier = nn.Conv2d(2048, n_classes, 1, bias=False)
        init_weights(self.resnet50, generator)   # TorchConv's fan-out normal
        lecun_normal_init(self.classifier.weight, generator)   # flax nn.Conv's default

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnet50(x)[3]

    def _logits(self, f: torch.Tensor) -> torch.Tensor:
        return self.classifier(adaptive_avg_pool_11(f)).flatten(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Class logits (B, n_classes) of the pooled features."""
        return self._logits(self.features(x))

    def cam(self, x: torch.Tensor, weight: torch.Tensor | None = None,
            reweight: torch.Tensor | None = None) -> torch.Tensor:
        """CAM responses (B, n_classes, h, w), not ReLU'd (`resnet50_cam.py:109-147`):
        the classifier's weight; an external ``weight`` (forward1); or the weight
        multiplied elementwise by ``reweight`` (forward2). Both are in the
        classifier's layout, (n_classes, 2048, 1, 1)."""
        f = self.features(x)
        w = self.classifier.weight if weight is None else weight
        if reweight is not None:
            w = w * reweight
        return F.conv2d(f, w.float())

    def cam_with_logits(self, x: torch.Tensor):
        """Net_CAM (`resnet50_cam.py:58-76`): (logits, ReLU'd CAMs, features)."""
        f = self.features(x)
        return self._logits(f), torch.relu(self.classifier(f)), f

    def cam_feature(self, x: torch.Tensor):
        """Net_CAM_Feature (`resnet50_cam.py:79-103`): (logits, CAM-weighted mean
        features (B, n_classes, 2048), max-normalised CAMs (B, n_classes, h, w))."""
        f = self.features(x)
        cams = torch.relu(self.classifier(f))
        cams = cams / (adaptive_max_pool_11(cams) + 1e-5)
        cf = torch.einsum("bchw,bfhw->bcf", cams, f) / (f.shape[-2] * f.shape[-1])
        return self._logits(f), cf, cams
