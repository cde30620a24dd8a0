"""The ASFF fusion variants and SAGAN self-attention, the port of
``representationlearning_tpu/models/asff.py`` (`RSSFormer-TIP2023/module/baseline/
rs.py`: rsNetFusion and ASFF `:44-182`, Self_Attn `:337-372`; `hrnet2.py`:
HRNetFusion2, SimpleFusion without the aux head). These are the reference's
research sweep around RSSFormer: the ASFF neck gates the four upsampled HRNet
branches by a softmax over dilated-conv weight maps.

NCHW in and out. In eval mode the models return the softmax probabilities (B,
classes, H, W); in training mode the logits. The JAX models apply the CGFL
``segmentation_loss`` inside their training call; here the caller applies
``losses/cgfl.py::segmentation_loss`` with the model's ``loss_config`` (None:
{"ce": {}}) and ``ignore_index``, as for ``HRNetFusion``. No converter exists for
these models in either package: names follow the JAX package's scopes
(``backbone.*`` with the HRNet's reference names, ``neck.w0`` ...
``neck.weight_levels``, ``head_conv``, ``fuse_conv``, ``fuse_bn``), checked
against no reference checkpoint. ``head_conv`` is drawn as flax's ``nn.Conv``
(lecun normal), the other convolutions as the JAX ``TorchConv`` (fan out).

The models are built on the card: ``device=None`` means ``torch.device("cuda")``
and construction raises where there is none; the initial weights depend on the
generator only.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..core.registry import MODELS
from ..ops.image import resize_bilinear, resize_nearest
from .hrnet import HRNET_EXTRA, HighResolutionNet
from .layers import BatchNorm2d, init_weights, lecun_normal_init


class ASFF(nn.Module):
    """Adaptive spatial feature fusion (`rs.py:122-182`): every branch
    nearest-upsampled to branch 0's size, a weight map of ``compress_c``
    channels from each (a 1x1 conv for branch 0, 3x3 convs at dilations 6, 12
    and 18 for the others), ``weight_levels`` (1x1) over their concat, a softmax
    over the branches, and the concat of each branch times its weight.
    ``in_channels`` are the branches' widths (the JAX module infers them)."""

    DILATIONS = (1, 6, 12, 18)

    def __init__(self, in_channels: Sequence[int], compress_c: int = 16):
        super().__init__()
        for i, (ch, d) in enumerate(zip(in_channels, self.DILATIONS)):
            k = 1 if d == 1 else 3
            setattr(self, f"w{i}", nn.Conv2d(ch, compress_c, k, padding=d if k == 3 else 0,
                                             dilation=d))
        self.weight_levels = nn.Conv2d(len(in_channels) * compress_c, len(in_channels), 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        tgt = feats[0].shape[-2:]
        ups = [feats[0]] + [resize_nearest(f, tgt) for f in feats[1:]]
        weights = [getattr(self, f"w{i}")(f) for i, f in enumerate(ups)]
        lv = torch.softmax(self.weight_levels(torch.cat(weights, dim=1)), dim=1)
        return torch.cat([f * lv[:, i:i + 1] for i, f in enumerate(ups)], dim=1)


class SelfAttn(nn.Module):
    """SAGAN self-attention with a learned residual ``gamma``, zero at first
    (`rs.py:337-372`): queries and keys at ``in_dim // 8`` channels, values at
    ``in_dim``; the products in f32."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.query_conv = nn.Conv2d(in_dim, in_dim // 8, 1)
        self.key_conv = nn.Conv2d(in_dim, in_dim // 8, 1)
        self.value_conv = nn.Conv2d(in_dim, in_dim, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape

        def tokens(conv):   # (B, H * W, channels), row-major as the JAX reshape
            return conv(x).float().flatten(2).transpose(1, 2)

        attn = torch.softmax(tokens(self.query_conv) @ tokens(self.key_conv).transpose(1, 2), -1)
        out = (attn @ tokens(self.value_conv)).transpose(1, 2).reshape(B, C, H, W)
        return self.gamma * out + x


class _HRNetHead(nn.Module):
    """What ``RsNetFusion`` and ``HRNetFusion2`` share: the HRNet under
    ``backbone``, the neck a subclass makes (``_make_neck``) and runs (``_neck``),
    ``head_conv``, the bilinear upsample (align_corners=True) and the softmax in
    eval mode."""

    def __init__(self, hrnet_type: str = "hrnetv2_w32", classes: int = 7,
                 upsample_scale: int = 4, with_transformer: bool = False,
                 loss_config: Mapping | None = None, ignore_index: int = -1,
                 dtype=torch.float32, generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        widths = HRNET_EXTRA[hrnet_type]["widths"]
        self.upsample_scale = upsample_scale
        # the CGFL loss the caller applies (None: {"ce": {}}, as in JAX)
        self.loss_config, self.ignore_index = loss_config, ignore_index
        with resolve_device(device):  # parameters and buffers are created there
            self.backbone = HighResolutionNet(hrnet_type, with_transformer=with_transformer,
                                              dtype=dtype)
            self._make_neck(widths)
            self.head_conv = nn.Conv2d(sum(widths), classes, 1)
        init_weights(self, generator)
        lecun_normal_init(self.head_conv.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logit = self.head_conv(self._neck(self.backbone(x)))
        size = (logit.shape[-2] * self.upsample_scale, logit.shape[-1] * self.upsample_scale)
        logit = resize_bilinear(logit, size, align_corners=True)
        return logit if self.training else torch.softmax(logit, dim=1)


@MODELS.register("rsNetFusion")
class RsNetFusion(_HRNetHead):
    """HRNet encoder + ASFF neck + 1x1 head (`rs.py:44-91`)."""

    def _make_neck(self, widths):
        self.neck = ASFF(widths)

    def _neck(self, feats):
        return self.neck(feats)


@MODELS.register("HRNetFusion2")
class HRNetFusion2(_HRNetHead):
    """The SimpleFusion HRNet variant without the aux head (`hrnet2.py:45-110`):
    every branch bilinear-upsampled (align_corners=True) to branch 0's size,
    concatenated, ``fuse_conv`` (1x1) + ``fuse_bn`` + ReLU."""

    def _make_neck(self, widths):
        self.fuse_conv = nn.Conv2d(sum(widths), sum(widths), 1)
        self.fuse_bn = BatchNorm2d(sum(widths), eps=1e-5, momentum=0.1)

    def _neck(self, feats):
        tgt = feats[0].shape[-2:]
        ups = [feats[0]] + [resize_bilinear(f, tgt, align_corners=True) for f in feats[1:]]
        return F.relu(self.fuse_bn(self.fuse_conv(torch.cat(ups, dim=1))))
