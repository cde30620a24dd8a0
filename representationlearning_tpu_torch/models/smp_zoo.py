"""The RSSFormer baseline zoo, second half: the port of
``representationlearning_tpu/models/smp_zoo.py`` (`RSSFormer-TIP2023/module/
baseline/unet.py:38-217`, the smp-based UNetPP / LinkNet / DeepLabV3 /
DeepLabV3Plus / MANet / PAN wrappers on ResNet-50 encoders, and `trans.py:44-91`,
HRNet + SimpleFusion, the ``trans`` registry entry).

The reference delegates these architectures to ``segmentation_models_pytorch``;
the JAX package builds them from scratch on its ResNet-50 taps (layer1..4 at
strides 4 / 8 / 16 / 16, smp's stride-2 stem tap folded into the last
upsample), and the port follows the JAX package's architecture: LinkNet's
decoder upsamples by a resize and a 3x3 conv, not smp's transposed
convolution. The contract is that of ``models/baselines.py``: the loss dict in
training mode (``model(x, y)``), the softmax in eval mode.

Modules are named after the JAX package's scopes (``x1_2.c1.conv``,
``aspp.b3.bn``, ``dec0.se1``); the ResNet-50 encoder under ``encoder`` and
``trans``'s HRNet under ``backbone`` carry the reference names that
``convert_resnet50`` and ``convert_hrnet(prefix="backbone.")`` read. Maps are
NCHW. The models are built on the card unless ``device`` says otherwise.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.registry import MODELS
from ..ops.image import adaptive_avg_pool_11, resize_bilinear
from .baselines import RESNET_WIDTHS, ZooModel, _bn, _conv
from .hrnet import HRNET_EXTRA, HighResolutionNet
from .resnet import ResNet50Backbone, resnet50_config


class ConvBNReLU(nn.Module):
    """The zoo's conv (k x k, ``dilation``, padding (k // 2) * dilation, no
    bias) -> BN -> ReLU; names ``conv``, ``bn``. Not ``models/layers.py``'s
    ConvBNReLU, which has no dilation."""

    def __init__(self, cin: int, ch: int, k: int = 3, dilation: int = 1):
        super().__init__()
        p = (k // 2) * dilation
        self.conv = nn.Conv2d(cin, ch, k, padding=p, dilation=dilation, bias=False)
        self.bn = _bn(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class DoubleConv(nn.Module):
    def __init__(self, cin: int, ch: int):
        super().__init__()
        self.c1, self.c2 = ConvBNReLU(cin, ch), ConvBNReLU(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c2(self.c1(x))


def _encoder(stride: int = 16) -> ResNet50Backbone:
    return ResNet50Backbone(**resnet50_config(stride))


@MODELS.register("UNetPP")
class UNetPP(ZooModel):
    """UNet++ (`unet.py:38-64`; Zhou et al. 2018) over the four taps: the nested
    grid X[i][j] = DoubleConv(cat(X[i][0..j-1], up(X[i+1][j-1]))) at
    ``decoder_channels[min(i, 2)]`` channels, the resize align_corners=False."""

    LECUN = ("head",)

    def __init__(self, classes: int = 7, decoder_channels: Sequence[int] = (256, 128, 64),
                 loss_config: Mapping | None = None, ignore_index: int = -1,
                 generator: torch.Generator | None = None, device=None):
        self.decoder_channels = tuple(decoder_channels)
        super().__init__(classes, loss_config, ignore_index, generator, device)

    def _ch(self, i: int, j: int) -> int:
        dc = self.decoder_channels
        return RESNET_WIDTHS[i] if j == 0 else dc[min(i, len(dc) - 1)]

    def _build(self):
        self.encoder = _encoder(16)
        self.depth = len(RESNET_WIDTHS) - 1
        for j in range(1, self.depth + 1):
            for i in range(self.depth + 1 - j):
                cin = sum(self._ch(i, k) for k in range(j)) + self._ch(i + 1, j - 1)
                setattr(self, f"x{i}_{j}", DoubleConv(cin, self._ch(i, j)))
        self.head = nn.Conv2d(self._ch(0, self.depth), self.classes, 1)

    def forward(self, x, y=None, generator=None):
        grid = {(i, 0): f for i, f in enumerate(self.encoder(x))}
        for j in range(1, self.depth + 1):
            for i in range(self.depth + 1 - j):
                up = resize_bilinear(grid[(i + 1, j - 1)], grid[(i, 0)].shape[-2:])
                cat = torch.cat([grid[(i, k)] for k in range(j)] + [up], dim=1)
                grid[(i, j)] = getattr(self, f"x{i}_{j}")(cat)
        logit = resize_bilinear(self.head(grid[(0, self.depth)]), x.shape[-2:])
        return self._loss_or_softmax(logit, y)


class LinkNetDecoderBlock(nn.Module):
    """1x1 ``reduce`` to C / 4 -> resize to the target (align_corners=False) and
    a 3x3 ``up_conv`` -> 1x1 ``expand`` (Chaurasia & Culurciello 2017)."""

    def __init__(self, cin: int, out_ch: int):
        super().__init__()
        c = cin // 4
        self.reduce = ConvBNReLU(cin, c, k=1)
        self.up_conv = ConvBNReLU(c, c, k=3)
        self.expand = ConvBNReLU(c, out_ch, k=1)

    def forward(self, x: torch.Tensor, target_hw) -> torch.Tensor:
        x = resize_bilinear(self.reduce(x), target_hw)
        return self.expand(self.up_conv(x))


@MODELS.register("LinkNet")
class LinkNet(ZooModel):
    """LinkNet (`unet.py:67-93`): decoder blocks added to the encoder skips."""

    LECUN = ("head",)

    def __init__(self, classes: int = 7, loss_config: Mapping | None = None,
                 ignore_index: int = -1, generator: torch.Generator | None = None, device=None):
        super().__init__(classes, loss_config, ignore_index, generator, device)

    def _build(self):
        self.encoder = _encoder(16)
        for i in (2, 1, 0):
            setattr(self, f"dec{3 - i}", LinkNetDecoderBlock(RESNET_WIDTHS[i + 1],
                                                             RESNET_WIDTHS[i]))
        self.dec4 = LinkNetDecoderBlock(RESNET_WIDTHS[0], 32)
        self.head = nn.Conv2d(32, self.classes, 1)

    def forward(self, x, y=None, generator=None):
        feats = self.encoder(x)
        h = feats[3]
        for i in (2, 1, 0):
            h = getattr(self, f"dec{3 - i}")(h, feats[i].shape[-2:]) + feats[i]
        h = self.dec4(h, x.shape[-2:])
        return self._loss_or_softmax(self.head(h), y)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling at smp's rates (12, 24, 36): a 1x1 branch,
    three dilated 3x3 branches, and the image pool broadcast over the map;
    their concat through a 1x1 ``project``."""

    def __init__(self, cin: int, ch: int = 256, rates: Sequence[int] = (12, 24, 36)):
        super().__init__()
        self.b0 = ConvBNReLU(cin, ch, k=1)
        for i, r in enumerate(rates):
            setattr(self, f"b{i + 1}", ConvBNReLU(cin, ch, k=3, dilation=r))
        self.n = len(rates) + 1
        self.pool_conv = ConvBNReLU(cin, ch, k=1)
        self.project = ConvBNReLU((self.n + 1) * ch, ch, k=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [getattr(self, f"b{i}")(x) for i in range(self.n)]
        pooled = self.pool_conv(adaptive_avg_pool_11(x))
        branches.append(pooled.expand(-1, -1, x.shape[-2], x.shape[-1]))
        return self.project(torch.cat(branches, dim=1))


@MODELS.register("DeepLabV3")
class DeepLabV3(ZooModel):
    """DeepLabV3 (`unet.py:97-123`): the dilated stride-8 ResNet-50, ASPP, a 1x1
    classifier and an upsample to the input (align_corners=False)."""

    LECUN = ("head",)

    def __init__(self, classes: int = 7, loss_config: Mapping | None = None,
                 ignore_index: int = -1, generator: torch.Generator | None = None, device=None):
        super().__init__(classes, loss_config, ignore_index, generator, device)

    def _build(self):
        self.encoder = _encoder(8)
        self.aspp = ASPP(RESNET_WIDTHS[3])
        self.head = nn.Conv2d(256, self.classes, 1)

    def forward(self, x, y=None, generator=None):
        logit = self.head(self.aspp(self.encoder(x)[3]))
        return self._loss_or_softmax(resize_bilinear(logit, x.shape[-2:]), y)


@MODELS.register("DeepLabV3Plus")
class DeepLabV3Plus(ZooModel):
    """DeepLabV3+ (`unet.py:126-153`): the stride-16 encoder, ASPP, a 48-channel
    low-level skip from layer1, two 3x3 conv-BN-ReLUs, x4 upsample."""

    LECUN = ("head",)

    def __init__(self, classes: int = 7, loss_config: Mapping | None = None,
                 ignore_index: int = -1, generator: torch.Generator | None = None, device=None):
        super().__init__(classes, loss_config, ignore_index, generator, device)

    def _build(self):
        self.encoder = _encoder(16)
        self.aspp = ASPP(RESNET_WIDTHS[3])
        self.low_reduce = ConvBNReLU(RESNET_WIDTHS[0], 48, k=1)
        self.fuse1 = ConvBNReLU(256 + 48, 256)
        self.fuse2 = ConvBNReLU(256, 256)
        self.head = nn.Conv2d(256, self.classes, 1)

    def forward(self, x, y=None, generator=None):
        feats = self.encoder(x)
        low = self.low_reduce(feats[0])
        h = resize_bilinear(self.aspp(feats[3]), low.shape[-2:])
        h = self.fuse2(self.fuse1(torch.cat([h, low], dim=1)))
        logit = resize_bilinear(self.head(h), x.shape[-2:])
        return self._loss_or_softmax(logit, y)


class PAB(nn.Module):
    """Position attention on the deepest tap (smp MAnet): 1x1 ``q``, ``k`` at
    ``mid`` channels and ``v`` at C; a dense softmax attention over the H * W
    tokens in f32, added to the input."""

    def __init__(self, cin: int, mid: int = 64):
        super().__init__()
        self.q, self.k, self.v = _conv(cin, mid), _conv(cin, mid), _conv(cin, cin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape

        def tokens(conv):   # (B, H * W, channels), row-major as the JAX reshape
            return conv(x).float().flatten(2).transpose(1, 2)

        attn = torch.softmax(tokens(self.q) @ tokens(self.k).transpose(1, 2), dim=-1)
        out = (attn @ tokens(self.v)).transpose(1, 2).reshape(B, C, H, W)
        return x + out


class MFAB(nn.Module):
    """Multi-scale fusion attention (smp MAnet decoder): the decoder state
    resized to the skip and a 3x3 ``pre`` conv-BN-ReLU to its width, added to
    it; SE gating by the Linear layers ``se1`` (to max(C // 16, 4)) and
    ``se2`` on the pooled vector; two 3x3 conv-BN-ReLUs to ``ch``."""

    def __init__(self, cin: int, skip_ch: int, ch: int, reduction: int = 16):
        super().__init__()
        self.pre = ConvBNReLU(cin, skip_ch)
        hidden = max(skip_ch // reduction, 4)
        self.se1, self.se2 = nn.Linear(skip_ch, hidden), nn.Linear(hidden, skip_ch)
        self.c1, self.c2 = ConvBNReLU(skip_ch, ch), ConvBNReLU(ch, ch)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        h = self.pre(resize_bilinear(x, skip.shape[-2:])) + skip
        se = torch.relu(self.se1(adaptive_avg_pool_11(h).flatten(1)))
        h = h * torch.sigmoid(self.se2(se))[:, :, None, None]
        return self.c2(self.c1(h))


@MODELS.register("MANet")
class MANet(ZooModel):
    """MA-Net (`unet.py:158-183`): PAB on the deepest tap, an MFAB decoder, an
    upsample to the input, a 3x3 conv-BN-ReLU (32) and the classifier."""

    LECUN = ("head", "dec0.se1", "dec0.se2", "dec1.se1", "dec1.se2", "dec2.se1", "dec2.se2")

    def __init__(self, classes: int = 7, decoder_channels: Sequence[int] = (256, 128, 64),
                 loss_config: Mapping | None = None, ignore_index: int = -1,
                 generator: torch.Generator | None = None, device=None):
        self.decoder_channels = tuple(decoder_channels)
        super().__init__(classes, loss_config, ignore_index, generator, device)

    def _build(self):
        self.encoder = _encoder(16)
        self.pab = PAB(RESNET_WIDTHS[3])
        cin = RESNET_WIDTHS[3]
        for n, i in enumerate((2, 1, 0)):
            setattr(self, f"dec{n}", MFAB(cin, RESNET_WIDTHS[i], self.decoder_channels[n]))
            cin = self.decoder_channels[n]
        self.final = ConvBNReLU(cin, 32)
        self.head = nn.Conv2d(32, self.classes, 1)

    def forward(self, x, y=None, generator=None):
        feats = self.encoder(x)
        h = self.pab(feats[3])
        for n, i in enumerate((2, 1, 0)):
            h = getattr(self, f"dec{n}")(h, feats[i])
        h = self.final(resize_bilinear(h, x.shape[-2:]))
        return self._loss_or_softmax(self.head(h), y)


class FPA(nn.Module):
    """Feature pyramid attention on the deepest tap (PAN, Li et al. 2018): a
    pooled global branch, a 1x1 middle branch, and a pyramid of 7 / 5 / 3 convs
    at halved resolutions (2x2 average pools) brought back up, which scales the
    middle branch. The pyramid stops before a level whose input has a side
    below 2; with no level at all the middle branch is taken times ones. The
    modules of every level exist; a small map leaves the deeper ones unused."""

    KS = (7, 5, 3)

    def __init__(self, cin: int, ch: int):
        super().__init__()
        self.ch = ch
        self.glob = ConvBNReLU(cin, ch, k=1)
        self.mid = ConvBNReLU(cin, ch, k=1)
        for i, k in enumerate(self.KS):
            setattr(self, f"d{i + 1}", ConvBNReLU(cin if i == 0 else ch, ch, k=k))
            setattr(self, f"u{i + 1}", ConvBNReLU(ch, ch, k=k))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[-2:]
        glob = self.glob(adaptive_avg_pool_11(x))
        mid = self.mid(x)
        downs, h = [], x
        for i in range(len(self.KS)):
            if min(h.shape[-2], h.shape[-1]) < 2:
                break
            h = getattr(self, f"d{i + 1}")(F.avg_pool2d(h, 2, 2))
            downs.append(h)
        up = None
        for i in range(len(downs) - 1, -1, -1):
            h = downs[i] if up is None else downs[i] + up
            tgt = downs[i - 1].shape[-2:] if i > 0 else (H, W)
            up = resize_bilinear(getattr(self, f"u{i + 1}")(h), tgt)
        pyr = up if up is not None else torch.ones_like(mid)
        return mid * pyr + glob


class GAU(nn.Module):
    """Global attention upsample (PAN decoder): the pooled high-level state
    gates the 3x3 conv of the low-level skip (``gate_conv``, ``gate_bn``,
    sigmoid), added to the upsampled high-level state through a 1x1
    ``up_conv``."""

    def __init__(self, high_ch: int, low_ch: int, ch: int):
        super().__init__()
        self.low_conv = ConvBNReLU(low_ch, ch)
        self.gate_conv = _conv(high_ch, ch, bias=False)
        self.gate_bn = _bn(ch)
        self.up_conv = ConvBNReLU(high_ch, ch, k=1)

    def forward(self, high: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self.gate_bn(self.gate_conv(adaptive_avg_pool_11(high))))
        up = self.up_conv(resize_bilinear(high, low.shape[-2:]))
        return up + self.low_conv(low) * gate


@MODELS.register("PAN")
class PAN(ZooModel):
    """Pyramid attention network (`unet.py:186-211`): FPA + a GAU decoder at
    ``decoder_ch`` channels, the classifier upsampled to the input."""

    LECUN = ("head",)

    def __init__(self, classes: int = 7, decoder_ch: int = 32, loss_config: Mapping | None = None,
                 ignore_index: int = -1, generator: torch.Generator | None = None, device=None):
        super().__init__(classes, loss_config, ignore_index, generator, device,
                         decoder_ch=decoder_ch)

    def _build(self, decoder_ch):
        self.encoder = _encoder(16)
        self.fpa = FPA(RESNET_WIDTHS[3], decoder_ch)
        for n, i in enumerate((2, 1, 0)):
            setattr(self, f"gau{n}", GAU(decoder_ch, RESNET_WIDTHS[i], decoder_ch))
        self.head = nn.Conv2d(decoder_ch, self.classes, 1)

    def forward(self, x, y=None, generator=None):
        feats = self.encoder(x)
        h = self.fpa(feats[3])
        for n, i in enumerate((2, 1, 0)):
            h = getattr(self, f"gau{n}")(h, feats[i])
        logit = resize_bilinear(self.head(h), x.shape[-2:])
        return self._loss_or_softmax(logit, y)


@MODELS.register("trans")
class Trans(ZooModel):
    """`trans.py:44-91`: the HRNet without the transformer fusion, its branches
    upsampled to branch 0 (align_corners=True) and concatenated, a 1x1
    ``fuse_conv`` with bias, ``fuse_bn``, ReLU, the 1x1 ``head`` and an
    align-corners upsample by ``upsample_scale``. ``dtype`` is the HRNet's
    convolution operand type, as in the JAX model."""

    LECUN = ("head",)

    def __init__(self, hrnet_type: str = "hrnetv2_w48", classes: int = 7, upsample_scale: int = 4,
                 loss_config: Mapping | None = None, ignore_index: int = -1,
                 dtype=torch.float32, generator: torch.Generator | None = None, device=None):
        self.upsample_scale = upsample_scale
        super().__init__(classes, loss_config, ignore_index, generator, device,
                         hrnet_type=hrnet_type, dtype=dtype)

    def _build(self, hrnet_type, dtype):
        width = sum(HRNET_EXTRA[hrnet_type]["widths"])
        self.backbone = HighResolutionNet(hrnet_type, with_transformer=False, dtype=dtype)
        self.fuse_conv = _conv(width, width)
        self.fuse_bn = _bn(width)
        self.head = nn.Conv2d(width, self.classes, 1)

    def forward(self, x, y=None, generator=None):
        feats = self.backbone(x)
        tgt = feats[0].shape[-2:]
        h = torch.cat([feats[0]] + [resize_bilinear(f, tgt, align_corners=True)
                                    for f in feats[1:]], dim=1)
        logit = self.head(torch.relu(self.fuse_bn(self.fuse_conv(h))))
        size = (logit.shape[-2] * self.upsample_scale, logit.shape[-1] * self.upsample_scale)
        return self._loss_or_softmax(resize_bilinear(logit, size, align_corners=True), y)


# the fourteen registry names of the zoo (models/baselines.py and this module)
ZOO_MODELS = tuple(n for n in MODELS.keys()
                   if isinstance(MODELS.get(n), type) and issubclass(MODELS.get(n), ZooModel))
