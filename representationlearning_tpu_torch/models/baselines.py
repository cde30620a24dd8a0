"""The RSSFormer baseline zoo, first half: the port of
``representationlearning_tpu/models/baselines.py`` (`RSSFormer-TIP2023/module/
baseline/`, registered there in the ``ever`` MODEL registry; here in
``core.registry.MODELS`` under the JAX package's names).

Every model follows the reference's contract (`hrnet_aux.py:89-110`):
``model(x, y)`` in training mode returns the loss dict (CGFL
``segmentation_loss`` with the model's ``loss_config``, None meaning
{"ce": {}}, except where a model has its own losses), ``model(x)`` in eval mode
the probabilities (B, classes, H, W). ``generator`` (a CPU ``torch.Generator``;
None is the global one) draws the dropout masks of ``PSPNet`` and ``FCN8s``.

Models: FarSegV1 (FPN + FSRelation + AsymmetricDecoder, `base.py:6-252`,
`farsegv1.py:11`), SemanticFPN (`semantic_fpn.py:14,84`), PSPNet (`pspnet.py:44`),
FCN8s (VGG-16, `fcn8s.py:10`), AnyUNet (`unet.py:6-217`), FactSeg
(`factseg.py:10-56`) and SemanticFPNDecouple (`semantic_fpn.py:84-146`).

Modules are named after the JAX package's scopes (``fpn.inner1``,
``decoder.b2_conv1``, ``psp.stage3``, flax's auto-named ``PReLU_0``), and the
ResNet-50 encoder under ``resnet`` carries the reference names that
``convert_resnet50`` reads; its BatchNorms are the frozen ones. Convolutions the
JAX package draws as ``TorchConv`` start fan-out normal, those it draws as flax
``nn.Conv`` (the 1x1 classifiers) lecun normal. Maps are NCHW.

The models are built on the card: ``device=None`` means ``torch.device("cuda")``
and construction raises where there is none; the initial weights depend on the
generator only.
"""
from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..core.registry import MODELS
from ..losses.cgfl import binary_cross_entropy_with_logits_ignore, segmentation_loss
from ..losses.wsss import cross_entropy_ignore
from ..ops.image import adaptive_avg_pool_11, resize_bilinear
from .layers import BatchNorm2d, dropout, init_weights, lecun_normal_init
from .resnet import ResNet50Backbone, resnet50_config

RESNET_WIDTHS = (256, 512, 1024, 2048)   # ResNet-50's four taps


def _bn(ch: int) -> BatchNorm2d:
    """flax ``nn.BatchNorm(momentum=0.9)``: eps 1e-5, torch momentum 0.1."""
    return BatchNorm2d(ch, eps=1e-5, momentum=0.1)


def _conv(cin: int, cout: int, k: int = 1, bias: bool = True) -> nn.Conv2d:
    """The JAX ``TorchConv`` with padding k // 2."""
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=bias)


class ZooModel(nn.Module):
    """What the zoo's models share: construction on ``device`` with the weights
    drawn from ``generator`` (``_build`` makes the modules; ``LECUN`` names the
    flax ``nn.Conv`` / ``nn.Dense`` ones), and the training / eval contract
    (``_loss_or_softmax``)."""

    LECUN: tuple[str, ...] = ()

    def __init__(self, classes: int, loss_config: Mapping | None, ignore_index: int,
                 generator: torch.Generator | None, device, **build):
        super().__init__()
        self.classes, self.loss_config, self.ignore_index = classes, loss_config, ignore_index
        with resolve_device(device):  # parameters and buffers are created there
            self._build(**build)
        init_weights(self, generator)
        for name in self.LECUN:
            lecun_normal_init(self.get_submodule(name).weight, generator)

    def _build(self, **kw) -> None:
        raise NotImplementedError

    def _loss_or_softmax(self, logit: torch.Tensor, y: torch.Tensor | None):
        """The training loss dict (CGFL ``segmentation_loss``) or, in eval mode,
        the softmax over the classes."""
        if not self.training:
            return torch.softmax(logit, dim=1)
        return segmentation_loss(logit, _labels(y), self.loss_config or {"ce": {}},
                                 self.ignore_index)


def _labels(y: torch.Tensor | None) -> torch.Tensor:
    if y is None:
        raise ValueError("a zoo model in training mode takes the labels: model(x, y)")
    return y


class FPN(nn.Module):
    """Top-down FPN (`base.py:92-160`): 1x1 lateral ``inner{i}`` and 3x3 output
    ``layer{i}`` convolutions; the top-down path is a bilinear resize
    (align_corners=False), as the JAX module computes it."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        self.n = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"inner{i + 1}", _conv(c, out_channels))
            setattr(self, f"layer{i + 1}", _conv(out_channels, out_channels, 3))

    def forward(self, feats: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        laterals = [getattr(self, f"inner{i + 1}")(f) for i, f in enumerate(feats)]
        outs = [None] * self.n
        last = laterals[-1]
        outs[-1] = getattr(self, f"layer{self.n}")(last)
        for i in range(self.n - 2, -1, -1):
            last = laterals[i] + resize_bilinear(last, laterals[i].shape[-2:])
            outs[i] = getattr(self, f"layer{i + 1}")(last)
        return outs


class AsymmetricDecoder(nn.Module):
    """``AssymetricDecoder`` (`base.py:6-45`): for each level, conv-BN-ReLU stacks
    with a x2 bilinear upsample (align_corners=True) after each, down to
    ``out_stride``; the sum is divided by 4.0 whatever the number of levels."""

    def __init__(self, in_channels: int, out_channels: int = 128,
                 in_strides: Sequence[int] = (4, 8, 16, 32), out_stride: int = 4):
        super().__init__()
        self.n_up = [int(math.log2(s)) - int(math.log2(out_stride)) for s in in_strides]
        for i, n_up in enumerate(self.n_up):
            for k in range(max(n_up, 1)):
                setattr(self, f"b{i}_conv{k}",
                        _conv(in_channels if k == 0 else out_channels, out_channels, 3, False))
                setattr(self, f"b{i}_bn{k}", _bn(out_channels))

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        out = None
        for i, (h, n_up) in enumerate(zip(feats, self.n_up)):
            for k in range(max(n_up, 1)):
                h = torch.relu(getattr(self, f"b{i}_bn{k}")(getattr(self, f"b{i}_conv{k}")(h)))
                if n_up:
                    h = resize_bilinear(h, (h.shape[-2] * 2, h.shape[-1] * 2), align_corners=True)
            out = h if out is None else out + h
        return out / 4.0


class FSRelation(nn.Module):
    """Foreground-scene relation (`base.py:162-252`): a scene embedding of the
    pooled deepest feature gates each level by sigmoid(sum_c(content * scene) /
    sqrt(scene_channels)), one channel a pixel."""

    def __init__(self, scene_in: int, in_channels: Sequence[int], scene_channels: int = 256,
                 out_channels: int = 256):
        super().__init__()
        self.scene_channels = scene_channels
        self.scene_encoder = _conv(scene_in, scene_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"content{i}", _conv(c, scene_channels))
            setattr(self, f"feature{i}", _conv(c, out_channels))
            setattr(self, f"bn{i}", _bn(out_channels))

    def forward(self, scene_feat: torch.Tensor, feats: Sequence[torch.Tensor]):
        scene = self.scene_encoder(adaptive_avg_pool_11(scene_feat))
        outs = []
        for i, f in enumerate(feats):
            cdr = getattr(self, f"content{i}")(f)
            rel = torch.sigmoid((cdr * scene).sum(1, keepdim=True)
                                / math.sqrt(float(self.scene_channels)))
            feat = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"feature{i}")(f)))
            outs.append(feat * rel)
        return outs


@MODELS.register("FarSegV1")
class FarSegV1(ZooModel):
    """FarSeg: ResNet-50 (stride 32) -> FPN -> FSRelation -> AsymmetricDecoder ->
    1x1 classifier, upsampled to the input (align_corners=True). ``dtype`` is the
    JAX field, which the JAX model never reads; it is accepted and not read."""

    LECUN = ("cls_head",)

    def __init__(self, classes: int = 7, fpn_channels: int = 256, decoder_channels: int = 128,
                 loss_config: Mapping | None = None, dtype=torch.float32,
                 generator: torch.Generator | None = None, device=None):
        super().__init__(classes, loss_config, -1, generator, device,
                         fpn_channels=fpn_channels, decoder_channels=decoder_channels)

    def _build(self, fpn_channels, decoder_channels):
        self.resnet = ResNet50Backbone(strides=(2, 2, 2, 2))
        self.fpn = FPN(RESNET_WIDTHS, fpn_channels)
        self.fsr = FSRelation(RESNET_WIDTHS[-1], (fpn_channels,) * 4)
        self.decoder = AsymmetricDecoder(256, decoder_channels)
        self.cls_head = nn.Conv2d(decoder_channels, self.classes, 1)

    def forward(self, x, y=None, generator=None):
        feats = self.resnet(x)
        dec = self.decoder(self.fsr(feats[-1], self.fpn(feats)))
        logit = resize_bilinear(self.cls_head(dec), x.shape[-2:], align_corners=True)
        return self._loss_or_softmax(logit, y)


@MODELS.register("SemanticFPN")
class SemanticFPN(ZooModel):
    """ResNet-50 (stride 32) -> FPN -> per level 3x3 conv-BN-ReLU resized to
    stride 4 (align_corners=False) and summed -> 1x1 classifier."""

    LECUN = ("cls_head",)

    def __init__(self, classes: int = 7, fpn_channels: int = 256, seg_channels: int = 128,
                 loss_config: Mapping | None = None,
                 generator: torch.Generator | None = None, device=None):
        super().__init__(classes, loss_config, -1, generator, device,
                         fpn_channels=fpn_channels, seg_channels=seg_channels)

    def _build(self, fpn_channels, seg_channels):
        self.resnet = ResNet50Backbone(strides=(2, 2, 2, 2))
        self.fpn = FPN(RESNET_WIDTHS, fpn_channels)
        for i in range(4):
            setattr(self, f"seg{i}_conv", _conv(fpn_channels, seg_channels, 3, False))
            setattr(self, f"seg{i}_bn", _bn(seg_channels))
        self.cls_head = nn.Conv2d(seg_channels, self.classes, 1)

    def forward(self, x, y=None, generator=None):
        fpn_feats = self.fpn(self.resnet(x))
        tgt = fpn_feats[0].shape[-2:]
        merged = None
        for i, f in enumerate(fpn_feats):
            h = torch.relu(getattr(self, f"seg{i}_bn")(getattr(self, f"seg{i}_conv")(f)))
            h = resize_bilinear(h, tgt)
            merged = h if merged is None else merged + h
        logit = resize_bilinear(self.cls_head(merged), x.shape[-2:], align_corners=True)
        return self._loss_or_softmax(logit, y)


class PSPModule(nn.Module):
    """Pyramid pooling (`pspnet.py:9-28`): at each size s, the mean over the
    floor-cropped region x[..., :ph * s, :pw * s] in s x s cells (ph = H // s;
    not ``F.adaptive_avg_pool2d``, which differs where s does not divide the
    map), a 1x1 conv to C / len(sizes), an align-corners upsample; the concat
    with the input through a 3x3 ``bottleneck`` and ReLU."""

    def __init__(self, in_channels: int, out_channels: int = 1024,
                 sizes: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        self.sizes = tuple(sizes)
        for s in self.sizes:
            setattr(self, f"stage{s}", _conv(in_channels, in_channels // len(self.sizes),
                                             bias=False))
        self.bottleneck = _conv(in_channels + len(self.sizes) * (in_channels // len(self.sizes)),
                                out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        pieces = [x]
        for s in self.sizes:
            ph, pw = H // s, W // s
            pooled = x[:, :, :ph * s, :pw * s].reshape(B, C, s, ph, s, pw).mean(dim=(3, 5))
            pooled = getattr(self, f"stage{s}")(pooled)
            pieces.append(resize_bilinear(pooled, (H, W), align_corners=True))
        return torch.relu(self.bottleneck(torch.cat(pieces, dim=1)))


@MODELS.register("PSPNet")
class PSPNet(ZooModel):
    """Dilated ResNet-50 (stride 8) -> PSPModule(1024) -> dropout 0.3 -> three
    x2 bilinear upsamples (align_corners=False), each a 3x3 conv, BN, a PReLU
    with flax's one scalar slope (initial 0.01) and dropout 0.15 -> 1x1
    classifier. The dropouts are elementwise."""

    LECUN = ("final",)

    def __init__(self, classes: int = 7, loss_config: Mapping | None = None,
                 generator: torch.Generator | None = None, device=None):
        super().__init__(classes, loss_config, -1, generator, device)

    def _build(self):
        self.resnet = ResNet50Backbone(**resnet50_config(8))
        self.psp = PSPModule(RESNET_WIDTHS[-1], 1024)
        cin = 1024
        for i, ch in enumerate((256, 64, 64)):
            setattr(self, f"up{i}_conv", _conv(cin, ch, 3))
            setattr(self, f"up{i}_bn", _bn(ch))
            setattr(self, f"PReLU_{i}", nn.PReLU(1, init=0.01))
            cin = ch
        self.final = nn.Conv2d(cin, self.classes, 1)

    def forward(self, x, y=None, generator=None):
        p = self.psp(self.resnet(x)[-1])
        p = dropout(p, 0.3, self.training, generator)
        for i in range(3):
            p = resize_bilinear(p, (p.shape[-2] * 2, p.shape[-1] * 2))
            p = getattr(self, f"up{i}_bn")(getattr(self, f"up{i}_conv")(p))
            p = dropout(getattr(self, f"PReLU_{i}")(p), 0.15, self.training, generator)
        logit = resize_bilinear(self.final(p), x.shape[-2:])
        return self._loss_or_softmax(logit, y)


class VGG16Features(nn.Module):
    """VGG-16's thirteen 3x3 conv-ReLUs (``conv0`` ... ``conv12``) with 2x2
    max pools (VALID), returning pool3 (256 channels, stride 8), pool4 (512,
    16) and pool5 (512, 32) (`fcn8s.py:16-22`)."""

    CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
           512, 512, 512, "M")

    def __init__(self):
        super().__init__()
        cin, ci = 3, 0
        for v in self.CFG:
            if v != "M":
                setattr(self, f"conv{ci}", _conv(cin, v, 3))
                cin, ci = v, ci + 1

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        outs, ci, pools = [], 0, 0
        for v in self.CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                pools += 1
                if pools >= 3:
                    outs.append(x)
            else:
                x = torch.relu(getattr(self, f"conv{ci}")(x))
                ci += 1
        return outs


@MODELS.register("FCN8s")
class FCN8s(ZooModel):
    """VGG-16 -> 3x3 conv-BN-ReLU (128) -> dropout 0.1 -> class scores, fused
    with pool4's and pool3's by align-corners upsamples."""

    LECUN = ("head_cls", "score_pool4", "score_pool3")

    def __init__(self, classes: int = 7, loss_config: Mapping | None = None,
                 generator: torch.Generator | None = None, device=None):
        super().__init__(classes, loss_config, -1, generator, device)

    def _build(self):
        self.vgg = VGG16Features()
        self.head_conv = _conv(512, 512 // 4, 3, False)
        self.head_bn = _bn(512 // 4)
        self.head_cls = nn.Conv2d(512 // 4, self.classes, 1)
        self.score_pool4 = nn.Conv2d(512, self.classes, 1)
        self.score_pool3 = nn.Conv2d(256, self.classes, 1)

    def forward(self, x, y=None, generator=None):
        pool3, pool4, pool5 = self.vgg(x)
        head = torch.relu(self.head_bn(self.head_conv(pool5)))
        head = dropout(head, 0.1, self.training, generator)
        score_p4, score_p3 = self.score_pool4(pool4), self.score_pool3(pool3)
        up2 = resize_bilinear(self.head_cls(head), score_p4.shape[-2:], True) + score_p4
        up4 = resize_bilinear(up2, score_p3.shape[-2:], True) + score_p3
        return self._loss_or_softmax(resize_bilinear(up4, x.shape[-2:], True), y)


@MODELS.register("AnyUNet")
class AnyUNet(ZooModel):
    """A plain UNet (`unet.py:6-217`): ``depth`` encoder levels of two 3x3
    conv-BN-ReLUs at ``base * 2**d`` channels and a 2x2 max pool, a middle
    conv-BN-ReLU, and decoder levels that resize (align_corners=False), concat
    the skip and apply one conv-BN-ReLU."""

    LECUN = ("head",)

    def __init__(self, classes: int = 7, base: int = 32, depth: int = 4,
                 loss_config: Mapping | None = None,
                 generator: torch.Generator | None = None, device=None):
        self.depth = depth
        super().__init__(classes, loss_config, -1, generator, device, base=base)

    def _build(self, base):
        cin = 3
        for d in range(self.depth):
            ch = base * 2 ** d
            setattr(self, f"e{d}_c1", _conv(cin, ch, 3, False))
            setattr(self, f"e{d}_bn1", _bn(ch))
            setattr(self, f"e{d}_c2", _conv(ch, ch, 3, False))
            setattr(self, f"e{d}_bn2", _bn(ch))
            cin = ch
        self.mid_c, self.mid_bn = _conv(cin, base * 2 ** self.depth, 3, False), \
            _bn(base * 2 ** self.depth)
        cin = base * 2 ** self.depth
        for d in range(self.depth - 1, -1, -1):
            ch = base * 2 ** d
            setattr(self, f"d{d}_c", _conv(cin + ch, ch, 3, False))
            setattr(self, f"d{d}_bn", _bn(ch))
            cin = ch
        self.head = nn.Conv2d(base, self.classes, 1)

    def _cbr(self, x, conv, bn):
        return torch.relu(getattr(self, bn)(getattr(self, conv)(x)))

    def forward(self, x, y=None, generator=None):
        skips, h = [], x
        for d in range(self.depth):
            h = self._cbr(self._cbr(h, f"e{d}_c1", f"e{d}_bn1"), f"e{d}_c2", f"e{d}_bn2")
            skips.append(h)
            h = F.max_pool2d(h, 2, 2)
        h = self._cbr(h, "mid_c", "mid_bn")
        for d in range(self.depth - 1, -1, -1):
            h = torch.cat([resize_bilinear(h, skips[d].shape[-2:]), skips[d]], dim=1)
            h = self._cbr(h, f"d{d}_c", f"d{d}_bn")
        return self._loss_or_softmax(self.head(h), y)


@MODELS.register("FactSeg")
class FactSeg(ZooModel):
    """Foreground-activation factorised net (`factseg.py:10-56`): two FPN +
    AsymmetricDecoder branches, a multiclass foreground head and a binary
    objectness head. Training: {"cls_loss": CE(fg), "bi_loss": BCE with ignore
    of the binary head against (y > 0)}; eval: softmax(fg). ``dtype`` is the JAX
    field, which the JAX model never reads; it is accepted and not read."""

    LECUN = ("fg_cls", "bi_cls")

    def __init__(self, classes: int = 7, fpn_channels: int = 256, decoder_channels: int = 128,
                 ignore_index: int = -1, dtype=torch.float32,
                 generator: torch.Generator | None = None, device=None):
        super().__init__(classes, None, ignore_index, generator, device,
                         fpn_channels=fpn_channels, decoder_channels=decoder_channels)

    def _build(self, fpn_channels, decoder_channels):
        self.resnet = ResNet50Backbone(strides=(2, 2, 2, 2))
        for b in ("fg", "bi"):
            setattr(self, f"{b}_fpn", FPN(RESNET_WIDTHS, fpn_channels))
            setattr(self, f"{b}_decoder", AsymmetricDecoder(fpn_channels, decoder_channels))
        self.fg_cls = nn.Conv2d(decoder_channels, self.classes, 1)
        self.bi_cls = nn.Conv2d(decoder_channels, 1, 1)

    def forward(self, x, y=None, generator=None):
        feats = self.resnet(x)
        fg = self.fg_cls(self.fg_decoder(self.fg_fpn(feats)))
        fg = resize_bilinear(fg, x.shape[-2:], align_corners=True)
        if not self.training:
            return torch.softmax(fg, dim=1)
        y = _labels(y)
        bi = self.bi_cls(self.bi_decoder(self.bi_fpn(feats)))
        bi = resize_bilinear(bi, x.shape[-2:], align_corners=True)
        ig = self.ignore_index
        bi_true = torch.where(y > 0, 1.0, torch.where(y == ig, float(ig), 0.0))
        return {"cls_loss": cross_entropy_ignore(fg, y, ig),
                "bi_loss": binary_cross_entropy_with_logits_ignore(bi[:, 0], bi_true, ig)}


def multi_binary_loss(pred: torch.Tensor, y_true: torch.Tensor, num_fg: int,
                      bce_scaler: float = 1.0, dice_scaler: float = 1.0,
                      label_smooth: float = 0.0, ignore_index: int = -1) -> torch.Tensor:
    """The per-class binary decoupled loss (`CGFL.py:435+`): for each foreground
    class k + 1, BCE with logits (pixels at ``ignore_index`` left out) plus a
    soft dice against the class indicator, 1 smoothed to 1 - label_smooth;
    the mean over the classes. pred (B, num_fg, H, W) logits."""
    losses = []
    for k in range(num_fg):
        tgt = torch.where(y_true == k + 1, 1.0, 0.0)
        tgt = torch.where(y_true == ignore_index, float(ignore_index), tgt)
        if label_smooth:
            tgt = torch.where(tgt == 1.0, 1.0 - label_smooth, tgt)
        bce = binary_cross_entropy_with_logits_ignore(pred[:, k], tgt, ignore_index)
        valid = tgt != ignore_index
        p = torch.sigmoid(pred[:, k]) * valid
        t = tgt * valid
        dice = 1.0 - (2 * (p * t).sum() + 1.0) / (p.sum() + t.sum() + 1.0)
        losses.append(bce_scaler * bce + dice_scaler * dice)
    return sum(losses) / max(num_fg, 1)


@MODELS.register("SemanticFPNDecouple")
class SemanticFPNDecouple(ZooModel):
    """Decoupled per-class binary SemanticFPN (`semantic_fpn.py:84-146`): FPN +
    AsymmetricDecoder + a (classes - 1)-channel binary head. Training:
    {"multi_binary": ``multi_binary_loss``}; eval: the per-class sigmoids
    (B, classes - 1, H, W)."""

    LECUN = ("cls_pred",)

    def __init__(self, classes: int = 7, fpn_channels: int = 256, decoder_channels: int = 128,
                 bce_scaler: float = 1.0, dice_scaler: float = 1.0, label_smooth: float = 0.0,
                 ignore_index: int = -1, generator: torch.Generator | None = None, device=None):
        self.bce_scaler, self.dice_scaler, self.label_smooth = bce_scaler, dice_scaler, label_smooth
        super().__init__(classes, None, ignore_index, generator, device,
                         fpn_channels=fpn_channels, decoder_channels=decoder_channels)

    def _build(self, fpn_channels, decoder_channels):
        self.resnet = ResNet50Backbone(strides=(2, 2, 2, 2))
        self.fpn = FPN(RESNET_WIDTHS, fpn_channels)
        self.decoder = AsymmetricDecoder(fpn_channels, decoder_channels)
        self.cls_pred = nn.Conv2d(decoder_channels, self.classes - 1, 1)

    def forward(self, x, y=None, generator=None):
        pred = self.cls_pred(self.decoder(self.fpn(self.resnet(x))))
        pred = resize_bilinear(pred, x.shape[-2:], align_corners=True)
        if not self.training:
            return torch.sigmoid(pred)
        return {"multi_binary": multi_binary_loss(
            pred, _labels(y), self.classes - 1, self.bce_scaler, self.dice_scaler,
            self.label_smooth, self.ignore_index)}
