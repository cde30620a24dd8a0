"""The RML model (`RML/network/RML_model.py`), its class predictor and the WeTr
attention-affinity zoo (`RML/backbone/model_attn_aff.py`): the port of
``representationlearning_tpu/models/rml.py``. NCHW in and out.

Over SCD's TSCD, RML REPLACES the SegFormer head by a ``SimpleFusion8`` neck (all
stages upsampled to 1/4 with align_corners=True, concatenated, a 1x1 conv to a
hard-coded 15 channels, BatchNorm, ReLU; `RML_model.py:100-126`), adds
``ClassPredictor`` (`:129-157`) and optionally the PATM wave block on the CAM
(`backbone/model_attn_aff.py:126`). The JAX package's ``s2d_stem`` and
``taps_stem`` are TPU lowerings of the stage-1 stem and are not ported.

Models are built on the card: ``device=None`` means ``torch.device("cuda")`` and
construction raises where there is none; the CPU is the caller's explicit choice
(``device="cpu"``). The weights depend on ``generator`` only, not on the device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..core.registry import MODELS
from ..ops.image import adaptive_avg_pool_11, adaptive_max_pool_11, resize_bilinear
from .layers import AttnProj, BatchNorm2d, init_weights
from .mit import MIT_CONFIGS, MixVisionTransformer
from .segformer_head import SegFormerHead
from .wavemlp import PATM


class SimpleFusionNeck(nn.Module):
    """`SimpleFusion8` (`RML_model.py:100-126`): concat every stage at 1/4 (bilinear,
    align_corners=True), 1x1 conv to ``out_ch``, BatchNorm (flax's running
    update, see ``layers.BatchNorm2d``), ReLU. The reference's names:
    ``fuse_conv.0`` (conv), ``fuse_conv.1`` (BatchNorm)."""

    def __init__(self, in_channels: int, out_ch: int = 15):
        super().__init__()
        self.fuse_conv = nn.Sequential(nn.Conv2d(in_channels, out_ch, 1),
                                       BatchNorm2d(out_ch, eps=1e-5, momentum=0.1))

    def forward(self, feats) -> torch.Tensor:
        x0 = feats[0]
        ups = [x0] + [resize_bilinear(f, x0.shape[-2:], align_corners=True) for f in feats[1:]]
        return F.relu(self.fuse_conv[1](self.fuse_conv[0](torch.cat(ups, dim=1))))


def _pool(x: torch.Tensor, pooling: str) -> torch.Tensor:
    return adaptive_max_pool_11(x) if pooling == "gmp" else adaptive_avg_pool_11(x)


@MODELS.register("RML")
class RMLModel(nn.Module):
    """MiT encoder + ``SimpleFusionNeck`` seg output + affinity head (``AttnProj``
    over the last two exported attention maps -> sigmoid) + CAM classifier (1x1,
    no bias) on the stage-4 features, optionally followed by PATM on the CAM.

    - ``cam_only=True`` -> (cam (B, C - 1, h, w), detached, attn_pred or None)
    - default           -> (cls_logits (B, C - 1), seg (B, seg_classes, H/4, W/4),
      attns, attn_pred)

    ``fused_blocks``, ``collect_attns``, ``dtype`` and ``act_dtype`` are those of
    ``MixVisionTransformer``; the CAM twin of the RML train step is
    ``RMLModel(fused_blocks=True, collect_attns="none")`` on the trained model's
    parameters (``tscd.share_parameters``)."""

    def __init__(self, backbone: str = "mit_b1", num_classes: int = 21, seg_classes: int = 15,
                 strides=(4, 2, 2, 1), pooling: str = "gmp", use_wave: bool = False,
                 fused_blocks: bool = False, collect_attns: bool | str = "last2",
                 dtype=torch.float32, act_dtype=None,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        if pooling not in ("gmp", "gap"):
            raise ValueError(f"pooling: {pooling!r}")
        self.num_classes, self.pooling, self.use_wave = num_classes, pooling, use_wave
        cfg = dict(MIT_CONFIGS[backbone])
        with resolve_device(device):  # parameters and buffers are created there
            self.encoder = MixVisionTransformer(
                strides=tuple(strides), dtype=dtype, fused_blocks=fused_blocks,
                collect_attns=collect_attns, act_dtype=act_dtype, **cfg)
            self.neck = SimpleFusionNeck(sum(cfg["embed_dims"]), seg_classes)
            self.attn_proj = AttnProj(16)   # 2 stage-4 blocks x 8 heads
            self.classifier = nn.Conv2d(cfg["embed_dims"][3], num_classes - 1, 1, bias=False)
            if use_wave:
                self.wave = PATM(num_classes - 1)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor, cam_only: bool = False,
                generator: torch.Generator | None = None):
        feats, attns = self.encoder(x, generator)
        x4 = feats[3]
        attn_pred = torch.sigmoid(self.attn_proj(attns[-2:])) if attns else None
        if cam_only:
            cam = self.classifier(x4)
            if self.use_wave:
                cam = self.wave(cam)
            return cam.detach(), attn_pred
        seg = self.neck(feats)
        cls_logits = self.classifier(_pool(x4, self.pooling)).reshape(
            x.shape[0], self.num_classes - 1)
        return cls_logits, seg, attns, attn_pred


@MODELS.register("rml_class_predictor")
class ClassPredictor(nn.Module):
    """`Class_Predictor` (`RML_model.py:129-157`): masked per-class cross-entropy
    over class features, the loss over the batch size, the accuracy over the count
    of present classes. The weight is the reference's 1x1 ``classifier`` conv."""

    def __init__(self, num_classes: int = 20, representation_size: int = 512,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        with resolve_device(device):
            self.classifier = nn.Conv2d(representation_size, num_classes, 1, bias=False)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        """x (B, num_classes, representation_size), label (B, num_classes) ->
        (loss, acc)."""
        B, C, _ = x.shape
        logits = torch.einsum("bcf,kf->bck", x, self.classifier.weight[:, :, 0, 0])
        diag_nll = -torch.diagonal(torch.log_softmax(logits, dim=-1), dim1=1, dim2=2)
        mask = (label > 0).to(logits.dtype)
        per_sample = (diag_nll * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1.0)
        correct = ((logits.argmax(dim=-1) == torch.arange(C, device=x.device)) * mask).sum()
        return per_sample.sum() / B, correct / mask.sum().clamp(min=1.0)


@MODELS.register("wetr_attn_aff")
class WeTrAttnAff(nn.Module):
    """The WeTr attention-affinity research zoo reduced to two axes; see the JAX
    package's ``WeTrAttnAff`` for the table of reference classes.

    attn_source, what feeds the 16 -> 1 ``attn_proj`` affinity head:
      "attns":   the concat of the last two exported stage-4 attention maps;
      "x4_last": ``attn_proj1(x4)`` (512 -> 8) bilinearly upsampled
                 (align_corners=True) to the (N, N) attention grid, concat with
                 the last exported map;
      "x4_prev": the same with the map before it.
    wave_mode, where the PATM wave block sits:
      "none"; "stage4": x4 = PATM(x4) feeding the affinity, the classifier and
      the CAM but NOT the decoder, which reads the stage-4 map from before the
      wave (`model_attn_aff.py:836-840`); "post_cls": PATM on the pooled
      (B, C - 1, 1, 1) class logits, then ``classifier2``.
    State_dict names are the reference's (``convert/torch2jax.py::convert_wetr_attn_aff``).
    """

    def __init__(self, backbone: str = "mit_b1", num_classes: int = 21,
                 embedding_dim: int = 256, strides=(4, 2, 2, 1), pooling: str = "gmp",
                 attn_source: str = "x4_prev", wave_mode: str = "stage4",
                 dtype=torch.float32, generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        if attn_source not in ("attns", "x4_last", "x4_prev"):
            raise ValueError(f"unknown attn_source {attn_source!r}")
        if wave_mode not in ("none", "stage4", "post_cls"):
            raise ValueError(f"unknown wave_mode {wave_mode!r}")
        if pooling not in ("gmp", "gap"):
            raise ValueError(f"pooling: {pooling!r}")
        self.num_classes, self.pooling = num_classes, pooling
        self.attn_source, self.wave_mode = attn_source, wave_mode
        cfg = dict(MIT_CONFIGS[backbone])
        dims = cfg["embed_dims"]
        with resolve_device(device):
            self.encoder = MixVisionTransformer(strides=tuple(strides), dtype=dtype, **cfg)
            self.decoder = SegFormerHead(dims, num_classes, embedding_dim, dtype=dtype)
            # 16 input channels either way: 2 maps x 8 heads, or 8 heads + 8 from x4
            self.attn_proj = nn.Conv2d(16, 1, 1)
            if attn_source != "attns":
                self.attn_proj1 = nn.Conv2d(dims[3], 8, 1)
            self.classifier = nn.Conv2d(dims[3], num_classes - 1, 1, bias=False)
            if wave_mode == "post_cls":
                self.classifier2 = nn.Conv2d(num_classes - 1, num_classes - 1, 1, bias=False)
                self.wave = PATM(num_classes - 1)
            elif wave_mode == "stage4":
                self.wave = PATM(dims[3])
        init_weights(self, generator)

    def forward(self, x: torch.Tensor, cam_only: bool = False,
                generator: torch.Generator | None = None):
        feats, attns = self.encoder(x, generator)
        x4 = feats[3]
        if self.wave_mode == "stage4":
            x4 = self.wave(x4)
        if self.attn_source == "attns":
            attn_cat = torch.cat(attns[-2:], dim=1)
        else:
            other = attns[-1] if self.attn_source == "x4_last" else attns[-2]
            nk = other.shape[3]
            x4a = resize_bilinear(self.attn_proj1(x4), (nk, nk), align_corners=True)
            attn_cat = torch.cat([other, x4a], dim=1)
        attn_pred = torch.sigmoid(self.attn_proj(attn_cat)[:, 0])

        cls = self.classifier(_pool(x4, self.pooling))
        if self.wave_mode == "post_cls":
            cls = self.classifier2(self.wave(cls))
        if cam_only:
            cam = cls if self.wave_mode == "post_cls" else self.classifier(x4)
            return cam.detach(), attn_pred
        seg = self.decoder(feats, generator)   # the stage-4 map from before the wave
        return cls.reshape(x.shape[0], self.num_classes - 1), seg, attns, attn_pred
