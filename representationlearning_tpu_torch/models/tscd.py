"""TSCD, the SCD end-to-end WSSS model (`SCD-AAAI2023/network/TSCD_model.py`), the
port of ``representationlearning_tpu/models/tscd.py``, with its plain baseline
``WeTrBaseline`` and the dilated-conv head ``LargeFOV``.

MiT encoder + SegFormer head + affinity head (``AttnProj`` over the last two
exported attention maps -> sigmoid) + CAM classifier (1x1, no bias) on the
stage-4 features. NCHW in and out:
- ``cam_only=True`` -> (cam_s4 (B, C-1, h, w), attn_pred)
- default           -> (cls_logits (B, C-1), seg (B, C, H/4, W/4), attns, attn_pred)
``attn_pred`` is None under ``collect_attns="none"``. In training mode the
drop-path masks and the head's dropout mask are drawn from ``generator`` (a CPU
``torch.Generator``; None is the global one).

The model is built on the card: ``device=None`` means ``torch.device("cuda")``
and construction raises where there is none; the CPU is the caller's explicit
choice (``device="cpu"``, as the tests do). The initial weights depend on the
generator only, not on the device.
"""
from __future__ import annotations

import torch
from torch import nn

from .._device import resolve_device
from ..core.registry import MODELS
from ..ops.image import adaptive_avg_pool_11, adaptive_max_pool_11
from .layers import AttnProj, init_weights, lecun_normal_init
from .mit import MIT_CONFIGS, MixVisionTransformer
from .segformer_head import SegFormerHead


@MODELS.register("TSCD")
class TSCD(nn.Module):
    def __init__(self, backbone: str = "mit_b1", num_classes: int = 21,
                 embedding_dim: int = 256, strides=(4, 2, 2, 1), pooling: str = "gmp",
                 use_flash: bool = False, fused_blocks: bool = False,
                 collect_attns: bool | str = "last2", dtype=torch.float32,
                 act_dtype=None, remat: bool = False, pre_sr: bool = False,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        if pooling not in ("gmp", "gap"):
            raise ValueError(f"pooling: {pooling!r}")
        self.num_classes, self.pooling = num_classes, pooling
        cfg = dict(MIT_CONFIGS[backbone])
        with resolve_device(device):  # parameters and buffers are created there
            self.encoder = MixVisionTransformer(
                strides=tuple(strides), dtype=dtype, use_flash=use_flash,
                fused_blocks=fused_blocks, collect_attns=collect_attns,
                act_dtype=act_dtype, remat=remat, pre_sr=pre_sr, **cfg)
            self.decoder = SegFormerHead(cfg["embed_dims"], num_classes, embedding_dim,
                                         dtype=dtype)
            # 2 stage-4 blocks x 8 heads = 16 input channels (`TSCD_model.py:38`)
            self.attn_proj = AttnProj(16)
            self.classifier = nn.Conv2d(cfg["embed_dims"][3], num_classes - 1, 1,
                                        bias=False)
        init_weights(self, generator)

    def _pool(self, x):
        return adaptive_max_pool_11(x) if self.pooling == "gmp" else adaptive_avg_pool_11(x)

    def forward(self, x: torch.Tensor, cam_only: bool = False,
                generator: torch.Generator | None = None):
        feats, attns = self.encoder(x, generator)
        x4 = feats[3]
        attn_pred = torch.sigmoid(self.attn_proj(attns[-2:])) if attns else None
        if cam_only:
            return self.classifier(x4).detach(), attn_pred
        cls_logits = self.classifier(self._pool(x4)).reshape(x.shape[0], self.num_classes - 1)
        seg = self.decoder(feats, generator)
        return cls_logits, seg, attns, attn_pred


@MODELS.register("WeTrBaseline")
class WeTrBaseline(nn.Module):
    """The plain WeTr baseline (`SCD-AAAI2023/network/model_bsl.py:8-71`): the MiT
    encoder without attention export, the SegFormer head and the CAM classifier,
    no affinity head. Names as ``TSCD``'s (``encoder.*``, ``decoder.*``,
    ``classifier.weight``). NCHW in and out:
    - ``cam_only=True`` -> the detached stage-4 CAM (B, C-1, h, w)
    - default           -> (cls_logits (B, C-1), seg (B, C, H/4, W/4))
    ``fused_blocks`` runs every encoder block on kernel K1, whose CUDA kernels
    take bf16 compute only: on the card it needs ``dtype=torch.bfloat16``."""

    def __init__(self, backbone: str = "mit_b1", num_classes: int = 21,
                 embedding_dim: int = 256, strides=(4, 2, 2, 1), pooling: str = "gmp",
                 fused_blocks: bool = False, dtype=torch.float32,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        if pooling not in ("gmp", "gap"):
            raise ValueError(f"pooling: {pooling!r}")
        self.num_classes, self.pooling = num_classes, pooling
        cfg = dict(MIT_CONFIGS[backbone])
        with resolve_device(device):  # parameters and buffers are created there
            self.encoder = MixVisionTransformer(
                strides=tuple(strides), dtype=dtype, fused_blocks=fused_blocks,
                collect_attns=False, **cfg)
            self.decoder = SegFormerHead(cfg["embed_dims"], num_classes, embedding_dim,
                                         dtype=dtype)
            self.classifier = nn.Conv2d(cfg["embed_dims"][3], num_classes - 1, 1,
                                        bias=False)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor, cam_only: bool = False,
                generator: torch.Generator | None = None):
        feats, _ = self.encoder(x, generator)
        x4 = feats[3]
        if cam_only:
            return self.classifier(x4).detach()
        pooled = adaptive_max_pool_11(x4) if self.pooling == "gmp" else adaptive_avg_pool_11(x4)
        cls_logits = self.classifier(pooled).reshape(x.shape[0], self.num_classes - 1)
        return cls_logits, self.decoder(feats, generator)


class LargeFOV(nn.Module):
    """The dilated-conv DeepLab head (`SCD-AAAI2023/network/conv_head.py:11-39`):
    two 3x3 convs to 512 channels at dilation and padding ``dilation``, each with
    ReLU, then a 1x1 conv to ``out_planes``; biases on all three. The JAX module
    infers ``in_planes`` and names its convs ``Conv_0..2``; the port takes the
    width as an argument and keeps those names. Weights flax's lecun normal, zero
    biases."""

    def __init__(self, in_planes: int, out_planes: int, dilation: int = 12,
                 generator: torch.Generator | None = None):
        super().__init__()
        d = dilation
        self.Conv_0 = nn.Conv2d(in_planes, 512, 3, padding=d, dilation=d)
        self.Conv_1 = nn.Conv2d(512, 512, 3, padding=d, dilation=d)
        self.Conv_2 = nn.Conv2d(512, out_planes, 1)
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            lecun_normal_init(conv.weight, generator)
            nn.init.zeros_(conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.Conv_0(x))
        x = torch.relu(self.Conv_1(x))
        return self.Conv_2(x)


def share_parameters(twin: nn.Module, model: nn.Module) -> nn.Module:
    """Make every parameter and buffer of ``twin`` the very tensor that ``model``
    holds under the same name, so the twin (for example the fused bf16 CAM model
    of the SCD trainer, `cli/train_scd.py:146-149` of the JAX package) always
    runs on the trained model's current weights. Returns the twin."""
    params, buffers = dict(model.named_parameters()), dict(model.named_buffers())
    for prefix, mod in twin.named_modules():
        for store, source in ((mod._parameters, params), (mod._buffers, buffers)):
            for leaf in store:
                if store[leaf] is not None:
                    store[leaf] = source[f"{prefix}.{leaf}" if prefix else leaf]
    return twin
