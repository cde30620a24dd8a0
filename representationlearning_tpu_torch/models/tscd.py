"""TSCD, the SCD end-to-end WSSS model (`SCD-AAAI2023/network/TSCD_model.py`), the
port of ``representationlearning_tpu/models/tscd.py``.

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
from ..ops.image import adaptive_avg_pool_11, adaptive_max_pool_11
from .layers import AttnProj, init_weights
from .mit import MIT_CONFIGS, MixVisionTransformer
from .segformer_head import SegFormerHead


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
