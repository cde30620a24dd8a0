"""RSSFormer (`RSSFormer-TIP2023/module/baseline/hrnet_aux.py:70-134`), the port
of ``representationlearning_tpu/models/rssformer.py``.

HRNetV2 encoder with transformer fusion + SimpleFusion8 neck (every branch
upsampled to stride 4 with align_corners=True, concat, 1x1 conv-BN-ReLU; it also
hands on the raw branch-0 feature) + 1x1 classifier head with a x4 bilinear
upsample (align_corners=True) + an auxiliary linear head on the pooled branch-0
feature. NCHW in and out. In eval mode the forward returns the softmax
probabilities (B, classes, H, W). In training mode it returns ``(logit,
aux_logits)``. The JAX model applies the CGFL loss inside its training call;
here the train step applies it (``train/rssformer.py`` with
``losses/cgfl.py::segmentation_loss_aux``), reading ``loss_config`` and
``ignore_index`` from the model, which holds them as the JAX model does.

Modules carry the reference's state_dict names (``backbone.hrnet.*``,
``neck.fuse_conv.0``, ``head.0``, ``headaux.0``). ``fused_mlp`` runs every
transformer block's FFN on kernel K5 and ``fused_attn`` its window-attention core
on kernel K6. ``fused_attn`` is the one name here that the JAX package lacks:
there the K6 kernel is reachable through ``Mhca(fused=True)`` only, which no
model sets; the flag carries that choice from the model down to ``Mhca``.

``hrnet_type`` names an HRNetV2 width (``hrnetv2_w18`` ... ``w48``) or an
HRFormer variant (``hrt_small``, ``hrt_base``, ``hrt_base_win13``,
``hrt_base_win15``: ``models/hrt.py``, the reference's swap of the encoder's
import at `hrnet_encoder.py:7-8`), under the same ``backbone.hrnet.`` prefix. The
HRFormer has no MlpDWBN, no fusion transformer and no remat: ``fused_mlp``,
``fused_attn`` and ``remat_transformer`` raise with it, and ``with_transformer``
does not apply to it. In training its drop path draws its masks from the
``generator`` of ``forward`` (a CPU ``torch.Generator``; None is the global one).

The model is built on the card: ``device=None`` means ``torch.device("cuda")`` and
construction raises where there is none; the CPU is the caller's explicit choice
(``device="cpu"``). The initial weights depend on the generator only.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..core.registry import MODELS
from ..ops.image import adaptive_avg_pool_11, resize_bilinear
from .hrnet import HRNET_EXTRA, HighResolutionNet
from .hrt import HRT_CONFIGS, HighResolutionTransformerNet
from .layers import BatchNorm2d, conv2d, init_weights


class SimpleFusion8(nn.Module):
    """``dtype`` is the type in which the upsampled maps are concatenated and the
    1x1 conv multiplies (bf16 halves the (B, sum(widths), H/4, W/4) concat); None
    keeps f32."""

    def __init__(self, in_channels: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.fuse_conv = nn.Sequential(nn.Conv2d(in_channels, in_channels, 1),
                                       BatchNorm2d(in_channels, eps=1e-5, momentum=0.1))

    def forward(self, feats: Sequence[torch.Tensor]):
        x0 = feats[0]
        tgt = x0.shape[-2:]
        ups = [x0] + [resize_bilinear(f, tgt, align_corners=True) for f in feats[1:]]
        if self.dtype is not None:
            ups = [u.to(self.dtype) for u in ups]
        x = self.fuse_conv[1](conv2d(self.fuse_conv[0], torch.cat(ups, dim=1), self.dtype))
        return F.relu(x), x0


class _Encoder(nn.Module):
    """The reference's `HRNetEncoder` wrapper: the net lives under ``hrnet``."""

    def __init__(self, hrnet: nn.Module):
        super().__init__()
        self.hrnet = hrnet

    def forward(self, x, generator: torch.Generator | None = None):
        if isinstance(self.hrnet, HighResolutionTransformerNet):
            return self.hrnet(x, generator)
        return self.hrnet(x)   # draws nothing: its transformer blocks' drop path is 0


@MODELS.register("RSSFormer")
class HRNetFusion(nn.Module):
    def __init__(self, hrnet_type: str = "hrnetv2_w32", classes: int = 7,
                 upsample_scale: int = 4, with_transformer: bool = True,
                 loss_config: Mapping | None = None, ignore_index: int = -1,
                 dtype=torch.float32, fused_mlp: bool = False, fused_attn: bool = False,
                 remat_transformer: bool = False, neck_bf16: bool = False,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        hrt = hrnet_type in HRT_CONFIGS
        if hrt:
            flags = [n for n, on in (("fused_mlp", fused_mlp), ("fused_attn", fused_attn),
                                     ("remat_transformer", remat_transformer)) if on]
            if flags:
                raise ValueError(f"{', '.join(flags)}: the HRT backbone ({hrnet_type}) has no "
                                 "MlpDWBN, fusion transformer or remat to apply it to")
            widths = HRT_CONFIGS[hrnet_type]["channels"]
        else:
            widths = HRNET_EXTRA[hrnet_type]["widths"]
        self.upsample_scale = upsample_scale
        # the CGFL losses the train step applies (None: {"ce": {}}, as in JAX)
        self.loss_config, self.ignore_index = loss_config, ignore_index
        with resolve_device(device):  # parameters and buffers are created there
            if hrt:
                net = HighResolutionTransformerNet(hrnet_type, dtype)
            else:
                net = HighResolutionNet(hrnet_type, with_transformer=with_transformer,
                                        dtype=dtype, fused_mlp=fused_mlp, fused_attn=fused_attn,
                                        remat_transformer=remat_transformer)
            self.backbone = _Encoder(net)
            self.neck = SimpleFusion8(sum(widths), torch.bfloat16 if neck_bf16 else None)
            self.head = nn.Sequential(nn.Conv2d(sum(widths), classes, 1))
            self.headaux = nn.Sequential(nn.Linear(widths[0], classes))
        init_weights(self, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        feats = self.backbone(x, generator)
        fused, f0 = self.neck(feats)
        aux_logits = self.headaux(adaptive_avg_pool_11(f0).flatten(1))
        logit = self.head(fused)
        size = (logit.shape[-2] * self.upsample_scale, logit.shape[-1] * self.upsample_scale)
        logit = resize_bilinear(logit, size, align_corners=True)
        if self.training:
            return logit, aux_logits
        return torch.softmax(logit, dim=1)
