"""SegFormer all-MLP decode head in the reference form (`SCD-AAAI2023/network/
segformer_head.py`), the port of ``representationlearning_tpu/models/segformer_head.py``.

Per-stage linear embed -> bilinear upsample to the stride-4 grid
(align_corners=False) -> concat [c4, c3, c2, c1] -> 1x1 fuse conv -> BN (eps
1e-5) -> ReLU -> dropout (elementwise, as the JAX head's ``nn.Dropout``) -> 1x1
classifier. With ``dtype=bfloat16`` the embeds
and the fused map are stored in bf16 (f32 accumulation inside the products), and
BN runs in f32, as the JAX head does. The JAX package's sliced-fuse rewrite
(`_SlicedFuseConv`) is a TPU lowering of the same math and is not ported.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.image import resize_bilinear
from .layers import BatchNorm2d, dropout


class _MLP(nn.Module):
    """Reference `MLP`: a Linear over the flattened grid, named `proj`."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Linear(in_dim, embed_dim)


class _ConvModule(nn.Module):
    """mmcv ConvModule (conv without bias, BN, ReLU): names `conv`, `bn`."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        self.bn = BatchNorm2d(out_ch, eps=1e-5, momentum=0.1)


class SegFormerHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 embedding_dim: int = 256, dropout_rate: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        for i, c in enumerate(in_channels, start=1):
            setattr(self, f"linear_c{i}", _MLP(c, embedding_dim))
        self.linear_fuse = _ConvModule(embedding_dim * 4, embedding_dim)
        self.dropout_rate = dropout_rate
        self.linear_pred = nn.Conv2d(embedding_dim, num_classes, 1)

    def forward(self, feats: Sequence[torch.Tensor],
                generator: torch.Generator | None = None) -> torch.Tensor:
        """generator: the source of the training-mode dropout mask (see
        ``layers.dropout``); None is the global one."""
        c1 = feats[0]
        B, _, h, w = c1.shape
        embeds = []
        for i in (4, 3, 2, 1):
            c = feats[i - 1]
            proj = getattr(self, f"linear_c{i}").proj
            tok = c.flatten(2).transpose(1, 2)                        # (B, hw, Cin)
            e = F.linear(tok.to(self.dtype), proj.weight.to(self.dtype),
                         proj.bias.to(self.dtype))
            e = e.transpose(1, 2).reshape(B, -1, c.shape[2], c.shape[3])
            embeds.append(resize_bilinear(e, (h, w), align_corners=False))
        x = torch.cat(embeds, dim=1)
        x = F.conv2d(x, self.linear_fuse.conv.weight.to(self.dtype))
        x = self.linear_fuse.bn(x)           # f32, flax's running update
        x = dropout(F.relu(x), self.dropout_rate, self.training, generator)
        return self.linear_pred(x)
