"""HRNetV2 backbone (w18/w32/w40/w48) with the RSSFormer transformer fusion, the
port of ``representationlearning_tpu/models/hrnet.py``. Modules carry the
reference's names (`RSSFormer-TIP2023/module/baseline/base_hrnet/_hrnet_rssformer.py`:
``conv1``, ``layer1.0.downsample.0``, ``transition1.1.0.0``,
``stage2.0.branches.1.3.conv2``, ``stage3.2.fuse_layers.0.1.0``,
``stage4.0.transformer.mlp.dw6`` ...), so a reference checkpoint loads as it is.

Structure: two stride-2 3x3 convs -> layer1 (4 Bottlenecks, 64 -> 256) ->
transitions -> stages 2/3/4 of HighResolutionModules (4 BasicBlocks a branch, then
the multi-resolution fuse). The RSSFormer delta (`_hrnet_rssformer.py:410-436`):
in every module's fuse the highest-resolution output is ``transformer(low, y)``,
``low`` the sum of the upsampled lower branches and ``y`` the branch-0 feature,
instead of ``y + low``.

Maps are NCHW. ``dtype`` is the operand type of every convolution (bf16: input,
weight and result in bf16, f32 sums inside); BatchNorm runs in f32 and hands f32
on, as flax's does. BN eps 1e-5, torch momentum 0.1.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.image import resize_nearest
from .layers import BatchNorm2d, conv2d
from .rssformer_modules import GeneralTransformerBlock

HRNET_EXTRA = {
    "hrnetv2_w18": dict(widths=(18, 36, 72, 144)),
    "hrnetv2_w32": dict(widths=(32, 64, 128, 256)),
    "hrnetv2_w40": dict(widths=(40, 80, 160, 320)),
    "hrnetv2_w48": dict(widths=(48, 96, 192, 384)),
}
# stage layout shared by all variants (`_hrnet_rssformer.py:model_extra`)
STAGE_MODULES = (1, 1, 4, 3)   # stage1..4 num_modules
STAGE_BRANCHES = (1, 2, 3, 4)
STAGE_BLOCKS = 4               # blocks per branch, all stages


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=1e-5, momentum=0.1)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


def _conv_bn(seq: nn.Sequential, x: torch.Tensor, dtype) -> torch.Tensor:
    """A reference ``Sequential(conv, bn, ...)``: the conv in `dtype`, then the BN."""
    return seq[1](conv2d(seq[0], x, dtype))


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1, self.bn1 = _conv(inplanes, planes, 3, stride), _bn(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), _bn(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(_conv(inplanes, planes, 1, stride), _bn(planes))

    def forward(self, x):
        out = F.relu(self.bn1(conv2d(self.conv1, x, self.dtype)))
        out = self.bn2(conv2d(self.conv2, out, self.dtype))
        res = x if self.downsample is None else _conv_bn(self.downsample, x, self.dtype)
        return F.relu(out + res)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1, self.bn1 = _conv(inplanes, planes, 1), _bn(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, stride), _bn(planes)
        self.conv3, self.bn3 = _conv(planes, planes * 4, 1), _bn(planes * 4)
        self.downsample = None
        if stride != 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(_conv(inplanes, planes * 4, 1, stride),
                                            _bn(planes * 4))

    def forward(self, x):
        out = F.relu(self.bn1(conv2d(self.conv1, x, self.dtype)))
        out = F.relu(self.bn2(conv2d(self.conv2, out, self.dtype)))
        out = self.bn3(conv2d(self.conv3, out, self.dtype))
        res = x if self.downsample is None else _conv_bn(self.downsample, x, self.dtype)
        return F.relu(out + res)


class FuseUp(nn.Sequential):
    """j > i path: 1x1 conv -> BN -> nearest upsample to the target branch's size
    (the reference's fixed 2^(j-i) Upsample whenever the sizes divide evenly)."""

    def __init__(self, in_ch: int, out_ch: int, dtype=None):
        super().__init__(_conv(in_ch, out_ch, 1), _bn(out_ch))
        self.dtype = dtype

    def forward(self, x, target):
        return resize_nearest(_conv_bn(self, x, self.dtype), target)


class FuseDown(nn.Sequential):
    """j < i path: (i - j) stride-2 3x3 convs, each ``Sequential(conv, bn)``; ReLU
    between them, none at the end."""

    def __init__(self, in_ch: int, out_ch: int, steps: int, dtype=None):
        super().__init__(*(nn.Sequential(_conv(in_ch, out_ch if k == steps - 1 else in_ch, 3, 2),
                                         _bn(out_ch if k == steps - 1 else in_ch))
                           for k in range(steps)))
        self.dtype = dtype

    def forward(self, x):
        for k, step in enumerate(self):
            x = _conv_bn(step, x, self.dtype)
            if k < len(self) - 1:
                x = F.relu(x)
        return x


class HighResolutionModule(nn.Module):
    """Two or more branches (stages 2-4). ``remat_transformer`` recomputes the
    transformer block in the backward pass (``torch.utils.checkpoint``) instead
    of keeping its activations."""

    def __init__(self, num_branches: int, channels: Sequence[int], num_blocks: int = 4,
                 with_transformer: bool = True, dtype=torch.float32, fused_mlp: bool = False, fused_attn: bool = False,
                 remat_transformer: bool = False):
        super().__init__()
        nb = num_branches
        self.num_branches, self.remat_transformer = nb, remat_transformer
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(channels[i], channels[i], dtype=dtype)
                            for _ in range(num_blocks))) for i in range(nb))
        self.transformer = None
        rows = []
        for i in range(nb):
            row = []
            for j in range(nb):
                if j == i:
                    row.append(None)
                elif j > i:
                    row.append(FuseUp(channels[j], channels[i], dtype))
                else:
                    row.append(FuseDown(channels[j], channels[i], i - j, dtype))
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)
        if with_transformer:
            self.transformer = GeneralTransformerBlock(
                channels[0], num_heads=2, dtype=dtype, fused_mlp=fused_mlp,
                fused_attn=fused_attn)

    def forward(self, xs):
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        outs = []
        for i, row in enumerate(self.fuse_layers):
            # y: what branch 0 contributes; low: the sum of the other branches
            y = xs[0] if i == 0 else row[0](xs[0])
            low = None
            for j in range(1, self.num_branches):
                if j == i:
                    t = xs[j]
                elif j > i:
                    t = row[j](xs[j], xs[i].shape[-2:])
                else:
                    t = row[j](xs[j])
                low = t if low is None else low + t
            if i == 0 and self.transformer is not None:
                if self.remat_transformer and torch.is_grad_enabled():
                    y = checkpoint(self.transformer, low, y, use_reentrant=False)
                else:
                    y = self.transformer(low, y)
            else:
                y = y + low
            outs.append(F.relu(y))
        return outs


class Transition(nn.ModuleList):
    """Transition between stages (`_hrnet_rssformer.py:514-546`): a 3x3 conv where
    a kept branch changes width (``{i}.0``, ``{i}.1``), nothing where it does not,
    and a chain of stride-2 convs from the last branch for each new one
    (``{i}.{j}.0``, ``{i}.{j}.1``)."""

    def __init__(self, prev_channels: Sequence[int], cur_channels: Sequence[int], dtype=None):
        n_pre = len(prev_channels)
        entries = []
        for i, ch in enumerate(cur_channels):
            if i < n_pre:
                entries.append(None if ch == prev_channels[i] else
                               nn.Sequential(_conv(prev_channels[i], ch, 3), _bn(ch)))
            else:
                steps = i + 1 - n_pre
                outs = [ch if j == steps - 1 else prev_channels[-1] for j in range(steps)]
                entries.append(nn.Sequential(*(
                    nn.Sequential(_conv(prev_channels[-1], o, 3, 2), _bn(o)) for o in outs)))
        super().__init__(entries)
        self.n_pre, self.dtype = n_pre, dtype

    def forward(self, xs):
        outs = []
        for i, entry in enumerate(self):
            if i < self.n_pre:
                outs.append(xs[i] if entry is None else F.relu(_conv_bn(entry, xs[i], self.dtype)))
            else:
                h = xs[-1]
                for step in entry:
                    h = F.relu(_conv_bn(step, h, self.dtype))
                outs.append(h)
        return outs


class HighResolutionNet(nn.Module):
    """NCHW image -> four maps at strides 4 / 8 / 16 / 32."""

    def __init__(self, hrnet_type: str = "hrnetv2_w32", with_transformer: bool = True,
                 dtype=torch.float32, fused_mlp: bool = False, fused_attn: bool = False,
                 remat_transformer: bool = False):
        super().__init__()
        widths = HRNET_EXTRA[hrnet_type]["widths"]
        self.dtype = dtype
        self.conv1, self.bn1 = _conv(3, 64, 3, 2), _bn(64)
        self.conv2, self.bn2 = _conv(64, 64, 3, 2), _bn(64)
        self.layer1 = nn.Sequential(*(Bottleneck(64 if b == 0 else 256, 64, dtype=dtype)
                                      for b in range(4)))
        prev = (256,)
        for stage, (n_modules, n_branches) in enumerate(
                zip(STAGE_MODULES[1:], STAGE_BRANCHES[1:]), start=2):
            cur = tuple(widths[:n_branches])
            setattr(self, f"transition{stage - 1}", Transition(prev, cur, dtype))
            setattr(self, f"stage{stage}", nn.Sequential(*(
                HighResolutionModule(n_branches, cur, STAGE_BLOCKS,
                                     with_transformer=with_transformer, dtype=dtype,
                                     fused_mlp=fused_mlp, fused_attn=fused_attn,
                                     remat_transformer=remat_transformer)
                for _ in range(n_modules))))
            prev = cur

    def forward(self, x):
        x = F.relu(self.bn1(conv2d(self.conv1, x, self.dtype)))
        x = F.relu(self.bn2(conv2d(self.conv2, x, self.dtype)))
        feats = [self.layer1(x)]
        for stage in (2, 3, 4):
            feats = getattr(self, f"transition{stage - 1}")(feats)
            feats = getattr(self, f"stage{stage}")(feats)
        return feats
