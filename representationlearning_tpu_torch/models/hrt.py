"""The HRFormer (High-Resolution Transformer) backbone, the port of
``representationlearning_tpu/models/hrt.py`` (`RSSFormer-TIP2023/module/baseline/
base_hrnet/hrt_backbone.py:113` module, `:370` net; `hrt_config.py` variants).

The HRNetV2 multi-branch topology with a transformer block in every stage-2/3/4
branch: pre-LN interlaced window self-attention (window pad, contiguous 7 x 7
windows, ``Mhca`` with q = k = v) on a drop-path residual. The reference's FFN
is commented out in its forward and its ``norm2`` is dead, so neither is created
(``cli/convert_checkpoint.py`` drops ``norm2`` from a reference checkpoint). The
fuse's down paths are depthwise-separable stride-2 convs; the up paths are 1x1
conv + BN + nearest upsample, as in HRNetV2.

Modules carry the reference's names, as ``convert_hrt`` of the JAX package reads
them: ``conv1``, ``layer1.0.downsample.0``, ``transition1.1.0.0``,
``stage3.2.branches.1.0.attn.attn.q_proj``, ``stage2.0.fuse_layers.0.1.0`` (up),
``stage4.1.fuse_layers.3.0.2.1`` (down: ``.{step}.{0 dw, 1 bn, 2 pw, 3 bn}``).

Maps are NCHW. ``dtype`` reaches the window attention's products only: the
convolutions, Bottlenecks, transitions and fuse paths compute in f32 whatever it
says, as in the JAX package.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .hrnet import Bottleneck, FuseUp, Transition, _bn, _conv
from .layers import DropPath
from .rssformer_modules import Mhca, window_depad, window_pad, window_partition, window_reverse

HRT_CONFIGS = {
    # `hrt_config.py:14-58`; RSSFormer's `hrt_backbone.hrnetv2_w32` builds hrt_small
    "hrt_small": dict(
        stage1_planes=32, stage1_blocks=2,
        channels=(32, 64, 128, 256), num_heads=(1, 2, 4, 8),
        num_modules=(1, 4, 2), num_blocks=2, window=7, drop_path_rate=0.2,
    ),
    # `hrt_config.py:60-105`
    "hrt_base": dict(
        stage1_planes=64, stage1_blocks=2,
        channels=(78, 156, 312, 624), num_heads=(2, 4, 8, 16),
        num_modules=(1, 4, 2), num_blocks=2, window=7, drop_path_rate=0.2,
    ),
    "hrt_base_win13": dict(
        stage1_planes=64, stage1_blocks=2,
        channels=(78, 156, 312, 624), num_heads=(2, 4, 8, 16),
        num_modules=(1, 4, 2), num_blocks=2, window=13, drop_path_rate=0.2,
    ),
    "hrt_base_win15": dict(
        stage1_planes=64, stage1_blocks=2,
        channels=(78, 156, 312, 624), num_heads=(2, 4, 8, 16),
        num_modules=(1, 4, 2), num_blocks=2, window=15, drop_path_rate=0.2,
    ),
}


class ISASelfAttention(nn.Module):
    """`InterlacedPoolAttention` (`multihead_isa_pool_attention.py:11-49`):
    centre-pad to a window multiple, group contiguous ws x ws windows,
    self-attend with ``Mhca``, then reverse and depad."""

    def __init__(self, embed_dim: int, num_heads: int, window_size: int = 7,
                 dtype=torch.float32):
        super().__init__()
        self.window_size = window_size
        self.attn = Mhca(embed_dim, num_heads, dtype=dtype)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """x (B, N, C) tokens, N = H * W row-major -> (B, N, C)."""
        B, N, C = x.shape
        ws = self.window_size
        xp, orig = window_pad(x.reshape(B, H, W, C), ws)
        Hp, Wp = xp.shape[1:3]
        xw = window_partition(xp, ws)
        out = window_reverse(self.attn(xw, xw, xw), ws, B, Hp, Wp)
        return window_depad(out, orig, ws).reshape(B, N, C)


class HRTBlock(nn.Module):
    """`GeneralTransformerBlock` (`transformer_block.py:52-115`):
    x + drop_path(ISA(LN(x))) on tokens, LayerNorm eps 1e-6; NCHW in and out."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 drop_path: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = ISASelfAttention(dim, num_heads, window_size, dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        B, C, H, W = x.shape
        t = x.flatten(2).transpose(1, 2)
        t = t + self.drop_path(self.attn(self.norm1(t), H, W), generator=generator)
        return t.transpose(1, 2).reshape(B, C, H, W)


class HRTFuseDown(nn.Sequential):
    """The j < i fuse path (`hrt_backbone.py:276-330`): (i - j) steps, each
    ``Sequential(3x3 depthwise stride-2 conv, BN, 1x1 conv, BN)``; ReLU between
    steps, none after the last. Intermediate steps keep ``in_ch``."""

    def __init__(self, in_ch: int, out_ch: int, steps: int):
        super().__init__(*(nn.Sequential(
            nn.Conv2d(in_ch, in_ch, 3, 2, 1, groups=in_ch, bias=False), _bn(in_ch),
            _conv(in_ch, out_ch if k == steps - 1 else in_ch, 1),
            _bn(out_ch if k == steps - 1 else in_ch)) for k in range(steps)))

    def forward(self, x):
        for k, (dw, dwbn, pw, pwbn) in enumerate(self):
            x = pwbn(pw(dwbn(dw(x))))
            if k < len(self) - 1:
                x = F.relu(x)
        return x


class HighResolutionTransformerModule(nn.Module):
    """`hrt_backbone.py:113-368`: each branch's transformer blocks, then the
    multi-resolution fuse: output i sums every branch brought to branch i (itself
    for j = i, ``FuseUp`` for j > i, ``HRTFuseDown`` for j < i), in branch order,
    then ReLU."""

    def __init__(self, num_branches: int, channels: Sequence[int], num_heads: Sequence[int],
                 num_blocks: int = 2, window_size: int = 7,
                 drop_paths: Sequence[float] = (0.0, 0.0), dtype=torch.float32):
        super().__init__()
        nb = num_branches
        self.branches = nn.ModuleList(
            nn.ModuleList(HRTBlock(channels[i], num_heads[i], window_size, drop_paths[b], dtype)
                          for b in range(num_blocks)) for i in range(nb))
        self.fuse_layers = nn.ModuleList(
            nn.ModuleList(None if j == i else FuseUp(channels[j], channels[i]) if j > i
                          else HRTFuseDown(channels[j], channels[i], i - j) for j in range(nb))
            for i in range(nb))

    def forward(self, xs, generator: torch.Generator | None = None):
        xs = list(xs)
        for i, blocks in enumerate(self.branches):
            for blk in blocks:
                xs[i] = blk(xs[i], generator)
        outs = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, path in enumerate(row):
                t = xs[j] if j == i else path(xs[j], xs[i].shape[-2:]) if j > i else path(xs[j])
                y = t if y is None else y + t
            outs.append(F.relu(y))
        return outs


class HighResolutionTransformerNet(nn.Module):
    """`HighResolutionTransformer` (`hrt_backbone.py:370-696`) without its ImageNet
    head: the two-conv stem, stage 1 of Bottlenecks, then stages 2-4 of
    transformer modules (1, 4, 2 of them) behind the HRNet transitions; the
    stochastic-depth rates rise linearly over all the stages' blocks,
    rate * i / (n - 1), two blocks a module in order. NCHW image -> four maps at
    strides 4 / 8 / 16 / 32. In training the drop-path masks are drawn from
    ``generator`` (a CPU ``torch.Generator``; None is the global one)."""

    def __init__(self, hrt_type: str = "hrt_small", dtype=torch.float32):
        super().__init__()
        cfg = HRT_CONFIGS[hrt_type]
        widths, planes = cfg["channels"], cfg["stage1_planes"]
        self.conv1, self.bn1 = _conv(3, 64, 3, 2), _bn(64)
        self.conv2, self.bn2 = _conv(64, 64, 3, 2), _bn(64)
        self.layer1 = nn.Sequential(*(Bottleneck(64 if b == 0 else planes * 4, planes)
                                      for b in range(cfg["stage1_blocks"])))
        nblk = cfg["num_blocks"]
        total = nblk * sum(cfg["num_modules"])
        dpr = [cfg["drop_path_rate"] * i / max(total - 1, 1) for i in range(total)]
        prev, first = (planes * 4,), 0   # the index in dpr of a module's first block
        for stage, n_modules in enumerate(cfg["num_modules"], start=2):
            cur = tuple(widths[:stage])
            setattr(self, f"transition{stage - 1}", Transition(prev, cur))
            setattr(self, f"stage{stage}", nn.ModuleList(
                HighResolutionTransformerModule(
                    stage, cur, cfg["num_heads"][:stage], nblk, cfg["window"],
                    dpr[first + m * nblk:first + (m + 1) * nblk], dtype)
                for m in range(n_modules)))
            first += nblk * n_modules
            prev = cur

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        feats = [self.layer1(x)]
        for stage in (2, 3, 4):
            feats = getattr(self, f"transition{stage - 1}")(feats)
            for module in getattr(self, f"stage{stage}"):
                feats = module(feats, generator)
        return feats
