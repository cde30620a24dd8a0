"""DRFL's dual-stream medical segmentation net ("Softnet"/DCL), the port of
``representationlearning_tpu/models/dcl.py`` (parity with `DRFL-EAAI2023/model/DCL.py`).

Architecture (`DCL.py:247-344`):
- shared UNet encoder: 4x4/s2 stem + 4 Encode layers (BasicBlock w/ channel+edge
  attention -> 4x4/s2 conv -> per-channel GroupNorm -> LeakyReLU 0.2)
- one decoder stack REUSED for both streams (the reference calls decode1..4 twice —
  the seg/sr branches share weights and differ only through dropout randomness);
  in training each call moves the BatchNorms' running statistics in turn
- ViT bottleneck refiners on the 1/2-resolution decoder features: `Transformer`
  (self, gated q/k/v AttentionW) and `Transformer2` (cross: q/k from the sr stream,
  v from the seg stream) with the reference's (B, n, 768) -> (B, 3, H, W)
  channel-major reshape; output gate map multiplies the sr stream
- `Softnethead` refinement UNet takes (seg out, sr out) -> final `bin` mask
- returns (out, out2, bin, d5_a, d5sr_a) (`:344`)

NCHW, f32 throughout (the JAX ``Softnet.dtype`` is unused). Module names are the
JAX package's flax scopes (``firstConv``, ``encode1.basic.conv1``,
``encode1.down_gn``, ``decode1.up_conv``, ``decode1.prelu``,
``transformer.block0.query``, ``transformer.position_embeddings``,
``softnethead.end.conv``); ``convert/from_jax.py::dcl_state_dict_from_jax`` maps a
JAX variable tree onto them. The JAX package has no DCL converter and no
reference checkpoint was at hand, so the names are not checked against one.

Known differences from torch's defaults, so that the port computes what the JAX
package does: GroupNorm's epsilon is flax's 1e-6 (torch's default is 1e-5);
BatchNorm follows flax (``layers.BatchNorm2d``). The transposed convolutions are
``nn.ConvTranspose2d``, whose weight is the JAX kernel (kh, kw, in, out)
transposed to (in, out, kh, kw) and flipped in both spatial axes.

Dropout (``decode1`` and ``softnethead.decode1`` at 0.5, each ViT block's MLP at
0.1, twice) goes through this module's name ``dropout`` (``layers.dropout``) with
the generator the forward is given, in the JAX package's order of calls.

The position embeddings fix the input side: a model is built for one ``side``
and its forward raises ``ValueError`` on another. Models are built on the card
unless ``device`` says otherwise; their weights depend on the generator only.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..core.registry import MODELS
from .layers import GN_EPS, BatchNorm2d, _draw, dropout, fan_out_conv_init

GATE = 1.0 / (1.0 + math.exp(-0.1))        # sigmoid(0.1): the frozen q/k/v gates (`DCL.py:414-416`)
_TRUNC_STD = 0.87962566103423978           # std of a unit normal truncated at +-2


def _lecun_normal(w: torch.Tensor, fan_in: int, generator=None) -> None:
    """flax's lecun_normal: a normal truncated at +-2 of its standard deviations,
    scaled to variance 1 / fan_in. Drawn by rejection (entries beyond +-2 drawn
    again), the same law as ``trunc_normal_init``'s inverse CDF at a tenth of its
    time for the 170 M weights of the full model's linears."""

    def fill(u):
        flat = u.view(-1).normal_(generator=generator)
        idx = (flat.abs() > 2.0).nonzero().squeeze(1)
        while idx.numel():
            r = torch.randn(idx.numel(), generator=generator)
            flat[idx] = r
            idx = idx[r.abs() > 2.0]
        return u.mul_(fan_in ** -0.5 / _TRUNC_STD)

    _draw(w, fill)


def init_dcl(module: nn.Module, generator: torch.Generator | None = None) -> None:
    """The JAX package's initialisers over a module tree: convolutions
    ``TorchConv``'s fan-out normal, transposed convolutions and linears lecun
    normal, every bias 0; norms ones / zeros, PReLU 0.25 and the position
    embeddings 0 as constructed."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_out_conv_init(m.weight, generator=generator)
        elif isinstance(m, nn.ConvTranspose2d):
            w = m.weight                                 # (in, out, kh, kw)
            _lecun_normal(w, w.shape[0] * w.shape[2] * w.shape[3], generator)
        elif isinstance(m, nn.Linear):
            _lecun_normal(m.weight, m.weight.shape[1], generator)
        else:
            continue
        if m.bias is not None:
            nn.init.zeros_(m.bias)


class ChannelAttention(nn.Module):
    """`DCL.py:44-60`: the first 1x1 conv has in_planes // 16 outputs whatever
    ``ratio`` says, as in the reference."""

    def __init__(self, in_planes: int, ratio: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(in_planes, in_planes // 16, 1, bias=False)
        self.fc2 = nn.Conv2d(in_planes // 16, in_planes, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = x.mean(dim=(2, 3), keepdim=True)
        mx = x.amax(dim=(2, 3), keepdim=True)
        out = self.fc2(F.relu(self.fc1(avg))) + self.fc2(F.relu(self.fc1(mx)))
        return torch.sigmoid(out)


class EdgeAttention(nn.Module):
    """`DCL.py:22-43`: channel-mean-subtracted edge map + mean map -> 3x3 conv gate."""

    def __init__(self, planes: int, kernel_size: int = 3):
        super().__init__()
        p = 1 if kernel_size == 3 else 3
        self.conv1 = nn.Conv2d(planes, 1, kernel_size, padding=p, bias=False)
        self.conv2 = nn.Conv2d(2, 1, kernel_size, padding=p, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = x.mean(dim=1, keepdim=True)
        edge = self.conv1(x - avg)
        return torch.sigmoid(self.conv2(torch.cat([edge, avg], dim=1)))


class DCLBasicBlock(nn.Module):
    """Residual block with channel+edge attention (`DCL.py:62-98`)."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.ca = ChannelAttention(planes)
        self.ea = EdgeAttention(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        out = self.ca(out) * out
        out = self.ea(out) * out
        return F.relu(out + x)


class EncodeLayer(nn.Module):
    """BasicBlock -> 4x4/s2 conv -> per-channel GroupNorm -> LeakyReLU(0.2)
    (`DCL.py:99-112`)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.basic = DCLBasicBlock(in_ch)
        self.down_conv = nn.Conv2d(in_ch, out_ch, 4, 2, 1, bias=False)
        self.down_gn = nn.GroupNorm(out_ch, out_ch, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.down_gn(self.down_conv(self.basic(x)))
        return F.leaky_relu(x, 0.2)


class DecodeLayer(nn.Module):
    """BasicBlock -> 4x4/s2 transpose conv -> GroupNorm -> PReLU [-> dropout 0.5]
    (`DCL.py:113-131`)."""

    def __init__(self, in_ch: int, out_ch: int, use_dropout: bool = False):
        super().__init__()
        self.use_dropout = use_dropout
        self.basic = DCLBasicBlock(in_ch)
        self.up_conv = nn.ConvTranspose2d(in_ch, out_ch, 4, 2, 1, bias=False)
        self.up_gn = nn.GroupNorm(out_ch, out_ch, eps=GN_EPS)
        self.prelu = nn.PReLU(1, init=0.25)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.prelu(self.up_gn(self.up_conv(self.basic(x))))
        if self.use_dropout:
            x = dropout(x, 0.5, self.training, generator)
        return x


class EndLayer(nn.Module):
    """transpose-conv (4/2/1 or 3/1/1) + sigmoid (`DCL.py:132-165`)."""

    def __init__(self, in_ch: int, kernel: int = 4, stride: int = 2):
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_ch, 1, kernel, stride, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.conv(x))


class GatedViTBlock(nn.Module):
    """AttentionW(2) + MLP pre-LN block: q/k/v each scaled by the sigmoid(0.1)
    gates (`DCL.py:394-449` AttentionW, `:580-624` Block/Block2). ``cross=True``
    takes q/k from the second stream, v from the first (`:475-489`). The MLP's
    activation is ReLU: the reference maps "gelu" to it (`DCL.py:363`)."""

    def __init__(self, hidden: int = 768, heads: int = 12, mlp_dim: int = 3072,
                 cross: bool = False, drop: float = 0.1):
        super().__init__()
        self.heads, self.cross, self.drop = heads, cross, drop
        self.attention_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)
        self.ffn_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.fc1 = nn.Linear(hidden, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, hidden)

    def forward(self, x: torch.Tensor, x2: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B, N, C = x.shape
        hd = C // self.heads
        xa = self.attention_norm(x)
        src = self.attention_norm(x2) if self.cross else xa

        def heads(t):   # (B, N, C) -> (B, heads, N, hd), gated
            return t.reshape(B, N, self.heads, hd).transpose(1, 2) * GATE

        q, k, v = heads(self.query(src)), heads(self.key(src)), heads(self.value(xa))
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        ctx = (attn @ v).transpose(1, 2).reshape(B, N, C)
        x = x + self.out(ctx)
        y = F.relu(self.fc1(self.ffn_norm(x)))
        y = dropout(y, self.drop, self.training, generator)
        y = dropout(self.fc2(y), self.drop, self.training, generator)
        return x + y


class DCLTransformer(nn.Module):
    """`Transformer`/`Transformer2` (`DCL.py:666-753`): 16x16 patch embed of the 64-ch
    1/2-res map (one conv shared by both streams) -> gated ViT encoder ->
    channel-major reshape to (B, 3, H, W) -> plus two 1x1 skip convs -> 1x1 head
    to ``out_ch``. ``n_tokens`` (the patch count) fixes the input side."""

    def __init__(self, in_ch: int, out_ch: int, n_tokens: int, cross: bool = False,
                 num_layers: int = 12, hidden: int = 768):
        super().__init__()
        self.cross, self.num_layers = cross, num_layers
        self.patch_embeddings = nn.Conv2d(in_ch, hidden, 16, 16)
        self.position_embeddings = nn.Parameter(torch.zeros(1, n_tokens, hidden))
        if cross:
            self.position_embeddings2 = nn.Parameter(torch.zeros(1, n_tokens, hidden))
        for i in range(num_layers):
            setattr(self, f"block{i}", GatedViTBlock(hidden, cross=cross))
        self.encoder_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.start1 = nn.Conv2d(in_ch, 3, 1)
        self.start2 = nn.Conv2d(in_ch, 3, 1)
        self.end = nn.Conv2d(3, out_ch, 1)

    def forward(self, x: torch.Tensor, x2: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B, _, H, W = x.shape

        def embed(v, pos):   # (B, C, H, W) -> (B, n, hidden), patches in row-major order
            return self.patch_embeddings(v).flatten(2).transpose(1, 2) + pos

        tokens = embed(x, self.position_embeddings)
        tokens2 = embed(x2, self.position_embeddings2) if self.cross else None
        for i in range(self.num_layers):
            tokens = getattr(self, f"block{i}")(tokens, tokens2, generator)
        tokens = self.encoder_norm(tokens)
        # the reference's view of (B, hidden, n) as (B, 3, H, W), channel-major
        m = tokens.transpose(1, 2).reshape(B, 3, H // 16 * 16, W // 16 * 16)
        m = self.start1(x) + m + self.start2(x)
        return self.end(m)


class Softnethead(nn.Module):
    """Refinement UNet over (seg out, sr out) (`DCL.py:167-219`)."""

    def __init__(self):
        super().__init__()
        self.firstConv = nn.Conv2d(1, 63, 4, 2, 1, bias=False)
        for i in range(1, 5):
            setattr(self, f"encode{i}", EncodeLayer(64, 64))
        self.decode1 = DecodeLayer(64, 64, use_dropout=True)
        self.decode2 = DecodeLayer(128, 64)
        self.decode3 = DecodeLayer(128, 64)
        self.decode4 = DecodeLayer(128, 64)
        self.end = EndLayer(128, 3, 1)

    def forward(self, x: torch.Tensor, sr: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        e0 = torch.cat([F.leaky_relu(self.firstConv(sr), 0.2), x], dim=1)   # 64 ch
        e1 = self.encode1(e0)
        e2 = self.encode2(e1)
        e3 = self.encode3(e2)
        e4 = self.encode4(e3)
        d2 = self.decode1(e4, generator)
        d3 = self.decode2(torch.cat([d2, e3], dim=1))
        d4 = self.decode3(torch.cat([d3, e2], dim=1))
        d5 = self.decode4(torch.cat([d4, e1], dim=1))
        return self.end(torch.cat([d5, e0], dim=1))


@MODELS.register("Softnet")
class Softnet(nn.Module):
    """Full DCL net for ``side`` x ``side`` inputs (a multiple of 32). Input
    (B, input_nc, side, side) in [-1, 1]; returns (out (B, 1, side, side), out2
    (B, 1, 2 side, 2 side), bin (B, 1, side, side), d5_a, d5sr_a (B, 64, side / 2,
    side / 2)) like `DCL.py:344`. ``generator`` (a CPU ``torch.Generator``) draws
    the weights; the forward's draws the dropout masks in training."""

    def __init__(self, input_nc: int = 3, num_vit_layers: int = 12, side: int = 256,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        if side <= 0 or side % 32:
            raise ValueError(f"Softnet's side must be a positive multiple of 32, got {side}")
        self.side = side
        n_tokens = (side // 32) ** 2   # 16 x 16 patches of the side / 2 decoder map
        with resolve_device(device):   # parameters and buffers are created there
            self.firstConv = nn.Conv2d(input_nc, 64, 4, 2, 1, bias=False)
            self.encode1 = EncodeLayer(64, 128)
            self.encode2 = EncodeLayer(128, 256)
            self.encode3 = EncodeLayer(256, 512)
            self.encode4 = EncodeLayer(512, 512)
            self.decode1 = DecodeLayer(512, 512, use_dropout=True)
            self.decode2 = DecodeLayer(1024, 256)
            self.decode3 = DecodeLayer(512, 128)
            self.decode4 = DecodeLayer(256, 64)
            self.transformer = DCLTransformer(64, 64, n_tokens, num_layers=num_vit_layers)
            self.decode5 = DecodeLayer(128, 128)
            self.end2 = EndLayer(128, 4, 2)
            self.transformer2 = DCLTransformer(64, 1, n_tokens, cross=True,
                                               num_layers=num_vit_layers)
            self.end = EndLayer(192, 4, 2)
            self.softnethead = Softnethead()
        init_dcl(self, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        if tuple(x.shape[-2:]) != (self.side, self.side):
            raise ValueError(
                f"Softnet was built for {self.side} x {self.side} inputs (its position "
                f"embeddings fix the side), got {x.shape[-2]} x {x.shape[-1]}")
        e0 = F.leaky_relu(self.firstConv(x), 0.2)
        e1 = self.encode1(e0)
        e2 = self.encode2(e1)
        e3 = self.encode3(e2)
        e4 = self.encode4(e3)

        def run_decoder():
            d2 = self.decode1(e4, generator)
            d3 = self.decode2(torch.cat([d2, e3], dim=1))
            d4 = self.decode3(torch.cat([d3, e2], dim=1))
            return self.decode4(torch.cat([d4, e1], dim=1))

        d5 = run_decoder()
        d5_a = self.transformer(d5, generator=generator)
        # sr stream: the same decoder modules run again (`DCL.py:302-311` reuses them)
        d5sr = run_decoder()
        d5sr_a = self.transformer(d5sr, generator=generator)
        out2 = self.end2(self.decode5(torch.cat([d5sr, e0], dim=1)))
        gate = self.transformer2(d5_a, d5sr_a, generator=generator)
        out = self.end(torch.cat([d5, d5sr * gate, e0], dim=1))   # 192 ch
        binm = self.softnethead(out, out2, generator)
        return out, out2, binm, d5_a, d5sr_a


@MODELS.register("PixelDiscriminator")
class PixelDiscriminator(nn.Module):
    """1x1 PatchGAN discriminator (`model_dcl.py` netD='pixel') over ``input_nc``
    channels (flax infers them; torch needs them)."""

    def __init__(self, input_nc: int = 4, ndf: int = 64,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        with resolve_device(device):
            self.conv1 = nn.Conv2d(input_nc, ndf, 1)
            self.conv2 = nn.Conv2d(ndf, ndf * 2, 1, bias=False)
            self.bn = BatchNorm2d(ndf * 2)
            self.conv3 = nn.Conv2d(ndf * 2, 1, 1)
        init_dcl(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.conv1(x), 0.2)
        x = F.leaky_relu(self.bn(self.conv2(x)), 0.2)
        return self.conv3(x)
