"""RSSFormer transformer modules, the port of
``representationlearning_tpu/models/rssformer_modules.py`` (the part the HRNet
backbone uses) with the reference's module names
(`RSSFormer-TIP2023/module/baseline/base_hrnet/modules/`):

- ``SpatialAttention``: channel mean and max -> 7x7 conv -> sigmoid gate map.
- ``InterlacedPoolAttention2``: softmax fusion of the two input streams from their
  gate maps, 7x7 window partition (centre-padded, contiguous windows), then
  cross attention (q from x, k and v from y) through ``Mhca``.
- ``Mhca``: multi-head attention with separate projections, q scaled before the
  product, and the DAL channel gate. ``fused=True`` runs the core on kernel K6
  (``ops/isa_attention.py``).
- ``MlpDWBN``: 1x1 conv-BN-GELU -> sum of {1x1, 3x3 d6, 3x3 d12} full convs ->
  BN-GELU -> 1x1 conv-BN-GELU. ``fused=True`` runs inference on kernel K5
  (``ops/mlp_dwbn.py``); the unfused module uses the exact erf, K5 the A&S one
  (1.5e-7 apart in f32).
- ``GeneralTransformerBlock``: pre-LN attention + MlpDWBN with drop-path
  residuals on tokens; takes and returns NCHW maps.

Maps are NCHW; tokens are (B, N, C) with N = H * W row-major; the window helpers
work on (B, H, W, C) as in the JAX package. ``dtype`` is the operand type of the
attention products and of the FFN's convolutions; LayerNorm, BatchNorm, softmax
and GELU run in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.isa_attention import isa_attention_core
from ..ops.mit_block import mm
from ..ops.mlp_dwbn import fold_bn_affine, fused_mlp_dwbn
from .layers import BatchNorm2d, DropPath, conv2d


class SpatialAttention(nn.Module):
    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) -> the sigmoid gate map (B, 1, H, W)."""
        h = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.conv1(h))


def window_pad(x: torch.Tensor, ws: int):
    """Centre-pad H, W of (B, H, W, C) to multiples of ws (`PadBlock.pad_if_needed`)."""
    _, H, W, _ = x.shape
    ph, pw = (-H) % ws, (-W) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    return x, (H, W)


def window_depad(x: torch.Tensor, orig_hw, ws: int) -> torch.Tensor:
    H, W = orig_hw
    ph, pw = (-H) % ws, (-W) % ws
    if ph or pw:
        x = x[:, ph // 2: ph // 2 + H, pw // 2: pw // 2 + W, :]
    return x


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * qh * qw, ws * ws, C), contiguous ws x ws blocks."""
    B, H, W, C = x.shape
    qh, qw = H // ws, W // ws
    x = x.reshape(B, qh, ws, qw, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * qh * qw, ws * ws, C)


def window_reverse(x: torch.Tensor, ws: int, B: int, H: int, W: int) -> torch.Tensor:
    qh, qw = H // ws, W // ws
    C = x.shape[-1]
    x = x.reshape(B, qh, qw, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


class Mhca(nn.Module):
    """Cross multi-head attention with separate q/k/v projections
    (`DAL.py:676-1030`): q scaled by hd^-0.5 before the product, and the DAL
    channel gate (`DAL.py:1005-1016`): the attention output of a head is
    multiplied by sigmoid(mean(M) + max(M)), M = q_h^T k_h summed over the tokens.

    The gate needs as many key tokens as query tokens; another count raises.

    ``fused=True`` runs scores, softmax, gate and weighted sum on kernel K6 in
    every call that drops no probability (eval mode, or ``dropout == 0``). A
    training call with live dropout is not K6's function and takes the plain
    products below, as the JAX module does: ``fused`` then launches nothing. The
    parameters are the same either way."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = True, fused: bool = False, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.dropout, self.fused, self.dtype = num_heads, dropout, fused, dtype
        self.q_proj = nn.Linear(embed_dim, embed_dim, bias=bias)
        self.k_proj = nn.Linear(embed_dim, embed_dim, bias=bias)
        self.v_proj = nn.Linear(embed_dim, embed_dim, bias=bias)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, key, value):
        """query (B, S, C), key and value (B, T, C) -> (B, S, C)."""
        B, S, C = query.shape
        nh, hd = self.num_heads, C // self.num_heads
        if key.shape[1] != S:
            raise ValueError(f"Mhca: the DAL gate needs as many key tokens as query tokens, "
                             f"got {key.shape[1]} and {S}")
        q = self.q_proj(query) * hd ** -0.5
        k = self.k_proj(key)
        v = self.v_proj(value)
        drops = self.training and self.dropout > 0.0
        if self.fused and not drops:
            return self.out_proj(isa_attention_core(q, k, v, nh, self.dtype))
        q = q.reshape(B, S, nh, hd).transpose(1, 2)
        k = k.reshape(B, -1, nh, hd).transpose(1, 2)
        v = v.reshape(B, -1, nh, hd).transpose(1, 2)
        attn = torch.softmax(mm(q, k.transpose(-1, -2), self.dtype), dim=-1)
        attn = F.dropout(attn, self.dropout, self.training)
        out = mm(attn, v, self.dtype)
        # the DAL channel gate
        m = mm(q.transpose(-1, -2), k, self.dtype)                    # (B, nh, hd, hd)
        alpha = torch.sigmoid(m.mean(dim=(2, 3), keepdim=True) + m.amax(dim=(2, 3), keepdim=True))
        out = (out * alpha).transpose(1, 2).reshape(B, S, C)
        return self.out_proj(out)


class InterlacedPoolAttention2(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, window_size: int = 7,
                 attn_drop: float = 0.0, dtype=torch.float32, fused_attn: bool = False):
        super().__init__()
        self.window_size = window_size
        self.atrous_block1 = SpatialAttention()
        self.atrous_block2 = SpatialAttention()
        self.weight_levels = nn.Conv2d(2, 2, 1)
        self.attn = Mhca(embed_dim, num_heads, attn_drop, fused=fused_attn, dtype=dtype)

    def forward(self, x: torch.Tensor, y: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """x, y: (B, N, C) token streams -> (B, N, C).

        The reference calls ``.view(B, C, H, W)`` on the contiguous (B, N, C)
        tokens (`multihead_isa_pool_attention.py:150-151`): a raw row-major
        reinterpretation, not a permute. It gates that view and ``.view(B, H, W,
        C)``s the product, again raw, before windowing. Trained weights encode
        this scramble, so the same two views are taken here, on contiguous
        tokens."""
        B, N, C = x.shape
        xv = x.contiguous().view(B, C, H, W)
        yv = y.contiguous().view(B, C, H, W)
        lv = torch.cat([self.atrous_block1(xv), self.atrous_block2(yv)], dim=1)
        lv = torch.softmax(self.weight_levels(lv), dim=1)              # (B, 2, H, W)
        xm = (xv * lv[:, 0:1]).view(B, H, W, C)
        ym = (yv * lv[:, 1:2]).view(B, H, W, C)

        ws = self.window_size
        xp, orig = window_pad(xm, ws)
        yp, _ = window_pad(ym, ws)
        Hp, Wp = xp.shape[1:3]
        yw = window_partition(yp, ws)
        out = self.attn(window_partition(xp, ws), yw, yw)
        out = window_depad(window_reverse(out, ws, B, Hp, Wp), orig, ws)
        return out.reshape(B, N, C)


class MlpDWBN(nn.Module):
    """The RSSFormer FFN (`ffn_block.py:207-270`). Its "dw" convs are full
    hid x hid convolutions despite the name. ``fused=True`` runs an eval-mode
    call on kernel K5. K5 folds the running statistics into its epilogues, so it
    is the eval function only: a training call takes the convs below (BatchNorm
    needs the batch) and launches nothing, as the JAX module does."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 dtype=torch.float32, fused: bool = False):
        super().__init__()
        hid = hidden_features
        self.dtype, self.fused = dtype, fused
        self.fc1 = nn.Conv2d(in_features, hid, 1)
        self.norm1 = BatchNorm2d(hid, eps=1e-5, momentum=0.1)
        self.dw = nn.Conv2d(hid, hid, 1)
        self.dw6 = nn.Conv2d(hid, hid, 3, padding=6, dilation=6)
        self.dw12 = nn.Conv2d(hid, hid, 3, padding=12, dilation=12)
        self.norm2 = BatchNorm2d(hid, eps=1e-5, momentum=0.1)
        self.fc2 = nn.Conv2d(hid, out_features, 1)
        self.norm3 = BatchNorm2d(out_features, eps=1e-5, momentum=0.1)

    def kernel_params(self) -> dict[str, torch.Tensor]:
        p = {"fc1_weight": self.fc1.weight, "fc1_bias": self.fc1.bias,
             "dw1_weight": self.dw.weight, "dw6_weight": self.dw6.weight,
             "dw12_weight": self.dw12.weight,
             "dw_bias": self.dw.bias + self.dw6.bias + self.dw12.bias,
             "fc2_weight": self.fc2.weight, "fc2_bias": self.fc2.bias}
        for i, bn in enumerate((self.norm1, self.norm2, self.norm3), start=1):
            p[f"bn{i}_scale"], p[f"bn{i}_shift"] = fold_bn_affine(
                bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
        return p

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """x (B, N, C) tokens -> (B, N, out_features)."""
        B, N, C = x.shape
        if self.fused and not self.training:
            return fused_mlp_dwbn(x, self.kernel_params(), H=H, W=W, dtype=self.dtype)
        h = x.transpose(1, 2).reshape(B, C, H, W)
        h = F.gelu(self.norm1(conv2d(self.fc1, h, self.dtype)))
        h = conv2d(self.dw, h, self.dtype) + conv2d(self.dw6, h, self.dtype) \
            + conv2d(self.dw12, h, self.dtype)
        h = F.gelu(self.norm2(h))
        h = F.gelu(self.norm3(conv2d(self.fc2, h, self.dtype)))
        return h.flatten(2).transpose(1, 2)


class GeneralTransformerBlock(nn.Module):
    """The MTFM / Adaptive-TransFusion block (`MTFM.py:48-120`). Inputs are NCHW
    maps (x the summed lower-resolution fusion, y the high-resolution branch);
    the residuals are on tokens; the output is an NCHW map."""

    def __init__(self, dim: int, num_heads: int = 2, window_size: int = 7,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0, attn_drop: float = 0.0,
                 dtype=torch.float32, fused_mlp: bool = False, fused_attn: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = InterlacedPoolAttention2(dim, num_heads, window_size, attn_drop,
                                             dtype=dtype, fused_attn=fused_attn)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MlpDWBN(dim, int(dim * mlp_ratio), dim, dtype=dtype, fused=fused_mlp)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B, C, H, W = x.shape
        xt = x.float().flatten(2).transpose(1, 2).contiguous()        # (B, N, C)
        yt = y.float().flatten(2).transpose(1, 2).contiguous()
        a = self.attn(self.norm1(xt), self.norm1(yt), H, W)
        xt = xt + self.drop_path(a, generator=generator)
        m = self.mlp(self.norm2(xt), H, W)
        xt = xt + self.drop_path(m, generator=generator)
        return xt.transpose(1, 2).reshape(B, C, H, W)
