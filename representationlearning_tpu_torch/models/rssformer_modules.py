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

The reference's other attention and FFN blocks, which no model of either
package uses yet (their names follow the JAX package's scopes, checked against
no reference checkpoint): ``DALMultiheadAttention``, ``Mlp``, ``MlpDW``,
``MultiheadAttention2``, ``MlpLight``, ``MlpConvBN`` and ``dilated_conv``.

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
from .layers import BatchNorm2d, DropPath, conv2d, dropout, trunc_normal_init


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


class DALMultiheadAttention(nn.Module):
    """DAL self-attention (`DAL.py:14-343`, `multihead_isa_attention.py` MHA_): a
    joint in-projection, the optional ``residual_attn`` logits added before the
    softmax, and the optional Swin relative-position bias over a window_size x
    window_size grid (`multihead_isa_attention.py:28-52`), indexed
    (rel0 + ws - 1)(2 ws - 1) + (rel1 + ws - 1). The products are f32: the JAX
    module declares a ``dtype`` it never reads, and the port takes none."""

    def __init__(self, embed_dim: int, num_heads: int, rpe: bool = False,
                 window_size: int = 7):
        super().__init__()
        self.num_heads, self.rpe, self.window_size = num_heads, rpe, window_size
        self.in_proj = nn.Linear(embed_dim, 3 * embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        if rpe:
            self.relative_position_bias_table = nn.Parameter(
                torch.empty((2 * window_size - 1) ** 2, num_heads))
            trunc_normal_init(self.relative_position_bias_table)

    def _position_bias(self) -> torch.Tensor:
        """(nh, S, S) with S = ws * ws."""
        ws = self.window_size
        i = torch.arange(ws, device=self.relative_position_bias_table.device)
        coords = torch.stack(torch.meshgrid(i, i, indexing="ij")).reshape(2, -1)
        rel = coords[:, :, None] - coords[:, None, :]
        idx = (rel[0] + ws - 1) * (2 * ws - 1) + (rel[1] + ws - 1)
        S = ws * ws
        return self.relative_position_bias_table[idx.reshape(-1)].reshape(S, S, -1).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, residual_attn: torch.Tensor | None = None):
        """x (B, S, C) -> (out (B, S, C), logits (B, nh, S, S) before the softmax)."""
        B, S, C = x.shape
        nh = self.num_heads
        hd = C // nh
        q, k, v = self.in_proj(x).reshape(B, S, 3, nh, hd).permute(2, 0, 3, 1, 4)
        logits = (q @ k.transpose(-1, -2)) * hd ** -0.5
        if self.rpe:
            if S != self.window_size ** 2:
                raise ValueError(f"rpe needs window tokens: {S} != {self.window_size}^2")
            logits = logits + self._position_bias()[None]
        if residual_attn is not None:
            logits = logits + residual_attn
        out = torch.softmax(logits, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(B, S, C)), logits


class Mlp(nn.Module):
    """The token MLP (`ffn_block.py:6-29`): fc1 -> exact GELU -> dropout -> fc2 ->
    dropout."""

    def __init__(self, in_features: int, hidden: int, out: int, drop: float = 0.0):
        super().__init__()
        self.drop = drop
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = dropout(F.gelu(self.fc1(x)), self.drop, self.training)
        return dropout(self.fc2(x), self.drop, self.training)


class MlpDW(nn.Module):
    """1x1 conv -> GELU -> 3x3 depthwise conv -> GELU -> 1x1 conv on tokens
    (`ffn_block.py:52-103`)."""

    def __init__(self, in_features: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Conv2d(in_features, hidden, 1)
        self.dw3x3 = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Conv2d(hidden, out, 1)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """x (B, N, C) tokens, N = H * W row-major -> (B, N, out)."""
        B, N, C = x.shape
        h = x.transpose(1, 2).reshape(B, C, H, W)
        h = F.gelu(self.dw3x3(F.gelu(self.fc1(h))))
        return self.fc2(h).flatten(2).transpose(1, 2)


class MultiheadAttention2(nn.Module):
    """`DAL.py:344-675`: separate q / k / v projections, q scaled by hd^-0.5 before
    the product, the optional pre-softmax ``residual_attn`` (broadcastable to (B,
    nh, S, T)), dropout on the probabilities; ``Mhca`` without the channel gate.
    ``dtype`` is the operand type of the two products (f32 sums)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 use_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.dropout, self.dtype = num_heads, dropout, dtype
        self.q_proj = nn.Linear(embed_dim, embed_dim, bias=use_bias)
        self.k_proj = nn.Linear(embed_dim, embed_dim, bias=use_bias)
        self.v_proj = nn.Linear(embed_dim, embed_dim, bias=use_bias)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, key, value, residual_attn: torch.Tensor | None = None):
        """query (B, S, C), key and value (B, T, C) -> (B, S, C)."""
        B, S, C = query.shape
        nh = self.num_heads
        hd = C // nh
        q = (self.q_proj(query) * hd ** -0.5).reshape(B, S, nh, hd).transpose(1, 2)
        k = self.k_proj(key).reshape(B, -1, nh, hd).transpose(1, 2)
        v = self.v_proj(value).reshape(B, -1, nh, hd).transpose(1, 2)
        logits = mm(q, k.transpose(-1, -2), self.dtype)
        if residual_attn is not None:
            logits = logits + residual_attn
        attn = dropout(torch.softmax(logits, dim=-1), self.dropout, self.training)
        out = mm(attn, v, self.dtype).transpose(1, 2).reshape(B, S, C)
        return self.out_proj(out)


class MlpLight(nn.Module):
    """`ffn_block.py:32-50`: one Linear, exact GELU, dropout, on tokens."""

    def __init__(self, dim: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.fc1 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(F.gelu(self.fc1(x)), self.dropout, self.training)


class MlpConvBN(nn.Module):
    """`ffn_block.py:295-338`: two 1x1 Conv1d + BatchNorm1d blocks over the
    channels of (B, N, C) tokens (a Conv1d of width 1 is a Linear; the
    BatchNorm's statistics run over B and N, with flax's momentum and biased
    variance through ``BatchNorm2d``), GELU between them, dropout after each."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.bn1 = BatchNorm2d(hidden_features, eps=1e-5, momentum=0.1)
        self.fc2 = nn.Linear(hidden_features, out_features)
        self.bn2 = BatchNorm2d(out_features, eps=1e-5, momentum=0.1)

    @staticmethod
    def _bn(bn: BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        return bn(x.reshape(B * N, C, 1, 1)).reshape(B, N, C)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = dropout(F.gelu(self._bn(self.bn1, self.fc1(x))), self.dropout, self.training)
        return dropout(self._bn(self.bn2, self.fc2(h)), self.dropout, self.training)


def dilated_conv(ch_in: int, ch_out: int, k: int, d: int = 1, stride: int = 1) -> nn.Conv2d:
    """`ffn_block.py:105-128` DilatedConv: a conv without bias at dilation d,
    padding ((k - 1) // 2) * d."""
    return nn.Conv2d(ch_in, ch_out, k, stride, padding=((k - 1) // 2) * d, dilation=d,
                     bias=False)
