"""Wave-MLP PATM block (RML), the port of ``representationlearning_tpu/models/wavemlp.py``
(`RML/backbone/wavemlp.py:133-201`). NCHW in and out.

PATM, phase-aware token mixing: amplitude 1x1 convs ``fc_h`` / ``fc_w`` / ``fc_c``,
phase convs ``theta_h_conv`` / ``theta_w_conv`` (a 1x1 conv with bias in "fc"
mode; a depthwise 3x3 + BatchNorm ``theta_{h,w}_bn`` + ReLU in "conv" mode, the
JAX package's names), cos / sin modulation into 2C channels, grouped (1, 7) /
(7, 1) token FCs ``tfc_h`` / ``tfc_w``, a 3-way softmax reweighting from pooled
features (``reweight.fc1`` / ``reweight.fc2``, with the reference's
channel-major (B, 3C) -> (B, C, 3) pairing) and the 1x1 projection ``proj``.
The "fc" names are those ``convert/torch2jax.py::_add_patm_rules`` reads.
``WaveBlock`` wraps it with BatchNorm pre-norms, residuals and an MLP. Both keep
PyTorch's default initialisation until the model that holds them applies
``layers.init_weights`` with its generator.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d, DropPath


class _Mlp(nn.Module):
    """The reference's ``Mlp`` of two 1x1 convs: ``fc1``, GELU, ``fc2``."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.fc2 = nn.Conv2d(hidden, out, 1)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class PATM(nn.Module):
    def __init__(self, dim: int, mode: str = "fc", qkv_bias: bool = False):
        super().__init__()
        if mode not in ("fc", "conv"):
            raise ValueError(f"PATM mode: {mode!r}")
        self.mode = mode
        for a in ("h", "w"):
            if mode == "fc":
                setattr(self, f"theta_{a}_conv", nn.Conv2d(dim, dim, 1))
            else:
                setattr(self, f"theta_{a}_conv", nn.Conv2d(dim, dim, 3, 1, 1, groups=dim,
                                                          bias=False))
                setattr(self, f"theta_{a}_bn", BatchNorm2d(dim, eps=1e-5, momentum=0.1))
        self.fc_h = nn.Conv2d(dim, dim, 1, bias=qkv_bias)
        self.fc_w = nn.Conv2d(dim, dim, 1, bias=qkv_bias)
        self.fc_c = nn.Conv2d(dim, dim, 1, bias=qkv_bias)
        self.tfc_h = nn.Conv2d(2 * dim, dim, (1, 7), 1, (0, 3), groups=dim, bias=False)
        self.tfc_w = nn.Conv2d(2 * dim, dim, (7, 1), 1, (3, 0), groups=dim, bias=False)
        self.reweight = _Mlp(dim, dim // 4, dim * 3)
        self.proj = nn.Conv2d(dim, dim, 1)

    def _theta(self, x, a):
        t = getattr(self, f"theta_{a}_conv")(x)
        return t if self.mode == "fc" else F.relu(getattr(self, f"theta_{a}_bn")(t))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        theta_h, theta_w = self._theta(x, "h"), self._theta(x, "w")
        x_h, x_w = self.fc_h(x), self.fc_w(x)
        x_h = torch.cat([x_h * torch.cos(theta_h), x_h * torch.sin(theta_h)], dim=1)
        x_w = torch.cat([x_w * torch.cos(theta_w), x_w * torch.sin(theta_w)], dim=1)
        h, w, c = self.tfc_h(x_h), self.tfc_w(x_w), self.fc_c(x)
        a = self.reweight((h + w + c).mean(dim=(2, 3), keepdim=True))
        # torch (B, 3C) -> (B, C, 3) is channel-major: triple k of channel c sits at 3c + k
        a = torch.softmax(a.reshape(B, C, 3), dim=-1)[..., None, None]   # (B, C, 3, 1, 1)
        return self.proj(h * a[:, :, 0] + w * a[:, :, 1] + c * a[:, :, 2])


class WaveBlock(nn.Module):
    """PATM + MLP with BatchNorm pre-norms (`wavemlp.py:188-201`). In training the
    drop-path masks come from ``generator`` (a CPU ``torch.Generator``)."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 mode: str = "fc"):
        super().__init__()
        self.norm1 = BatchNorm2d(dim, eps=1e-5, momentum=0.1)
        self.attn = PATM(dim, mode)
        self.norm2 = BatchNorm2d(dim, eps=1e-5, momentum=0.1)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        x = x + self.drop_path(self.attn(self.norm1(x)), generator=generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator=generator)
