"""WaveCAM's wave-modeling block and its per-class predictor, the port of
``representationlearning_tpu/models/wavecam.py`` (parity with
`WaveCAM-TMM2023/net/wavecam.py:39-83` and `net/resnet50_cam.py:155-189`).

``WaveModeling`` treats the C-channel CAM as a wave: the foreground branch
relu(x/3 + 0.1) and the background branch (1 - x)/3 each get a 1x1 phase conv
(conv -> BatchNorm -> ReLU) and a 1x1 amplitude conv; cos / sin modulation makes
2C channels, grouped (1, 7) / (7, 1) token FCs bring them back to C, and a
softmax over channel pairs of two pooled 1x1 convs weighs the two branches.

``ClassPredictorWavecam`` adds the wave output, viewed channel-major as
(B, C, 2 * s * s), to the (B, C, 2048) class features of ``Net.cam_feature``
and classifies each present class's feature: a masked per-class cross-entropy
and its accuracy. The CAM is resized bilinearly to the canonical s x s grid
(s = 32 at ``representation_size`` 2048) when it is not that size already; at
the reference's 512 crop and stride 16 it is.

Maps are NCHW. The BatchNorms are ``layers.BatchNorm2d`` (flax's conventions:
biased running variance, momentum 0.9, eps 1e-5) and use batch statistics only
in training mode (``.train()``).

State-dict names follow the JAX scopes: ``wave.theta_R_conv``,
``wave.theta_R_bn``, ``wave.theta_I_conv``, ``wave.theta_I_bn``, ``wave.fc_h``,
``wave.fc_w``, ``wave.tfc_h``, ``wave.tfc_w``, ``wave.w1``, ``wave.w2`` and
``classifier``. ``classifier`` is a bare (num_classes, representation_size)
parameter, the transpose of JAX's ``classifier_kernel`` (F, C) and the layout of
``Net.classifier``'s weight without its 1x1, which is what ``make_wavecam``
reweights that weight with. The modules are built on the card unless ``device``
says otherwise; the initial weights depend on the generator only.
"""
from __future__ import annotations

import torch
from torch import nn

from .._device import resolve_device
from ..core.registry import MODELS
from ..ops.image import adaptive_avg_pool_11, resize_bilinear
from .layers import BatchNorm2d, lecun_normal_init


class WaveModeling(nn.Module):
    def __init__(self, dim: int = 20, qkv_bias: bool = False,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        with resolve_device(device):
            for name in ("theta_R", "theta_I"):
                setattr(self, f"{name}_conv", nn.Conv2d(dim, dim, 1))
                setattr(self, f"{name}_bn", BatchNorm2d(dim, eps=1e-5, momentum=0.1))
            self.fc_h = nn.Conv2d(dim, dim, 1, bias=qkv_bias)
            self.fc_w = nn.Conv2d(dim, dim, 1, bias=qkv_bias)
            # groups = dim over 2 * dim inputs: input channels (2k, 2k + 1) feed output k
            self.tfc_h = nn.Conv2d(2 * dim, dim, (1, 7), padding=(0, 3), groups=dim, bias=False)
            self.tfc_w = nn.Conv2d(2 * dim, dim, (7, 1), padding=(3, 0), groups=dim, bias=False)
            self.w1 = nn.Conv2d(dim, dim, 1)
            self.w2 = nn.Conv2d(dim, dim, 1)
        for m in self.modules():   # flax nn.Conv's lecun normal kernels, zero biases
            if isinstance(m, nn.Conv2d):
                lecun_normal_init(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) CAM -> (B, 2C, H, W), channels [h-branch; w-branch]."""
        B, C = x.shape[:2]
        x = torch.relu(x / 3.0 + 0.1)
        background = (1.0 - x) / 3.0
        theta_R = torch.relu(self.theta_R_bn(self.theta_R_conv(x)))
        theta_I = torch.relu(self.theta_I_bn(self.theta_I_conv(background)))

        x_h, x_w = self.fc_h(x), self.fc_w(background)
        x_h = torch.cat([x_h * torch.cos(theta_R), x_h * torch.sin(theta_R)], dim=1)
        x_w = torch.cat([x_w * torch.cos(theta_I), x_w * torch.sin(theta_I)], dim=1)
        h, w = self.tfc_h(x_h), self.tfc_w(x_w)

        a = adaptive_avg_pool_11(x)
        # the (B, 2C) concat viewed as (B, C, 2) pairs channels (2c, 2c + 1) of
        # [w1; w2], not (w1_c, w2_c) (`wavecam.py:76-78`)
        pair = torch.cat([self.w1(a), self.w2(a)], dim=1).reshape(B, C, 2, 1, 1).softmax(dim=2)
        return torch.cat([h * pair[:, :, 0], w * pair[:, :, 1]], dim=1)


@MODELS.register("wavecam_class_predictor")
class ClassPredictorWavecam(nn.Module):
    """``Class_Predictor_wavecam``: (loss, acc) of the per-class re-classification
    of the class features plus the wave-modulated CAM."""

    def __init__(self, num_classes: int = 20, representation_size: int = 2048,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.representation_size = representation_size
        self.wave = WaveModeling(num_classes, generator=generator, device=device)
        self.classifier = nn.Parameter(torch.empty(num_classes, representation_size,
                                                   device=resolve_device(device)))
        lecun_normal_init(self.classifier, generator)   # fan in: representation_size

    def forward(self, x: torch.Tensor, label: torch.Tensor, cams: torch.Tensor):
        """x (B, C, representation_size) class features, label (B, C) multilabel
        one-hot, cams (B, C, H, W) -> (loss, acc)."""
        B, C, _ = x.shape
        s = int(round((self.representation_size // 2) ** 0.5))
        cams = resize_bilinear(cams, (s, s))   # the identity at s x s
        x = x + self.wave(cams).reshape(B, C, -1)   # NCHW viewed channel-major
        logits = torch.einsum("bcf,kf->bck", x, self.classifier)
        # for each present class c of a sample, the target of its feature is c
        diag_nll = -torch.diagonal(torch.log_softmax(logits, dim=-1), dim1=1, dim2=2)
        mask = (label > 0).to(logits.dtype)
        per_sample = (diag_nll * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1.0)
        correct = ((logits.argmax(dim=-1) == torch.arange(C, device=x.device)) * mask).sum()
        # the reference divides by the batch size (`resnet50_cam.py:188`)
        return per_sample.sum() / B, correct / mask.sum().clamp(min=1.0)
