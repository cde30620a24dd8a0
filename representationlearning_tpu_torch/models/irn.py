"""IRN (Inter-pixel Relation Network), the port of
``representationlearning_tpu/models/irn.py`` (parity with
`WaveCAM-TMM2023/net/resnet50_irn.py`).

A ResNet-50 backbone at stride 16 (``models/resnet.py``), frozen (run under
``torch.no_grad``) as the JAX package's ``stop_gradient`` freezes it
(`resnet50_irn.py:115-119`): its parameters get no gradient; a
five-level edge branch (1x1 conv -> GroupNorm -> bilinear upsample -> ReLU, fused
by a 1x1 conv to one edge channel) and a seven-level displacement branch ending
in a two-channel field with its running mean subtracted on request (MeanShift).
The network is f32 (the JAX ``IRNNet.dtype`` is unused).

``AffinityDisplacementHead`` turns sigmoid edges into per-path affinities via a
``PathIndex`` and returns the four loss maps (`resnet50_irn.py:144-213`);
``irn_total_loss`` mixes them as the train stage does; ``edge_displacement_infer``
is the inference head (the flip-averaged sigmoid edge, `resnet50_irn.py:216-234`).

Names follow IRN's published ``resnet50_irn.py``: ``resnet50.*``,
``fc_edge{1..5}.{0,1}`` (conv, GroupNorm), ``fc_edge6``, ``fc_dp{1..6}.{0,1}``,
``fc_dp7.0`` / ``.1`` / ``.3`` (conv, GroupNorm, the two-channel conv) and
``mean_shift.running_mean``. The JAX package has no IRN converter, and no
reference checkpoint was at hand to check these names against.

Known difference from torch's defaults: GroupNorm's epsilon is flax's 1e-6 (torch's
``nn.GroupNorm`` default is 1e-5), so that the port computes what the JAX package
does. Each upsample is bilinear with ``align_corners=False`` and then cropped to
the stem's size, as in the JAX package. Maps are NCHW. ``IRNNet`` is built on the
card unless ``device`` says otherwise, and its weights depend on the generator only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..core.registry import MODELS
from ..ops.image import flip_lr, resize_bilinear
from ..wsss.indexing import PathIndex, edge_to_affinity
from .layers import GN_EPS, init_weights, lecun_normal_init
from .resnet import ResNet50Backbone, resnet50_config

# name: (in, out, groups, upsample) of each conv -> GroupNorm -> (upsample) -> ReLU
EDGE = {"fc_edge1": (64, 32, 4, 1), "fc_edge2": (256, 32, 4, 1), "fc_edge3": (512, 32, 4, 2),
        "fc_edge4": (1024, 32, 4, 4), "fc_edge5": (2048, 32, 4, 4)}
DP = {"fc_dp1": (64, 64, 8, 1), "fc_dp2": (256, 128, 16, 1), "fc_dp3": (512, 256, 16, 1),
      "fc_dp4": (1024, 256, 16, 2), "fc_dp5": (2048, 256, 16, 2), "fc_dp6": (768, 256, 16, 2)}


class MeanShift(nn.Module):
    """The displacement field's running mean (2,), a buffer the train stage's
    calibration sets."""

    def __init__(self, channels: int = 2):
        super().__init__()
        self.register_buffer("running_mean", torch.zeros(channels))


def _conv_gn(seq: nn.Sequential, x: torch.Tensor, upsample: int = 1) -> torch.Tensor:
    x = seq[0](x)
    x = F.group_norm(x, seq[1].num_groups, seq[1].weight, seq[1].bias, GN_EPS)
    if upsample > 1:
        x = resize_bilinear(x, (x.shape[-2] * upsample, x.shape[-1] * upsample))
    return torch.relu(x)


@MODELS.register("irn")
class IRNNet(nn.Module):
    """Returns (edge_out (B, 1, h, w) logits at stride 4, dp_out (B, 2, h, w))."""

    def __init__(self, generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        with resolve_device(device):  # parameters and buffers are created there
            self.resnet50 = ResNet50Backbone(**resnet50_config(16), return_stem=True)
            for name, (cin, cout, groups, _) in {**EDGE, **DP}.items():
                setattr(self, name, nn.Sequential(nn.Conv2d(cin, cout, 1, bias=False),
                                                  nn.GroupNorm(groups, cout, eps=GN_EPS)))
            self.fc_edge6 = nn.Conv2d(160, 1, 1, bias=True)
            self.fc_dp7 = nn.Sequential(nn.Conv2d(448, 256, 1, bias=False),
                                        nn.GroupNorm(16, 256, eps=GN_EPS), nn.ReLU(),
                                        nn.Conv2d(256, 2, 1, bias=False))
            self.mean_shift = MeanShift(2)
        init_weights(self.resnet50, generator)   # TorchConv's fan-out normal
        for name in (*EDGE, *DP, "fc_edge6", "fc_dp7"):   # flax nn.Conv's lecun normal
            for m in getattr(self, name).modules():
                if isinstance(m, nn.Conv2d):
                    lecun_normal_init(m.weight, generator)
                    if m.bias is not None:
                        nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor, apply_mean_shift: bool = False):
        # stem (64, s4), layer1 (256, s4), layer2 (512, s8), layer3 (1024, s16),
        # layer4 (2048, s16); the backbone is frozen, and keeps no activations for
        # a backward
        with torch.no_grad():
            x1, x2, x3, x4, x5 = self.resnet50(x)
        h2, w2 = x1.shape[-2:]

        e = [_conv_gn(self.fc_edge1, x1), _conv_gn(self.fc_edge2, x2)]
        for name, f in (("fc_edge3", x3), ("fc_edge4", x4), ("fc_edge5", x5)):
            e.append(_conv_gn(getattr(self, name), f, EDGE[name][3])[..., :h2, :w2])
        edge_out = self.fc_edge6(torch.cat(e, dim=1))

        d1 = _conv_gn(self.fc_dp1, x1)
        d2 = _conv_gn(self.fc_dp2, x2)
        d3 = _conv_gn(self.fc_dp3, x3)
        h3, w3 = d3.shape[-2:]
        d4 = _conv_gn(self.fc_dp4, x4, 2)[..., :h3, :w3]
        d5 = _conv_gn(self.fc_dp5, x5, 2)[..., :h3, :w3]
        d_up3 = _conv_gn(self.fc_dp6, torch.cat([d3, d4, d5], dim=1), 2)[..., :d2.shape[-2],
                                                                         :d2.shape[-1]]
        d = _conv_gn(self.fc_dp7, torch.cat([d1, d2, d_up3], dim=1))
        dp_out = self.fc_dp7[3](d)
        if apply_mean_shift:
            dp_out = dp_out - self.mean_shift.running_mean.view(1, 2, 1, 1)
        return edge_out, dp_out


class AffinityDisplacementHead:
    """The loss maps around ``IRNNet`` (`resnet50_irn.py:144-213`), stateless; the
    path index's arrays go to the device of the maps they index."""

    def __init__(self, path_index: PathIndex):
        self.path_index = path_index
        # (1, 2, n_paths, 1): each path's destination offset (dy, dx)
        self.disp_target = torch.as_tensor(path_index.search_dst.T[None, :, :, None],
                                           dtype=torch.float32)

    def to_affinity(self, edge_sigmoid: torch.Tensor) -> torch.Tensor:
        """(B, h, w) sigmoid edges -> (B, n_paths, n_pos) affinities."""
        B = edge_sigmoid.shape[0]
        return edge_to_affinity(edge_sigmoid.reshape(B, -1), self.path_index.path_indices)

    def to_pair_displacement(self, disp: torch.Tensor) -> torch.Tensor:
        """disp (B, 2, h, w) -> (B, 2, n_paths, n_pos) source-minus-destination
        differences (`resnet50_irn.py:177-191`)."""
        B, _, H, W = disp.shape
        rf = self.path_index.radius_floor
        ch, cw = H - rf, W - 2 * rf
        src = disp[:, :, :ch, rf:rf + cw]
        dst = torch.stack([disp[:, :, dy:dy + ch, rf + dx:rf + dx + cw]
                           for dy, dx in self.path_index.search_dst], dim=2)
        return (src[:, :, None] - dst).reshape(B, 2, dst.shape[2], -1)

    def losses(self, edge_out: torch.Tensor, dp_out: torch.Tensor):
        """(pos_aff_loss, neg_aff_loss, dp_fg_loss, dp_bg_loss) maps."""
        aff = self.to_affinity(torch.sigmoid(edge_out[:, 0]))
        pos = -torch.log(aff + 1e-5)
        neg = -torch.log(1.0 + 1e-5 - aff)
        pair = self.to_pair_displacement(dp_out)
        dp_fg = (pair - self.disp_target.to(pair.device)).abs()
        dp_bg = pair.abs()
        return pos, neg, dp_fg, dp_bg


def irn_total_loss(head: AffinityDisplacementHead, edge_out, dp_out, bg_pos_label, fg_pos_label,
                   neg_label):
    """The train stage's mix (`step/train_irn.py:57-70`): (total, parts)."""
    pos, neg, dp_fg, dp_bg = head.losses(edge_out, dp_out)
    bg_pos = (bg_pos_label * pos).sum() / (bg_pos_label.sum() + 1e-5)
    fg_pos = (fg_pos_label * pos).sum() / (fg_pos_label.sum() + 1e-5)
    pos_loss = bg_pos / 2 + fg_pos / 2
    neg_loss = (neg_label * neg).sum() / (neg_label.sum() + 1e-5)
    dp_fg_loss = (dp_fg * fg_pos_label[:, None]).sum() / (2 * fg_pos_label.sum() + 1e-5)
    dp_bg_loss = (dp_bg * bg_pos_label[:, None]).sum() / (2 * bg_pos_label.sum() + 1e-5)
    total = (pos_loss + neg_loss) / 2 + (dp_fg_loss + dp_bg_loss) / 2
    return total, {"pos_aff": pos_loss, "neg_aff": neg_loss,
                   "dp_fg": dp_fg_loss, "dp_bg": dp_bg_loss}


def edge_displacement_infer(model: IRNNet, x_and_flip: torch.Tensor, stride: int = 4):
    """EdgeDisplacement (`resnet50_irn.py:216-234`): the (2, 3, H, W) pair [x;
    flip(x)] -> (edge (h, w), dp (2, h, w)) at stride 4, the mean shift applied."""
    H, W = x_and_flip.shape[-2:]
    fh, fw = (H - 1) // stride + 1, (W - 1) // stride + 1
    edge_out, dp_out = model(x_and_flip, apply_mean_shift=True)
    edge_out = edge_out[:, 0, :fh, :fw]
    edge = torch.sigmoid(edge_out[0] / 2 + flip_lr(edge_out[1]) / 2)
    return edge, dp_out[0, :, :fh, :fw]
