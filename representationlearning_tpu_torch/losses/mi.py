"""RML mutual-information losses, the port of ``representationlearning_tpu/losses/mi.py``
(`RML/scripts/dist_train_voc.py:180-209` for the MI estimators, `:340-394` for
the CIML / MFML / APML composition). Maps are NCHW; ``attn_pred`` is (B, N, N).

Two quirks of the reference are reproduced on purpose:
- ``kl_div(input=softmax(F1 / T), target=softmax(F2 / T))``: torch's kl_div takes
  log-probabilities as ``input`` but the reference passes probabilities; the
  pointwise target * (log(target) - input) is averaged as it is, 0 * log 0 = 0;
- CIML's ``cosine_similarity(..., dim=3)`` reduces over a singleton axis, which
  gives the +-1 sign-agreement matrix a * b / max(|a| * |b|, 1e-8) of the pooled
  class vectors. The formula is written out: ``F.cosine_similarity`` clamps its
  eps differently.

Every term is a mean over rows that belong to one sample each (per-row softmaxes,
per-sample class matrices), so under a data group (``parallel/collectives.py``)
each loss is this rank's sum over the global count: its share.
"""
from __future__ import annotations

import torch

from ..ops.image import resize_bilinear
from ..parallel import collectives as C


def torch_kl_div_mean(inp: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``F.kl_div(input, target, reduction='mean')``: the mean over all elements of
    target * (log(target) - input), with 0 * log(0) = 0."""
    pos = target > 0
    logt = torch.where(pos, torch.log(torch.where(pos, target, torch.ones_like(target))),
                       torch.zeros_like(target))
    return C.share_of_mean(target * logt - target * inp)


def feat_feat_mi_estimation(F1: torch.Tensor, F2: torch.Tensor,
                            temperature: float = 0.05) -> torch.Tensor:
    """(B, dim, H, W) maps -> rows (B * dim, H * W) softmaxed over the grid;
    kl(F1.detach(), F2) (`dist_train_voc.py:180-193`)."""
    B, dim = F1.shape[:2]
    p1 = torch.softmax(F1.detach().reshape(B * dim, -1) / temperature, dim=1)
    p2 = torch.softmax(F2.reshape(B * dim, -1) / temperature, dim=1)
    return torch_kl_div_mean(p1, p2)


def feat_label_mi_estimation(feat: torch.Tensor, Y: torch.Tensor,
                             temperature: float = 0.05) -> torch.Tensor:
    """(B, H, W) prediction map against a (B, H, W) label map (`:195-209`). No
    gradient reaches either side; the target is the softmax of labels / 0.05 over
    a map that may hold 255s, as in the reference."""
    B = feat.shape[0]
    p1 = torch.softmax(feat.detach().reshape(B, -1) / temperature, dim=1)
    p2 = torch.softmax(Y.reshape(B, -1).float() / temperature, dim=1)
    return torch_kl_div_mean(p1, p2)


def _sign_cosine_matrix(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """``torch.cosine_similarity`` over a singleton axis: the (B, C, C) sign
    agreement of the pooled vectors a, b (B, C)."""
    num = a[:, :, None] * b[:, None, :]
    den = torch.clamp(a.abs()[:, :, None] * b.abs()[:, None, :], min=eps)
    return num / den


def ciml_loss(cams_full: torch.Tensor, cams_small: torch.Tensor) -> torch.Tensor:
    """Cross-image (scale) mutual learning (`:340-357`): L1 between the CAMs at the
    two scales plus 0.1 x the mean of the two sign-cosine matrices of the pooled
    class vectors. ``[:, 1:]`` drops the first of the 20 CAM channels, class 1, as
    the reference does. cams_full is already on cams_small's grid; both NCHW."""
    c1, c2 = cams_full[:, 1:], cams_small[:, 1:]
    cam_l1 = C.share_of_mean((c1 - c2).abs())
    a, b = c1.mean(dim=(2, 3)), c2.mean(dim=(2, 3))   # adaptive_avg_pool2d -> (B, C - 1)
    return 0.1 * C.share_of_mean(_sign_cosine_matrix(a, a) + _sign_cosine_matrix(b, b)) + cam_l1


def mfml_loss(segs1: torch.Tensor, segs2: torch.Tensor) -> torch.Tensor:
    """Mutual feature learning (`:360-367`): L1 plus 100 x the feature-feature MI
    between the seg maps at the two scales (both on the small grid, NCHW),
    channel 0 dropped."""
    s1, s2 = segs1[:, 1:], segs2[:, 1:]
    return 100.0 * feat_feat_mi_estimation(s1, s2) + C.share_of_mean((s1 - s2).abs())


def apml_mi_terms(attn_pred1: torch.Tensor, attn_pred2: torch.Tensor,
                  refined_label: torch.Tensor) -> torch.Tensor:
    """The APML MI correction (`:371-386`): -100 x ((feature-label MI) -
    (feature-feature MI)) in both directions. attn_pred{1,2}: (B, N, N) affinity
    maps; refined_label (B, H, W)."""
    H, W = refined_label.shape[1:3]
    a1 = resize_bilinear(attn_pred1, (H, W), align_corners=True)
    a2 = resize_bilinear(attn_pred2, (H, W), align_corners=True)
    y = refined_label.float()
    lossmi = feat_feat_mi_estimation(a1[:, None], a2[:, None])
    lossmil = feat_label_mi_estimation(a1, y)
    lossmi2 = feat_feat_mi_estimation(a2[:, None], a1[:, None])
    lossmil2 = feat_label_mi_estimation(a2, y)
    return -100.0 * (lossmil - lossmi) - 100.0 * (lossmil2 - lossmi2)
