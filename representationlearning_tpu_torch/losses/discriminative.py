"""The discriminative (pull-push) instance-embedding loss, the port of
``representationlearning_tpu/losses/discriminative.py``
(`RSSFormer-TIP2023/losses/obj2.py:9-186`, ``DiscriminativeLoss``): a variance
term pulls each embedding toward its instance's mean, a distance term pushes
the means apart with a 2 * delta_d margin, and a norm term regularises the
means. The reference's per-sample loops are masked batched reductions.

Embeddings are NCHW: ``pred`` (B, F, H, W).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _instance_means(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """pred (B, N, F), gt one-hot (B, N, I) -> the means (B, I, F), a safe divide."""
    num = torch.einsum("bnf,bni->bif", pred.float(), gt.float())
    return num / gt.sum(dim=1)[..., None].clamp(min=1.0)


def variance_term(pred: torch.Tensor, gt: torch.Tensor, delta_v: float = 0.5,
                  norm: int = 2) -> torch.Tensor:
    """Pull: the mean over instances and pixels of clamp(||pred - mean_i|| - delta_v)^2."""
    means = _instance_means(pred, gt)
    d = pred[:, :, None, :] - means[:, None, :, :]                 # (B, N, I, F)
    dist = torch.linalg.vector_norm(d, ord=norm, dim=-1)
    v = (dist - delta_v).clamp(min=0.0) ** 2 * gt
    denom = gt.sum(dim=(1, 2)).clamp(min=1.0)
    return (v.sum(dim=(1, 2)) / denom).mean()


def distance_term(means: torch.Tensor, instance_mask: torch.Tensor, delta_d: float = 2.0,
                  norm: int = 2) -> torch.Tensor:
    """Push: clamp(2 delta_d - ||mean_i - mean_j||)^2 over distinct present pairs.
    instance_mask (B, I) marks the instances present."""
    I = means.shape[1]
    off = 1.0 - torch.eye(I, device=means.device, dtype=means.dtype)
    dist = torch.linalg.vector_norm(means[:, :, None, :] - means[:, None, :, :], ord=norm, dim=-1)
    margin = 2.0 * delta_d * off[None]
    pair = instance_mask[:, :, None] * instance_mask[:, None, :] * off[None]
    term = (margin - dist).clamp(min=0.0) ** 2 * pair
    n = pair.sum(dim=(1, 2)).clamp(min=1.0)
    return (term.sum(dim=(1, 2)) / n).mean()


def regularization_term(means: torch.Tensor, instance_mask: torch.Tensor,
                        norm: int = 2) -> torch.Tensor:
    n = torch.linalg.vector_norm(means, ord=norm, dim=-1) * instance_mask
    cnt = instance_mask.sum(dim=1).clamp(min=1.0)
    return (n.sum(dim=1) / cnt).mean()


def discriminative_loss(pred: torch.Tensor, instance_labels: torch.Tensor, n_instances: int,
                        delta_v: float = 0.5, delta_d: float = 2.0, norm: int = 2,
                        alpha: float = 1.0, beta: float = 1.0, gamma: float = 0.001):
    """pred (B, F, H, W) embeddings; instance_labels (B, H, W) integer ids in
    [0, n_instances) (others ignored). Returns (alpha pull + beta push + gamma
    reg, {"var", "dist", "reg"})."""
    B, Fd = pred.shape[:2]
    p = pred.reshape(B, Fd, -1).transpose(1, 2)                       # (B, N, F)
    lab = instance_labels.reshape(B, -1)
    valid = (lab >= 0) & (lab < n_instances)
    safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
    onehot = F.one_hot(safe, n_instances).to(p.dtype) * valid[..., None].to(p.dtype)
    present = (onehot.sum(dim=1) > 0).to(p.dtype)                    # (B, I)
    means = _instance_means(p, onehot)
    lv = variance_term(p, onehot, delta_v, norm)
    ld = distance_term(means, present, delta_d, norm)
    lr = regularization_term(means, present, norm)
    return alpha * lv + beta * ld + gamma * lr, {"var": lv, "dist": ld, "reg": lr}
