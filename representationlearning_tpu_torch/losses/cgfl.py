"""CGFL, the foreground-saliency-guided losses of RSSFormer, the port of
``representationlearning_tpu/losses/cgfl.py`` (`RSSFormer-TIP2023/module/CGFL.py`,
`losses/auxloss.py:253-324`).

The key mechanism (`CGFL.py:192-273`, ``SegmentationLossaux``): the aux head's
class logits are compared with per-image class-membership vectors by
``mctrans_aux_l1``, which gives a per-sample scalar l1; it becomes the DYNAMIC
gamma of ``softmax_focalloss`` (modulating factor (1 - p)(1 - gamma / 7), the
scalar mean CE times the summed gathered factor over (n_valid + B): the
reference's own, unusual, reduction).

The probabilities and the gathered modulating factor carry no gradient, as in
the reference (``.detach()`` where JAX has ``stop_gradient``), so the dynamic
gamma, and with it the aux head, gets none from these losses.

Maps are NCHW: ``y_pred`` (B, C, H, W) logits, ``y_true`` (B, H, W) integer
labels with ``ignore_index`` (and anything outside [0, C)) ignored.

Under a data group (``parallel/collectives.py``) each loss is this rank's share of
the loss of the global batch: the batch size B, the valid counts and the detached
sums of the focal losses all-reduced; dice per sample, over the global count; the
Tversky sums all-reduced with their gradient, the loss divided among the ranks.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from ..parallel import collectives as PC
from .wsss import cross_entropy_ignore, select_class


def _valid(y_true: torch.Tensor, n_classes: int, ignore_index: int) -> torch.Tensor:
    return (y_true != ignore_index) & (y_true >= 0) & (y_true < n_classes)


def _safe(y_true: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, y_true, torch.zeros_like(y_true))


def softmax_focalloss(y_pred: torch.Tensor, y_true: torch.Tensor, gamma,
                      ignore_index: int = -1) -> torch.Tensor:
    """The active variant (`CGFL.py:72-100`): the scalar mean CE times the summed
    gathered modulating factor (1 - p)(1 - gamma / 7), over (n_valid + B).
    gamma is per sample, (B,). An ignored pixel's factor is that of class 0, as
    in the reference."""
    B, C = y_pred.shape[:2]
    ce = cross_entropy_ignore(y_pred, y_true, ignore_index)   # scalar mean
    p = torch.softmax(y_pred, dim=1).detach()
    g = torch.as_tensor(gamma, dtype=p.dtype, device=p.device).reshape(B, 1, 1, 1)
    mod = (1.0 - p) * (1.0 - g / 7.0)
    valid = _valid(y_true, C, ignore_index)
    mod = select_class(mod, _safe(y_true, valid)).detach()
    # ce (under a data group this rank's share of the global mean CE) is a
    # scalar: it scales the global sum of the detached factor
    return ce * PC.global_sum(mod.sum()) / (PC.global_sum(valid.sum()) + PC.global_batch(B))


def softmax_focalloss_pow(y_pred: torch.Tensor, y_true: torch.Tensor, gamma: float = 2.0,
                          ignore_index: int = -1, normalize: bool = False) -> torch.Tensor:
    """``softmax_focallossy`` (`CGFL.py:42-70`): the classic per-pixel (1 - p)^gamma
    focal loss, optionally normalised (the scale carries no gradient)."""
    C = y_pred.shape[1]
    valid = _valid(y_true, C, ignore_index)
    safe = _safe(y_true, valid)
    nll = -select_class(F.log_softmax(y_pred, dim=1), safe)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    p = torch.softmax(y_pred, dim=1).detach()
    mod = (1.0 - select_class(p, safe)) ** gamma
    mod = torch.where(valid, mod, torch.zeros_like(mod)).detach()
    scale = 1.0
    if normalize:
        scale = (PC.global_sum(nll.sum().detach())
                 / PC.global_sum((nll * mod).sum().detach()).clamp(min=1e-12))
    return scale * (nll * mod).sum() / (PC.global_sum(valid.sum())
                                         + PC.global_batch(y_pred.shape[0]))


def mctrans_aux_l1(cls_score: torch.Tensor, label_map: torch.Tensor,
                   n_classes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The core of ``MCTransAuxLoss`` (`auxloss.py:253-324`): per-image class
    membership (which values of ``label_map`` occur) against the class logits;
    l1 = sum_c 1 / (1 + exp|s - m|) / (2B). cls_score (B, C), label_map (B, H, W)
    (the binary background map in ``segmentation_loss_aux``, so only classes 0
    and 1 can be members: the reference's behaviour). Returns (a zero-weighted
    scalar loss, l1 (B,))."""
    B = PC.global_batch(cls_score.shape[0])
    classes = torch.arange(n_classes, dtype=torch.float32, device=label_map.device)
    member = (label_map.float().flatten(1)[:, :, None] == classes).any(dim=1)
    l1 = 1.0 / (1.0 + torch.exp((cls_score - member.to(cls_score.dtype)).abs()))
    l1 = l1.sum(dim=1) / (2.0 * B)
    return 0.0 * l1.sum(), l1


def binary_cross_entropy_with_logits_ignore(logit: torch.Tensor, target: torch.Tensor,
                                            ignore_index: int = -1) -> torch.Tensor:
    """BCE with logits over the pixels whose target is not ``ignore_index``."""
    mask = target != ignore_index
    t = torch.where(mask, target, torch.zeros_like(target))
    per = logit.clamp(min=0) - logit * t + torch.log1p(torch.exp(-logit.abs()))
    per = torch.where(mask, per, torch.zeros_like(per))
    return per.sum() / PC.global_sum(mask.sum()).clamp(min=1)


def tversky_loss_with_logits(logit: torch.Tensor, target: torch.Tensor, alpha: float = 0.5,
                             beta: float = 0.5, ignore_index: int = -1,
                             smooth: float = 1.0) -> torch.Tensor:
    mask = (target != ignore_index).to(logit.dtype)
    t = torch.where(mask.bool(), target, torch.zeros_like(target))
    p = torch.sigmoid(logit) * mask
    tp = PC.global_sum((p * t).sum())
    fp = PC.global_sum((p * (1 - t)).sum())
    fn = PC.global_sum(((1 - p) * t * mask).sum())
    return PC.share(1.0 - (tp + smooth) / (tp + alpha * fn + beta * fp + smooth))


def dice_loss_with_logits(y_pred: torch.Tensor, y_true: torch.Tensor, ignore_index: int = -1,
                          smooth: float = 1.0) -> torch.Tensor:
    """Multiclass soft dice over the softmax probabilities (`CGFL.py:359-418`)."""
    C = y_pred.shape[1]
    valid = _valid(y_true, C, ignore_index)
    v = valid.unsqueeze(1).to(y_pred.dtype)
    onehot = F.one_hot(_safe(y_true, valid).long(), C).permute(0, 3, 1, 2).to(y_pred.dtype) * v
    p = torch.softmax(y_pred, dim=1) * v
    inter = (p * onehot).sum(dim=(2, 3))
    denom = p.sum(dim=(2, 3)) + onehot.sum(dim=(2, 3))
    dice = (2 * inter + smooth) / (denom + smooth)
    return PC.share(1.0) - PC.share_of_mean(dice)


def _background_target(y_true: torch.Tensor, ignore_index: int) -> torch.Tensor:
    """1 on a class above 0, ``ignore_index`` where ignored, else 0 (float)."""
    one, zero = torch.ones((), device=y_true.device), torch.zeros((), device=y_true.device)
    ignored = torch.full((), float(ignore_index), device=y_true.device)
    return torch.where(y_true > 0, one, torch.where(y_true == ignore_index, ignored, zero))


def segmentation_loss_aux(y_pred: torch.Tensor, y_true: torch.Tensor, aux_logits: torch.Tensor,
                          loss_config: Mapping, ignore_index: int = -1) -> dict:
    """``SegmentationLossaux.forward`` (`CGFL.py:192-273`): the loss dict.
    y_pred (B, C, H, W) logits; y_true (B, H, W) integer (-1 ignored); aux_logits
    (B, C)."""
    out = {}
    C = y_pred.shape[1]
    if "ce" in loss_config:
        bg_true = (y_true > 0).float()
        bg_true = torch.where(y_true == ignore_index, torch.zeros_like(bg_true), bg_true)
        _, l1 = mctrans_aux_l1(aux_logits, bg_true, C)
        out["fc_loss"] = softmax_focalloss(y_pred, y_true, l1, ignore_index)
    if "fcloss" in loss_config:
        out["fc_loss_static"] = softmax_focalloss_pow(
            y_pred, y_true, loss_config["fcloss"]["gamma"], ignore_index, normalize=True)
    if "bceloss" in loss_config:
        out["bceloss"] = binary_cross_entropy_with_logits_ignore(
            y_pred[:, 0], _background_target(y_true, ignore_index), ignore_index,
        ) * loss_config["bceloss"]["scaler"]
    if "tverloss" in loss_config:
        out["tverloss"] = tversky_loss_with_logits(
            y_pred[:, 0], _background_target(y_true, ignore_index),
            loss_config["tverloss"]["alpha"], loss_config["tverloss"]["beta"], ignore_index,
        ) * loss_config["tverloss"]["scaler"]
    if "diceloss" in loss_config:
        out["dice_loss"] = dice_loss_with_logits(y_pred, y_true, ignore_index) * (
            loss_config["diceloss"].get("scaler", 1.0))
    return out


def segmentation_loss(y_pred: torch.Tensor, y_true: torch.Tensor, loss_config: Mapping,
                      ignore_index: int = -1) -> dict:
    """The plain ``SegmentationLoss`` (`CGFL.py:125-189`): ce / fcloss / bce / dice."""
    out = {}
    if "ce" in loss_config:
        out["ce_loss"] = cross_entropy_ignore(y_pred, y_true, ignore_index)
    if "fcloss" in loss_config:
        out["fc_loss"] = softmax_focalloss_pow(
            y_pred, y_true, loss_config["fcloss"]["gamma"], ignore_index, normalize=True)
    if "bceloss" in loss_config:
        out["bceloss"] = binary_cross_entropy_with_logits_ignore(
            y_pred[:, 0], _background_target(y_true, ignore_index), ignore_index,
        ) * loss_config["bceloss"]["scaler"]
    if "diceloss" in loss_config:
        out["dice_loss"] = dice_loss_with_logits(y_pred, y_true, ignore_index)
    return out
