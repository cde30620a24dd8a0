"""DRFL losses, the port of ``representationlearning_tpu/losses/dice.py`` (parity with
`DRFL-EAAI2023/model/model_dcl.py`).

- dice_bce_loss (`:877-904`): (BCE(probs) + soft-dice-loss)/2 with batch-global sums
  and smooth=0.
- GANLoss (`:763-790`): lsgan (MSE) / vanilla (BCEWithLogits) against constant
  real/fake targets (the reference zeroes the GAN terms, `:148-172`, but the API
  surface is kept).
- generator loss mix (`backward_G`, `:174-188`):
  L1(predict, softmask) + 10*diceBCE(gt, predict2) + 10*diceBCE(gt, bin).

The BCE clips the probabilities to [eps, 1 - eps] as the JAX package does;
``F.binary_cross_entropy`` clamps the log at -100 instead, a different function
near 0 and 1. Layout-free: every reduction is over all entries.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_loss(pred_probs: torch.Tensor, target: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    # jnp.clip as JAX writes it, min(max(p, eps), 1 - eps): a probability equal to
    # a bound takes half the gradient (``clamp`` would pass all of it)
    p = torch.minimum(torch.maximum(pred_probs, pred_probs.new_full((), eps)),
                      pred_probs.new_full((), 1.0 - eps))
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p)).mean()


def soft_dice_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
                   smooth: float = 0.0) -> torch.Tensor:
    i = y_true.sum()
    j = y_pred.sum()
    inter = (y_true * y_pred).sum()
    score = (2.0 * inter + smooth) / (i + j + smooth)
    return 1.0 - score


def dice_bce_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return 0.5 * (bce_loss(y_pred, y_true) + soft_dice_loss(y_true, y_pred))


def gan_loss(pred: torch.Tensor, target_is_real: bool, mode: str = "lsgan") -> torch.Tensor:
    target = 1.0 if target_is_real else 0.0
    if mode == "lsgan":
        return ((pred - target) ** 2).mean()
    if mode == "vanilla":   # BCE with logits in its softplus form
        return (F.relu(pred) - pred * target + torch.log1p(torch.exp(-pred.abs()))).mean()
    raise ValueError(mode)


def drfl_generator_loss(predict, predict2, binm, softmask, groundtruth):
    """`backward_G` mix. predict = out2 (sr stream), predict2 = out (seg stream), binm =
    refinement output — names follow the engine's assignment
    `self.predict2, self.predict, self.bin = netG(...)[0:3]` (`model_dcl.py:126`).
    Returns (total, {"G_L1", "G_bin", "bin"})."""
    l1 = (predict - softmask).abs().mean()
    g_bin = dice_bce_loss(groundtruth, predict2)
    bin_l = dice_bce_loss(groundtruth, binm)
    total = l1 + 10.0 * g_bin + 10.0 * bin_l
    return total, {"G_L1": l1, "G_bin": g_bin, "bin": bin_l}
