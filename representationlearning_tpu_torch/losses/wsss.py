"""SCD / RML WSSS losses, the port of ``representationlearning_tpu/losses/wsss.py``
(`SCD-AAAI2023/utils/losses.py`, `utils/corrloss.py`; the trainer mixes them at
`scripts/dist_train_voc.py:340-353`).

Every loss is a function of (predictions, targets), differentiable by autograd,
and runs where its inputs live. Maps are NCHW: the class axis is 1. Under a data
group (``parallel/collectives.py``) each returns this rank's share of the loss of
the global batch: means over the global count, counts all-reduced, the
correlation loss's recentring and coordinates global.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.image import grid_sample_bilinear
from ..parallel import collectives as C


def multilabel_soft_margin_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``F.multilabel_soft_margin_loss``: the mean over classes, then over the
    batch, of -[y log sigmoid(x) + (1 - y) log sigmoid(-x)]."""
    per_class = -(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))
    return C.share_of_mean(per_class)


def aux_loss(inputs: torch.Tensor,
             targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Balanced affinity loss (`losses.py:11-22`): inputs is the sigmoid affinity
    map, targets hold 0, 1 or ignore; the positive term pulls toward 1, the
    negative toward 0, each normalised by its count + 1. Returns (loss,
    pos_count, neg_count)."""
    pos = (targets == 1).to(inputs.dtype)
    neg = (targets == 0).to(inputs.dtype)
    pos_count = C.global_sum(pos.sum()) + 1.0
    neg_count = C.global_sum(neg.sum()) + 1.0
    pos_loss = (pos * (1.0 - inputs)).sum() / pos_count
    neg_loss = (neg * inputs).sum() / neg_count
    return 0.5 * pos_loss + 0.5 * neg_loss, pos_count, neg_count


def select_class(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, ...], ...] over the class axis (1): (B, C, ...) and integer
    (B, ...) -> (B, ...). The JAX package contracts with a one-hot because a
    gather is slow on the TPU; here the gather is the plain form of the same
    selection, with the same gradient."""
    return x.gather(1, idx.long().unsqueeze(1)).squeeze(1)


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = 255) -> torch.Tensor:
    """``F.cross_entropy(ignore_index=...)``: the mean over the pixels whose label
    is a class; 0 where there is none. logits (B, C, ...), labels integer (B, ...)."""
    valid = (labels != ignore_index) & (labels >= 0) & (labels < logits.shape[1])
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = -select_class(F.log_softmax(logits, dim=1), safe)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    n = C.global_sum(valid.sum())
    return torch.where(n > 0, nll.sum() / n.clamp(min=1), nll.new_zeros(()))


def seg_loss(pred: torch.Tensor, label: torch.Tensor, ignore_index: int = 255) -> torch.Tensor:
    """Cross entropy split into background and foreground (`losses.py:24-33`): the
    average of the loss over the background pixels and over the foreground ones."""
    ignore = torch.full_like(label, ignore_index)
    bg_label = torch.where(label != 0, ignore, label)
    fg_label = torch.where(label == 0, ignore, label)
    return 0.5 * (cross_entropy_ignore(pred, bg_label, ignore_index)
                  + cross_entropy_ignore(pred, fg_label, ignore_index))


# ------------------------------------------------- self-correspondence distillation
def _norm(t: torch.Tensor) -> torch.Tensor:
    """``F.normalize(dim=1)`` with the JAX package's eps of 1e-10."""
    return t / torch.linalg.vector_norm(t, dim=1, keepdim=True).clamp(min=1e-10)


def tensor_correlation(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum('nchw,ncij->nhwij') (`corrloss.py:14-15`)."""
    return torch.einsum("nchw,ncij->nhwij", a.float(), b.float())


def sample_coords(batch: int, n_samples: int, generator: torch.Generator | None = None,
                  device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The two coordinate sets of ``contrastive_corr_loss``: uniform in [-1, 1),
    (B, n, n, 2) each, drawn on the CPU from ``generator`` and moved to ``device``
    (under a data group those of the global batch are drawn, this rank's rows
    kept)."""
    total, rows = C.global_rows(batch)
    shape = (total, n_samples, n_samples, 2)
    c1 = torch.rand(shape, generator=generator) * 2.0 - 1.0
    c2 = torch.rand(shape, generator=generator) * 2.0 - 1.0
    return c1[rows].to(device), c2[rows].to(device)


def contrastive_corr_loss(feats: torch.Tensor, feats_pos: torch.Tensor, code: torch.Tensor,
                          code_pos: torch.Tensor, n_samples: int = 40,
                          generator: torch.Generator | None = None,
                          coords: tuple[torch.Tensor, torch.Tensor] | None = None
                          ) -> torch.Tensor:
    """ContrastiveCorrelationLoss (`corrloss.py:42-89`): grid-sample n_samples^2
    random coordinates from both maps and correlate; the loss is the mean of
    -clamp(cd, 0) * fd with fd mean-shifted and without gradient. Inputs NCHW
    (feats are the CAMs, code the seg logits in the SCD trainer, `:329`).

    The coordinates come from ``coords`` (two (B, n, n, 2) tensors in [-1, 1], as
    ``jax.random.uniform`` or ``sample_coords`` gives them; this rank's rows under
    a data group) or are drawn from ``generator``."""
    if coords is None:
        coords = sample_coords(feats.shape[0], n_samples, generator, feats.device)
    # torch: sample(t, coords.permute(0, 2, 1, 3)) -- transposed before grid_sample
    c1 = coords[0].transpose(1, 2)
    c2 = coords[1].transpose(1, 2)

    f1 = grid_sample_bilinear(feats, c1)
    f2 = grid_sample_bilinear(feats_pos, c2)
    cd1 = grid_sample_bilinear(code, c1)
    cd2 = grid_sample_bilinear(code_pos, c2)

    with torch.no_grad():
        fd = tensor_correlation(_norm(f1), _norm(f2))
        old_mean = C.global_mean(fd)
        fd = fd - fd.mean(dim=(3, 4), keepdim=True)
        fd = fd - C.global_mean(fd) + old_mean

    cd = tensor_correlation(_norm(cd1), _norm(cd2))
    return C.share_of_mean(-cd.clamp(min=0.0) * fd)


def equivariance_loss(cams_scaled: torch.Tensor, cams_small: torch.Tensor) -> torch.Tensor:
    """loss_er: L1 between the full-scale CAMs resized to 0.3x and the CAMs
    computed at 0.3x, foreground channels only (`dist_train_voc.py:324` slices
    [:, 1:]; callers pass foreground-only stacks)."""
    return C.share_of_mean((cams_scaled - cams_small).abs())
