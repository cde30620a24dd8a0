"""Segmentation metrics, the port of ``representationlearning_tpu/metrics/seg.py``,
with the exact semantics of the reference:

- the fast-hist confusion, pAcc / mAcc / mIoU with the ``valid = hist.sum(1) > 0``
  masking: `SCD-AAAI2023/utils/evaluate.py:9-35`;
- ``pseudo_scores``' handling of 255: `utils/evaluate.py:38-57`;
- multilabel F1: `utils/evaluate.py:4-6`;
- DRFL's +1-smoothed Dice / IoU at a byte threshold: `DRFL-EAAI2023/util/Dice_test.py:34-49`.

``confusion_matrix`` counts on the tensors' device with ``torch.bincount``, in
int64: exact at any count (the JAX package adds 1.0 in f32, exact up to 2^24 a
bin a call). The scores are computed on the host in float64, from numpy arrays
or an accumulated histogram.
"""
from __future__ import annotations

import numpy as np
import torch

from ..parallel.collectives import all_reduce_sum


def confusion_matrix(label_true: torch.Tensor, label_pred: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """The fast-hist on the tensors' device, int64: rows are true classes,
    columns predicted ones. Pixels whose true label lies outside
    [0, num_classes) (the 255 ignore convention) are not counted, nor those whose
    prediction does (an argmax never gives one)."""
    lt = label_true.reshape(-1).long()
    lp = label_pred.reshape(-1).long()
    mask = (lt >= 0) & (lt < num_classes) & (lp >= 0) & (lp < num_classes)
    idx = torch.where(mask, lt * num_classes + lp, torch.full_like(lt, num_classes ** 2))
    hist = torch.bincount(idx, minlength=num_classes ** 2 + 1)
    return hist[:-1].reshape(num_classes, num_classes)


def _fast_hist(label_true: np.ndarray, label_pred: np.ndarray, num_classes: int) -> np.ndarray:
    mask = (label_true >= 0) & (label_true < num_classes)
    return np.bincount(num_classes * label_true[mask].astype(int) + label_pred[mask],
                       minlength=num_classes ** 2).reshape(num_classes, num_classes)


def scores_from_hist(hist) -> dict:
    """pAcc, mAcc, mIoU (over the classes that occur in the ground truth) and the
    IoU of each class from a confusion histogram (numpy or a tensor)."""
    if isinstance(hist, torch.Tensor):
        hist = hist.cpu().numpy()
    hist = np.asarray(hist, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
    valid = hist.sum(axis=1) > 0
    mean_iu = np.nanmean(iu[valid]) if valid.any() else float("nan")
    return {"pAcc": float(acc), "mAcc": float(acc_cls), "miou": float(mean_iu),
            "iou": dict(zip(range(hist.shape[0]), iu))}


def scores(label_trues, label_preds, num_classes: int = 21) -> dict:
    """The reference ``scores`` (`utils/evaluate.py:17-35`)."""
    hist = np.zeros((num_classes, num_classes))
    for lt, lp in zip(label_trues, label_preds):
        hist += _fast_hist(np.asarray(lt).flatten(), np.asarray(lp).flatten(), num_classes)
    return scores_from_hist(hist)


def pseudo_scores(label_trues, label_preds, num_classes: int = 21) -> dict:
    """The reference ``pseudo_scores`` (`utils/evaluate.py:38-57`): where the pseudo
    label is 255 the pixel is left out (the ground truth set to 255 there, the
    prediction to 0)."""
    hist = np.zeros((num_classes, num_classes))
    for lt, lp in zip(label_trues, label_preds):
        lt = np.asarray(lt).flatten().copy()
        lp = np.asarray(lp).flatten().copy()
        lt[lp == 255] = 255
        lp[lp == 255] = 0
        hist += _fast_hist(lt, lp, num_classes)
    return scores_from_hist(hist)


def multilabel_f1(y_true, y_pred) -> float:
    """Binary F1 over flattened multilabel targets (`utils/evaluate.py:4-6`)."""
    y_true = np.asarray(y_true).reshape(-1).astype(bool)
    y_pred = np.asarray(y_pred).reshape(-1).astype(bool)
    tp = float((y_true & y_pred).sum())
    fp = float((~y_true & y_pred).sum())
    fn = float((y_true & ~y_pred).sum())
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom > 0 else 0.0


def dice_coefficient(pred, target, threshold: int = 150) -> float:
    """DRFL's boolean Dice with +1 smoothing at a uint8 threshold
    (`DRFL-EAAI2023/util/Dice_test.py:34-41`)."""
    p = np.asarray(pred) > threshold
    t = np.asarray(target) > threshold
    inter = float((p & t).sum())
    return (2.0 * inter + 1.0) / (float(p.sum()) + float(t.sum()) + 1.0)


def iou_score(pred, target, threshold: int = 150) -> float:
    """DRFL's boolean IoU with +1 smoothing (`util/Dice_test.py:43-49`)."""
    p = np.asarray(pred) > threshold
    t = np.asarray(target) > threshold
    inter = float((p & t).sum())
    union = float((p | t).sum())
    return (inter + 1.0) / (union + 1.0)


class SegMetricAccumulator:
    """A streaming confusion histogram: ``update`` counts a batch on its device
    (int64, no copy to the host), ``compute`` gives the scores. ``compute(group)``
    sums the histograms of the ranks of ``group`` first (an int64 all-reduce,
    exact), so ranks that each count their share of the samples score what one
    rank counting all of them does; ``device`` is where a rank that counted
    nothing holds its zeros."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.hist: torch.Tensor | None = None

    def update(self, label_true, label_pred) -> None:
        label_pred = torch.as_tensor(label_pred)
        label_true = torch.as_tensor(label_true).to(label_pred.device)
        h = confusion_matrix(label_true, label_pred, self.num_classes)
        self.hist = h if self.hist is None else self.hist + h.to(self.hist.device)

    def compute(self, group=None, device=None) -> dict:
        hist = self.hist
        if group is not None:
            if hist is None:
                hist = torch.zeros((self.num_classes,) * 2, dtype=torch.int64, device=device)
            hist = all_reduce_sum(hist, group)
        if hist is None:
            hist = np.zeros((self.num_classes, self.num_classes))
        return scores_from_hist(hist)
