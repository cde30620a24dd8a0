"""DRFL test harness, the port of ``representationlearning_tpu/infer/drfl_eval.py``
(parity with `DRFL-EAAI2023/test.py:17-125`: Dice/IoU/acc/sensitivity/precision at
a byte threshold; `test_select.py`: the threshold sweep that picks the best;
`util/html.py:1-53`: the HTML result gallery).

The forward runs where the model lives (eval mode, no gradient); its seg output
comes back to the host in the JAX layout (B, H, W, 1), and the thresholds are
applied there in numpy, as in the JAX package.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..metrics.seg import dice_coefficient, iou_score


def nchw(a, device: torch.device) -> torch.Tensor:
    """An NHWC array (numpy or tensor) -> a contiguous NCHW f32 tensor on ``device``."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
    return t.to(device, torch.float32).permute(0, 3, 1, 2).contiguous()


@torch.no_grad()
def seg_predictions(model, A) -> np.ndarray:
    """The eval forward's seg output ``out`` for images A (B, H, W, C) in [-1, 1],
    on the model's device: (B, H, W, 1) f32 numpy."""
    model.eval()
    x = nchw(A, next(model.parameters()).device)
    return model(x)[0].permute(0, 2, 3, 1).cpu().numpy()


def binary_stats(pred_u8: np.ndarray, gt_u8: np.ndarray, threshold: int = 150) -> dict:
    p = np.asarray(pred_u8) > threshold
    t = np.asarray(gt_u8) > threshold
    tp = float((p & t).sum())
    tn = float((~p & ~t).sum())
    fp = float((p & ~t).sum())
    fn = float((~p & t).sum())
    return {
        "dice": dice_coefficient(pred_u8, gt_u8, threshold),
        "iou": iou_score(pred_u8, gt_u8, threshold),
        "acc": (tp + tn) / max(tp + tn + fp + fn, 1),
        "sen": tp / max(tp + fn, 1),
        "pre": tp / max(tp + fp, 1),
    }


def evaluate_drfl(model, batches, threshold: int = 150) -> dict:
    """Mean Dice, IoU, accuracy, sensitivity and precision of the seg output over
    ``batches`` (``collate_drfl`` dicts) at ``threshold`` on the byte scale."""
    keys = ("dice", "iou", "acc", "sen", "pre")
    acc = {k: [] for k in keys}
    for batch in batches:
        pred = seg_predictions(model, batch["A"]) * 255.0
        gt = (np.asarray(batch["B"]) + 1.0) / 2.0 * 255.0
        for p, g in zip(pred, gt):
            s = binary_stats(p, g, threshold)
            for k in keys:
                acc[k].append(s[k])
    return {k: float(np.mean(v)) for k, v in acc.items()}


def threshold_sweep(model, batches, thresholds=range(50, 250, 10)) -> dict:
    """`test_select.py`: sweep thresholds, return the best by Dice."""
    batches = list(batches)
    results = {int(t): evaluate_drfl(model, iter(batches), t) for t in thresholds}
    best_t = max(results, key=lambda t: results[t]["dice"])
    return {"best_threshold": best_t, "best": results[best_t], "all": results}


def write_html_gallery(out_dir: str, rows, title: str = "results") -> str:
    """`util/html.py` equivalent: rows = [(name, [(label, image_relpath), ...])]."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "index.html")
    with open(path, "w") as f:
        f.write(f"<html><head><title>{title}</title></head><body><h1>{title}</h1>\n")
        for name, cells in rows:
            f.write(f"<h3>{name}</h3><table><tr>\n")
            for label, rel in cells:
                f.write(
                    f"<td><img src='{rel}' width='256'/><br/>{label}</td>\n"
                )
            f.write("</tr></table>\n")
        f.write("</body></html>\n")
    return path
