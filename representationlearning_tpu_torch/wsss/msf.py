"""Multi-scale + flip (MSF) CAM inference, the port of
``representationlearning_tpu/wsss/msf.py`` (parity with WaveCAM's
`voc12/dataloader.py:259-287` MSF dataset and `step/make_cam.py:17-71`, the
per-image strided and high-resolution CAM sums).

Images and CAMs are channel-first: an image (3, H, W), CAMs (C, h, w). Scaled
sizes are ``int(round(H * s))``, Python's round (half to even), as in the JAX
package. The CAM dicts of ``finalize_cam_dict`` are numpy and channel-first, as
the JAX package saves them; ``cam_dict_to_label`` and
``evaluate_cam_multi_thres`` work on them on the host.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

from ..metrics.seg import _fast_hist, scores_from_hist
from ..ops.image import flip_lr, resize_bilinear


def get_strided_size(orig_size, stride):
    return ((orig_size[0] - 1) // stride + 1, (orig_size[1] - 1) // stride + 1)


def get_strided_up_size(orig_size, stride):
    s = get_strided_size(orig_size, stride)
    return s[0] * stride, s[1] * stride


def msf_cam_single(cam_fn: Callable, image: torch.Tensor,
                   scales: Sequence[float] = (1.0, 0.5, 1.5, 2.0), stride: int = 4,
                   up_stride: int = 16):
    """image (3, H, W), normalised. ``cam_fn`` maps the (2, 3, h, w) pair [image;
    flip] to (2, C, h', w') CAM responses (`CAM.forward(separate=True)`). Returns
    (strided_cam (C, hs, ws), highres_cam (C, H, W)): sums over the scales of the
    ReLU'd flip sum of each (`resnet50_cam.py:113-121`, `make_cam.py:36-46`), not
    normalised."""
    H, W = image.shape[-2:]
    strided = get_strided_size((H, W), stride)
    up = get_strided_up_size((H, W), up_stride)

    strided_sum = highres_sum = None
    for s in scales:
        si = resize_bilinear(image, (int(round(H * s)), int(round(W * s))))
        o = torch.relu(cam_fn(torch.stack([si, flip_lr(si)])))
        o = o[0] + flip_lr(o[1])   # the flip sum (`resnet50_cam.py:120-121`)
        sc = resize_bilinear(o, strided)
        hc = resize_bilinear(o, up)[:, :H, :W]
        strided_sum = sc if strided_sum is None else strided_sum + sc
        highres_sum = hc if highres_sum is None else highres_sum + hc
    return strided_sum, highres_sum


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def finalize_cam_dict(strided_cam, highres_cam, cls_onehot) -> Dict[str, np.ndarray]:
    """The present classes' CAMs, each divided by its max (`make_cam.py:42-49`):
    strided (C, hs, ws) and high-resolution (C, H, W) CAMs and a (C,) one-hot ->
    {"keys": (k,), "cam": (k, hs, ws), "high_res": (k, H, W)}, numpy."""
    keys = np.nonzero(_numpy(cls_onehot))[0]
    sc = _numpy(strided_cam)[keys]
    hc = _numpy(highres_cam)[keys]
    sc = sc / (sc.max(axis=(1, 2), keepdims=True) + 1e-5)
    hc = hc / (hc.max(axis=(1, 2), keepdims=True) + 1e-5)
    return {"keys": keys, "cam": sc, "high_res": hc}


def cam_dict_to_label(cam_dict: Dict[str, np.ndarray], thres: float) -> np.ndarray:
    """A background plane at ``thres``, the argmax, classes through keys + 1
    (`eval_cam.py:18-22`)."""
    cams = cam_dict["high_res"]
    cams = np.pad(cams, ((1, 0), (0, 0), (0, 0)), mode="constant", constant_values=thres)
    keys = np.pad(cam_dict["keys"] + 1, (1, 0), mode="constant")
    return keys[np.argmax(cams, axis=0)]


def evaluate_cam_multi_thres(cam_dicts, gt_masks, num_classes: int, thresholds=None) -> dict:
    """The multi-threshold CAM mIoU sweep (WaveCAM `step_coco/train_cam_mde_coco.py:41-80`):
    {"per_threshold": {threshold: miou}, "best_threshold", "best_miou"}."""
    thresholds = list(thresholds if thresholds is not None else np.arange(0.1, 0.6, 0.05))
    results = {}
    for t in thresholds:
        hist = np.zeros((num_classes, num_classes))
        for d, gt in zip(cam_dicts, gt_masks):
            pred = cam_dict_to_label(d, float(t))
            hist += _fast_hist(np.asarray(gt).flatten(), pred.flatten(), num_classes)
        results[round(float(t), 4)] = scores_from_hist(hist)["miou"]
    best_t = max(results, key=results.get)
    return {"per_threshold": results, "best_threshold": best_t, "best_miou": results[best_t]}
