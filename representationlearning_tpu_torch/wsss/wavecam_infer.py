"""WaveCAM's pseudo-label inference stages for one image: the per-image bodies
of ``representationlearning_tpu/wsss/wavecam_pipeline.py``'s ``make_cam``
(`:221-247`), ``cam_to_ir_label`` (`:263-286`) and ``make_sem_seg_labels``
(`:364-391`), composed as that pipeline composes them.

- ``make_cam``: multi-scale flip CAMs of the ResNet-50 ``Net`` (``wsss/msf.py``),
  then the present classes' CAMs normalised into a dict;
- ``cam_to_ir_label``: two DenseCRF label passes on the high-resolution CAMs with
  a confident-foreground and a confident-background threshold give the IR label
  (class, 0 for confident background, 255 unsure);
- ``make_sem_seg_labels``: IRN's edges on [x; flip x], the random walk of the
  strided CAMs held back by those edges, x4 upsampling, a background plane, and
  the argmax through the dict's keys.

Images are (3, H, W): normalised for the networks, in [0, 255] for the CRF. The
CAM dicts are numpy and channel-first, as the JAX pipeline saves them between
stages; each stage puts what it takes from a dict on the device of its image.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..models.irn import IRNNet, edge_displacement_infer
from ..models.resnet import Net
from ..ops.crf import crf_inference_label
from ..ops.image import flip_lr, resize_bilinear
from .indexing import propagate_to_edge
from .msf import finalize_cam_dict, msf_cam_single


@torch.no_grad()
def make_cam(net: Net, image: torch.Tensor, cls_onehot,
             scales: Sequence[float] = (1.0, 0.5, 1.5, 2.0),
             reweight: torch.Tensor | None = None) -> dict:
    """One image's CAM dict {"keys", "cam" (k, H/4, W/4), "high_res" (k, H, W)} from
    the ``Net``'s CAMs at ``scales``; with ``reweight`` (``make_wavecam``), those of
    the classifier's weight times it (``Net.cam(reweight=)``)."""
    strided, high = msf_cam_single(lambda pair: net.cam(pair, reweight=reweight), image, scales)
    return finalize_cam_dict(strided, high, cls_onehot)


def _keys(cam_dict: dict, device) -> torch.Tensor:
    """The dict's classes + 1 after a 0 for the background."""
    return torch.as_tensor(np.pad(cam_dict["keys"] + 1, (1, 0), mode="constant"), device=device)


def cam_to_ir_label(img: torch.Tensor, cam_dict: dict, conf_fg_thres: float = 0.35,
                    conf_bg_thres: float = 0.1, crf_method: str = "grid") -> torch.Tensor:
    """The IR label (H, W) uint8 of one image: img (3, H, W) in [0, 255]."""
    dev = img.device
    cams = torch.as_tensor(cam_dict["high_res"], device=dev)
    keys = _keys(cam_dict, dev)
    conf = []
    for thres in (conf_fg_thres, conf_bg_thres):
        padded = torch.cat([torch.full((1,) + tuple(cams.shape[1:]), thres, device=dev), cams])
        pred = crf_inference_label(img, padded.argmax(0), n_labels=max(len(keys), 2),
                                   method=crf_method)
        conf.append(keys[pred])
    fg_conf, bg_conf = conf
    out = fg_conf.clone()
    out[fg_conf == 0] = 255
    out[bg_conf + fg_conf == 0] = 0
    return out.to(torch.uint8)


@torch.no_grad()
def make_sem_seg_labels(irn: IRNNet, image: torch.Tensor, cam_dict: dict, radius: int = 5,
                        beta: float = 10.0, exp_times: int = 8, bg_thres: float = 0.28,
                        out: dict | None = None) -> torch.Tensor:
    """The final pseudo label (H, W) int64 of one image: image (3, H, W)
    normalised. Where ``out`` is a dict it receives the edge map (``"edge"``), the
    random walk's transition matrix (``"trans"``) and the scores whose argmax the
    label is (``"scores"``, the background plane first)."""
    H, W = image.shape[-2:]
    edge, _ = edge_displacement_infer(irn, torch.stack([image, flip_lr(image)]))
    cams = torch.as_tensor(cam_dict["cam"], device=image.device)
    keys = _keys(cam_dict, image.device)
    edge = edge[:cams.shape[1], :cams.shape[2]]   # the strided CAMs' size
    if out is not None:
        out["edge"] = edge
    rw = propagate_to_edge(cams, edge, radius=radius, beta=beta, exp_times=exp_times, out=out)
    rw_up = resize_bilinear(rw, (cams.shape[1] * 4, cams.shape[2] * 4))[:, :H, :W]
    rw_up = rw_up / (rw_up.max() + 1e-12)
    bg = torch.full((1, H, W), bg_thres, dtype=rw_up.dtype, device=rw_up.device)
    scores = torch.cat([bg, rw_up])
    if out is not None:
        out["scores"] = scores
    return keys[scores.argmax(0)]
