"""The RML trainer, the port of ``representationlearning_tpu/train/rml.py``
(`RML/scripts/dist_train_voc.py:321-401`): the SCD loop with three mutual-learning
losses, CIML (cross-scale CAM consistency), MFML (seg-feature mutual learning
with a 100x KL MI term) and APML (the affinity loss minus 100 x (feature-label
MI - feature-feature MI) in both directions). PAR replaces VARM in the
background-aware refinement (`:22`). The loss schedule (`:390-394`): the
classification loss alone during the warm-up, then 1.0 cls + 0.1 APML + 0.1
MFML + 0.1 CIML.

- ``rml_losses``: the main forward, the CAMs and labels without gradients, the
  0.3-scale forward, its CAMs, and the four losses;
- ``rml_total_loss``: the warm-up switch;
- ``make_rml_train_step``: (on-device augmentation,) forward, backward and one
  optimiser update a call.

Tensors are NCHW.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch.profiler import record_function

from .._device import resolve_device
from ..data.device_transforms import DeviceAugConfig, augment_raw_batch
from ..losses import mi as MI
from ..losses import wsss as LW
from ..models.layers import bn_stats_frozen
from ..models.refine import par_refine
from ..ops.image import resize_bilinear
from ..parallel import collectives as C
from ..wsss import camutils as CU
from .scd import _attn_mask, _eval_mode
from .state import TrainState


class RMLConfig(NamedTuple):
    num_classes: int = 21
    crop_size: int = 320
    cam_scales: tuple = (0.5, 1.0, 1.5)
    bkg_score: float = 0.45
    high_thre: float = 0.55
    low_thre: float = 0.35
    ignore_index: int = 255
    cam_iters: int = 2000
    par_dilations: tuple = (1, 2, 4, 8, 12, 24)
    par_iters: int = 10
    w_apml: float = 0.1
    w_mfml: float = 0.1
    w_ciml: float = 0.1
    mean: tuple = (123.675, 116.28, 103.53)
    std: tuple = (58.395, 57.12, 57.375)
    attn_radius: int = 8
    # cap on the present classes per image for the refine gather
    # (camutils.refine_cams_with_bkg_v2): None = all; VOC images have at most
    # about 6, so 8 bounds the propagated channels
    max_present: int | None = None


def rml_losses(model, batch, cfg: RMLConfig, attn_mask: torch.Tensor | None = None,
               generator: torch.Generator | None = None, cam_model=None):
    """The four RML losses of one batch.

    batch: dict(image (B, 3, H, W) normalised, cls_label (B, C - 1), img_box (B, 4))
    on the model's device. ``model`` (an ``RMLModel`` that exports its attention
    maps) runs in the mode it is in; in training only the main forward moves the
    BatchNorm running statistics, the 0.3-scale forward normalises with its
    batch statistics and leaves them. Both forwards carry gradient: ``segs2``
    and ``attn_pred2`` into MFML and APML. ``cam_model`` makes the CAMs without
    gradients, usually the fused twin (``collect_attns="none"``) on the same
    parameters; None is ``model`` itself in eval mode. ``generator`` (a CPU
    ``torch.Generator``) feeds the drop-path masks. Each stage (main_forward,
    pseudo_labels, small_forward, small_cams, losses) is a named range in a
    ``torch.profiler`` trace.

    Returns ({"cls", "apml", "mfml", "ciml"}, {"refined_label", "segs", "cams"}).
    """
    inputs, cls_labels, img_box = batch["image"], batch["cls_label"], batch["img_box"]
    H, W = inputs.shape[-2:]
    if cam_model is None:
        cam_model, cam_mode = model, (lambda: _eval_mode(model))
    else:
        cam_mode = contextlib.nullcontext

    def cam_fn(x):
        return cam_model(x, cam_only=True)

    if attn_mask is None:
        attn_mask = _attn_mask(cfg, inputs.device)

    with record_function("main_forward"):
        cls_logits, segs, _, attn_pred = model(inputs, generator=generator)

    # multi-scale CAMs, PAR refinement, affinity labels (`dist_train_voc.py:321-338`)
    with record_function("pseudo_labels"), cam_mode(), torch.no_grad():
        cams, _ = CU.multi_scale_cam_with_ref_mat(cam_fn, inputs, cfg.cam_scales)
        std = inputs.new_tensor(cfg.std)[None, :, None, None]
        mean = inputs.new_tensor(cfg.mean)[None, :, None, None]

        def refine_fn(im, m):
            return par_refine(im, m, dilations=cfg.par_dilations, num_iter=cfg.par_iters)

        refined_label = CU.refine_cams_with_bkg_v2(
            refine_fn, inputs * std + mean, cams, cls_labels, img_box,
            high_thre=cfg.high_thre, low_thre=cfg.low_thre, ignore_index=cfg.ignore_index,
            max_present=cfg.max_present)
        ref_label = CU.cams_to_refine_label(refined_label, mask=attn_mask,
                                            ignore_index=cfg.ignore_index, down=16)

    # the same at 0.3 scale (`:326-332`)
    small = (int(H * 0.3), int(W * 0.3))
    inputs2 = resize_bilinear(inputs, small, align_corners=True)
    with record_function("small_forward"), bn_stats_frozen(model):
        _, segs2, _, attn_pred2 = model(inputs2, generator=generator)
    with record_function("small_cams"), cam_mode(), torch.no_grad():
        cams2 = CU.multi_scale_cam(cam_fn, inputs2, cfg.cam_scales)

    with record_function("losses"):
        loss_ciml = MI.ciml_loss(resize_bilinear(cams, small, align_corners=True), cams2)
        segs_up = resize_bilinear(segs, (H, W), align_corners=True)
        segs1 = resize_bilinear(segs_up, small, align_corners=True)
        loss_mfml = MI.mfml_loss(segs1, resize_bilinear(segs2, small, align_corners=True))
        loss_apml_aux, _, _ = LW.aux_loss(attn_pred, ref_label)
        loss_apml = loss_apml_aux + MI.apml_mi_terms(attn_pred, attn_pred2, refined_label)
        loss_cls = LW.multilabel_soft_margin_loss(cls_logits, cls_labels)

    losses = {"cls": loss_cls, "apml": loss_apml, "mfml": loss_mfml, "ciml": loss_ciml}
    return losses, {"refined_label": refined_label, "segs": segs_up, "cams": cams}


def rml_total_loss(losses: dict, step: int, cfg: RMLConfig) -> torch.Tensor:
    """The warm-up schedule (`dist_train_voc.py:390-394`): the classification loss
    alone for the first ``cam_iters`` steps, then the weighted sum of all four."""
    if int(step) <= cfg.cam_iters:
        return 1.0 * losses["cls"]
    return (losses["cls"] + cfg.w_apml * losses["apml"] + cfg.w_mfml * losses["mfml"]
            + cfg.w_ciml * losses["ciml"])


def make_rml_train_step(model, cfg: RMLConfig, cam_model=None,
                        device: torch.device | str | None = None,
                        aug_cfg: DeviceAugConfig | None = None, data_group=None):
    """One RML training iteration as a function ``train_step(state, batch,
    generator=None) -> (state, metrics)``.

    ``model`` is the trained ``RMLModel`` (``collect_attns="last2"``), ``state`` a
    ``TrainState`` over it; ``cam_model`` as in ``rml_losses``. The batch is moved
    to ``device``, the card unless the caller names another (it raises where
    there is none). Without ``aug_cfg`` the batch is dict(image normalised,
    cls_label, img_box); with it, the raw batch dict(raw (B, 3, S, S) uint8,
    hw (B, 2), cls_label), augmented there first by the classification chain
    (``data/device_transforms.py``, decisions drawn from ``generator`` before the
    drop-path masks), as `bench.py::bench_rml_train` fuses the two. The state is
    updated in place and returned; metrics holds the four losses and their
    ``total``, detached. Beside the stages of ``rml_losses`` the profiler sees
    augment, backward and optimizer.

    With ``data_group`` (a ``parallel.mesh.Mesh``; None, or a data axis of one
    rank, is the single-device step) the step is one rank's part of the data-parallel step: the
    batch holds this rank's rows of the global batch, the augmentation decisions
    and the drop-path and dropout masks are drawn for the global batch and sliced,
    every BatchNorm and loss reduction is global, the gradients are summed over
    the ranks before the update, and metrics holds the global losses. n ranks so
    give the single-rank step on the global batch, to f32 summation order. The
    CAM twin and the refinement run on this rank's rows."""
    device = resolve_device(device)
    attn_mask = _attn_mask(cfg, device)

    def train_step(state: TrainState, batch, generator: torch.Generator | None = None):
        model.train()
        batch = {k: v.to(device) for k, v in batch.items()}
        with C.data_parallel(data_group):
            if aug_cfg is not None:
                with record_function("augment"):
                    batch = augment_raw_batch(batch, aug_cfg, generator)
            losses, _ = rml_losses(model, batch, cfg, attn_mask, generator=generator,
                                   cam_model=cam_model)
            total = rml_total_loss(losses, state.step, cfg)
            with record_function("backward"):
                total.backward()
            with record_function("optimizer"):
                C.allreduce_grads(state.tx.params)
                state.apply_gradients()
            metrics = {k: v.detach() for k, v in losses.items()}
            metrics["total"] = total.detach()
            return state, C.reduce_metrics(metrics)

    return train_step
