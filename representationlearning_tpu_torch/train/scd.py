"""The SCD end-to-end WSSS trainer, the port of
``representationlearning_tpu/train/scd.py``
(`SCD-AAAI2023/scripts/dist_train_voc.py:95-146,181-432`):

- ``scd_pseudo_labels``: multi-scale flip CAMs -> pseudo labels -> background-
  aware VARM refinement -> pairwise affinity labels, the part of the train step
  that runs without gradients;
- ``scd_losses`` / ``scd_total_loss``: the main forward, a second forward at 0.3
  scale, the CAMs of both through the CAM model, the labels, and the six losses
  with the warm-up switch;
- ``make_scd_train_step``: (on-device augmentation,) forward, backward and one
  optimiser update per call;
- ``make_scd_eval_step``: the validation forward.

Per iteration (SURVEY.md 3.1): forward -> multi-scale flip CAM (+ 0.3x forward
and CAM set) -> pseudo labels -> VARM refine -> affinity labels -> 6 losses ->
schedule-weighted sum -> backward -> PolyWarmupAdamW step. Tensors are NCHW.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch.profiler import record_function

from .._device import resolve_device
from ..data.device_transforms import DeviceAugConfig, augment_raw_batch
from ..losses import wsss as LW
from ..losses.energy import get_energy_loss
from ..models.layers import bn_stats_frozen
from ..models.refine import varm_refine
from ..ops.image import resize_bilinear
from ..parallel import collectives as C
from ..wsss import camutils as CU
from .state import TrainState


class SCDConfig(NamedTuple):
    num_classes: int = 21
    crop_size: int = 320
    cam_scales: tuple = (1.0, 0.5, 1.5)
    bkg_score: float = 0.45
    high_thre: float = 0.55
    low_thre: float = 0.35
    ignore_index: int = 255
    cam_iters: int = 2000
    varm_dilations: tuple = (1, 2, 4, 8, 12, 24)
    varm_iters: int = 10
    energy_weight: float = 1e-7
    w_seg: float = 0.1
    w_energy: float = 0.01
    w_aux: float = 0.1
    w_corr: float = 0.1
    w_er: float = 0.1
    corr_samples: int = 40
    mean: tuple = (123.675, 116.28, 103.53)
    std: tuple = (58.395, 57.12, 57.375)
    attn_radius: int = 8
    # cap on the present classes per image for the refine gather
    # (camutils.refine_cams_with_bkg_v2): None = all; VOC images have at most
    # about 6, so 8 bounds the propagated channels
    max_present: int | None = None
    energy_method: str = "grid"


def _attn_mask(cfg: SCDConfig, device: torch.device | str | None = None) -> torch.Tensor:
    """The radius mask over the stride-16 token grid of a training crop, on the
    card unless the caller names another device."""
    s = cfg.crop_size // 16
    return torch.from_numpy(CU.get_mask_by_radius(s, s, cfg.attn_radius)).to(
        resolve_device(device))


def _down_size(h: int, stride: int = 16) -> int:
    """`dist_train_voc.py:89-93` get_down_size: feature-grid extent at stride 16."""
    return h // stride + 1 - (h % stride == 0)


@torch.no_grad()
def scd_pseudo_labels(cam_model, images: torch.Tensor, cls_label: torch.Tensor,
                      img_box: torch.Tensor, cfg: SCDConfig,
                      attn_mask: torch.Tensor | None = None):
    """The label half of the SCD train step, without gradients.

    cam_model(x, cam_only=True) -> (cam, attn_pred or None): a TSCD, usually the
    fused twin with ``collect_attns="none"``. images (B, 3, H, W) normalised,
    cls_label (B, C - 1) one-hot, img_box (B, 4) as (y0, y1, x0, x1). attn_mask
    is ``_attn_mask(cfg, images.device)`` unless the caller made it once.

    Returns (cams (B, C - 1, H, W), pseudo_label (B, H, W), refined_label
    (B, H, W), ref_label (B, N, N)), N = (crop_size / 16)^2.
    """
    def cam_fn(x):
        return cam_model(x, cam_only=True)

    # multi-scale CAMs (`dist_train_voc.py:311-324`)
    cams, _ = CU.multi_scale_cam_with_ref_mat(cam_fn, images, cfg.cam_scales)

    # pseudo labels + VARM refine (`:312,334`)
    _, pseudo_label = CU.cam_to_label(
        cams, cls_label, img_box, ignore_mid=True, bkg_score=cfg.bkg_score,
        high_thre=cfg.high_thre, low_thre=cfg.low_thre, ignore_index=cfg.ignore_index)
    std = images.new_tensor(cfg.std)[None, :, None, None]
    mean = images.new_tensor(cfg.mean)[None, :, None, None]
    inputs_denorm = images * std + mean

    def refine_fn(im, m):
        return varm_refine(im, m, dilations=cfg.varm_dilations, num_iter=cfg.varm_iters)

    refined_label = CU.refine_cams_with_bkg_v2(
        refine_fn, inputs_denorm, cams, cls_label, img_box, high_thre=cfg.high_thre,
        low_thre=cfg.low_thre, ignore_index=cfg.ignore_index, max_present=cfg.max_present)

    if attn_mask is None:
        attn_mask = _attn_mask(cfg, images.device)
    ref_label = CU.cams_to_refine_label(refined_label, mask=attn_mask,
                                        ignore_index=cfg.ignore_index, down=16)
    return cams, pseudo_label, refined_label, ref_label


@contextlib.contextmanager
def _eval_mode(model):
    """``model`` in eval mode inside, back in the mode it had afterwards."""
    was = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was)


def scd_losses(model, batch, cfg: SCDConfig, attn_mask: torch.Tensor | None = None,
               generator: torch.Generator | None = None, cam_model=None, coords=None):
    """The six SCD losses and the diagnostics of one batch.

    batch: dict(image (B, 3, H, W) normalised, cls_label (B, C - 1), img_box
    (B, 4)) on the model's device. ``model`` runs in the mode it is in (train:
    drop path, dropout and BatchNorm batch statistics, whose running average
    moves with the main forward only). ``cam_model`` is the model that makes
    the CAMs without gradients, usually the fused twin with
    ``collect_attns="none"`` on the same parameters; None is ``model`` itself in
    eval mode (`utils/camutils.py:88,118` torch.no_grad). ``generator`` (a CPU
    ``torch.Generator``) feeds the drop-path and dropout masks and then the
    correlation loss's coordinates, unless ``coords`` gives those. Each stage
    (main_forward, pseudo_labels, small_forward, small_cams, losses, energy_loss)
    is a named range in a ``torch.profiler`` trace.

    Returns ({"cls", "seg", "energy", "aux", "corr", "er"}, {"pseudo_label",
    "refined_label", "segs", "cams"})."""
    inputs, cls_labels, img_box = batch["image"], batch["cls_label"], batch["img_box"]
    H, W = inputs.shape[-2:]
    if cam_model is None:
        cam_model, cam_mode = model, (lambda: _eval_mode(model))
    else:
        cam_mode = contextlib.nullcontext

    with record_function("main_forward"):
        cls_logits, segs, _, attn_pred = model(inputs, generator=generator)

    # multi-scale CAMs, pseudo labels, VARM refine, affinity labels
    # (`dist_train_voc.py:311-336`)
    with record_function("pseudo_labels"), cam_mode():
        cams, pseudo_label, refined_label, ref_label = scd_pseudo_labels(
            cam_model, inputs, cls_labels, img_box, cfg, attn_mask=attn_mask)

    # the same at 0.3 scale (`:316-324`)
    inputs2 = resize_bilinear(inputs, (int(H * 0.3), int(W * 0.3)), align_corners=True)
    with record_function("small_forward"), bn_stats_frozen(model):
        _, segs2, _, _ = model(inputs2, generator=generator)
    with record_function("small_cams"), cam_mode(), torch.no_grad():
        cams2 = CU.multi_scale_cam(lambda x: cam_model(x, cam_only=True), inputs2,
                                   cfg.cam_scales)

    with record_function("losses"):
        cams1 = resize_bilinear(cams, cams2.shape[-2:], align_corners=True)
        loss_er = LW.equivariance_loss(cams1[:, 1:], cams2[:, 1:])

        segs_up = resize_bilinear(segs, (H, W), align_corners=True)
        segs2_up = resize_bilinear(segs2, cams2.shape[-2:], align_corners=True)
        loss_corr = LW.contrastive_corr_loss(cams, cams2, segs_up, segs2_up,
                                             n_samples=cfg.corr_samples, generator=generator,
                                             coords=coords)
        loss_aux, _, _ = LW.aux_loss(attn_pred, ref_label)
        loss_seg = LW.seg_loss(segs_up, refined_label, cfg.ignore_index)
        loss_cls = LW.multilabel_soft_margin_loss(cls_logits, cls_labels)
    with record_function("energy_loss"):
        loss_energy = get_energy_loss(inputs, segs_up, refined_label, img_box, mean=cfg.mean,
                                      std=cfg.std, weight=cfg.energy_weight,
                                      method=cfg.energy_method)

    losses = {"cls": loss_cls, "seg": loss_seg, "energy": loss_energy, "aux": loss_aux,
              "corr": loss_corr, "er": loss_er}
    aux_out = {"pseudo_label": pseudo_label, "refined_label": refined_label,
               "segs": segs_up, "cams": cams}
    return losses, aux_out


def scd_total_loss(losses: dict, step: int, cfg: SCDConfig) -> torch.Tensor:
    """Warm-up schedule (`dist_train_voc.py:350-353`): the classification loss
    alone for the first ``cam_iters`` steps, then the weighted sum of all six."""
    if int(step) <= cfg.cam_iters:
        return 1.0 * losses["cls"]
    return (1.0 * losses["cls"] + cfg.w_seg * losses["seg"] + cfg.w_energy * losses["energy"]
            + cfg.w_aux * losses["aux"] + cfg.w_corr * losses["corr"]
            + cfg.w_er * losses["er"])


def make_scd_train_step(model, cfg: SCDConfig, cam_model=None,
                        device: torch.device | str | None = None,
                        aug_cfg: DeviceAugConfig | None = None, data_group=None):
    """One SCD training iteration as a function ``train_step(state, batch,
    generator=None) -> (state, metrics)``.

    ``model`` is the trained TSCD (``collect_attns="last2"``), ``state`` a
    ``TrainState`` over it; ``cam_model`` as in ``scd_losses``. The batch is moved
    to ``device``, the card unless the caller names another (it raises where
    there is none). Without ``aug_cfg`` the batch is dict(image normalised,
    cls_label, img_box); with it, the raw batch dict(raw (B, 3, S, S) uint8,
    hw (B, 2), cls_label), augmented there first by the classification chain
    (``data/device_transforms.py``, decisions drawn from ``generator`` before the
    drop-path masks), as the JAX package's `cli/train_scd.py:171-190` fuses the
    two. The state is updated in place and returned; metrics holds the six
    losses and their ``total``, detached. Beside the stages of ``scd_losses`` the
    profiler sees the ranges augment, backward and optimizer.

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
            losses, _ = scd_losses(model, batch, cfg, attn_mask, generator=generator,
                                   cam_model=cam_model)
            total = scd_total_loss(losses, state.step, cfg)
            with record_function("backward"):
                total.backward()
            with record_function("optimizer"):
                C.allreduce_grads(state.tx.params)
                state.apply_gradients()
            metrics = {k: v.detach() for k, v in losses.items()}
            metrics["total"] = total.detach()
            return state, C.reduce_metrics(metrics)

    return train_step


def make_scd_eval_step(model, cfg: SCDConfig, device: torch.device | str | None = None):
    """Validation forward (`dist_train_voc.py:95-146`): seg argmax + multi-scale CAM
    pseudo labels + affinity-propagated "ref" labels (the reference's third score
    stream, `:122-142`). ``model`` is a TSCD that exports its attention maps
    (``collect_attns="last2"``). The step takes a batch dict (image (B, 3, H, W),
    cls_label (B, C - 1)) on ``device``, the card unless the caller names another,
    and returns tensors there; metric accumulation happens outside."""
    device = resolve_device(device)
    masks: dict[tuple[int, int], torch.Tensor] = {}  # radius masks by grid size

    @torch.no_grad()
    def eval_step(batch):
        inputs = batch["image"].to(device)
        cls_labels = batch["cls_label"].to(device)
        H, W = inputs.shape[-2:]
        cls_logits, segs, _, attn_pred = model(inputs)
        segs_up = resize_bilinear(segs, (H, W), align_corners=False)
        cams = CU.multi_scale_cam(lambda x: model(x, cam_only=True), inputs, cfg.cam_scales)
        cam_label = CU.cam_to_label(cams, cls_labels, img_box=None, bkg_score=cfg.bkg_score)
        # ref stream (`:122-130`): the raw (not class-masked) CAM down to the
        # stride-16 grid, random-walked through the predicted affinity under a
        # radius mask; bkg_score is hard-coded 0.35 in the reference call
        h16, w16 = _down_size(H), _down_size(W)
        if (h16, w16) not in masks:
            masks[h16, w16] = torch.from_numpy(
                CU.get_mask_by_radius(h16, w16, cfg.attn_radius)).to(device)
        cam16 = resize_bilinear(cams, (h16, w16), align_corners=False)
        ref_cam = CU.propagate_ref_cam_with_bkg(cam16, attn_pred, cls_labels, bkg_score=0.35,
                                                mask=masks[h16, w16])
        ref_cam = resize_bilinear(ref_cam, (H, W), align_corners=False)
        return {
            "seg_pred": segs_up.argmax(1),
            "cam_label": cam_label,
            "ref_label": ref_cam.argmax(1),
            "cls_pred": (cls_logits > 0).int(),
        }

    return eval_step
