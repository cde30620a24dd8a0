"""The DRFL trainer, the port of ``representationlearning_tpu/train/drfl.py`` (parity
with `DRFL-EAAI2023/model/model_dcl.py:67-333`, the CGAN engine with its GAN / D
terms zeroed, so effectively supervised, and `train.py:34-106`: the epoch loop,
per-epoch Dice / IoU validation at byte threshold 150, ``best`` saved), plus the
reference's checkpoint resume (`model_dcl.py:270-324` save / load +
``continue_train``) as ``torch.save`` of the train state under the same
``net_{latest,best}`` names.

Adam with betas (0.5, 0.999) and eps 1e-8 at the linear-decay rate
(``linear_decay_schedule``) over every parameter of the ``Softnet``. The batch is
``data/medical.py::collate_drfl``'s dict (NHWC numpy arrays, or tensors of that
layout); ``drfl_batch`` moves it to the device as NCHW tensors. Each step draws
its dropout masks from the generator it is given; ``train_drfl`` seeds one a step
with ``ep * 10_000 + i``, as the JAX package keys its steps.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from .._device import resolve_device
from ..infer.drfl_eval import nchw, seg_predictions
from ..losses.dice import drfl_generator_loss
from ..metrics.seg import dice_coefficient, iou_score
from .optim import Transform, _scheduled
from .state import TrainState


class DRFLConfig(NamedTuple):
    lr: float = 2e-4
    beta1: float = 0.5
    maintain_epoch: int = 30
    decay_epoch: int = 30
    epoch_count: int = 1
    threshold: int = 150


def linear_decay_schedule(cfg: DRFLConfig, steps_per_epoch: int):
    """`get_scheduler` lambda rule (`model_dcl.py:398-406`): flat for maintain_epoch
    epochs then linear decay to 0 over decay_epoch+1 epochs; the epoch is
    ``step // steps_per_epoch``."""

    def sched(step):
        epoch = int(step) // max(steps_per_epoch, 1)
        over = max(0, epoch + cfg.epoch_count - cfg.maintain_epoch)
        return cfg.lr * max(1.0 - over / (cfg.decay_epoch + 1.0), 0.0)

    return sched


def create_drfl_state(model, cfg: DRFLConfig, steps_per_epoch: int) -> TrainState:
    """Adam (betas (cfg.beta1, 0.999), eps 1e-8) over ``model``'s parameters at
    the linear-decay rate; the model keeps the weights it has."""
    params = list(model.parameters())
    opt = torch.optim.Adam(params, lr=1.0, betas=(cfg.beta1, 0.999), eps=1e-8)
    return TrainState.create(model, Transform(
        opt, _scheduled(opt, [linear_decay_schedule(cfg, steps_per_epoch)]), None, tuple(params)))


def drfl_batch(batch, device: torch.device) -> dict[str, torch.Tensor]:
    """``collate_drfl``'s A (B, H, W, C), B (B, H, W, 1) and C (B, 2H, 2W, 1), numpy
    or tensors -> contiguous NCHW f32 tensors on ``device`` (``name`` dropped)."""
    return {k: nchw(batch[k], device) for k in ("A", "B", "C")}


def drfl_losses(model, batch: dict[str, torch.Tensor],
                generator: torch.Generator | None = None):
    """The training forward of ``model`` on an NCHW batch and the generator loss:
    (total, {"G_L1", "G_bin", "bin"}). groundtruth = (B + 1) / 2
    (`model_dcl.py:118`); the engine's naming: predict2 = out (seg), predict =
    out2 (sr 2x), bin = binm."""
    out, out2, binm, _, _ = model(batch["A"], generator)
    return drfl_generator_loss(out2, out, binm, batch["C"], (batch["B"] + 1.0) / 2.0)


def make_drfl_train_step(model, device: torch.device | str | None = None):
    """One training iteration as ``train_step(state, batch, generator=None) ->
    (state, metrics)``: forward in training mode (dropout from ``generator``, the
    decoder's BatchNorms moving their statistics at each of its two passes), the
    loss mix, backward, one Adam update. ``state`` is a ``TrainState`` over
    ``model`` (``create_drfl_state``), updated in place and returned. The batch
    goes to ``device``, the card unless the caller names another (it raises where
    there is none). metrics holds the three parts and ``total``, detached. The
    profiler sees forward, backward and optimizer."""
    device = resolve_device(device)

    def train_step(state: TrainState, batch, generator: torch.Generator | None = None):
        model.train()
        batch = drfl_batch(batch, device)
        with record_function("forward"):
            total, parts = drfl_losses(model, batch, generator)
        with record_function("backward"):
            total.backward()
        with record_function("optimizer"):
            state.apply_gradients()
        metrics = {k: v.detach() for k, v in parts.items()}
        metrics["total"] = total.detach()
        return state, metrics

    return train_step


def validate(model, batches, threshold: int = 150) -> dict:
    """Per-epoch Dice/IoU at uint8 threshold (`train.py:82-98` via `util/Dice_test`),
    the model in eval mode where it lives."""
    dices, ious = [], []
    for batch in batches:
        pred = seg_predictions(model, batch["A"])
        gt = (np.asarray(batch["B"]) + 1.0) / 2.0
        pred_u8 = (pred * 255.0).clip(0, 255)
        gt_u8 = gt * 255.0
        for p, g in zip(pred_u8, gt_u8):
            dices.append(dice_coefficient(p, g, threshold))
            ious.append(iou_score(p, g, threshold))
    return {"dice": float(np.mean(dices)), "iou": float(np.mean(ious))}


def save_checkpoint(work_dir: str, tag: str, state: TrainState) -> str:
    """``torch.save`` of the whole state (step, model, optimiser, schedule) at
    ``work_dir/net_{tag}.pt``."""
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, f"net_{tag}.pt")
    torch.save(state.state_dict(), path + ".tmp")
    os.replace(path + ".tmp", path)   # a reader sees a whole file or none
    return path


def load_checkpoint(work_dir: str, tag: str, state: TrainState) -> TrainState:
    """Restore ``net_{tag}.pt`` into ``state`` (continue_train semantics), onto
    the devices the state's own tensors live on."""
    path = os.path.join(work_dir, f"net_{tag}.pt")
    state.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return state


def train_drfl(model, train_batches_fn, val_batches_fn, cfg: DRFLConfig, epochs: int,
               work_dir: str, log=None, device: torch.device | str | None = None):
    """Epoch loop with best-Dice checkpointing (`train.py:34-106`) over ``model``
    as it is (its own initialisation, or weights loaded into it); batches on
    ``device``, the card unless the caller names another. Returns (state,
    history)."""
    step_fn = make_drfl_train_step(model, device)
    steps_per_epoch = max(1, len(list(train_batches_fn())))
    state = create_drfl_state(model, cfg, steps_per_epoch)
    best = -1.0
    history = []
    for ep in range(epochs):
        for i, batch in enumerate(train_batches_fn()):
            state, metrics = step_fn(state, batch,
                                     torch.Generator().manual_seed(ep * 10_000 + i))
        scores = validate(model, val_batches_fn(), cfg.threshold)
        loss = float(metrics["total"])
        history.append({"epoch": ep, **scores, "loss": loss})
        if log:
            log.info("epoch %d loss=%.4f dice=%.4f iou=%.4f", ep, loss, scores["dice"],
                     scores["iou"])
        save_checkpoint(work_dir, "latest", state)
        if scores["dice"] > best:
            best = scores["dice"]
            save_checkpoint(work_dir, "best", state)
    return state, history
