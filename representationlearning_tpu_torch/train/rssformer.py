"""The RSSFormer / LoveDA trainer, the port of
``representationlearning_tpu/train/rssformer.py``: the native replacement for the
``ever`` package's ``th_amp_ddp`` trainer that the reference delegates to
(`RSSFormer-TIP2023/train.py:77-80`; config `configs/base/loveda.py:63-112`):
SGD with momentum 0.9 and weight decay 1e-4, the poly rate 0.01^0.9 over 30k
iterations, gradient clip 35, the loss dict summed; evaluation by the confusion
histogram (``metrics/seg.py``), optionally with TTA.

Every BatchNorm of the model moves its running statistics in the training
forward (flax momentum 0.9, the biased variance: ``models/layers.py::BatchNorm2d``);
the JAX package's ``defer_bn_ema`` is one fused TPU update of the same
arithmetic and is not ported.

The CGFL losses leave the aux head without a gradient (``losses/cgfl.py``).
optax's SGD still decays and moves such a parameter, while ``torch.optim.SGD``
skips one whose ``.grad`` is None; the step gives those parameters a zero
gradient, so the update is optax's.

Tensors are NCHW: the batch is dict(image (B, 3, H, W) f32, mask (B, H, W)
integer, ``ignore_index`` ignored).
"""
from __future__ import annotations

from typing import Iterable, NamedTuple

import torch
from torch.profiler import record_function

from .._device import resolve_device
from ..infer.tta import tta
from ..losses.cgfl import segmentation_loss_aux
from ..metrics.seg import SegMetricAccumulator
from .optim import make_sgd, poly_schedule
from .state import TrainState


class RSSFormerTrainConfig(NamedTuple):
    base_lr: float = 0.01
    power: float = 0.9
    max_iters: int = 30000
    momentum: float = 0.9
    weight_decay: float = 1e-4
    grad_clip: float = 35.0
    num_classes: int = 7
    ignore_index: int = -1


def create_rssformer_state(model, cfg: RSSFormerTrainConfig) -> TrainState:
    """The optimiser state over ``model``'s parameters, as they are: clip, SGD
    with momentum and L2 weight decay at the poly rate."""
    return TrainState.create(model, make_sgd(
        model, cfg.base_lr, cfg.weight_decay, cfg.momentum,
        schedule=poly_schedule(cfg.base_lr, cfg.max_iters, cfg.power),
        grad_clip_norm=cfg.grad_clip))


def rssformer_losses(model, batch, generator: torch.Generator | None = None) -> dict:
    """The training forward of ``model`` (an ``HRNetFusion``, in the mode it is
    in; ``generator`` draws the HRFormer backbone's drop-path masks) and its CGFL
    loss dict: ``segmentation_loss_aux`` with the model's ``loss_config`` (None:
    {"ce": {}}) and ``ignore_index``."""
    logit, aux_logits = model(batch["image"], generator)
    return segmentation_loss_aux(logit, batch["mask"], aux_logits,
                                 model.loss_config or {"ce": {}}, model.ignore_index)


def make_rssformer_train_step(model, cfg: RSSFormerTrainConfig,
                              device: torch.device | str | None = None):
    """One training iteration as a function ``train_step(state, batch,
    generator=None) -> (state, metrics)``: forward in training mode, the CGFL
    losses and their sum, backward, one update. ``state`` is a ``TrainState``
    over ``model`` (``create_rssformer_state``); it is updated in place and
    returned. The batch is moved to ``device``, the card unless the caller
    names another (it raises where there is none). ``generator`` (a CPU
    ``torch.Generator``; None is the global one) draws the drop-path masks of an
    HRFormer backbone (``hrt_*``); the HRNetV2 stack draws nothing (its dropout
    and drop path are 0). metrics holds the losses and ``total``, detached. The
    profiler sees forward, backward and optimizer."""
    device = resolve_device(device)

    def train_step(state: TrainState, batch, generator: torch.Generator | None = None):
        model.train()
        batch = {k: v.to(device) for k, v in batch.items()}
        with record_function("forward"):
            losses = rssformer_losses(model, batch, generator)
            total = sum(losses.values())
        with record_function("backward"):
            total.backward()
        with record_function("optimizer"):
            for p in state.tx.params:   # optax decays a parameter without gradient too
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            state.apply_gradients()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total"] = total.detach()
        return state, metrics

    return train_step


def make_rssformer_eval_step(model):
    """``eval_step(image) -> probabilities`` (B, classes, H, W): the model in eval
    mode (running statistics), no gradient."""

    @torch.no_grad()
    def eval_step(image: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(image)

    return eval_step


def evaluate(model, batches: Iterable, num_classes: int, tta_transforms=None,
             device: torch.device | str | None = None) -> dict:
    """PixelMetric-style evaluation (`train.py:14-56` ``evaluate_cls_fn``),
    optionally with TTA (`eval.py:58-65`, ``infer/tta.py``): ``batches`` yields
    (image (B, 3, H, W), mask (B, H, W)); the argmax of the (averaged)
    probabilities is counted against the mask on ``device`` (the card unless
    the caller names another). Returns ``scores_from_hist``'s dict."""
    device = resolve_device(device)
    eval_step = make_rssformer_eval_step(model)
    acc = SegMetricAccumulator(num_classes)
    for image, mask in batches:
        image = torch.as_tensor(image).to(device)
        probs = tta(eval_step, image, tta_transforms) if tta_transforms else eval_step(image)
        acc.update(torch.as_tensor(mask).to(device), probs.argmax(1))
    return acc.compute()
