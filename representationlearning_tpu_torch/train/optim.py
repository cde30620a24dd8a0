"""Optimisers and schedules, the port of ``representationlearning_tpu/train/optim.py``:
the reference's PolyWarmupAdamW / SGD (`SCD-AAAI2023/utils/optimizer.py:3-65`) with
its parameter groups (`scripts/dist_train_voc.py:254-284`): backbone at the base
learning rate, encoder norms frozen, cls / seg heads at 10x.

A schedule is a function step -> learning rate. An optimiser is a ``Transform``:
a ``torch.optim`` optimiser over the parameter groups, a ``LambdaLR`` that sets
each group's rate to its schedule at the count of updates made so far (the
first update reads the schedule at 0, as optax does), and the global-norm clip.
``train/state.py::TrainState`` steps the three together. The JAX package's
``flatten_transform`` is a TPU launch-count lever and is not ported.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Mapping, NamedTuple

import torch
from torch import nn


def poly_warmup_schedule(base_lr: float, warmup_iter: int, max_iter: int,
                         warmup_ratio: float = 1e-6, power: float = 1.0) -> Callable:
    """AdamW variant (`optimizer.py:18-28`): linear warm-up from ratio * lr, then
    (1 - t / max)^power decay."""

    def sched(step):
        step = float(step)
        if step < warmup_iter:
            mult = 1.0 - (1.0 - step / max(warmup_iter, 1)) * (1.0 - warmup_ratio)
        else:
            mult = max(1.0 - step / max_iter, 0.0) ** power
        return base_lr * mult

    return sched


def poly_warmup_sgd_schedule(base_lr: float, warmup_iter: int, max_iter: int,
                             power: float = 0.9) -> Callable:
    """SGD variant (`optimizer.py:35-65`): 10x poly warm-up, then shifted poly decay."""

    def sched(step):
        step = float(step)
        if step < warmup_iter:
            return base_lr * 10.0 * (1.0 - step / max(warmup_iter, 1)) ** power
        poly = 1.0 - (step - warmup_iter) / max(max_iter - warmup_iter, 1)
        return base_lr * max(poly, 0.0) ** power

    return sched


def poly_schedule(base_lr: float, max_iter: int, power: float = 0.9) -> Callable:
    """Plain poly rate (WaveCAM PolyOptimizer `misc/torchutils.py:9-24`; RSSFormer
    `configs/base/loveda.py:96-102`)."""

    def sched(step):
        return base_lr * max(1.0 - float(step) / max_iter, 0.0) ** power

    return sched


def sgdr_schedule(base_lr: float, steps_per_epoch: int, epoch_start: int = 1,
                  restart_mult: int = 2, total_steps: int | None = None) -> Callable:
    """Warm-restart cosine schedule (WaveCAM SGDROptimizer,
    `misc/torchutils.py:33-63`): cosine within a window whose length multiplies by
    `restart_mult` at each restart; the amplitude decays by 1 / (restarts + 1).
    A table, since the restart boundaries depend on the steps before;
    total_steps bounds its length."""
    total = total_steps or steps_per_epoch * 128
    lrs = []
    local, max_step, restarts = 0, steps_per_epoch * epoch_start, 0
    for _ in range(total):
        if local >= max_step:
            local = 0
            max_step *= restart_mult
            restarts += 1
        lrs.append(base_lr * (1 + math.cos(math.pi * local / max_step)) / 2 / (restarts + 1))
        local += 1

    def sched(step):
        return lrs[min(max(int(step), 0), total - 1)]

    return sched


def tscd_param_labels(names: Iterable[str]) -> dict[str, str]:
    """Label parameters, by their state_dict names, with the reference's groups
    (`TSCD_model.py:44-62`): encoder norms -> 'norm' (frozen), other encoder ->
    'backbone', classifier, attn_proj and decoder -> 'head10'."""
    labels = {}
    for name in names:
        parts = name.split(".")
        if parts[0] == "encoder":
            labels[name] = "norm" if any("norm" in p for p in parts[1:]) else "backbone"
        else:
            labels[name] = "head10"
    return labels


class Transform(NamedTuple):
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    grad_clip_norm: float | None = None
    # every parameter the gradient came for, the frozen ones too: the clip's norm
    # is taken over all of them
    params: tuple = ()


def clip_by_global_norm(params: Iterable[nn.Parameter], max_norm: float) -> None:
    """Scale every gradient in place by max_norm / max(norm, max_norm), norm the
    l2 norm over all of them (optax's ``clip_by_global_norm``)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = max_norm / norm.clamp(min=max_norm)
    for g in grads:
        g.mul_(scale)


def _named(params) -> list[tuple[str, nn.Parameter]]:
    if isinstance(params, nn.Module):
        return list(params.named_parameters())
    return list(params.items()) if isinstance(params, Mapping) else list(params)


def _scheduled(opt: torch.optim.Optimizer, scheds: list[Callable]):
    # the groups' lr is 1, so the lambda IS the rate
    return torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda=scheds)


def make_poly_warmup_adamw(params, learning_rate: float, weight_decay: float,
                           warmup_iter: int, max_iter: int, warmup_ratio: float = 1e-6,
                           power: float = 1.0, betas=(0.9, 0.999),
                           param_labels: Mapping[str, str] | Callable | None = None,
                           grad_clip_norm: float | None = None) -> Transform:
    """The reference optimiser over ``params`` (a module, or (name, parameter)
    pairs). Without ``param_labels`` one group at the base rate. With them (a
    mapping name -> label, or a function of the names such as
    ``tscd_param_labels``): 'backbone' at the base rate, 'head10' at 10x,
    'norm' frozen: no update, no decay, no moments."""
    named = _named(params)
    if param_labels is None:
        groups = {1.0: [p for _, p in named]}
    else:
        labels = param_labels([n for n, _ in named]) if callable(param_labels) \
            else param_labels
        mult = {"backbone": 1.0, "head10": 10.0}
        groups = {m: [] for m in mult.values()}
        for n, p in named:
            if labels[n] != "norm":
                groups[mult[labels[n]]].append(p)
        groups = {m: ps for m, ps in groups.items() if ps}
    opt = torch.optim.AdamW([{"params": ps} for ps in groups.values()], lr=1.0, betas=betas,
                            eps=1e-8, weight_decay=weight_decay)
    scheds = [poly_warmup_schedule(learning_rate * m, warmup_iter, max_iter, warmup_ratio, power)
              for m in groups]
    return Transform(opt, _scheduled(opt, scheds), grad_clip_norm, tuple(p for _, p in named))


def make_sgd(params, learning_rate: float, weight_decay: float = 1e-4, momentum: float = 0.9,
             schedule: Callable | None = None,
             grad_clip_norm: float | None = None) -> Transform:
    """SGD with momentum and torch-style L2 weight decay (RSSFormer
    `configs/base/loveda.py:63-67`, grad clip 35 `:74-77`): clip, add
    weight_decay * p to the gradient, momentum, then the scheduled rate."""
    named = _named(params)
    opt = torch.optim.SGD([p for _, p in named], lr=1.0, momentum=momentum,
                          weight_decay=weight_decay)
    sched = schedule or (lambda step: learning_rate)
    return Transform(opt, _scheduled(opt, [sched]), grad_clip_norm,
                     tuple(p for _, p in named))
