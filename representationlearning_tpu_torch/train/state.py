"""Train state, the port of ``representationlearning_tpu/train/state.py``: the
step count, the model and the optimiser as one object. Where the JAX state is
an immutable tree that ``apply_gradients`` replaces, this one holds the module
and the ``Transform`` (``train/optim.py``) and updates them in place, which is
PyTorch's idiom; ``state_dict`` / ``load_state_dict`` give and take the whole of
it for checkpoints.
"""
from __future__ import annotations

import torch
from torch import nn

from .optim import Transform, clip_by_global_norm


class TrainState:
    def __init__(self, model: nn.Module, tx: Transform, step: int = 0):
        self.model, self.tx, self.step = model, tx, step

    @classmethod
    def create(cls, model: nn.Module, tx: Transform) -> "TrainState":
        return cls(model, tx, 0)

    def apply_gradients(self) -> "TrainState":
        """One update from the gradients that lie in ``.grad``: clip, the
        optimiser's step at the schedule's rate for this count, then the count
        and the schedule move on and the gradients are dropped."""
        if self.tx.grad_clip_norm is not None:
            clip_by_global_norm(self.tx.params, self.tx.grad_clip_norm)
        self.tx.optimizer.step()
        self.tx.scheduler.step()
        for p in self.tx.params:
            p.grad = None
        self.step += 1
        return self

    @property
    def learning_rates(self) -> list[float]:
        """The rate of each parameter group at the next update."""
        return [g["lr"] for g in self.tx.optimizer.param_groups]

    @property
    def variables(self) -> dict[str, torch.Tensor]:
        """Parameters and buffers (BatchNorm statistics) by name."""
        return self.model.state_dict()

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.tx.optimizer.state_dict(),
                "scheduler": self.tx.scheduler.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.tx.optimizer.load_state_dict(sd["optimizer"])
        self.tx.scheduler.load_state_dict(sd["scheduler"])
        self.step = int(sd["step"])
