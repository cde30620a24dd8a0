"""Checkpoint save / load / resume, the port of
``representationlearning_tpu/train/checkpoints.py`` with ``torch.save`` in the
place of Orbax: the same ``ckpt_dir/step_N`` layout (a directory per step, here
holding one ``state.pt``) and the same resume semantics (restore into an
existing state, the latest step unless one is named).
"""
from __future__ import annotations

import os

import torch

_FILE = "state.pt"


def save(ckpt_dir: str, step: int, state) -> str:
    """Save a ``TrainState`` (anything with ``state_dict()``) at `ckpt_dir/step_N`."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, os.path.join(path, _FILE))  # a reader sees a whole file or none
    return path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and d.split("_")[1].isdigit()
             and os.path.isfile(os.path.join(ckpt_dir, d, _FILE))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, state, step: int | None = None):
    """Restore into an existing ``TrainState`` (continue_train semantics): the
    tensors are loaded onto the devices the state's own already live on."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}", _FILE)
    state.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return state
