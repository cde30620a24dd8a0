"""Process grid and batch placement, the port of
``representationlearning_tpu/parallel/mesh.py`` on ``torch.distributed`` (the
reference's substrate is torch DDP over NCCL: `SCD-AAAI2023/scripts/dist_train_voc.py:185,286`).

One process a rank. ``init_distributed`` joins the default process group from
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``); ``make_mesh`` lays the ranks out as a ("data", "model") grid,
rank = data index * n_model + model index as the JAX mesh reshapes its devices,
with one process group a row and a column. Training is data-parallel over the
data axis (``parallel/collectives.py``); the sharded sliding window splits rows
over the model axis (``infer/sliding.py``). ``shard_batch`` gives this rank its
contiguous rows of a global batch, as ``jax.device_put`` with the data sharding
places them; ``replicate`` broadcasts rank 0's state.

Launch: ``python -m torch.distributed.run --nproc-per-node N -m <module> ...``
(NCCL, one card a rank); ``parallel/launch.py`` spawns gloo ranks for the tests.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .._device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def rank_device(device: torch.device | str | None = None) -> torch.device:
    """This rank's device: ``device`` where given, else ``cuda:LOCAL_RANK`` (the
    card of a torchrun rank; raises where there is no card, as every entry point
    does)."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def init_distributed(backend: str | None = None, init_method: str | None = None,
                     device: torch.device | str | None = None) -> bool:
    """Join the default process group (JAX's ``initialize_multihost``).

    Reads torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``
    (``init_method`` None is ``env://``). Returns False in a single process (no
    ``WORLD_SIZE`` and no ``init_method``), True once a group exists; where a
    default group exists already it is used as it is. ``backend`` None is NCCL
    for a CUDA ``device`` and gloo for the CPU; ``device`` None is
    ``rank_device()``. A CUDA device becomes the current one whenever this
    returns True, the group new or not."""
    joined = dist.is_initialized()
    if not joined and init_method is None and "WORLD_SIZE" not in os.environ:
        return False
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if joined:
        return True
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend=backend, init_method=init_method or "env://")
    return True


def process_rank() -> tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) in a single process."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


@dataclass(frozen=True)
class Mesh:
    """A ("data", "model") grid of ranks. ``data_group`` holds the ranks of this
    rank's column (same model index), ``model_group`` those of its row; a group of
    one rank is None (nothing to reduce)."""
    shape: dict = field(hash=False)
    coords: tuple[int, int]
    data_group: object = field(default=None, hash=False)
    model_group: object = field(default=None, hash=False)


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """A ``(n_data, n_model)`` grid of the default group's ranks (``n_data``
    None: all of them over ``n_model``). Every rank calls it, with the same
    arguments: the groups are made collectively."""
    rank, world = process_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} ranks, "
                         f"there are {world}")
    i, j = divmod(rank, n_model)
    data_group = model_group = None
    if n_data > 1:
        for col in range(n_model):   # every rank makes every group, in one order
            g = dist.new_group([r * n_model + col for r in range(n_data)])
            if col == j:
                data_group = g
    if n_model > 1:
        for row in range(n_data):
            g = dist.new_group([row * n_model + c for c in range(n_model)])
            if row == i:
                model_group = g
    return Mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model}, (i, j), data_group, model_group)


def process_local_slice(global_indices: np.ndarray) -> np.ndarray:
    """The ``DistributedSampler`` replacement (`dist_train_voc.py:214`): this
    rank's rank-strided subset of the global sample indices."""
    rank, world = process_rank()
    return np.asarray(global_indices)[rank::world]


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.shape[DATA_AXIS]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by data-parallel size {n}")
    return global_batch // n


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, value=0):
    """Pad leading batch to a device-divisible size; returns (padded, n_valid)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, rem)
    return np.pad(x, widths, constant_values=value), n


def batch_rows(global_batch: int, mesh: Mesh) -> slice:
    """This rank's contiguous rows of a global batch on the mesh's data axis."""
    b = local_batch_size(global_batch, mesh)
    return slice(mesh.coords[0] * b, (mesh.coords[0] + 1) * b)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a batch (a dict, tuple or list of arrays or tensors
    whose leading axis is the global batch; a list of per-sample items is cut the
    same way)."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return tuple(shard_batch(mesh, v) for v in batch)
    return batch[batch_rows(len(batch), mesh)]


def replicate(mesh: Mesh, obj):
    """Rank 0's parameters and buffers (an ``nn.Module``) or tensors (a list or
    dict) broadcast to every rank, in place; returns ``obj``. Nothing in a single
    process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    if isinstance(obj, nn.Module):
        tensors = list(obj.state_dict(keep_vars=True).values())
    elif isinstance(obj, dict):
        tensors = list(obj.values())
    else:
        tensors = list(obj)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data if isinstance(t, nn.Parameter) else t, src=0)
    return obj
