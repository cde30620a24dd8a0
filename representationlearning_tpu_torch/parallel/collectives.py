"""Collectives of the port's data-parallel and row-sharded paths, the port of
``representationlearning_tpu/parallel/collectives.py`` on ``torch.distributed``:
the gradient all-reduce (DDP's, `SCD-AAAI2023/scripts/dist_train_voc.py:286`),
cross-replica BatchNorm statistics (SyncBN, `segformer_head.py:53`) and the
neighbour halo exchange of the sharded sliding window.

The convention every data-parallel step of the package keeps:

- each rank's loss is its share of the global objective, and the shares of the
  ranks sum to it: a mean over the batch is this rank's sum over the global
  count (``share_of_mean``), a loss of batch-level sums (Tversky) is computed
  from the all-reduced sums and divided by the world size (``share``);
- every collective under autograd has its exact adjoint as its backward: the
  all-reduce sum's backward is an all-reduce sum of the cotangents
  (``global_sum``);
- parameter gradients are summed over ranks (``allreduce_grads``), not averaged.

So the data-parallel step on n ranks gives what the JAX package's sharded ``jit``
gives: the single-rank step on the global batch, to f32 summation order.

The data group of a step is set for its duration by ``data_parallel(mesh)``
(a context variable, so nothing outlives the ``with``); the losses, BatchNorm,
drop path, dropout and the augmentation draws read it. With no group active every
helper here returns its input or does what the single-device code did, bit for
bit. The masks and decisions of a step are drawn for the global batch from the
step's generator and each rank takes its own rows (``global_rows``), so n ranks
draw what one rank draws.

Backends: NCCL for CUDA tensors, one card a rank; gloo for CPU tensors, and for
CUDA tensors where several ranks share one card (NCCL refuses that). Under gloo
a CUDA tensor takes ``all_reduce``, ``broadcast`` and ``barrier`` only, so the
point-to-point exchanges and the gather move their slabs through host memory
there. The choice follows the group's backend and the tensor's device (never an
error caught), and is logged once a group.
"""
from __future__ import annotations

import contextlib
import contextvars
import logging
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

_log = logging.getLogger(__name__)


class DataGroup(NamedTuple):
    """A process group with this rank's place in it."""
    group: object   # torch.distributed.ProcessGroup
    rank: int
    size: int


_ACTIVE: contextvars.ContextVar[DataGroup | None] = contextvars.ContextVar(
    "data_group", default=None)
_STAGING_LOGGED: set[int] = set()


def as_data_group(mesh) -> DataGroup | None:
    """The data group of a ``parallel.mesh.Mesh`` as a ``DataGroup``; None for
    None or a mesh whose data axis is one rank."""
    group = None if mesh is None else mesh.data_group
    if group is None:
        return None
    return DataGroup(group, dist.get_rank(group), dist.get_world_size(group))


@contextlib.contextmanager
def data_parallel(mesh):
    """Inside, the data group of ``mesh`` (a ``parallel.mesh.Mesh`` or None, see
    ``as_data_group``) is the active data group: every batch-level reduction of
    the package is global over it."""
    token = _ACTIVE.set(as_data_group(mesh))
    try:
        yield _ACTIVE.get()
    finally:
        _ACTIVE.reset(token)


def active_data_group() -> DataGroup | None:
    return _ACTIVE.get()


# ------------------------------------------------------------------ transport
def _host_staged(group, t: torch.Tensor) -> bool:
    """Whether ``t`` crosses ``group`` through host memory: a CUDA tensor under
    gloo, which moves CUDA tensors only by all_reduce, broadcast and barrier."""
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    if staged and id(group) not in _STAGING_LOGGED:
        _STAGING_LOGGED.add(id(group))
        _log.info("gloo group of %d ranks: point-to-point exchanges and gathers of CUDA "
                  "tensors go through host memory", dist.get_world_size(group))
    return staged


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, a new tensor; no gradient."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum over the group. Backward: its adjoint, the sum over the
    group of the cotangents."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def _peer(group, rank: int) -> int:
    return dist.get_global_rank(group, rank)


def exchange(group, sends: list[tuple[torch.Tensor, int]],
             recvs: list[tuple[torch.Tensor, int]]) -> None:
    """Send each tensor of ``sends`` to its group rank and fill each of ``recvs``
    from its group rank, all at once (``batch_isend_irecv``); CUDA tensors under
    gloo through host memory."""
    tensors = [t for t, _ in sends + recvs]
    staged = bool(tensors) and _host_staged(group, tensors[0])
    host_recvs = [(torch.empty(t.shape, dtype=t.dtype) if staged else t, r) for t, r in recvs]
    ops = [dist.P2POp(dist.isend, (t.cpu() if staged else t).contiguous(), _peer(group, r),
                      group) for t, r in sends]
    ops += [dist.P2POp(dist.irecv, t, _peer(group, r), group) for t, r in host_recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if staged:
        for (dst, _), (src, _) in zip(recvs, host_recvs):
            dst.copy_(src)


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape on each), in group rank order, on ``t``'s
    device; CUDA tensors under gloo through host memory. No gradient."""
    staged = _host_staged(group, t)
    src = (t.cpu() if staged else t).contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out] if staged else out


# ----------------------------------------------------------- the JAX helpers
def psum_tree(tree, group):
    """The sum over ``group`` of every tensor of a pytree, flattened into one
    buffer a dtype and device and all-reduced once; a new tree."""
    leaves, spec = pytree.tree_flatten(tree)
    out = list(leaves)
    buckets: dict[tuple, list[int]] = {}
    for i, t in enumerate(leaves):
        buckets.setdefault((t.dtype, t.device), []).append(i)
    for idx in buckets.values():
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = part.view(leaves[i].shape)
    return pytree.tree_unflatten(out, spec)


def pmean_tree(tree, group):
    """The mean over ``group`` of every tensor of a pytree (DDP's gradient
    all-reduce as the JAX package states it)."""
    n = dist.get_world_size(group)
    return pytree.tree_map(lambda t: t / n, psum_tree(tree, group))


def allreduce_grads(params) -> None:
    """Sum every parameter's ``.grad`` over the active data group in place, one
    all-reduce a dtype; nothing without a group. Every rank holds a gradient for
    the same parameters."""
    dg = active_data_group()
    if dg is None:
        return
    params = [p for p in params if p.grad is not None]
    summed = psum_tree([p.grad for p in params], dg.group)
    for p, g in zip(params, summed):
        p.grad.copy_(g)


def sync_batch_stats(mean: torch.Tensor, var: torch.Tensor, group):
    """SyncBN as the JAX package states it: the mean over ``group`` of the means
    and of ``var + mean^2``, recombined (E[x^2] - E[x]^2). Differentiable, one
    all-reduce."""
    n = dist.get_world_size(group)
    both = _AllReduceSum.apply(torch.stack([mean, var + mean * mean]), group) / n
    m = both[0]
    return m, both[1] - m * m


def halo_exchange_1d(x: torch.Tensor, halo: int, axis: int, group) -> torch.Tensor:
    """``halo``-wide slabs from both neighbours along ``axis`` (rank - 1's last
    rows before, rank + 1's first rows after), zeros at the edge ranks (as a
    convolution's zero padding at the image's true border). No gradient."""
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("halo_exchange_1d carries no gradient; call it under torch.no_grad()")
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[axis]
    lo, hi = x.narrow(axis, 0, halo), x.narrow(axis, size - halo, halo)
    from_left, from_right = torch.zeros_like(lo), torch.zeros_like(hi)
    sends, recvs = [], []
    if idx > 0:
        sends.append((lo, idx - 1))
        recvs.append((from_left, idx - 1))
    if idx < n - 1:
        sends.append((hi, idx + 1))
        recvs.append((from_right, idx + 1))
    exchange(group, sends, recvs)
    return torch.cat([from_left, x, from_right], dim=axis)


# ------------------------------------------- the data-parallel step's helpers
def global_rows(n_local: int) -> tuple[int, slice]:
    """(global batch, this rank's rows of it) for a local batch of ``n_local``
    under the active data group; every rank holds as many rows. Without a group,
    (n_local, every row)."""
    dg = active_data_group()
    if dg is None:
        return n_local, slice(None)
    return n_local * dg.size, slice(dg.rank * n_local, (dg.rank + 1) * n_local)


def global_batch(n_local: int) -> int:
    return global_rows(n_local)[0]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the active data group, with the all-reduce's adjoint
    as its gradient; ``t`` itself without a group."""
    dg = active_data_group()
    return t if dg is None else _AllReduceSum.apply(t, dg.group)


def share(t):
    """A quantity every rank computes whole (from global sums), as this rank's
    share of it: divided by the world size; ``t`` itself without a group."""
    dg = active_data_group()
    return t if dg is None else t / dg.size


def share_of_mean(t: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of ``t`` over the global batch (its sum over
    the global count; the shares sum to the mean); ``t.mean()`` without a group."""
    dg = active_data_group()
    return t.mean() if dg is None else t.sum() / (t.numel() * dg.size)


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the global batch, on every rank, without gradient;
    ``t.mean()`` without a group."""
    dg = active_data_group()
    if dg is None:
        return t.mean()
    return all_reduce_sum(t.sum(), dg.group) / (t.numel() * dg.size)


class _SyncBatchNorm(torch.autograd.Function):
    """BatchNorm in training with the statistics of the group's global batch.

    Forward: this rank's count, mean and sum of squared deviations (M2) in its
    own row of a (ranks, 2C + 1) buffer, one all-reduce, then Chan's parallel
    formula (mean = sum n_i mean_i / N, M2 = sum M2_i + sum n_i (mean_i - mean)^2),
    as stable as two passes. The output is x * a + b with a = weight / sqrt(var +
    eps) and b = bias - mean * a, as ATen's batch_norm computes it. Backward: one
    all-reduce of (sum dy, sum dy (x - mean)) over the group for the input's
    gradient (none where the input needs none, the same on every rank); the
    weight's and bias's are this rank's sums, which ``allreduce_grads`` adds."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, dg):
        C = x.shape[1]
        dims = (0,) + tuple(range(2, x.ndim))
        keep = (1, C) + (1,) * (x.ndim - 2)
        n = x.numel() // C
        var_l, mean_l = torch.var_mean(x, dim=dims, unbiased=False)
        rows = x.new_zeros((dg.size, 2 * C + 1))
        rows[dg.rank] = torch.cat([mean_l, var_l * n, mean_l.new_full((1,), n)])
        dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=dg.group)
        means, m2, counts = rows[:, :C], rows[:, C:2 * C], rows[:, 2 * C:]
        total = counts.sum()
        mean = (counts * means).sum(0) / total
        var = (m2.sum(0) + (counts * (means - mean).square()).sum(0)) / total
        invstd = torch.rsqrt(var + eps)
        a = invstd * weight
        y = torch.addcmul((bias - mean * a).view(keep), x, a.view(keep))
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.dg, ctx.total = dg, total
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd = ctx.saved_tensors
        C = x.shape[1]
        dims = (0,) + tuple(range(2, x.ndim))
        keep = (1, C) + (1,) * (x.ndim - 2)
        xmu = x - mean.view(keep)
        sums = torch.stack([dy.sum(dims), (dy * xmu).sum(dims)])
        dx = None
        if ctx.needs_input_grad[0]:
            g = all_reduce_sum(sums, ctx.dg.group) / ctx.total
            dx = (dy - g[0].view(keep) - xmu * (g[1] * invstd * invstd).view(keep)) \
                * (invstd * weight).view(keep)
        return dx, sums[1] * invstd, sums[0], None, None


def sync_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BatchNorm in training over the channels (axis 1) of NC... ``x`` with the
    statistics of the active data group's global batch (SyncBN): (the output,
    the global mean, the global biased variance; the two without gradient). One
    all-reduce forward, one backward (``_SyncBatchNorm``)."""
    return _SyncBatchNorm.apply(x, weight, bias, eps, active_data_group())


def reduce_metrics(metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The step's detached per-rank shares as the global losses: summed over the
    active data group in one all-reduce; unchanged without a group."""
    dg = active_data_group()
    if dg is None or not metrics:
        return metrics
    keys = list(metrics)
    summed = all_reduce_sum(torch.stack([metrics[k].double() for k in keys]), dg.group)
    return {k: v.to(metrics[k].dtype) for k, v in zip(keys, summed.unbind())}
