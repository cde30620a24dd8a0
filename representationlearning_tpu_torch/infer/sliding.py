"""Sliding-window inference over large tiles, the port of
``representationlearning_tpu/infer/sliding.py``: on one device
(``sliding_window_predict``) and row-sharded over the ranks of a mesh's model
axis with a halo exchange (``sharded_sliding_window_predict``).

Semantics, as there: the image is zero-padded by ``halo = window - stride`` rows
top and bottom, windows slide at every ``stride`` step over the padded rows and
the columns, per-window outputs accumulate with a count map, the padded border is
cropped, and sums divide by counts. Images are (C, H, W); ``model_fn`` maps a
batch of windows (N, C, w, w) to (N, n_out, w, w); the result is (n_out, H, W).

Sharded: each rank takes its slab of rows, pulls ``halo`` input rows from both
neighbours (``parallel/collectives.py::halo_exchange_1d``), runs the windows
whose start row it owns, and the accumulated strips go back to the ranks that own
those output rows. Where a strip's rows are covered by two ranks' windows, the
lower rank's partial sums are handed up before the upper rank adds its own, in
the order the single-device path adds them, so on the CPU the sharded result
equals ``sliding_window_predict`` on the same padding bit for bit (the JAX
package's claim, `infer/sliding.py:108-111`). On CUDA ``index_add_`` adds with
atomics, in no fixed order, on either path.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallel import collectives as C


def _window_tiles(x, window, stride, row_starts):
    """x (C, H, W): the stacked windows at every (row start, column start) and the
    flat index of each of their pixels in an (H * W) map, tile-major."""
    _, H, W = x.shape
    starts = [(r, c) for r in row_starts for c in range(0, W - window + 1, stride)]
    tiles = torch.stack([x[:, r: r + window, c: c + window] for r, c in starts])
    # flat index map: tile t, pixel (i, j) -> (r + i) * W + (c + j)
    ij = torch.arange(window, device=x.device)
    base = ij[:, None] * W + ij[None, :]                              # (w, w)
    offs = torch.tensor([r * W + c for r, c in starts], device=x.device)
    return tiles, (offs[:, None, None] + base).reshape(-1)


def _scatter(outs, idx, H, W, acc=None, cnt=None):
    """Add the window outputs (N, n_out, w, w) and their counts at ``idx`` into
    ``acc`` (n_out, H * W) and ``cnt`` (1, H * W), zeros where None, in index
    order."""
    n_out = outs.shape[1]
    dev = outs.device
    acc = torch.zeros((n_out, H * W), dtype=torch.float32, device=dev) if acc is None else acc
    cnt = torch.zeros((1, H * W), dtype=torch.float32, device=dev) if cnt is None else cnt
    acc.index_add_(1, idx, outs.permute(1, 0, 2, 3).reshape(n_out, -1))
    cnt.index_add_(1, idx, torch.ones((1, idx.numel()), device=dev))
    return acc, cnt


def _accumulate_windows(model_fn, x, window, stride, n_out, row_starts):
    """x (C, H, W): run model_fn once on the stacked batch of all windows, then
    scatter-add the results. Returns (sums (n_out, H, W), counts (1, H, W))."""
    _, H, W = x.shape
    tiles, idx = _window_tiles(x, window, stride, row_starts)
    acc, cnt = _scatter(model_fn(tiles).float(), idx, H, W)
    return acc.reshape(n_out, H, W), cnt.reshape(1, H, W)


def pad_for_sliding(image: torch.Tensor, window: int, stride: int, row_multiple: int = 1):
    """Zero-pad (C, H, W) so that the rows are a multiple of ``row_multiple *
    stride`` (and at least ``row_multiple * ceil(halo / stride) * stride``) and
    the columns are fully covered by stride-stepped windows. Returns (padded,
    (H, W))."""
    _, H, W = image.shape
    halo = window - stride
    rm = row_multiple * stride
    Hp = -(-H // rm) * rm
    if halo:
        Hp = max(Hp, row_multiple * (-(-halo // stride)) * stride)
    Wp = window + max(0, -(-(max(W, window) - window) // stride)) * stride
    if (Hp, Wp) != (H, W):
        image = F.pad(image, (0, Wp - W, 0, Hp - H))
    return image, (H, W)


def sliding_window_predict(model_fn: Callable, image: torch.Tensor, window: int, stride: int,
                           n_out: int) -> torch.Tensor:
    """image (C, H, W); ragged sizes are zero-padded to window coverage and
    cropped back. Returns the averaged outputs (n_out, H, W) in f32."""
    halo = window - stride
    image, (H, W) = pad_for_sliding(image, window, stride)
    xp = F.pad(image, (0, 0, halo, halo))
    row_starts = range(0, xp.shape[1] - window + 1, stride)
    acc, cnt = _accumulate_windows(model_fn, xp, window, stride, n_out, row_starts)
    rows = slice(halo, halo + image.shape[1])
    out = acc[:, rows] / cnt[:, rows].clamp_min(1.0)
    return out[:, :H, :W]


def sharded_sliding_window_predict(model_fn: Callable, image: torch.Tensor, mesh, window: int,
                                   stride: int, n_out: int, gather: bool = True):
    """The rows of ``image`` (C, H, W), the same on every rank, split over the
    model axis of ``mesh`` (a ``parallel.mesh.Mesh``; None is one rank). Every
    rank of that axis calls it. It pads with
    ``pad_for_sliding(..., row_multiple=n)``, and each rank runs the windows whose
    padded start row lies in its slab (the last rank also the trailing ones).

    Returns the averaged outputs (n_out, H, W) in f32 on every rank where
    ``gather``; else (this rank's rows (n_out, h, W) with the padding cropped,
    the first of those rows in the image)."""
    group = None if mesh is None else mesh.model_group
    n, idx = (1, 0) if group is None else (dist.get_world_size(group), dist.get_rank(group))
    halo = window - stride
    image, (H, W) = pad_for_sliding(image, window, stride, row_multiple=n)
    Wp = image.shape[2]
    Hs = image.shape[1] // n   # a multiple of stride, and at least the halo
    slab = image[:, idx * Hs:(idx + 1) * Hs]
    # padded-global window start g = idx * Hs + L, L on the extended slab; this
    # rank owns L in [0, Hs), the last rank also the starts up to Hs + halo - stride
    last = idx == n - 1
    with torch.no_grad():
        if halo and group is not None:
            ext = C.halo_exchange_1d(slab, halo, axis=1, group=group)
        else:
            ext = F.pad(slab, (0, 0, halo, halo))
        row_starts = range(0, (Hs + halo - stride if last else Hs - 1) + 1, stride)
        tiles, flat = _window_tiles(ext, window, stride, row_starts)
        outs = model_fn(tiles).float()
    He = Hs + 2 * halo
    acc = torch.zeros((n_out, He, Wp), dtype=torch.float32, device=outs.device)
    cnt = torch.zeros((1, He, Wp), dtype=torch.float32, device=outs.device)
    if halo and group is not None:
        # the strip of rows that rank idx - 1's windows reach: its partial sums
        # first, then this rank's own, as the single-device path adds them
        strip = torch.empty((n_out + 1, halo, Wp), dtype=torch.float32, device=outs.device)
        if idx > 0:
            C.exchange(group, [], [(strip, idx - 1)])
            acc[:, :halo], cnt[:, :halo] = strip[:n_out], strip[n_out:]
    _scatter(outs, flat, He, Wp, acc.view(n_out, -1), cnt.view(1, -1))
    if halo and group is not None:
        # hand the lower strip of this slab up, then take back the finished one
        if idx < n - 1:
            C.exchange(group, [(torch.cat([acc[:, Hs:Hs + halo], cnt[:, Hs:Hs + halo]]),
                                idx + 1)], [])
        sends = [(torch.cat([acc[:, :halo], cnt[:, :halo]]), idx - 1)] if idx > 0 else []
        recvs = [(strip, idx + 1)] if idx < n - 1 else []
        C.exchange(group, sends, recvs)
        if idx < n - 1:
            acc[:, Hs:Hs + halo], cnt[:, Hs:Hs + halo] = strip[:n_out], strip[n_out:]
    out = acc[:, halo:halo + Hs] / cnt[:, halo:halo + Hs].clamp_min(1.0)
    if not gather:
        top = idx * Hs
        return out[:, :max(0, min(H - top, Hs)), :W], top
    if group is not None:
        out = torch.cat(C.all_gather(out.contiguous(), group), dim=1)
    return out[:, :H, :W]
