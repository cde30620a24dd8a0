"""Sliding-window inference over large tiles on one device, the port of the
single-device half of ``representationlearning_tpu/infer/sliding.py``
(`_accumulate_windows`, `pad_for_sliding`, `sliding_window_predict`). The
row-sharded path over several devices is not ported yet.

Semantics, as there: the image is zero-padded by ``halo = window - stride`` rows
top and bottom, windows slide at every ``stride`` step over the padded rows and
the columns, per-window outputs accumulate with a count map, the padded border is
cropped, and sums divide by counts. Images are (C, H, W); ``model_fn`` maps a
batch of windows (N, C, w, w) to (N, n_out, w, w); the result is (n_out, H, W).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def _accumulate_windows(model_fn, x, window, stride, n_out, row_starts):
    """x (C, H, W): run model_fn once on the stacked batch of all windows, then
    scatter-add the results. Returns (sums (n_out, H, W), counts (1, H, W))."""
    _, H, W = x.shape
    starts = [(r, c) for r in row_starts for c in range(0, W - window + 1, stride)]
    tiles = torch.stack([x[:, r: r + window, c: c + window] for r, c in starts])
    outs = model_fn(tiles).float()                                    # (N, n_out, w, w)

    # flat index map: tile t, pixel (i, j) -> (r + i) * W + (c + j)
    ij = torch.arange(window, device=x.device)
    base = ij[:, None] * W + ij[None, :]                              # (w, w)
    offs = torch.tensor([r * W + c for r, c in starts], device=x.device)
    idx = (offs[:, None, None] + base).reshape(-1)
    acc = torch.zeros((n_out, H * W), dtype=torch.float32, device=x.device)
    acc.index_add_(1, idx, outs.permute(1, 0, 2, 3).reshape(n_out, -1))
    cnt = torch.zeros((1, H * W), dtype=torch.float32, device=x.device)
    cnt.index_add_(1, idx, torch.ones((1, idx.numel()), device=x.device))
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
