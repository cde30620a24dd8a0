"""The dilated 8-neighbour stencil shared by the affinity (K2) and propagation
(K3) ops and by ``models/refine.py`` (`SCD-AAAI2023/network/VARM.py:6-20`).

Tap k of the K = 8 * len(dilations) taps is ``for d in dilations: for (dy, dx)
in OFFSETS`` and reads the replicate-padded input at (y + dy * d, x + dx * d).
The CUDA kernels under ``csrc/refine/`` hard-code the same order.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

# neighbour offsets in the reference kernel's order: row-major 3 x 3 minus the centre
OFFSETS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]
# distance weights: sqrt(2) on the diagonals (`VARM.py:53-58`)
DIST = np.array([np.sqrt(2), 1, np.sqrt(2), 1, 1, np.sqrt(2), 1, np.sqrt(2)], np.float32)


def shifted_views(x: torch.Tensor, dilations: Sequence[int]):
    """Yield the K replicate-padded neighbour views of x (B, C, H, W), in tap order."""
    H, W = x.shape[-2:]
    for d in dilations:
        xp = F.pad(x, (d, d, d, d), mode="replicate")
        for dy, dx in OFFSETS:
            yield xp[..., d + dy * d: d + dy * d + H, d + dx * d: d + dx * d + W]


def dilated_neighbors(x: torch.Tensor, dilations: Sequence[int]) -> torch.Tensor:
    """x (B, C, H, W) -> (B, K, C, H, W): 8 replicate-padded neighbours per dilation."""
    return torch.stack(list(shifted_views(x, dilations)), dim=1)
