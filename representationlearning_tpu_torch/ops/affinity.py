"""Kernel K2: the VARM / PAR / PAMR affinity weights
(`SCD-AAAI2023/network/VARM.py:40-84`, `RML/network/PAR.py:65-91`).

The counterpart of ``representationlearning_tpu/ops/pallas/affinity.py``
(``affinity_pallas``). From a 3-channel image it computes, per pixel, a softmax
over the K dilated neighbours of the negative squared colour distance, scaled by
the unbiased standard deviation of those neighbours, and then

    par    + w2 * softmax(position affinity)   (scale 1 / w1)
    pamr   nothing                             (scale 1 / w1)
    varm   - w2 * softmax(local variation)     (scale 4)

Images are (B, 3, H, W) f32, the weights (B, K, H, W) f32: channel-first, the
layout ``ops/varm.py`` (K3) consumes. ``affinity`` launches the CUDA kernel
(``csrc/refine/affinity.cu``) on a CUDA tensor and runs ``affinity_reference``,
the plain PyTorch composition over the materialised neighbour tensor, on a CPU
tensor. Nothing falls back: a build or launch failure raises.

The kernel sums over K in tap order where the plain version reduces in torch's
order, so the two agree to rounding (about 1e-6 on weights in [-w2, 1 + w2]),
not bit for bit; every plan of the kernel gives the same bits.

A block of the kernel stages 32 columns by ``rows`` rows of the image, plus the
halo its taps reach, in shared memory; each thread keeps its pixel's logits in
registers, for up to ``held`` dilations. ``affinity_plan`` picks (rows, held) from
the shapes.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import numpy as np
import torch

from . import _build
from .neighbors import DIST, dilated_neighbors

MODES = {"par": 0, "pamr": 1, "varm": 2}
MAX_DILATIONS = 16  # the kernel takes the dilation list as a by-value parameter

# launches of the kernel since the last reset; the wrapper adds one per launch
LAUNCHES = {"affinity": 0}

SMS = 132                     # SMs of one H100 SXM
SMEM_LIMIT = 227 * 1024       # dynamic shared memory a block may ask for on sm_90
SMEM_PER_SM = 228 * 1024      # shared memory of an SM, 1 KB of it reserved a block
REGS_PER_SM = 65536
# (rows a block, dilations held) -> registers a thread in par or pamr mode and in
# varm mode (which also keeps its variation's sums), as `ptxas -v` reports them: six
# dilations hold 48 logits a thread, sixteen 128 (in blocks of 128 threads).
AFFINITY_KERNELS = {(4, 6): (79, 96), (8, 6): (79, 96), (16, 6): (79, 96), (4, 16): (168, 232)}
# the work of a staged element (one copy) against that of a pixel (three passes over
# its K taps, a few thousand instructions), for the plan's estimate
AFFINITY_STAGE_WEIGHT = 1 / 200


def reset_launches() -> None:
    LAUNCHES["affinity"] = 0


def _pos_softmax(dilations: Sequence[int], w1: float) -> tuple:
    """PAR's position-affinity softmax (`PAR.py:49-63`): a K-vector constant."""
    pos = np.concatenate([DIST * d for d in dilations]).astype(np.float64)
    pa = -((pos / (pos.std(ddof=1) + 1e-8)) / w1) ** 2
    ex = np.exp(pa - pa.max())
    return tuple((ex / ex.sum()).astype(np.float32).tolist())


def _scale(mode: str, w1: float) -> float:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {sorted(MODES)}")
    return 4.0 if mode == "varm" else 1.0 / w1


def local_variation(nb: torch.Tensor) -> torch.Tensor:
    """Squared difference of the neighbour tensor (B, K, C, H, W) to its next
    output row and column, the last one replicated (`VARM.py:66-70`), averaged
    over the channels -> (B, K, 1, H, W)."""
    t1 = torch.cat([nb[..., 1:, :], nb[..., -1:, :]], dim=-2)
    t2 = torch.cat([nb[..., 1:], nb[..., -1:]], dim=-1)
    return ((nb - t1) ** 2 + (nb - t2) ** 2).mean(dim=2, keepdim=True)


def affinity_reference(imgs: torch.Tensor, dilations: Sequence[int], mode: str,
                       w1: float = 0.3, w2: float = 0.01) -> torch.Tensor:
    """Plain PyTorch K2 on any device: imgs (B, 3, H, W) -> (B, K, H, W) f32."""
    scale = _scale(mode, w1)
    imgs = imgs.float()
    nb = dilated_neighbors(imgs, dilations)                        # (B, K, 3, H, W)
    std = nb.std(dim=1, keepdim=True, unbiased=True)
    aff = -(((nb - imgs[:, None]).abs() / (std + 1e-8)) * scale) ** 2
    ref = torch.softmax(aff.mean(dim=2), dim=1)                    # (B, K, H, W)
    if mode == "par":
        pos = torch.tensor(_pos_softmax(dilations, w1), device=imgs.device)
        ref = ref + w2 * pos[None, :, None, None]
    elif mode == "varm":
        ref = ref - w2 * torch.softmax(local_variation(nb)[:, :, 0], dim=1)
    return ref


AFFINITY_HALO6 = 24           # the six-dilation kernels' strides fit a halo of up to 24
AFFINITY_PITCH6 = 32 + 2 * AFFINITY_HALO6 + 4


def _halos(H: int, W: int, dilations: Sequence[int]) -> tuple[int, int]:
    """Staged halo along y, and along x rounded up to 4 (rows copy in 16-byte pieces)."""
    md = max(dilations)
    return min(md, H - 1), -(-min(md, W - 1) // 4) * 4


def _staged(H: int, W: int, dilations: Sequence[int], rows: int, held: int) -> tuple[int, int]:
    """(rows, pitch) of a staged plane: the tile, its halo, and the next row and column
    the variation reads; the six-dilation kernels' fixed strides."""
    hy, hx4 = _halos(H, W, dilations)
    if held == 6:
        return rows + 2 * AFFINITY_HALO6 + 1, AFFINITY_PITCH6
    return rows + 2 * hy + 1, (32 + 2 * hx4 + 4) // 4 * 4


def affinity_smem_bytes(H: int, W: int, dilations: Sequence[int], mode: str,
                        rows: int, held: int) -> int:
    """Dynamic shared memory of a block: an mbarrier (128 bytes), the three staged
    planes and, in varm mode, a column of K variations a thread."""
    srows, pitch = _staged(H, W, dilations, rows, held)
    return 128 + 4 * (3 * srows * pitch + (8 * len(dilations) * 32 * rows if mode == "varm" else 0))


def affinity_takes(H: int, W: int, dilations: Sequence[int], mode: str, rows: int,
                   held: int) -> bool:
    """Whether the kernel of (rows, held) takes these shapes."""
    if (rows, held) not in AFFINITY_KERNELS or len(dilations) > held:
        return False
    hy, hx4 = _halos(H, W, dilations)
    return (held != 6 or max(hy, hx4) <= AFFINITY_HALO6) and \
        affinity_smem_bytes(H, W, dilations, mode, rows, held) <= SMEM_LIMIT


def affinity_blocks_per_sm(rows: int, held: int, mode: str, smem: int) -> int:
    """Blocks of a kernel an SM holds at once, by its shared memory, its registers
    (allocated 8 a thread at a time) and its threads (`chip_smoke.py` checks the
    estimate against the card's count)."""
    regs = AFFINITY_KERNELS[rows, held][mode == "varm"]
    by_regs = REGS_PER_SM // (32 * rows * -(-regs // 8) * 8)
    return max(1, min(SMEM_PER_SM // (smem + 1024), by_regs, 2048 // (32 * rows)))



@functools.lru_cache(maxsize=256)
def affinity_plan(B: int, H: int, W: int, dilations: tuple, mode: str) -> tuple[int, int]:
    """(rows, held) of the K2 kernel: six dilations held where there are at most six
    and the halo is at most 24, else sixteen; the rows whose blocks give the SM that
    gets the most of them the least work (its blocks, the grid over the SMs rounded
    up, times a block's pixels and staged elements). A function of the shapes only;
    every plan gives the same bits."""
    _scale(mode, 1.0)
    dilations = tuple(int(d) for d in dilations)
    held = 6 if len(dilations) <= 6 and max(_halos(H, W, dilations)) <= AFFINITY_HALO6 else 16
    takes = [r for r, h in sorted(AFFINITY_KERNELS) if h == held
             and affinity_takes(H, W, dilations, mode, r, h)]
    if not takes:
        raise ValueError(f"affinity: no kernel takes a {H} x {W} image at dilations "
                         f"{dilations} (the staged tile exceeds shared memory)")

    def work(r):
        blocks = B * math.ceil(H / r) * math.ceil(W / 32)
        hy, hx4 = _halos(H, W, dilations)
        staged = 3 * (r + 2 * hy + 1) * (32 + 2 * hx4 + 4)
        return math.ceil(blocks / SMS) * (32 * r + AFFINITY_STAGE_WEIGHT * staged)

    return min(takes, key=work), held


def check_affinity_plan(plan, H: int, W: int, dilations: Sequence[int],
                        mode: str) -> tuple[int, int]:
    """The plan as (rows, held), or ValueError if the kernel does not take it at these
    shapes."""
    try:
        rows, held = (int(v) for v in plan)
    except (TypeError, ValueError):
        raise ValueError(f"affinity: plan {plan!r} is not (rows, held)") from None
    if not affinity_takes(H, W, tuple(dilations), mode, rows, held):
        raise ValueError(f"affinity: plan {plan!r} is not one the kernel takes at {H} x {W}, "
                         f"dilations {tuple(dilations)}, mode {mode} ((rows, held) in "
                         f"{sorted(AFFINITY_KERNELS)})")
    return rows, held


def _dilations(dilations: Sequence[int]) -> tuple:
    dilations = tuple(int(d) for d in dilations)
    if not 0 < len(dilations) <= MAX_DILATIONS or min(dilations) < 1:
        raise ValueError(f"affinity: 1 to {MAX_DILATIONS} dilations >= 1, got {dilations}")
    return dilations


def affinity(imgs: torch.Tensor, dilations: Sequence[int], mode: str, w1: float = 0.3,
             w2: float = 0.01, plan=None) -> torch.Tensor:
    """K2 dispatcher: imgs (B, 3, H, W) f32 -> affinity weights (B, K, H, W) f32.
    `plan`: a (rows, held) other than `affinity_plan`'s, for tests and tuning; it is
    checked on any device, every plan gives the same bits on the card, and it
    changes nothing on the CPU."""
    scale = _scale(mode, w1)
    if plan is not None:
        plan = check_affinity_plan(plan, *imgs.shape[-2:], _dilations(dilations), mode)
    if not imgs.is_cuda:
        return affinity_reference(imgs, dilations, mode, w1, w2)
    dilations = _dilations(dilations)
    if imgs.ndim != 4 or imgs.shape[1] != 3:
        raise ValueError(f"affinity: imgs must be (B, 3, H, W), got {tuple(imgs.shape)}")
    if imgs.dtype != torch.float32:
        raise TypeError(f"affinity: dtype {imgs.dtype}, the kernel takes float32")
    if not imgs.is_contiguous():
        raise ValueError("affinity: imgs not contiguous")
    B, _, H, W = imgs.shape
    K = 8 * len(dilations)
    out = torch.empty((B, K, H, W), device=imgs.device, dtype=torch.float32)
    if out.numel():
        rows, held = affinity_plan(B, H, W, dilations, mode) if plan is None else plan
        pos = _pos_softmax(dilations, w1) if mode == "par" else (0.0,) * K
        lib = _build.load_library("refine")
        with torch.cuda.device(imgs.device):
            err = lib.k2_affinity(
                imgs.data_ptr(), out.data_ptr(), B, H, W,
                (ctypes.c_int * len(dilations))(*dilations), len(dilations), MODES[mode],
                scale, w2, (ctypes.c_float * K)(*pos), rows, held,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, "k2_affinity")
        LAUNCHES["affinity"] += 1
    return out
