"""Kernel K3: the VARM / PAR mask-propagation loop
(`SCD-AAAI2023/network/VARM.py:86-89`).

The counterpart of ``representationlearning_tpu/ops/pallas/varm.py``
(``varm_propagate_pallas``): ``num_iter`` times

    m'[b, c, y, x] = sum_k ref[b, k, y, x] * m[b, c, clamp(y + dy_k d_k), clamp(x + dx_k d_k)]

summed in tap order starting from the k = 0 term, in f32. Masks are (B, C, H, W),
the weights channel-first (B, K, H, W) as K2 (``ops/affinity.py``) writes them,
or (B, K, 1, H, W) as a plain affinity with a kept channel axis produces them.

``varm_propagate`` launches the CUDA kernel (``csrc/refine/varm.cu``) once per
iteration on a CUDA tensor, ping-ponging between two buffers, and runs
``varm_propagate_reference`` on a CPU tensor. The kernel multiplies and adds
without fusing the two, in the same order as the plain version, so on the same
inputs the two are equal bit for bit, at every plan. Nothing falls back: a build
or launch failure raises.

The kernel's persistent blocks walk steps of a tile and two of its planes: a tile
is 32 columns by ``tile_rows`` rows, a thread owns ``pixels`` of it and holds their
weights in registers for every plane of the tile it walks, and each step's planes,
with the tile's halo, are staged in shared memory. ``varm_plan`` picks (tile_rows,
pixels, blocks) from the shapes.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch

from . import _build
from .affinity import MAX_DILATIONS
from .neighbors import shifted_views

# launches of the kernel since the last reset: one per iteration
LAUNCHES = {"varm_propagate": 0}

SMS = 132                     # SMs of one H100 SXM
SMEM_LIMIT = 227 * 1024       # dynamic shared memory a block may ask for on sm_90
SMEM_PER_SM = 228 * 1024      # shared memory of an SM, 1 KB of it reserved a block
REGS_PER_SM = 65536
# (tile rows, pixels a thread) -> (threads, dilations it holds, registers a thread as
# `ptxas -v` reports them). Two pixels a thread hold 96 weights under launch bounds of
# 128 registers; one pixel holds up to 16 dilations (128 weights).
VARM_KERNELS = {(32, 2): (512, 6, 128), (16, 2): (256, 6, 128), (8, 2): (128, 6, 128),
                (8, 1): (256, 16, 215)}
VARM_HALO2 = 24               # the two-pixel kernels stage a fixed halo of 24 each side
VARM_PITCH2 = 32 + 2 * VARM_HALO2
VARM_STAGES = 2               # slots in a block's ring
VARM_PLANES = 3               # planes a step of the two-pixel kernels (one pixel: 1)
# a plan takes the largest tile with at least this many steps (tile, planes) for each
# block the card holds at once, so that a block's range is a few steps long
VARM_UNITS_PER_BLOCK = 4


def reset_launches() -> None:
    LAUNCHES["varm_propagate"] = 0


def _halo(max_d: int, n: int) -> int:
    """Halo of a staged tile along an axis of n pixels: an offset beyond n - 1
    clamps to the pixel n - 1 does."""
    return min(max_d, n - 1)


def varm_planes(pixels: int) -> int:
    """Planes a step of the kernel of `pixels` a thread."""
    return VARM_PLANES if pixels == 2 else 1


def varm_geometry(H: int, W: int, dilations: Sequence[int], tile_rows: int,
                  pixels: int) -> tuple[int, int, int]:
    """(staged rows, staged pitch, dynamic shared memory in bytes) of a kernel: the
    ring's mbarriers (128 bytes) and VARM_STAGES slots of `varm_planes` planes of a tile
    plus its halo (each slot 128-byte aligned). The two-pixel kernels stage a fixed
    halo of VARM_HALO2; the one-pixel kernel the largest dilation clamped to the
    plane, along x rounded up to 4 (rows 16-byte aligned)."""
    md = max(dilations)
    if pixels == 2:
        srows, pitch = tile_rows + 2 * VARM_HALO2, VARM_PITCH2
    else:
        srows, pitch = tile_rows + 2 * _halo(md, H), 32 + 2 * (-(-_halo(md, W) // 4) * 4)
    planes = varm_planes(pixels)
    return srows, pitch, 128 + 4 * VARM_STAGES * (-(-planes * srows * pitch // 32) * 32)


def varm_takes(H: int, W: int, dilations: Sequence[int], tile_rows: int, pixels: int) -> bool:
    """Whether the kernel of (tile_rows, pixels) takes these shapes."""
    if (tile_rows, pixels) not in VARM_KERNELS:
        return False
    held = VARM_KERNELS[tile_rows, pixels][1]
    md = max(dilations)
    fits = pixels != 2 or max(_halo(md, H), -(-_halo(md, W) // 4) * 4) <= VARM_HALO2
    return len(dilations) <= held and fits and \
        varm_geometry(H, W, dilations, tile_rows, pixels)[2] <= SMEM_LIMIT


def varm_blocks_per_sm(tile_rows: int, pixels: int, smem: int) -> int:
    """Blocks of a kernel an SM holds at once, by its shared memory, its registers
    (allocated 8 a thread at a time) and its threads (`chip_smoke.py` checks the
    estimate against the card's count)."""
    threads, _, regs = VARM_KERNELS[tile_rows, pixels]
    by_regs = REGS_PER_SM // (threads * -(-regs // 8) * 8)
    return max(1, min(SMEM_PER_SM // (smem + 1024), by_regs, 2048 // threads))


def varm_steps(B: int, C: int, H: int, W: int, plan, block: int) -> list[tuple]:
    """The steps block `block` of a launch walks, in the order it walks them on an
    even iteration (odd blocks walk backwards; the next iteration flips every block):
    (image, first plane, planes, tile row, tile column) each, as the kernel decodes
    its range of steps (tile-major, `varm_planes` planes a step)."""
    tile_rows, pixels, blocks = plan
    tiles_x, tiles_y = math.ceil(W / 32), math.ceil(H / tile_rows)
    planes = varm_planes(pixels)
    cp = math.ceil(C / planes)
    units = B * tiles_y * tiles_x * cp
    grid = min(blocks, units)
    steps = []
    for u in range(units * block // grid, units * (block + 1) // grid):
        tile, c = divmod(u, cp)
        b, t = divmod(tile, tiles_x * tiles_y)
        ty, tx = divmod(t, tiles_x)
        steps.append((b, planes * c, min(planes, C - planes * c), ty, tx))
    return steps[::-1] if block % 2 else steps


def varm_units(B: int, C: int, H: int, W: int, tile_rows: int, pixels: int) -> int:
    """Steps of a launch, each a tile and `varm_planes` of its planes: the work the
    persistent blocks share."""
    return B * math.ceil(C / varm_planes(pixels)) * math.ceil(H / tile_rows) * math.ceil(W / 32)


@functools.lru_cache(maxsize=256)
def varm_plan(B: int, C: int, H: int, W: int, dilations: tuple) -> tuple[int, int, int]:
    """(tile_rows, pixels, blocks) of the K3 kernel: the largest tile (the least halo
    staged a pixel) that gives each block the card holds at once at least
    VARM_UNITS_PER_BLOCK steps, else the tile with the most steps; two pixels a thread
    wherever that kernel takes the dilations. Blocks: one wave of the blocks the card
    holds, or one a step where there are fewer. A function of the shapes only; every
    plan gives the same bits."""
    dilations = tuple(int(d) for d in dilations)
    takes = [k for k in VARM_KERNELS if varm_takes(H, W, dilations, *k)]
    if not takes:
        raise ValueError(f"varm_propagate: no kernel takes a {H} x {W} plane at dilations "
                         f"{dilations} (the staged tile exceeds shared memory)")

    def resident(k):
        return varm_blocks_per_sm(*k, varm_geometry(H, W, dilations, *k)[2]) * SMS

    best = next((k for k in takes
                 if varm_units(B, C, H, W, *k) >= VARM_UNITS_PER_BLOCK * resident(k)),
                max(takes, key=lambda k: varm_units(B, C, H, W, *k)))
    return (*best, max(1, min(varm_units(B, C, H, W, *best), resident(best))))


def check_varm_plan(plan, H: int, W: int, dilations: Sequence[int]) -> tuple[int, int, int]:
    """The plan as (tile_rows, pixels, blocks), or ValueError if the kernel does not
    take it at these shapes."""
    try:
        tile_rows, pixels, blocks = (int(v) for v in plan)
    except (TypeError, ValueError):
        raise ValueError(f"varm_propagate: plan {plan!r} is not (tile_rows, pixels, "
                         "blocks)") from None
    if blocks < 1 or not varm_takes(H, W, tuple(dilations), tile_rows, pixels):
        raise ValueError(f"varm_propagate: plan {plan!r} is not one the kernel takes at "
                         f"{H} x {W}, dilations {tuple(dilations)} ((tile_rows, pixels) in "
                         f"{sorted(VARM_KERNELS)}, blocks >= 1)")
    return tile_rows, pixels, blocks


def _channel_first(ref: torch.Tensor, K: int) -> torch.Tensor:
    """(B, K, H, W), or (B, K, 1, H, W) with its unit axis dropped (a view)."""
    if ref.ndim == 5:
        if ref.shape[2] != 1:
            raise ValueError(f"ref (B, K, 1, H, W) expected, got {tuple(ref.shape)}")
        ref = ref[:, :, 0]
    if ref.ndim != 4 or ref.shape[1] != K:
        raise ValueError(f"ref must hold K = {K} taps on axis 1, got {tuple(ref.shape)}")
    return ref


def varm_propagate_reference(masks: torch.Tensor, ref: torch.Tensor,
                             dilations: Sequence[int], num_iter: int) -> torch.Tensor:
    """Plain PyTorch K3 on any device: a running sum over the K shifted views,
    without materialising the (B, K, C, H, W) neighbour tensor."""
    ref = _channel_first(ref, 8 * len(dilations))
    for _ in range(num_iter):
        acc = None
        for k, nb in enumerate(shifted_views(masks, dilations)):
            term = nb * ref[:, k: k + 1]
            acc = term if acc is None else acc + term
        masks = acc
    return masks


def _dilations(dilations: Sequence[int]) -> tuple:
    dilations = tuple(int(d) for d in dilations)
    if not 0 < len(dilations) <= MAX_DILATIONS or min(dilations) < 1:
        raise ValueError(f"varm_propagate: 1 to {MAX_DILATIONS} dilations >= 1, "
                         f"got {dilations}")
    return dilations


def varm_propagate(masks: torch.Tensor, ref: torch.Tensor, dilations: Sequence[int],
                   num_iter: int, plan=None) -> torch.Tensor:
    """K3 dispatcher: masks (B, C, H, W) f32, ref (B, K, H, W) or (B, K, 1, H, W)
    f32 -> the propagated masks (B, C, H, W). `plan`: a (tile_rows, pixels, blocks)
    other than `varm_plan`'s, for tests and tuning; it is checked on any device,
    every plan gives the same bits on the card, and it changes nothing on the CPU."""
    if plan is not None:
        plan = check_varm_plan(plan, *masks.shape[-2:], _dilations(dilations))
    if not masks.is_cuda:
        return varm_propagate_reference(masks, ref, dilations, num_iter)
    dilations = _dilations(dilations)
    ref = _channel_first(ref, 8 * len(dilations))
    if masks.ndim != 4:
        raise ValueError(f"varm_propagate: masks must be (B, C, H, W), got "
                         f"{tuple(masks.shape)}")
    B, C, H, W = masks.shape
    if ref.device != masks.device:
        raise ValueError(f"varm_propagate: ref on {ref.device}, masks on {masks.device}")
    if tuple(ref.shape) != (B, ref.shape[1], H, W):
        raise ValueError(f"varm_propagate: ref {tuple(ref.shape)} does not match masks "
                         f"{tuple(masks.shape)}")
    if masks.dtype != torch.float32 or ref.dtype != torch.float32:
        raise TypeError(f"varm_propagate: dtypes {masks.dtype}, {ref.dtype}; the kernel "
                        "takes float32")
    if not masks.is_contiguous():
        raise ValueError("varm_propagate: masks not contiguous")
    if num_iter <= 0 or not masks.numel():
        return masks
    ref = ref.contiguous()  # once, outside the iteration loop
    tile_rows, pixels, blocks = varm_plan(B, C, H, W, dilations) if plan is None else plan
    dil = (ctypes.c_int * len(dilations))(*dilations)
    lib = _build.load_library("refine")
    src, bufs = masks, (torch.empty_like(masks), torch.empty_like(masks))
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(num_iter):
            dst = bufs[i % 2]
            err = lib.k3_varm_iter(src.data_ptr(), ref.data_ptr(), dst.data_ptr(),
                                   B, C, H, W, dil, len(dilations), tile_rows, pixels,
                                   blocks, i, stream)
            _build.check(err, "k3_varm_iter")
            LAUNCHES["varm_propagate"] += 1
            src = dst
    return src
