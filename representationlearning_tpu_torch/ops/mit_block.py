"""Kernel K1: one whole MiT encoder block, for inference.

    y   = x + proj(softmax(q(ln1(x)) k(srln(sr(ln1(x))))^T * hd^-1/2) v)      [SRA]
    out = y + fc2(gelu(dwconv3x3(fc1(ln2(y)))))                              [MixFFN]

The counterpart of ``representationlearning_tpu/ops/pallas/mit_block.py``
(``fused_block_pallas``, whose body is ``_block_math``). The TPU kernel keeps one
whole image in VMEM; an H100 SM has 227 KB of shared memory, so on the card the
block runs as a few token-tiled CUDA kernels (``csrc/mit_block/``):

    ln_stats      LayerNorm row statistics (one-pass variance, eps 1e-6)
    linear        GEMM, LayerNorm prologue, bias/residual epilogue
                  (q, kv, proj + residual, fc1, fc2 + residual), its output
                  tile and the M tiles a block walks chosen by `linear_plan`
    sr_conv       the stride-sr sr x sr conv as an implicit-im2col GEMM (sr > 1),
                  split along K by `sr_conv_plan`, the slices added in order (bf16:
                  by a second kernel; f32: inside the thread-block cluster of a tile)
    attention     per-head softmax(q k^T * scale) v, optional raw-logit export;
                  bf16: one pass over the keys up to ATTN_ONE_PASS_KEYS, two
                  beyond; f32: one pass with an online softmax at every Nk, the
                  queries a block and the persistent blocks chosen by
                  `attention_plan`
    dwconv_gelu   3x3 depthwise conv + bias + exact (A&S erf) GELU, a thread
                  walking a run of rows over 4 channels x a run of columns
                  chosen by `dwconv_plan`

Intermediates between kernels stay f32; matmul operands are rounded to the
compute dtype (bf16, or f32 as the TPU kernel's default) and accumulate in f32,
LayerNorm, softmax and GELU run in f32 -- the numerics of the TPU kernel. On the
card the f32 products are 3xTF32 products (f32 to about 2^-21 of each product):
`linear`, `sr_conv` and `attention` run them on `wgmma` in kernels of their own for f32
(gemm_f32.cu, sr_conv_f32.cu, attention_f32.cu). The f32 `attention` takes one pass
over the keys with an online softmax: the bf16 kernels must normalise each row before
they round its probabilities to bf16 (two passes beyond ATTN_ONE_PASS_KEYS), while in
f32 nothing is rounded to bf16 and an online softmax differs from the plain version
only in the order of f32 operations (attention_f32.cu). Each of the five wrappers below runs its kernel on a
CUDA tensor (compute dtype f32 or bf16; anything else raises) and its plain PyTorch version,
``<name>_reference``, on a CPU tensor. ``fused_block_reference`` is the same
composition with the plain versions only; ``fused_block`` is the dispatcher.
Both take the PRE_SR variant of the TPU kernel (``_kernel_presr``): with ``h =
ln1(x)`` and ``xs = srnorm(srconv(h) + b)`` computed outside (``sr_reduce``) and
handed in, the block starts at q and kv.

Layouts follow the JAX kernel: tokens (B, N, C), N = H * W row-major. Weights
are torch layouts: ``nn.Linear`` (out, in), conv OIHW, depthwise (hid, 1, 3, 3).
"""
from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import Mapping

import torch
import torch.nn.functional as F

from . import _build

LN_EPS = 1e-6

# launches of each kernel since the last reset; the wrappers add one per launch
LAUNCHES = {"ln_stats": 0, "linear": 0, "sr_conv": 0, "attention": 0, "dwconv_gelu": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# The attention kernel with bf16 operands keeps all keys of an (image, head) in shared
# memory and the whole score rows in registers up to this many keys (one pass: K and V
# of ATTN_ONE_PASS_TILES keys, the first that holds Nk); beyond it, key tiles of
# ATTN_STREAM_KEYS stream through shared memory in two passes (csrc/mit_block/attention.cu).
ATTN_ONE_PASS_KEYS = 256
ATTN_ONE_PASS_TILES = (64, 128, 256)
ATTN_STREAM_KEYS = 64
# With f32 operands the kernel is `attention_wg_kernel` (3xTF32 `wgmma`,
# csrc/mit_block/attention_f32.cu): one or two consumer warpgroups of 64 queries and a
# producer warpgroup a block, persistent blocks walking units of 64 or 128 queries of one
# (image, head); key tiles of ATTN_WG_KEYS (K and V^T, written by the call's pre-pass into
# a workspace, keys padded to the tile; their TF32 small halves split in shared memory)
# through a ring of tensor-map copies, as many slots as fit beside each warpgroup's staged
# score tile, at most ATTN_WG_MAX_STAGES. The key tile is a constant: every plan gives
# the same bits.
ATTN_WG_KEYS = 64
ATTN_WG_QUERIES = (64, 128)
ATTN_WG_MAX_STAGES = 4
ATTN_SMS = 132

# The linear kernel (csrc/mit_block/gemm.cu) with bf16 operands: a block's output tile,
# (rows, columns), one of these instantiations (their index is the kernel's tile id),
# and the blocks of each that an SM holds at once; K walked in steps of LINEAR_K_STEP
# columns through LINEAR_STAGES[dtype] ring slots.
LINEAR_TILES = ((64, 64), (64, 128), (128, 256))
LINEAR_BLOCKS_PER_SM = (4, 3, 1)
LINEAR_STAGES = {torch.bfloat16: (3, 3, 4)}
LINEAR_WARPS = ((2, 2), (2, 2), (2, 4))   # warps along M and N
LINEAR_K_STEP = 32
# With f32 operands the kernel is `linear_wg_kernel` (3xTF32 `wgmma`): BM / 64 consumer
# warpgroups of 64 rows and a producer warpgroup a block, one block an SM, persistent
# blocks walking the output tiles; a ring of tensor-map copies of LINEAR_WG_K_STEP
# columns (128-byte rows of A, of the weights and of their TF32 small half), as many
# slots as fit, at most LINEAR_WG_MAX_STAGES.
LINEAR_TILES_F32 = ((128, 64), (128, 128), (64, 64))
LINEAR_BLOCKS_PER_SM_F32 = (1, 1, 1)
LINEAR_WG_K_STEP, LINEAR_WG_MAX_STAGES = 32, 8
SMEM_LIMIT = 227 * 1024       # dynamic shared memory a block may ask for on sm_90
LINEAR_SMS = 132
LINEAR_WIDE_MIN_BLOCKS = 96   # the 128 x 256 tile needs about one block an SM
LINEAR_MAX_PER = 4
LINEAR_MAX_GROUPS = 65535     # the grid's second dimension


def linear_tiles(dtype=torch.bfloat16) -> tuple[tuple[int, int], ...]:
    """The output tiles (rows, columns) of the linear kernel with `dtype` operands; a
    tile's index is the kernel's tile id."""
    return LINEAR_TILES_F32 if dtype == torch.float32 else LINEAR_TILES


def _wg_stage_bytes(tile: int) -> int:
    bm, bn = LINEAR_TILES_F32[tile]
    return (bm + 2 * bn) * LINEAR_WG_K_STEP * 4


def linear_stages(tile: int, dtype) -> int:
    """Slots of the kernel's ring: bf16 LINEAR_STAGES; f32 as many as fit in
    SMEM_LIMIT beside the barriers and 1 KB of alignment, at most LINEAR_WG_MAX_STAGES
    (gemm.cu's `lwg_stages`)."""
    if dtype != torch.float32:
        return LINEAR_STAGES[dtype][tile]
    return min(LINEAR_WG_MAX_STAGES, (SMEM_LIMIT - 1024 - 24 * LINEAR_WG_MAX_STAGES)
               // _wg_stage_bytes(tile))


def linear_smem_bytes(tile: int, dtype) -> int:
    """Shared memory of the linear kernel's tile `tile` (an index of
    `linear_tiles(dtype)`), as gemm.cu counts it. bf16 (`linear_smem`): the ring of f32
    A steps (pitch 32), the ring of weight steps (a row of 32 and 16 bytes), the bf16 A
    double buffer and each warp's 8 staged rows. f32 (`lwg_smem`): the ring's slots of
    A (rows of 128 bytes), the weights and their TF32 small half, the ring's barriers
    and 1 KB to align it."""
    if dtype == torch.float32:
        return 1024 + 24 * LINEAR_WG_MAX_STAGES + linear_stages(tile, dtype) * _wg_stage_bytes(tile)
    (bm, bn), (wm, wn) = LINEAR_TILES[tile], LINEAR_WARPS[tile]
    stages, size = LINEAR_STAGES[dtype][tile], torch.finfo(dtype).bits // 8
    pitch = LINEAR_K_STEP + 16 // size
    return (stages * bm * LINEAR_K_STEP * 4 + stages * bn * pitch * size
            + 2 * bm * pitch * 2 + wm * wn * 8 * (bn // wn + 8) * 4)


def _linear_plan_f32(M: int, Nout: int, K: int) -> tuple[tuple[int, int], int]:
    """The f32 tile whose waves of one tile an SM take the fewest SM cycles by a model
    of the kernel: a column of K costs a BM x BN tile the larger of its products (three
    TF32 products of BM x BN, 1024 multiply-adds an SM a cycle) and its copies (BM + BN
    f32 at 24 bytes an SM a cycle from L2), the epilogue BM x BN / 3 (so that a product
    of one wave takes the tile with the shortest chain a block: 64 x 64 at the kv of the
    first stages); blocks one a tile up to one an SM."""
    best = None
    for t, (bm, bn) in enumerate(LINEAR_TILES_F32):
        tiles = max(1, math.ceil(M / bm)) * math.ceil(Nout / bn)
        per_column = max(3 * bm * bn / 1024, (bm + bn) * 4 / 24)
        cost = math.ceil(tiles / LINEAR_SMS) * (K * per_column + bm * bn / 3)
        if best is None or cost < best[0]:
            best = (cost, t, tiles)
    _, t, tiles = best
    return LINEAR_TILES_F32[t], min(tiles, LINEAR_SMS)


@functools.lru_cache(maxsize=1024)   # the host's time a launch counts: shapes repeat
def linear_plan(M: int, Nout: int, K: int, dtype=torch.bfloat16) -> tuple[tuple[int, int], int]:
    """The plan of the linear kernel for an (M, K) x (K, Nout) product. bf16: (tile,
    per), the block's output tile and the number of M tiles a block walks: the 128 x 256
    tile (half the L2 traffic of the others per product) where 256 divides Nout and it
    still gives about one block an SM, its blocks walking up to LINEAR_MAX_PER M tiles so
    that the grid is about one wave; else the 64 x 128 tile where it gives at least two
    blocks an SM; else 64 x 64. The four-warp tiles walk one M tile a block: three or
    four of them share an SM. f32: (tile, blocks), a tile of `LINEAR_TILES_F32` and the
    number of persistent blocks (`_linear_plan_f32`). A function of the shapes only;
    every plan sums each output over its whole K in the same order, so all give the
    same bits."""
    if K % LINEAR_K_STEP:
        raise ValueError(f"linear: K={K} is not a multiple of {LINEAR_K_STEP}")
    if dtype == torch.float32:
        return _linear_plan_f32(M, Nout, K)

    def blocks(t):
        rows, cols = LINEAR_TILES[t]
        return max(1, math.ceil(M / rows)) * math.ceil(Nout / cols)

    if Nout % 256 == 0 and blocks(2) >= LINEAR_WIDE_MIN_BLOCKS:
        t = 2
    elif Nout > 64 and blocks(1) >= 2 * LINEAR_SMS:
        t = 1
    else:
        t = 0
    per = 1
    if LINEAR_BLOCKS_PER_SM[t] == 1:
        per = min(LINEAR_MAX_PER, math.ceil(blocks(t) / LINEAR_SMS))
    mtiles = max(1, math.ceil(M / LINEAR_TILES[t][0]))
    return LINEAR_TILES[t], max(per, math.ceil(mtiles / LINEAR_MAX_GROUPS))


def check_linear_plan(plan, dtype=torch.bfloat16) -> tuple[int, int]:
    """(tile id, per or blocks) of a plan, or ValueError if the kernel does not take it."""
    try:
        tile, n = plan
        tile, n = (int(tile[0]), int(tile[1])), int(n)
    except (TypeError, ValueError, IndexError):
        raise ValueError(f"linear: plan {plan!r} is not ((rows, columns), count)") from None
    tiles = linear_tiles(dtype)
    if tile not in tiles or n < 1:
        raise ValueError(f"linear: plan {plan!r} is not one the kernel takes with {dtype} "
                         f"operands (tile in {tiles}, count >= 1)")
    return tiles.index(tile), n


def _attn_wg_stage_bytes(hd: int) -> int:
    return 16 * hd * ATTN_WG_KEYS     # K, V^T and their small halves, f32


def attention_stages(queries: int, hd: int) -> int:
    """Slots of the f32 kernel's ring: as many as fit in SMEM_LIMIT beside 1 KB of
    alignment, the barriers and the consumer warpgroups' staged score tiles, at most
    ATTN_WG_MAX_STAGES (attention_f32.cu's `aw_stages`)."""
    staging = queries * ATTN_WG_KEYS * 4
    return min(ATTN_WG_MAX_STAGES, (SMEM_LIMIT - 1024 - 24 * ATTN_WG_MAX_STAGES - staging)
               // _attn_wg_stage_bytes(hd))


def attention_smem_bytes(plan, hd: int, dtype) -> int:
    """Shared memory of the attention kernel that `plan` (of `attention_plan`) runs at
    head width `hd`. f32 (`aw_smem`): 1 KB to align, the ring (K, V^T and their small
    halves a slot), a 64 x ATTN_WG_KEYS score tile a consumer warpgroup, the barriers.
    bf16: the one-pass form's K and V of `keys` keys, or the streaming form's ring of
    three K and V tiles, rows of hd bf16 and 16 bytes (`launch_onepass`,
    `launch_stream`)."""
    if dtype == torch.float32:
        queries = plan[0]
        return (1024 + attention_stages(queries, hd) * _attn_wg_stage_bytes(hd)
                + queries * ATTN_WG_KEYS * 4 + 24 * ATTN_WG_MAX_STAGES)
    form, keys = plan
    rows = 2 * keys if form == "one_pass" else 3 * 2 * keys
    return rows * 2 * (hd + 8)


def attention_workspace_elems(B: int, Nk: int, C: int, dtype) -> int:
    """Elements of the workspace the kernel's pre-pass fills: bf16, k and v head by head
    (B Nk 2C); f32, K and V^T head by head, V^T's keys padded to a multiple of
    ATTN_WG_KEYS."""
    if dtype == torch.float32:
        nkp = -(-Nk // ATTN_WG_KEYS) * ATTN_WG_KEYS
        return B * C * (Nk + nkp)
    return B * Nk * 2 * C


def attention_units(B: int, N: int, nh: int, queries: int) -> int:
    """Units of work of the f32 kernel: `queries` queries of one (image, head)."""
    return B * nh * -(-N // queries)


@functools.lru_cache(maxsize=1024)   # the host's time a launch counts: shapes repeat
def attention_plan(B: int, N: int, Nk: int, C: int, nh: int, dtype=torch.bfloat16):
    """The plan of the attention kernel. f32: (queries, blocks), the queries a block
    (128, two consumer warpgroups side by side, unless that leaves more than half the
    SMs without a unit: then 64) and the persistent blocks, one a unit up
    to one an SM. bf16: the form its kernel takes by itself, ("one_pass", keys) with the
    smallest of ATTN_ONE_PASS_TILES that holds Nk, or ("streaming", ATTN_STREAM_KEYS)
    beyond ATTN_ONE_PASS_KEYS. A function of the shapes only; every f32 plan gives the
    same bits."""
    if dtype == torch.float32:
        queries = 128 if 2 * attention_units(B, N, nh, 128) > ATTN_SMS else 64
        return queries, max(1, min(attention_units(B, N, nh, queries), ATTN_SMS))
    if Nk > ATTN_ONE_PASS_KEYS:
        return "streaming", ATTN_STREAM_KEYS
    return "one_pass", next(k for k in ATTN_ONE_PASS_TILES if Nk <= k)


def check_attention_plan(plan, B: int, N: int, Nk: int, C: int, nh: int,
                         dtype=torch.bfloat16):
    """The plan as the kernel takes it, or ValueError: f32, (queries, blocks) with
    queries one of ATTN_WG_QUERIES and at least one block; bf16, only its own form
    (`attention_plan`'s)."""
    if dtype != torch.float32:
        want = attention_plan(B, N, Nk, C, nh, dtype)
        if plan != want:
            raise ValueError(f"attention: plan {plan!r} is not one the bf16 kernel takes: it "
                             f"chooses its form from Nk ({want!r})")
        return want
    try:
        queries, blocks = plan
        queries, blocks = int(queries), int(blocks)
    except (TypeError, ValueError):
        raise ValueError(f"attention: plan {plan!r} is not (queries, blocks)") from None
    if queries not in ATTN_WG_QUERIES or blocks < 1:
        raise ValueError(f"attention: plan {plan!r} is not one the f32 kernel takes: queries "
                         f"one of {ATTN_WG_QUERIES}, blocks at least 1")
    return queries, blocks


# The sr conv kernel with bf16 operands (csrc/mit_block/sr_conv.cu): output tiles of
# SR_TILE_M rows, K walked in steps of SR_K_STEP columns.
SR_TILE_M, SR_K_STEP = 64, 32
SR_TARGET_BLOCKS = 2 * 132   # two thread blocks on each of the H100's 132 SMs
SR_MIN_STEPS = 4             # a slice shorter than this is all prologue
SR_MAX_SLICES = 32
# With f32 operands the kernel is `sr_conv_wg_kernel` (3xTF32 `wgmma`,
# csrc/mit_block/sr_conv_f32.cu): a block is rows / 64 consumer warpgroups and a producer
# warpgroup, owns one output tile of SR_WG_ROWS x SR_WG_COLUMNS and one K slice; the K
# slices of a tile are the blocks of one thread-block cluster (at most SR_WG_MAX_SLICES,
# the H100's largest; above 8 a non-portable size), which sums them in slice order. A
# ring of tensor-map copies of SR_K_STEP columns (an im2col box of the tokens, the weights
# and their TF32 small half), as many slots as fit beside a copy of the LayerNorm vectors
# (SR_WG_MAX_C channels) and the barriers, at most SR_WG_MAX_STAGES.
SR_WG_ROWS = (64, 128)
SR_WG_COLUMNS = (32, 64, 96, 128, 160, 192)
SR_WG_MAX_SLICES, SR_WG_MAX_STAGES, SR_WG_MAX_C = 16, 8, 512
SR_WG_MIN_STEPS = 2            # a slice shorter than this is all prologue
# clusters of 1 to 16 blocks (one an SM) that the H100 holds at once: its SMs come in groups,
# and a cluster lies in one (`cudaOccupancyMaxActiveClusters`, `k1_sr_conv_wg_clusters`;
# chip_smoke.py checks them). A grid of more clusters runs in two waves.
SR_WG_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7)


def sr_conv_columns(C: int) -> int:
    """The f32 kernel's widest output tile for C channels: C cut into the fewest tiles of
    at most 192 columns, each a multiple of 32 (C 64 -> 64, 128 -> 128, 320 -> 2 x 160)."""
    tiles = max(1, math.ceil(C / SR_WG_COLUMNS[-1]))
    return SR_K_STEP * math.ceil(C / tiles / SR_K_STEP)


def _sr_slices(steps: int, tiles: int) -> int:
    """The f32 kernel's K slices for `tiles` output tiles: the most whose clusters the card
    holds in one wave (SR_WG_CLUSTERS), at most SR_WG_MAX_SLICES, at least SR_WG_MIN_STEPS
    K steps a slice, none empty."""
    s = max([n for n in range(1, SR_WG_MAX_SLICES + 1) if tiles <= SR_WG_CLUSTERS[n - 1]]
            + [1])
    s = min(s, max(1, steps // SR_WG_MIN_STEPS))
    return math.ceil(steps / math.ceil(steps / s))


def _sr_conv_plan_f32(M: int, C: int, K: int) -> tuple[tuple[int, int], int]:
    steps = K // SR_K_STEP
    # few rows (the WSSS command lines' validation and CAM forwards): a slice's K steps are
    # the launch's critical path, so the narrowest columns whose 64-row tiles the card holds
    # in one wave at the most slices K allows
    most = _sr_slices(steps, 1)
    for bn in range(SR_K_STEP, sr_conv_columns(C) + 1, SR_K_STEP):
        if _sr_slices(steps, math.ceil(M / 64) * math.ceil(C / bn)) == most:
            return (64, bn), most
    bn = sr_conv_columns(C)
    ntiles = math.ceil(C / bn)

    def blocks(rows):
        tiles = max(1, math.ceil(M / rows)) * ntiles
        return tiles * _sr_slices(steps, tiles), _sr_slices(steps, tiles)

    rows = 128 if M > 64 and blocks(128)[0] >= blocks(64)[0] else 64
    return (rows, bn), blocks(rows)[1]


@functools.lru_cache(maxsize=1024)   # the host's time a launch counts: shapes repeat
def sr_conv_plan(M: int, C: int, K: int, dtype=torch.bfloat16):
    """The plan of the sr conv kernel for an (M, K) x (K, C) product. bf16: (tile,
    slices), the width of a block's output tile and the number of slices K is cut into,
    so that tiles x slices comes as near to SR_TARGET_BLOCKS as the work allows. f32:
    ((rows, columns), slices), the output tile and the K slices, the blocks of one cluster
    (`_sr_slices`): where some column width lets 64-row tiles take the most slices K allows
    in one wave, the narrowest such; else `sr_conv_columns` and the rows whose one wave
    holds the more blocks, 128 on a tie where M has more than 64 rows (a tile's A is
    normalised and split once for twice the products). A function of the shapes only: the
    same call always adds in the same order."""
    if K % SR_K_STEP:
        raise ValueError(f"sr_conv: K={K} is not a multiple of {SR_K_STEP}")
    if dtype == torch.float32:
        return _sr_conv_plan_f32(M, C, K)
    tile = 64 if C <= 64 else 128
    steps = K // SR_K_STEP
    tiles = max(1, math.ceil(M / SR_TILE_M)) * math.ceil(C / tile)
    slices = min(math.ceil(SR_TARGET_BLOCKS / tiles), max(1, steps // SR_MIN_STEPS),
                 SR_MAX_SLICES)
    per = math.ceil(steps / slices)
    return tile, math.ceil(steps / per)     # no slice is empty


def check_sr_conv_plan(plan, K: int, dtype=torch.bfloat16):
    """An f32 plan as the kernel takes it, ((rows, columns), slices), or ValueError: rows
    of SR_WG_ROWS, columns of SR_WG_COLUMNS, slices that leave none empty, at most
    SR_WG_MAX_SLICES. A bf16 plan (tile, slices) is checked by the kernel, which raises
    at launch."""
    if dtype != torch.float32:
        return plan
    try:
        (rows, cols), slices = plan
        rows, cols, slices = int(rows), int(cols), int(slices)
    except (TypeError, ValueError):
        raise ValueError(f"sr_conv: plan {plan!r} is not ((rows, columns), slices)") from None
    if (rows not in SR_WG_ROWS or cols not in SR_WG_COLUMNS
            or slices not in sr_conv_slice_counts(K, dtype)):
        raise ValueError(f"sr_conv: plan {plan!r} is not one the f32 kernel takes: rows one of "
                         f"{SR_WG_ROWS}, columns one of {SR_WG_COLUMNS}, slices one of "
                         f"{sr_conv_slice_counts(K, dtype)}")
    return (rows, cols), slices


def _sr_wg_fixed_bytes() -> int:
    """The f32 kernel's shared memory beside its ring: 1 KB to align the ring, the
    LayerNorm weight and bias of SR_WG_MAX_C channels, 3 barriers a slot and the sum's."""
    return 1024 + 2 * SR_WG_MAX_C * 4 + 8 * (3 * SR_WG_MAX_STAGES + 1)


def sr_conv_stages(tile) -> int:
    """Slots of the f32 kernel's ring at tile (rows, columns): as many as fit in
    SMEM_LIMIT beside `_sr_wg_fixed_bytes`, at most SR_WG_MAX_STAGES (sr_conv_f32.cu's
    `sw_stages`)."""
    rows, cols = tile
    return min(SR_WG_MAX_STAGES,
               (SMEM_LIMIT - _sr_wg_fixed_bytes()) // ((rows + 2 * cols) * SR_K_STEP * 4))


def sr_conv_smem_bytes(tile, dtype) -> int:
    """Shared memory of the sr conv kernel. bf16, at output width `tile` (64 or 128): two
    A tiles and a ring of three B tiles, rows of SR_K_STEP elements and 16 bytes
    (sr_conv.cu's `sr_smem`). f32, at `tile` (rows, columns): the ring's slots of A, the
    weights and their TF32 small half (rows of 128 bytes) and `_sr_wg_fixed_bytes`
    (sr_conv_f32.cu's `sw_smem`); the partials of the cluster's sum land in the ring."""
    if dtype == torch.float32:
        rows, cols = tile
        return _sr_wg_fixed_bytes() + sr_conv_stages(tile) * (rows + 2 * cols) * SR_K_STEP * 4
    size = torch.finfo(dtype).bits // 8
    return (2 * SR_TILE_M + 3 * tile) * (SR_K_STEP + 16 // size) * size


def sr_conv_slice_counts(K: int, dtype=torch.bfloat16) -> list[int]:
    """Every number of slices the kernel takes for this K: those that leave no slice
    empty when each but the last holds ceil(steps / slices) K steps, at most
    SR_MAX_SLICES (bf16) or SR_WG_MAX_SLICES (f32, a cluster's blocks)."""
    steps = K // SR_K_STEP
    most = SR_WG_MAX_SLICES if dtype == torch.float32 else SR_MAX_SLICES
    return [s for s in range(1, most + 1) if (s - 1) * math.ceil(steps / s) < steps]


def sr_conv_slices(K: int, slices: int) -> list[tuple[int, int]]:
    """The [begin, end) columns of each K slice, as the kernel cuts them: whole K
    steps, every slice as long as the first but possibly the last."""
    steps = K // SR_K_STEP
    per = math.ceil(steps / slices)
    return [(s * per * SR_K_STEP, min(steps, (s + 1) * per) * SR_K_STEP)
            for s in range(slices)]


# The depthwise conv kernel (csrc/mit_block/dwconv_gelu.cu): a thread owns 4 channels
# x a run of DWCONV_COLUMNS columns (the kernel's instantiations) and walks a run of
# rows; blocks of DWCONV_THREADS threads.
DWCONV_COLUMNS = (1, 2, 4)
DWCONV_THREADS = 128
DWCONV_ROWS = 3


def _dwconv_width(hid: int) -> None:
    if hid % 4:
        raise ValueError(f"dwconv_gelu: hid={hid} is not a multiple of 4 (a thread "
                         "owns one float4 of channels)")


def dwconv_plan(B: int, H: int, W: int, hid: int) -> tuple[int, int]:
    """(columns, rows) of the depthwise conv kernel: the run of columns a thread owns
    and the run of rows it walks. Two columns (one on a grid one column wide) and
    three rows: of 1, 2 and 4 columns walking 1, 2, 3, 8 and 16 rows, the fastest at
    each of the headline forward's four geometries on the H100 (4 columns hold 40
    more registers a thread, and an SM three blocks in place of four; PERF.md). A
    function of the shapes only; every plan computes each output by the same
    instructions, so all give the same bits."""
    _dwconv_width(hid)
    return (2 if W >= 2 else 1), DWCONV_ROWS


def check_dwconv_plan(plan) -> tuple[int, int]:
    """The plan as (columns, rows), or ValueError if the kernel does not take it."""
    try:
        cols, rows = (int(v) for v in plan)
    except (TypeError, ValueError):
        raise ValueError(f"dwconv_gelu: plan {plan!r} is not (columns, rows)") from None
    if cols not in DWCONV_COLUMNS or rows < 1:
        raise ValueError(f"dwconv_gelu: plan {plan!r} is not one the kernel takes: columns "
                         f"one of {DWCONV_COLUMNS}, rows at least 1")
    return cols, rows


# ------------------------------------------------------------------ plain math
def erf_as(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 erf (max abs err 1.5e-7), the TPU kernel's `_erf`."""
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    p_ = 0.3275911
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + p_ * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return s * (1.0 - poly * torch.exp(-ax * ax))


def gelu_as(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + erf_as(x * (2.0 ** -0.5)))


def mm(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a @ b with operands rounded to `dtype` and an f32 product: the TPU kernel's
    `jnp.dot(..., preferred_element_type=f32)`. A bf16 matmul would round the
    result to bf16 as well, so the operands go back to f32 before multiplying."""
    return a.to(dtype).float() @ b.to(dtype).float()


def _apply_ln(x, stats, w, b):
    return (x.float() - stats[..., 0:1]) * stats[..., 1:2] * w.float() + b.float()


def ln_stats_reference(x: torch.Tensor) -> torch.Tensor:
    """(..., C) -> (..., 2) holding [mean, rsqrt(var + eps)], var = E[x^2] - mean^2."""
    x32 = x.float()
    mu = x32.mean(-1)
    var = (x32 * x32).mean(-1) - mu * mu
    return torch.stack([mu, torch.rsqrt(var + LN_EPS)], dim=-1)


def linear_reference(a, w, bias, *, stats=None, ln_w=None, ln_b=None, residual=None,
                     dtype=torch.bfloat16):
    """LN?(a) @ w^T + bias (+ residual), all f32 but the `dtype`-rounded operands."""
    a = a.float() if stats is None else _apply_ln(a, stats, ln_w, ln_b)
    out = mm(a, w.t(), dtype) + bias.float()
    return out if residual is None else out + residual.float()


def _sr_patches(x, stats, ln_w, ln_b, *, H, W, sr):
    """LN(x) on the (H, W) grid cut into its full sr x sr windows: (B, Hs * Ws,
    sr * sr * C) f32, columns in (ky, kx, c) order."""
    B, _, C = x.shape
    Hs, Ws = H // sr, W // sr
    h = _apply_ln(x, stats, ln_w, ln_b).reshape(B, H, W, C)[:, : Hs * sr, : Ws * sr]
    hs = h.reshape(B, Hs, sr, Ws, sr, C).permute(0, 1, 3, 2, 4, 5)
    return hs.reshape(B, Hs * Ws, sr * sr * C)


def sr_conv_reference(x, stats, ln_w, ln_b, w_flat, bias, *, H, W, sr,
                      dtype=torch.bfloat16):
    """Stride-sr sr x sr conv of LN(x) on the (H, W) grid as a patch matmul,
    cropped to full windows (VALID). w_flat is (C, sr*sr*C) in (ky, kx, c) order."""
    hs = _sr_patches(x, stats, ln_w, ln_b, H=H, W=W, sr=sr)
    return mm(hs, w_flat.t(), dtype) + bias.float()


def sr_conv_sliced_reference(x, stats, ln_w, ln_b, w_flat, bias, *, H, W, sr, slices,
                             dtype=torch.bfloat16):
    """`sr_conv_reference` with the kernel's order of summation: one partial
    product for each K slice of `sr_conv_slices`, added in slice order, then the
    bias."""
    hs = _sr_patches(x, stats, ln_w, ln_b, H=H, W=W, sr=sr)
    out = None
    for k0, k1 in sr_conv_slices(hs.shape[-1], slices):
        part = mm(hs[..., k0:k1], w_flat[:, k0:k1].t(), dtype)
        out = part if out is None else out + part
    return out + bias.float()


def attention_reference(q, kv, *, nh, dtype=torch.bfloat16, export=False):
    """Per-head softmax(q k^T * hd^-1/2) v. q (B, N, C), kv (B, Nk, 2C) with
    feature f = (i2 * nh + head) * hd + d. Returns (out (B, N, C) f32, raw
    pre-scale logits (B, nh, N, Nk) f32 or None)."""
    B, N, C = q.shape
    Nk = kv.shape[1]
    hd = C // nh
    qh = q.float().reshape(B, N, nh, hd).transpose(1, 2)
    k = kv[..., :C].float().reshape(B, Nk, nh, hd).transpose(1, 2)
    v = kv[..., C:].float().reshape(B, Nk, nh, hd).transpose(1, 2)
    s_raw = mm(qh, k.transpose(-1, -2), dtype)                      # (B, nh, N, Nk)
    if Nk == 0:
        o = q.new_zeros((B, nh, N, hd), dtype=torch.float32)
    else:
        s = s_raw * hd ** -0.5
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = mm(e / e.sum(dim=-1, keepdim=True), v, dtype)
    out = o.transpose(1, 2).reshape(B, N, C)
    return out, (s_raw if export else None)


def dwconv_gelu_reference(f, w, bias, *, H, W):
    """gelu(3x3 zero-padded depthwise conv(f) + bias) on the (H, W) grid, as the
    TPU kernel's nine shifted multiply-adds. f (B, H*W, hid), w (hid, 1, 3, 3)."""
    B, N, hid = f.shape
    fi = f.float().reshape(B, H, W, hid)
    dw = w.float().reshape(hid, 3, 3)
    acc = torch.zeros_like(fi)
    for ky in range(3):
        for kx in range(3):
            dy, dx = ky - 1, kx - 1
            src = fi[:, max(0, dy): H + min(0, dy), max(0, dx): W + min(0, dx)]
            pad = (0, 0, max(0, -dx), max(0, dx), max(0, -dy), max(0, dy))
            acc = acc + F.pad(src * dw[:, ky, kx], pad)
    return gelu_as((acc + bias.float()).reshape(B, N, hid))


# ------------------------------------------------------------ kernel wrappers
def _check(t: torch.Tensor, name: str, device: torch.device, shape=None,
           dtype=torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _compute_dtype(dtype) -> None:
    _build.compute_dtype(dtype, "K1")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(fn: str, device: torch.device, *args) -> None:
    """``fn`` on ``device``'s current stream, with ``device`` current (a rank's
    card need not be the process's current device)."""
    lib = _build.load_library("mit_block")
    with torch.cuda.device(device):
        _build.check(getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream), fn)


def ln_stats(x: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda:
        return ln_stats_reference(x)
    C = x.shape[-1]
    _check(x, "x", x.device)
    out = torch.empty(x.shape[:-1] + (2,), device=x.device, dtype=torch.float32)
    rows = x.numel() // C if C else 0
    if rows:
        _launch("k1_ln_stats", x.device, x.data_ptr(), out.data_ptr(), rows, C)
        LAUNCHES["ln_stats"] += 1
    return out


def _aligned(t, name: str, nbytes: int = 16) -> None:
    if t is not None and t.data_ptr() % nbytes:
        raise ValueError(f"{name}: data not {nbytes}-byte aligned (the kernel reads vectors)")


def linear(a, w, bias, *, stats=None, ln_w=None, ln_b=None, residual=None,
           dtype=torch.bfloat16, plan=None):
    """`plan`: a (tile, per) (bf16) or (tile, blocks) (f32) other than `linear_plan`'s,
    for tests and tuning; it is checked on any device, every plan gives the same bits on
    the card, and it changes nothing on the CPU."""
    if plan is not None:
        check_linear_plan(plan, dtype)
    if not a.is_cuda:
        return linear_reference(a, w, bias, stats=stats, ln_w=ln_w, ln_b=ln_b,
                                residual=residual, dtype=dtype)
    _compute_dtype(dtype)
    Nout, K = w.shape
    dev = a.device
    if K % LINEAR_K_STEP:
        raise ValueError(f"linear: K={K} is not a multiple of {LINEAR_K_STEP}")
    _check(a, "a", dev)
    if a.shape[-1] != K:
        raise ValueError(f"linear: a has {a.shape[-1]} features, w takes {K}")
    M = a.numel() // K
    _check(w, "w", dev, (Nout, K), dtype)
    _check(bias, "bias", dev, (Nout,))
    if stats is not None:
        _check(stats, "stats", dev, a.shape[:-1] + (2,))
        _check(ln_w, "ln_w", dev, (K,))
        _check(ln_b, "ln_b", dev, (K,))
    out = torch.empty(a.shape[:-1] + (Nout,), device=dev, dtype=torch.float32)
    if residual is not None:
        _check(residual, "residual", dev, out.shape)
    for t, name in ((a, "a"), (w, "w"), (bias, "bias"), (ln_w, "ln_w"), (ln_b, "ln_b"),
                    (residual, "residual")):
        _aligned(t, name)
    _aligned(stats, "stats", 8)
    if M:
        tile_id, n = check_linear_plan(linear_plan(M, Nout, K, dtype) if plan is None else plan,
                                       dtype)
        _launch("k1_linear", dev, a.data_ptr(), w.data_ptr(), bias.data_ptr(), _ptr(stats),
                _ptr(ln_w), _ptr(ln_b), _ptr(residual), out.data_ptr(), M, Nout, K,
                tile_id, n, int(dtype == torch.float32))
        LAUNCHES["linear"] += 1   # one a call, whatever plan it runs
    return out


def sr_conv(x, stats, ln_w, ln_b, w_flat, bias, *, H, W, sr, dtype=torch.bfloat16,
            plan=None):
    """`plan`: a plan other than `sr_conv_plan`'s, for tests and tuning: bf16 (tile,
    slices), checked by the kernel; f32 ((rows, columns), slices), checked on any device.
    It changes the order of the f32 sums on the card and nothing on the CPU."""
    f32 = dtype == torch.float32
    if plan is not None and f32:
        plan = check_sr_conv_plan(plan, sr * sr * x.shape[-1], dtype)
    if not x.is_cuda:
        return sr_conv_reference(x, stats, ln_w, ln_b, w_flat, bias, H=H, W=W, sr=sr,
                                 dtype=dtype)
    _compute_dtype(dtype)
    B, N, C = x.shape
    dev = x.device
    if N != H * W or C % 32 or (f32 and C > SR_WG_MAX_C):
        raise ValueError(f"sr_conv: N={N}, H*W={H * W}, C={C} (C % 32 must be 0; with f32 "
                         f"operands C <= {SR_WG_MAX_C})")
    _check(x, "x", dev)
    _check(stats, "stats", dev, (B, N, 2))
    _check(ln_w, "ln_w", dev, (C,))
    _check(ln_b, "ln_b", dev, (C,))
    _check(w_flat, "w_flat", dev, (C, sr * sr * C), dtype)
    _check(bias, "bias", dev, (C,))
    Nk = (H // sr) * (W // sr)
    out = torch.empty((B, Nk, C), device=dev, dtype=torch.float32)
    if B * Nk:
        M, K = B * Nk, sr * sr * C
        ws = None
        if f32:     # tensor-map copies and 16-byte loads: no workspace, one kernel
            for t, name in ((x, "x"), (w_flat, "w_flat"), (bias, "bias")):
                _aligned(t, name)
            _aligned(stats, "stats", 8)
            (rows, tile), slices = sr_conv_plan(M, C, K, dtype) if plan is None else plan
        else:
            rows = SR_TILE_M
            tile, slices = sr_conv_plan(M, C, K) if plan is None else plan
            # the slices' partial results; the kernel's second step adds them in order
            if slices > 1:
                ws = torch.empty((slices, M, C), device=dev, dtype=torch.float32)
        _launch("k1_sr_conv", dev, x.data_ptr(), stats.data_ptr(), ln_w.data_ptr(),
                ln_b.data_ptr(), w_flat.data_ptr(), bias.data_ptr(), _ptr(ws),
                out.data_ptr(), B, H, W, C, sr, rows, tile, slices, int(f32))
        LAUNCHES["sr_conv"] += 1   # one a call, whatever number of device kernels it takes
    return out


def attention(q, kv, *, nh, dtype=torch.bfloat16, export=False, plan=None):
    """`plan`: an f32 (queries, blocks) other than `attention_plan`'s, for tests and
    tuning; it is checked on any device, every plan gives the same bits on the card, and
    it changes nothing on the CPU. With bf16 operands only the kernel's own form is
    taken."""
    B, N, C = q.shape
    Nk = kv.shape[1]
    if plan is not None:
        plan = check_attention_plan(plan, B, N, Nk, C, nh, dtype)
    if not q.is_cuda:
        return attention_reference(q, kv, nh=nh, dtype=dtype, export=export)
    _compute_dtype(dtype)
    if C % nh or C // nh not in (32, 64):
        raise NotImplementedError(f"attention kernel takes head dim 32 or 64, got C={C}, nh={nh}")
    _check(q, "q", q.device)
    _check(kv, "kv", q.device, (B, Nk, 2 * C))
    logits = (torch.empty((B, nh, N, Nk), device=q.device, dtype=torch.float32)
              if export else None)
    if Nk == 0:     # no key: zero by definition (the TPU kernel's case), nothing to launch
        return torch.zeros((B, N, C), device=q.device, dtype=torch.float32), logits
    out = torch.empty((B, N, C), device=q.device, dtype=torch.float32)
    if B * N:
        f32 = dtype == torch.float32
        queries, blocks = 0, 0
        if f32:     # q is read in 16-byte pieces
            _aligned(q, "q")
            queries, blocks = attention_plan(B, N, Nk, C, nh, dtype) if plan is None else plan
        # k and v in the operand type's layout, head by head, by the kernel's first step
        ws = torch.empty((attention_workspace_elems(B, Nk, C, dtype),), device=q.device,
                         dtype=dtype)
        _launch("k1_attention", q.device, q.data_ptr(), kv.data_ptr(), ws.data_ptr(),
                out.data_ptr(), _ptr(logits), B, N, Nk, C, nh, float(C // nh) ** -0.5,
                int(f32), queries, blocks)
        LAUNCHES["attention"] += 1   # one a call, whatever plan it runs
    return out, logits


def dwconv_gelu(f, w, bias, *, H, W, plan=None):
    """`plan`: a (columns, rows) other than `dwconv_plan`'s, for tests and tuning; it
    is checked on any device, every plan gives the same bits on the card, and it
    changes nothing on the CPU."""
    B, N, hid = f.shape
    if N != H * W:
        raise ValueError(f"dwconv_gelu: N={N} but H*W={H * W}")
    _dwconv_width(hid)
    if plan is not None:
        plan = check_dwconv_plan(plan)
    if not f.is_cuda:
        return dwconv_gelu_reference(f, w, bias, H=H, W=W)
    _check(f, "f", f.device)
    _check(w, "w", f.device, (hid, 1, 3, 3))
    _check(bias, "bias", f.device, (hid,))
    for t, name in ((f, "f"), (w, "w"), (bias, "bias")):
        _aligned(t, name)
    out = torch.empty_like(f)
    if f.numel():
        cols, rows = dwconv_plan(B, H, W, hid) if plan is None else plan
        _launch("k1_dwconv_gelu", f.device, f.data_ptr(), w.data_ptr(), bias.data_ptr(),
                out.data_ptr(), B, H, W, hid, cols, rows)
        LAUNCHES["dwconv_gelu"] += 1   # one a call, whatever plan it runs
    return out


# --------------------------------------------------------------- the block
PLAIN = SimpleNamespace(ln_stats=ln_stats_reference, linear=linear_reference,
                        sr_conv=sr_conv_reference, attention=attention_reference,
                        dwconv_gelu=dwconv_gelu_reference)
DISPATCH = SimpleNamespace(ln_stats=ln_stats, linear=linear, sr_conv=sr_conv,
                           attention=attention, dwconv_gelu=dwconv_gelu)


def sr_reduce(x: torch.Tensor, p: Mapping[str, torch.Tensor], *, H: int, W: int, sr: int,
              dtype=torch.float32):
    """The front of the PRE_SR block variant (the JAX package's `sr_reduce_xla`):
    h = ln1(x) and xs = srnorm(srconv(h) + bias) by library calls, outside any
    kernel, as there. x (B, N, C) tokens -> h (B, N, C) f32, xs (B, Nk, C) f32.
    The conv runs in `dtype` (under bf16 its result is bf16 too, one rounding
    more than the JAX version's f32 result)."""
    B, N, C = x.shape
    Hs, Ws = H // sr, W // sr
    h = F.layer_norm(x.float(), (C,), p["ln1_weight"].float(), p["ln1_bias"].float(), LN_EPS)
    if Hs * Ws == 0:     # a map smaller than one sr x sr patch reduces to no token
        return h, h.new_empty((B, 0, C))
    h2d = h.reshape(B, H, W, C)[:, : Hs * sr, : Ws * sr].permute(0, 3, 1, 2)
    xs = F.conv2d(h2d.to(dtype), p["sr_weight"].to(dtype), None, stride=sr).float()
    xs = xs.flatten(2).transpose(1, 2) + p["sr_bias"].float()
    xs = F.layer_norm(xs, (C,), p["srnorm_weight"].float(), p["srnorm_bias"].float(), LN_EPS)
    return h, xs


def _block(x, p, *, H, W, sr, nh, dtype, export, ops, h=None, xs=None):
    """The block as K1's kernel sequence; `ops` supplies the five pieces. With
    `h` and `xs` given (the PRE_SR variant, sr > 1, no export) LN1 and the sr
    front were computed outside: q and kv are plain linears of them, and neither
    `ln_stats` of the front nor `sr_conv` runs."""
    C = x.shape[-1]
    xf = x.float()
    if (h is None) != (xs is None):
        raise ValueError("h and xs come together (see sr_reduce)")
    if xs is not None and (export or sr == 1):
        raise ValueError("the PRE_SR variant is for sr > 1 blocks that export nothing")

    def wt(k):  # matmul weight, rounded to the compute dtype once per call
        return p[k].to(dtype)

    ln1 = dict(ln_w=p["ln1_weight"], ln_b=p["ln1_bias"])
    if xs is not None:
        q = ops.linear(h, wt("q_weight"), p["q_bias"], dtype=dtype)
        kv = ops.linear(xs, wt("kv_weight"), p["kv_bias"], dtype=dtype)
    else:
        s1 = ops.ln_stats(xf)
        q = ops.linear(xf, wt("q_weight"), p["q_bias"], stats=s1, dtype=dtype, **ln1)
        if sr > 1:
            w_flat = wt("sr_weight").permute(0, 2, 3, 1).reshape(C, sr * sr * C).contiguous()
            xs = ops.sr_conv(xf, s1, p["ln1_weight"], p["ln1_bias"], w_flat, p["sr_bias"],
                             H=H, W=W, sr=sr, dtype=dtype)
            kv = ops.linear(xs, wt("kv_weight"), p["kv_bias"], stats=ops.ln_stats(xs),
                            ln_w=p["srnorm_weight"], ln_b=p["srnorm_bias"], dtype=dtype)
        else:
            kv = ops.linear(xf, wt("kv_weight"), p["kv_bias"], stats=s1, dtype=dtype, **ln1)
    o, logits = ops.attention(q, kv, nh=nh, dtype=dtype, export=export)
    y = ops.linear(o, wt("proj_weight"), p["proj_bias"], residual=xf, dtype=dtype)
    f = ops.linear(y, wt("fc1_weight"), p["fc1_bias"], stats=ops.ln_stats(y),
                   ln_w=p["ln2_weight"], ln_b=p["ln2_bias"], dtype=dtype)
    g = ops.dwconv_gelu(f, p["dw_weight"], p["dw_bias"], H=H, W=W)
    out = ops.linear(g, wt("fc2_weight"), p["fc2_bias"], residual=y, dtype=dtype)
    out = out.to(x.dtype)
    return (out, logits) if export else out


def fused_block_reference(x: torch.Tensor, p: Mapping[str, torch.Tensor], *, H: int,
                          W: int, sr: int, nh: int, dtype=torch.float32,
                          export: bool = False, h=None, xs=None):
    """Plain PyTorch K1 on any device: the math of the TPU kernel's `_block_math`.
    Returns out (B, N, C) in x.dtype, plus the raw logits (B, nh, N, Nk) f32
    when `export`. `h`, `xs`: the PRE_SR variant (see `_block`, `sr_reduce`)."""
    return _block(x, p, H=H, W=W, sr=sr, nh=nh, dtype=dtype, export=export, ops=PLAIN,
                  h=h, xs=xs)


def fused_block(x: torch.Tensor, p: Mapping[str, torch.Tensor], *, H: int, W: int,
                sr: int, nh: int, dtype=torch.float32, export: bool = False, h=None,
                xs=None):
    """K1 dispatcher: the CUDA kernels for a CUDA tensor (compute dtype f32, the
    TPU kernel's default, or bf16), the plain version for a CPU tensor. Nothing falls
    back. `h`, `xs`: the PRE_SR variant (see `_block`, `sr_reduce`)."""
    if x.is_cuda:
        _compute_dtype(dtype)
    return _block(x, p, H=H, W=W, sr=sr, nh=nh, dtype=dtype, export=export, ops=DISPATCH,
                  h=h, xs=xs)
