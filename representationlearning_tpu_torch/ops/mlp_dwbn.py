"""Kernel K5: the whole RSSFormer MlpDWBN feed-forward block, for inference.

    h   = gelu(bn1(fc1(x)))                       1x1, Cin -> hid
    h   = gelu(bn2(dw(h) + dw6(h) + dw12(h)))     1x1 + 3x3 d6 + 3x3 d12, hid -> hid
    out = gelu(bn3(fc2(h)))                       1x1, hid -> Cout

The counterpart of ``representationlearning_tpu/ops/pallas/mlp_dwbn.py``
(``fused_mlp_dwbn_pallas``, whose body is ``_mlp_math``). The three "dw" convs are
full hid x hid convolutions, not depthwise, so the middle step is 19 products of
the hidden plane, shifted by the tap offsets and zero outside the plane, with
(hid, hid) matrices. BatchNorms are inference affines, folded outside
(``fold_bn_affine``); GELU is the exact one through the A&S erf of K1.

The TPU kernel keeps a whole image in VMEM (the hidden plane alone is 8.4 MB at
128 x 128 x 128 f32); an H100 block has 227 KB of shared memory. On the card K5
is two CUDA kernels (``csrc/rssformer/mlp_dwbn.cuh``), templates on the operand type
(bf16, or f32 as 3xTF32 products) and on the hidden width:

    mlp_fc1    x -> gelu(bn1(x W1 + b1)), written to device memory in the compute
               dtype: under bf16 the TPU kernel rounds h to bf16 at each of its 19
               uses, so storing the rounded plane is the same rounding, done once.
               bf16 runs `mma.sync`, persistent blocks walking 16-row tiles a warp,
               their count from `fc1_plan`; f32 runs `wgmma` (3xTF32, A from
               registers), w1 split once a block, x fed and h drained by the tensor
               memory accelerator, two consumer warpgroups and a producer a block
    mlp_taps   a 19-tap implicit GEMM over tiles of 128 or 256 tokens (taps
               outside the plane read as zero, no padded copy), bias + bn2 + GELU,
               then fc2 from the accumulator registers + bn3 + GELU; persistent
               blocks walk the tiles, their tile and count from `taps_plan`. bf16
               runs `mma.sync` from a `cp.async` ring; f32 runs `wgmma` (3xTF32,
               A from registers) from a ring of tensor-map copies, one producer
               and two consumer warpgroups a block

The kernels take a padded hidden width (`padded_hid`: hid rounded up to a multiple
of 32, at least 96: HRNetV2's hid 72 / 128 / 160 / 192 run at 96 / 128 / 160 / 192)
and pad the input and output widths to 16 inside; the wrappers pad the weights and
the BatchNorm vectors with zeros, which changes no output (a padded hidden feature
is gelu(0) = 0, and its weights are 0). `mlp_fc1` returns the hidden plane at the
padded width on the card, and `mlp_taps` takes it so.

Each wrapper runs its kernel on a CUDA tensor (compute dtype f32, the TPU kernel's
default, or bf16; anything else raises) and its plain PyTorch version,
``<name>_reference``, on a CPU tensor. ``fused_mlp_dwbn_reference`` is `_mlp_math`
step by step; ``fused_mlp_dwbn`` is the dispatcher.

Layouts: tokens (B, N, C), N = H * W row-major, f32. Weights are torch conv
layouts (OIHW): ``fc1_weight`` (hid, Cin, 1, 1), ``dw1_weight`` (hid, hid, 1, 1),
``dw6_weight`` / ``dw12_weight`` (hid, hid, 3, 3), ``fc2_weight`` (Cout, hid, 1, 1);
``dw_bias`` is the sum of the three branch biases.
"""
from __future__ import annotations

import functools
import math
from typing import Mapping

import torch

from . import _build
from .mit_block import _aligned, _check, gelu_as, mm

DILATIONS = (6, 12)  # of dw6 and dw12 (`ffn_block.py`); the kernel has them built in
HID = 128            # the hidden width of hrnetv2_w32, the default of the functions below
HIDDEN_WIDTHS = (96, 128, 160, 192)   # the padded hidden widths the kernels are built for

# The fc1 kernel with bf16 operands (csrc/rssformer/mlp_dwbn.cuh): a warp takes FC1_ROWS
# rows of x a step, a block FC1_WARPS warps (at most FC1_MAX_WARPS), each warp with a ring
# of FC1_STAGES slots of its x tiles. Its plan is (warps, steps a block).
FC1_ROWS, FC1_WARPS, FC1_MAX_WARPS, FC1_STAGES = 16, 8, 8, 2
FC1_SMS = 132
SMEM_LIMIT = 227 * 1024       # dynamic shared memory a block may ask for on sm_90
SMEM_PER_SM = 228 * 1024      # shared memory of an SM, 1 KB of it reserved a block
FC1_WARPS_PER_SM = 16         # the registers of an SM hold 16 warps of the kernel

# The fc1 kernel with f32 operands (csrc/rssformer/mlp_dwbn_fc1_f32.cu): persistent blocks
# of two consumer warpgroups and a producer warpgroup walk tiles of FC1_F32_ROWS rows of x (a
# consumer takes one half at a time) and compute a tile of hidden features: all hp, or
# FC1_F32_NARROW where the ring would keep fewer than two stages beside hp rows of w1 (big
# and small halves, 32 columns a chunk). x streams through a ring of stages of half a tile,
# as many as shared memory holds (at most FC1_F32_MAX_STAGES); each consumer warp stages h
# in FC1_F32_BOXES boxes of 16 rows x 32 features. Its plan is (tile, blocks): the grid is
# blocks x (hp / tile).
FC1_F32_ROWS, FC1_F32_NARROW, FC1_F32_MAX_STAGES, FC1_F32_BOXES = 128, 32, 32, 2


def _size(dtype) -> int:
    return torch.finfo(dtype).bits // 8


def _f32(dtype) -> bool:
    return _size(dtype) == 4


def padded_hid(hid: int) -> int:
    """The hidden width the kernels run `hid` at: rounded up to a multiple of 32, at
    least 96 (one of HIDDEN_WIDTHS)."""
    hp = max(HIDDEN_WIDTHS[0], -(-hid // 32) * 32)
    if hid < 1 or hp not in HIDDEN_WIDTHS:
        raise NotImplementedError(
            f"the K5 kernels take a hidden width up to {HIDDEN_WIDTHS[-1]}, got {hid}")
    return hp


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _fc1_f32_layout(cin: int, tile: int) -> tuple[int, int]:
    """(stages, bytes of shared memory) of the f32 kernel (mlp_dwbn_fc1_f32.cu's
    `f1_layout`): 1 KB of alignment; the barriers and b1, s1, t1 of the tile; w1's chunks
    of 32 columns, big and small, `tile` rows of 128 bytes each; eight warps' staging boxes
    of 2 KB; the ring, each stage half a tile of x: by tensor map 32-column chunks of 64
    rows of 128 bytes (cin % 4 == 0), else the 64 rows as they lie, and 16 bytes, rounded
    up to 1 KB and at least 4 KB: the ring takes what is left, up to FC1_F32_MAX_STAGES
    stages, so that a block holds more than half an SM's shared memory."""
    nch = -(-cin // 32)
    stage = nch * 64 * 128 if cin % 4 == 0 else max(4096, -(-(64 * cin * 4 + 16) // 1024) * 1024)
    fixed = 1024 + 1024 + -(-(12 * tile) // 1024) * 1024 + 2 * nch * tile * 128 \
        + 8 * FC1_F32_BOXES * 16 * 128
    stages = min(FC1_F32_MAX_STAGES, (SMEM_LIMIT - fixed) // stage)
    return stages, fixed + stages * stage


def fc1_f32_stages(cin: int, tile: int) -> int:
    """Stages of the f32 kernel's ring at this width and tile of hidden features."""
    return _fc1_f32_layout(cin, tile)[0]


def fc1_f32_tiles(cin: int, hid: int = HID) -> tuple[int, ...]:
    """The tiles of hidden features the f32 kernel takes at this width: hp and
    FC1_F32_NARROW, each where its ring keeps at least two stages (hp first)."""
    hp = padded_hid(hid)
    return tuple(t for t in dict.fromkeys((hp, FC1_F32_NARROW)) if fc1_f32_stages(cin, t) >= 2)


def fc1_smem_bytes(cin: int, w: int, hid: int = HID, dtype=torch.bfloat16) -> int:
    """`w` is the plan's first entry. bf16, `w` warps: b1, s1, t1 in f32; a ring of f32
    x tiles (pitch cinp + 8, cinp = cin rounded up to 16) and 16 staged half rows (hp / 2
    bf16 and 16 bytes) a warp; w1 in bf16 (a row of cinp and 16 bytes). f32, a tile of
    `w` hidden features: `_fc1_f32_layout`."""
    if _f32(dtype):
        return _fc1_f32_layout(cin, w)[1]
    hp, cinp = padded_hid(hid), _pad16(cin)
    staged = (hp // 2) * 2 + 16
    return 3 * hp * 4 + w * (FC1_STAGES * FC1_ROWS * (cinp + 8) * 4 + FC1_ROWS * staged) \
        + hp * (cinp * 2 + 16)


def fc1_fits(cin: int, w: int, hid: int = HID, dtype=torch.bfloat16) -> bool:
    """Whether the kernel takes the plan's first entry `w` at this width: a block of `w`
    warps that shared memory holds (bf16), one of `fc1_f32_tiles` (f32)."""
    if _f32(dtype):
        return w in fc1_f32_tiles(cin, hid)
    return 1 <= w <= FC1_MAX_WARPS and fc1_smem_bytes(cin, w, hid, dtype) <= SMEM_LIMIT


def fc1_blocks_per_sm(cin: int, w: int, hid: int = HID, dtype=torch.bfloat16) -> int:
    """Blocks of the fc1 kernel an SM holds at once, by its shared memory and its
    registers (`chip_smoke.py` checks the estimate against the card's own count). In
    f32 the ring takes what shared memory is left, so a block takes more than half of it."""
    smem = fc1_smem_bytes(cin, w, hid, dtype)
    by_regs = 1 if _f32(dtype) else FC1_WARPS_PER_SM // w
    return max(1, min(SMEM_PER_SM // (smem + 1024), by_regs))


@functools.lru_cache(maxsize=256)
def fc1_plan(M: int, cin: int, hid: int = HID, dtype=torch.bfloat16) -> tuple[int, int]:
    """The plan of the fc1 kernel for M tokens of cin features, a function of the shapes
    only, so that the grid is about one wave of the blocks the card holds at once; every
    plan computes each output by the same instructions, so all give the same bits.
    bf16: (warps, per), the warps a block (FC1_WARPS, fewer where shared memory cannot hold
    their rings) and the steps a block walks, a step being one 16-row tile a warp. f32:
    (tile, blocks), the widest tile of `fc1_f32_tiles` and one block a tile of rows up to
    one wave over the hp / tile slices of the features."""
    _widths(hid, cin=cin)
    if _f32(dtype):
        tile = fc1_f32_tiles(cin, hid)[0]
        resident = fc1_blocks_per_sm(cin, tile, hid, dtype) * FC1_SMS
        return tile, max(1, min(math.ceil(M / FC1_F32_ROWS),
                                resident // (padded_hid(hid) // tile)))
    warps = FC1_WARPS
    while warps > 1 and not fc1_fits(cin, warps, hid, dtype):
        warps //= 2
    steps = math.ceil(math.ceil(M / FC1_ROWS) / warps)
    resident = fc1_blocks_per_sm(cin, warps, hid, dtype) * FC1_SMS
    return warps, max(1, math.ceil(steps / resident))


def check_fc1_plan(plan, cin: int, hid: int = HID, dtype=torch.bfloat16) -> tuple[int, int]:
    """The plan as (warps, per) in bf16 or (tile, blocks) in f32, or ValueError if the
    kernel does not take it."""
    names = "(tile, blocks)" if _f32(dtype) else "(warps, per)"
    try:
        w, n = (int(v) for v in plan)
    except (TypeError, ValueError):
        raise ValueError(f"mlp_fc1: plan {plan!r} is not {names}") from None
    if not (n >= 1 and fc1_fits(cin, w, hid, dtype)):
        raise ValueError(f"mlp_fc1: plan {plan!r} is not one the kernel takes at cin={cin}"
                         + (f" (tile in {fc1_f32_tiles(cin, hid)}, blocks >= 1)"
                            if _f32(dtype) else ""))
    return w, n

# The taps kernel, bf16: eight warps a block, a tile of TAPS_TILES tokens (16 or 32 rows
# a warp, all hp hidden features; 256 only up to hp 128, where two 16-row tiles of
# accumulators fit a warp's registers), a ring of `taps_stages` slots of A and B, each a
# K step of `taps_bk` features of one tap (a row of 128 bytes, or 64 where hp allows no
# 128), beside fc2's weight (up to `taps_cout_max` rows) and the six vectors, which stay
# in shared memory. f32: the 3xTF32 `wgmma` kernel, three warpgroups a block (two
# consumers of 64 tokens, one producer), a tile of TAPS_TILE_F32 tokens, a ring of
# tensor-map copies of TAPS_BK_F32 features (128-byte rows: the tile's A rows, the tap
# matrix's chunk, and that chunk's TF32 small half), as many slots as fit beside the
# ring's barriers (at most TAPS_MAX_STAGES_F32); fc2's weight and the vectors are read
# through L1.
TAPS_TILES, TAPS_WARPS = (128, 256), 8
TAPS_TILE_F32, TAPS_BK_F32, TAPS_MAX_STAGES_F32 = 128, 32, 8
TAPS_SMS = FC1_SMS
TAPS_BLOCKS_BY_REGS = 1   # blocks of eight warps (bf16) or three warpgroups (f32) an SM's registers hold


def taps_tiles(hid: int = HID, dtype=torch.bfloat16) -> tuple[int, ...]:
    if _f32(dtype):
        return (TAPS_TILE_F32,)
    return TAPS_TILES if padded_hid(hid) <= 128 else TAPS_TILES[:1]


def taps_bk(hid: int = HID, dtype=torch.bfloat16) -> int:
    """Features of one tap a K step takes (mlp_dwbn.cuh's kTapsBK, hop::kWgBK in f32)."""
    if _f32(dtype):
        return TAPS_BK_F32
    return 64 if _size(dtype) == 2 and padded_hid(hid) % 64 == 0 else 32


def taps_cout_max(hid: int = HID, dtype=torch.bfloat16) -> int:
    """Output widths (padded to 16) whose fc2 weight shared memory holds."""
    return 128 if _size(dtype) == 2 and padded_hid(hid) == 128 else 64


def _taps_smem(tile: int, hid: int, dtype, stages: int) -> int:
    hp, size = padded_hid(hid), _size(dtype)
    if _f32(dtype):   # mlp_dwbn.cuh's twg_smem: 1 KB of alignment, the barriers, the ring
        return 1024 + 3 * TAPS_MAX_STAGES_F32 * 8 + stages * (tile + 2 * hp) * TAPS_BK_F32 * 4
    return stages * (tile + hp) * (taps_bk(hid, dtype) * size + 16) \
        + taps_cout_max(hid, dtype) * (hp * size + 16) + 6 * hp * 4


def taps_stages(tile: int, hid: int = HID, dtype=torch.bfloat16) -> int:
    """Slots of the ring. bf16: four where they fit beside the epilogue's constants,
    else three (the kernel needs three). f32: as many as fit, at most
    TAPS_MAX_STAGES_F32 (5 / 4 / 4 / 3 at hp 96 / 128 / 160 / 192)."""
    if _f32(dtype):
        fixed = _taps_smem(tile, hid, dtype, 0)
        return min(TAPS_MAX_STAGES_F32, (SMEM_LIMIT - fixed)
                   // (_taps_smem(tile, hid, dtype, 1) - fixed))
    return 4 if _taps_smem(tile, hid, dtype, 4) <= SMEM_LIMIT else 3


def taps_smem_bytes(tile: int, hid: int = HID, dtype=torch.bfloat16) -> int:
    """bf16: the ring's slots of A (tile rows) and B (hp rows), each row `taps_bk`
    features and 16 bytes; fc2's weight (`taps_cout_max` rows of hp features and 16
    bytes) and six f32 vectors of hp. f32: the ring's slots of A (tile rows) and the
    tap matrix's chunk twice (hp rows), rows of 128 bytes; the ring's barriers and 1 KB
    to align the ring."""
    return _taps_smem(tile, hid, dtype, taps_stages(tile, hid, dtype))


def taps_blocks_per_sm(tile: int, hid: int = HID, dtype=torch.bfloat16) -> int:
    """Blocks of the taps kernel an SM holds at once, by its shared memory and its
    registers: a block is built to hold more than 128 registers a thread (its launch
    bounds ask for one block an SM), so the registers hold one block of eight warps
    (bf16) or of three warpgroups (f32). `chip_smoke.py` checks the estimate against
    the card's count."""
    smem = taps_smem_bytes(tile, hid, dtype)
    return max(1, min(SMEM_PER_SM // (smem + 1024), TAPS_BLOCKS_BY_REGS))


@functools.lru_cache(maxsize=256)
def taps_plan(B: int, H: int, W: int, cout: int, hid: int = HID,
              dtype=torch.bfloat16) -> tuple[int, int]:
    """(tile, blocks) of the taps kernel for B planes of H x W tokens. bf16: tiles of
    256 tokens (the tap matrices read half as often as with 128) where the width has
    them, unless that leaves more than half the SMs without a tile; then 128. f32: the
    wgmma kernel's one tile. Blocks: one wave of the blocks the card holds, or one a
    tile where there are fewer tiles. A function of the shapes only; every plan
    computes each output by the same instructions in the same order, so all give the
    same bits."""
    _widths(hid, cout=cout, dtype=dtype)
    M = B * H * W
    tiles = taps_tiles(hid, dtype)
    big = 256 in tiles and math.ceil(M / 256) >= TAPS_SMS // 2
    tile = 256 if big else tiles[0]
    return tile, max(1, min(math.ceil(M / tile),
                            taps_blocks_per_sm(tile, hid, dtype) * TAPS_SMS))


def check_taps_plan(plan, hid: int = HID, dtype=torch.bfloat16) -> tuple[int, int]:
    """The plan as (tile, blocks), or ValueError if the kernel does not take it."""
    try:
        tile, blocks = (int(v) for v in plan)
    except (TypeError, ValueError):
        raise ValueError(f"mlp_taps: plan {plan!r} is not (tile, blocks)") from None
    if tile not in taps_tiles(hid, dtype) or blocks < 1:
        raise ValueError(f"mlp_taps: plan {plan!r} is not one the kernel takes (tile in "
                         f"{taps_tiles(hid, dtype)}, blocks >= 1)")
    return tile, blocks


# launches of each kernel since the last reset; the wrappers add one per launch
LAUNCHES = {"mlp_fc1": 0, "mlp_taps": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fold_bn_affine(weight, bias, mean, var, eps: float = 1e-5):
    """Inference BatchNorm as a per-channel affine y = x * g + s with
    g = weight / sqrt(var + eps), s = bias - mean * g, in f32."""
    g = weight.float() * torch.rsqrt(var.float() + eps)
    return g, bias.float() - mean.float() * g


def tap_offsets() -> list[tuple[int, int]]:
    """(dy, dx) of the 19 taps in the order of `_mlp_math`: dw1, then dw6 and
    dw12 over (ky, kx)."""
    return [(0, 0)] + [((ky - 1) * d, (kx - 1) * d)
                       for d in DILATIONS for ky in range(3) for kx in range(3)]


def tap_weights(p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The 19 (hid_out, hid_in) tap matrices, stacked in `tap_offsets` order."""
    hid = p["dw1_weight"].shape[0]
    return torch.cat([p["dw1_weight"].reshape(1, hid, hid)]
                     + [p[k].permute(2, 3, 0, 1).reshape(9, hid, hid)
                        for k in ("dw6_weight", "dw12_weight")])


# ------------------------------------------------------------------ plain math
def mlp_fc1_reference(x, w1, b1, scale, shift, *, dtype=torch.bfloat16):
    """gelu(bn1(x @ w1^T + b1)): x (B, N, Cin) f32, w1 (hid, Cin). Returns the
    hidden plane (B, N, hid), rounded to `dtype` when that is bf16 (every later
    use rounds it so), else f32."""
    h = mm(x, w1.t(), dtype) + b1.float()
    h = gelu_as(h * scale.float() + shift.float())
    return h.to(dtype) if dtype == torch.bfloat16 else h


def mlp_taps_reference(h, taps, dw_bias, scale2, shift2, w2, b2, scale3, shift3, *,
                       H, W, dtype=torch.bfloat16):
    """The 19 shifted products of the hidden plane, bn2, GELU, fc2, bn3, GELU.
    h (B, N, hid), taps (19, hid, hid) as (out, in), w2 (Cout, hid). f32 out."""
    B, N, hid = h.shape
    hp = h.float().reshape(B, H, W, hid)
    acc = torch.zeros((B, H, W, hid), dtype=torch.float32, device=h.device)
    for (dy, dx), wt in zip(tap_offsets(), taps):
        y0, y1 = max(0, -dy), min(H, H - dy)   # output rows whose source row is in the plane
        x0, x1 = max(0, -dx), min(W, W - dx)
        if y0 >= y1 or x0 >= x1:
            continue                            # the whole tap reads padding
        src = hp[:, y0 + dy: y1 + dy, x0 + dx: x1 + dx]
        acc[:, y0:y1, x0:x1] += mm(src, wt.t(), dtype)
    acc = acc.reshape(B, N, hid) + dw_bias.float()
    g = gelu_as(acc * scale2.float() + shift2.float())
    out = mm(g, w2.t(), dtype) + b2.float()
    return gelu_as(out * scale3.float() + shift3.float())


# ------------------------------------------------------------ kernel wrappers
def _compute_dtype(dtype) -> None:
    _build.compute_dtype(dtype, "K5")


def _widths(hid: int, cin: int | None = None, cout: int | None = None,
            dtype=torch.bfloat16) -> None:
    padded_hid(hid)
    if cin is not None and not 1 <= cin <= 256:
        raise NotImplementedError(f"mlp_fc1 takes an input width up to 256, got {cin}")
    if cout is not None and not 1 <= _pad16(cout) <= taps_cout_max(hid, dtype):
        raise NotImplementedError(
            f"mlp_taps takes an output width up to {taps_cout_max(hid, dtype)} at hidden "
            f"width {hid} in {dtype}, got {cout}")


def _launch(fn: str, device: torch.device, *args) -> None:
    """``fn`` on ``device``'s current stream, with ``device`` current (a rank's
    card need not be the process's current device)."""
    lib = _build.load_library("rssformer")
    with torch.cuda.device(device):
        _build.check(getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream), fn)


def _pad(t: torch.Tensor, *shape: int) -> torch.Tensor:
    """t (f32 or the compute dtype) with zeros appended to each dimension up to
    `shape`, contiguous; t itself where it already has that shape."""
    pad = [n - m for m, n in zip(t.shape, shape)][::-1]
    if not any(pad):
        return t.contiguous()
    return torch.nn.functional.pad(t, [v for n in pad for v in (0, n)]).contiguous()


def mlp_fc1(x, w1, b1, scale, shift, *, dtype=torch.bfloat16, plan=None):
    """`plan`: a (warps, per) in bf16 or a (tile, blocks) in f32 other than `fc1_plan`'s,
    for tests and tuning; it is checked on any device, every plan gives the same bits
    on the card, and it changes nothing on the CPU. On the card the hidden plane comes back at the padded
    width `padded_hid(hid)`, its padded features 0."""
    hid = w1.shape[0]
    if plan is not None:
        plan = check_fc1_plan(plan, x.shape[-1], hid, dtype)
    if not x.is_cuda:
        return mlp_fc1_reference(x, w1, b1, scale, shift, dtype=dtype)
    _compute_dtype(dtype)
    B, N, cin = x.shape
    _widths(hid, cin=cin)
    hp, cinp = padded_hid(hid), _pad16(cin)
    dev = x.device
    _check(x, "x", dev)
    _check(w1, "w1", dev, (hid, cin), dtype)
    for name, t in (("b1", b1), ("scale", scale), ("shift", shift)):
        _check(t, name, dev, (hid,))
    _aligned(x, "x", 16 if cin % 4 == 0 else 4)
    w1p = _pad(w1, hp, cinp)
    b1p, s1p, t1p = (_pad(t, hp) for t in (b1, scale, shift))
    for t, name in ((w1p, "w1"), (b1p, "b1"), (s1p, "scale"), (t1p, "shift")):
        _aligned(t, name)
    h = torch.empty((B, N, hp), device=dev, dtype=dtype)
    if B * N:
        a, b = fc1_plan(B * N, cin, hid, dtype) if plan is None else plan
        _launch("k5_mlp_fc1", dev, x.data_ptr(), w1p.data_ptr(), b1p.data_ptr(),
                s1p.data_ptr(), t1p.data_ptr(), h.data_ptr(), B * N, cin, cinp, hp,
                int(dtype == torch.float32), a, b)
        LAUNCHES["mlp_fc1"] += 1   # one a call, whatever plan it runs
    return h


def mlp_taps(h, taps, dw_bias, scale2, shift2, w2, b2, scale3, shift3, *, H, W,
             dtype=torch.bfloat16, plan=None):
    """`plan`: a (tile, blocks) other than `taps_plan`'s, for tests and tuning;
    it is checked on any device, every plan gives the same bits on the card, and it
    changes nothing on the CPU. On the card h comes at the padded width of `mlp_fc1`
    (hid itself where that is a padded width, as 128)."""
    hid = taps.shape[1]
    if plan is not None:
        plan = check_taps_plan(plan, hid, dtype)
    if not h.is_cuda:
        return mlp_taps_reference(h, taps, dw_bias, scale2, shift2, w2, b2, scale3, shift3,
                                  H=H, W=W, dtype=dtype)
    _compute_dtype(dtype)
    B, N, _ = h.shape
    cout = w2.shape[0]
    _widths(hid, cout=cout, dtype=dtype)
    hp, coutp = padded_hid(hid), _pad16(cout)
    if N != H * W:
        raise ValueError(f"mlp_taps: N={N} but H*W={H * W}")
    dev = h.device
    _check(h, "h", dev, (B, N, hp), dtype)
    _check(taps, "taps", dev, (19, hid, hid), dtype)
    _check(w2, "w2", dev, (cout, hid), dtype)
    for name, t in (("dw_bias", dw_bias), ("scale2", scale2), ("shift2", shift2)):
        _check(t, name, dev, (hid,))
    for name, t in (("b2", b2), ("scale3", scale3), ("shift3", shift3)):
        _check(t, name, dev, (cout,))
    padded = (("h", h), ("taps", _pad(taps, 19, hp, hp)), ("dw_bias", _pad(dw_bias, hp)),
              ("scale2", _pad(scale2, hp)), ("shift2", _pad(shift2, hp)),
              ("w2", _pad(w2, coutp, hp)), ("b2", _pad(b2, coutp)),
              ("scale3", _pad(scale3, coutp)), ("shift3", _pad(shift3, coutp)))
    for name, t in padded:
        _aligned(t, name)
    out = torch.empty((B, N, cout), device=dev, dtype=torch.float32)
    if B * N:
        tile, blocks = taps_plan(B, H, W, cout, hid, dtype) if plan is None else plan
        _launch("k5_mlp_taps", dev, *(t.data_ptr() for _, t in padded), out.data_ptr(),
                B, H, W, cout, coutp, hp, int(dtype == torch.float32), tile, blocks)
        LAUNCHES["mlp_taps"] += 1   # one a call, whatever plan it runs
    return out


# ------------------------------------------------------------------ the block
def _mlp(x, p, *, H, W, dtype, fc1, taps_fn):
    """K5 as its two pieces; `fc1` and `taps_fn` are the wrappers or the plain
    versions. Matmul weights are rounded to the compute dtype once per call."""
    hid = p["fc1_weight"].shape[0]
    cout = p["fc2_weight"].shape[0]
    xf = x.float().contiguous()
    h = fc1(xf, p["fc1_weight"].reshape(hid, -1).to(dtype), p["fc1_bias"],
            p["bn1_scale"], p["bn1_shift"], dtype=dtype)
    out = taps_fn(h, tap_weights(p).to(dtype).contiguous(), p["dw_bias"], p["bn2_scale"],
                  p["bn2_shift"], p["fc2_weight"].reshape(cout, hid).to(dtype),
                  p["fc2_bias"], p["bn3_scale"], p["bn3_shift"], H=H, W=W, dtype=dtype)
    return out.to(x.dtype)


def fused_mlp_dwbn_reference(x: torch.Tensor, p: Mapping[str, torch.Tensor], *, H: int,
                             W: int, dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch K5 on any device: the math of the TPU kernel's `_mlp_math`.
    x (B, N, Cin) -> (B, N, Cout) in x.dtype."""
    return _mlp(x, p, H=H, W=W, dtype=dtype, fc1=mlp_fc1_reference,
                taps_fn=mlp_taps_reference)


def fused_mlp_dwbn(x: torch.Tensor, p: Mapping[str, torch.Tensor], *, H: int, W: int,
                   dtype=torch.float32) -> torch.Tensor:
    """K5 dispatcher: the CUDA kernels for a CUDA tensor (compute dtype f32, the TPU
    kernel's default, or bf16; hidden widths up to 192), the plain version for a CPU
    tensor. Nothing falls back."""
    if x.is_cuda:
        _compute_dtype(dtype)
    return _mlp(x, p, H=H, W=W, dtype=dtype, fc1=mlp_fc1, taps_fn=mlp_taps)
