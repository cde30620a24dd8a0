"""Kernel K4: flash attention, forward and backward, for the MiT spatial-reduction
attention (`mix_transformer.py:94-133`).

The counterpart of ``representationlearning_tpu/ops/pallas/attention.py``
(``flash_attention``, ``mha_flash``): ``softmax(q k^T * scale) v`` with the
(Nq, Nk) scores kept out of device memory in both directions. q is (BH, Nq, D),
k and v are (BH, Nk, D); D is 32 or 64, the dtype f32 (f32-accurate products)
or bf16 (bf16 operands, f32 accumulation).

``flash_attention`` launches the CUDA kernels (``csrc/attention/flash_fwd.cu``,
``flash_bwd.cu``) on CUDA tensors through ``_Flash``, a ``torch.autograd.Function``
whose forward saves ``q, k, v, o`` and the row logsumexp and whose backward is the
backward kernel; any Nq >= 1 and Nk >= 1 runs on them (the TPU wrapper keeps its
kernel for tile multiples). On CPU tensors it runs ``flash_attention_reference``,
the plain softmax composition, which autograd differentiates. Nothing falls
back: a build or launch failure raises.

The forward is bound by the bytes of q and o and, close behind, by its f32
products (PERF.md). So it runs both products on the tensor cores (``mma.sync``:
bf16 operands, or f32 operands split into two TF32 halves, three TF32 products
a product, which holds f32 accuracy), keeps K and V of a bh in shared memory for
all the 16-row query tiles a block walks, and fills the card with a plan
(``flash_plan``: warps a block, blocks as many as the card holds at once, each
taking an equal run of query tiles). The key tile is a function of Nk alone
(``fwd_key_tile``) and each output row is summed by one warp in a fixed order,
so every plan and every rerun gives the same bits.

The backward (``flash_backward``) runs its five products the same way. A block
holds K and V of one bh's key tile (the forward's, at most 128 keys; longer Nk is
cut into tiles of 128), each warp owning 16 keys, and walks a run of the bh's
query tiles, keeping dk and dv in registers; dq goes through shared memory once a
tile. Its plan (``bwd_plan``: rows a query tile, runs a bh) gives as many blocks
as the card holds at once; a bh's runs (shares) of dk and dv, and where Nk > 128
the key tiles' shares of dq, are summed in a fixed order by a second small
kernel, so a rerun gives the same bits.
"""
from __future__ import annotations

import functools

import torch
from torch.autograd.function import once_differentiable

from . import _build

# launches since the last reset: one per forward call, one per backward call
# (the backward entry point runs its kernel and, where a bh has several shares,
# the small sums over them)
LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0}

# The forward kernel (csrc/attention/flash_fwd.cu): warps of 16 query rows, key tiles
# of Nk rounded up to 16 where Nk <= FWD_LONG_TILE, else of FWD_LONG_TILE keys; K and V
# in shared memory beside two q stages a warp.
FWD_MAX_WARPS = 8
FWD_LONG_TILE = 128
# The backward kernel (csrc/attention/flash_bwd.cu): query tiles of BWD_ROWS, key
# tiles of at most BWD_KEYS (a warp each 16 keys).
BWD_ROWS = (16, 32, 64)
BWD_KEYS = 128
SMEM_LIMIT = 227 * 1024      # dynamic shared memory a block may ask for on sm_90
SM_SMEM = 228 * 1024         # shared memory of an SM, 1 KB of it reserved a block
H100_SMS = 132


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """Plain PyTorch K4 on any device (`_xla_attention` of the JAX package): the
    products and the softmax in f32, the result in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.softmax(s * scale, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def fwd_key_tile(Nk: int) -> int:
    """Keys a tile of the forward kernel: a function of Nk alone, so every plan at one
    shape sums in the same order."""
    return FWD_LONG_TILE if Nk > FWD_LONG_TILE else -(-Nk // 16) * 16


def fwd_smem_bytes(Nk: int, D: int, bf16: bool, warps: int) -> tuple[int, int]:
    """(bytes of shared memory, K / V slots) of a forward block: two q stages a warp
    (16 rows at pitch D + 8), and every key tile where they fit beside them (the
    resident form), else two slots that the key tiles stream through."""
    e = 2 if bf16 else 4
    bk = fwd_key_tile(Nk)
    nkt = -(-Nk // bk)
    q = warps * 2 * 16 * (D + 8) * e
    kv = bk * ((D + 8) + (D + 8 if bf16 else D + 4)) * e
    slots = nkt if q + nkt * kv <= SMEM_LIMIT else 2
    return q + slots * kv, slots


def _blocks_per_sm_estimate(Nk: int, D: int, bf16: bool, warps: int) -> int:
    smem, _ = fwd_smem_bytes(Nk, D, bf16, warps)
    return max(1, min(64 // warps, SM_SMEM // (smem + 1024)))


def flash_plan(BH: int, Nq: int, Nk: int, D: int, dtype=torch.float32,
               blocks_per_sm: int | None = None, sms: int = H100_SMS) -> tuple[int, int]:
    """(warps, blocks) of the forward kernel. Four warps a block where the launch has
    four 16-row query tiles for every SM, fewer below that so that the small launches
    still spread over the SMs; eight in place of four under f32 or where K and V of
    several key tiles fill an SM's shared memory (an SM then holds one block and one
    K / V copy for its eight warps; measured, PERF.md); as many blocks as the card holds at once
    (`blocks_per_sm`, its occupancy; without it an estimate from shared memory), but
    no more than leave each warp a tile. Block b takes the tiles [b T / G, (b + 1) T / G)
    of the T = BH ceil(Nq / 16) tiles. Every plan gives the same bits."""
    tiles = BH * -(-Nq // 16)
    warps = max(1, min(4, tiles // sms))
    if warps == 4 and (dtype == torch.float32
                       or fwd_smem_bytes(Nk, D, dtype == torch.bfloat16, 4)[1] > 1):
        warps = 8  # f32, or K and V of several key tiles: one block an SM, a wide one
    per_sm = blocks_per_sm or _blocks_per_sm_estimate(Nk, D, dtype == torch.bfloat16, warps)
    return warps, max(1, min(-(-tiles // warps), per_sm * sms))


def check_plan(plan, Nk: int, D: int, dtype) -> tuple[int, int]:
    """The plan as (warps, blocks), or ValueError if the kernel does not take it."""
    try:
        warps, blocks = (int(x) for x in plan)
    except (TypeError, ValueError):
        raise ValueError(f"flash_attention: plan {plan!r} is not (warps, blocks)") from None
    if not (1 <= warps <= FWD_MAX_WARPS and blocks >= 1
            and fwd_smem_bytes(Nk, D, dtype == torch.bfloat16, warps)[0] <= SMEM_LIMIT):
        raise ValueError(f"flash_attention: plan {plan!r} is not one the kernel takes")
    return warps, blocks


def bwd_smem_bytes(Nk: int, D: int, bf16: bool, rows: int) -> int:
    """Bytes of shared memory of a backward block: K and V of its key tile (pitch D + 4
    under f32, D + 8 under bf16), two stages of q, do and o tiles of `rows` rows, the
    ds tile (rows x (keys + 8)) and two stages of lse and delta."""
    e, P = (2, D + 8) if bf16 else (4, D + 4)
    bk = fwd_key_tile(Nk)
    return e * (2 * bk * P + 6 * rows * P + rows * (bk + 8)) + 4 * 3 * rows


def bwd_workspace_floats(BH: int, Nq: int, Nk: int, D: int, shares: int) -> int:
    """f32 workspace of a backward launch: the dk and dv shares where a bh has several,
    the key tiles' dq shares where Nk > BWD_KEYS."""
    nkc = -(-Nk // BWD_KEYS)
    return (2 * BH * shares * Nk * D if shares > 1 else 0) \
        + (BH * nkc * Nq * D if nkc > 1 else 0)


def _bwd_blocks_per_sm_estimate(Nk: int, D: int, bf16: bool, rows: int) -> int:
    smem = bwd_smem_bytes(Nk, D, bf16, rows)
    return max(1, min(64 // (fwd_key_tile(Nk) // 16), SM_SMEM // (smem + 1024)))


def bwd_plan(BH: int, Nq: int, Nk: int, D: int, dtype=torch.float32,
             blocks_per_sm: int | None = None, sms: int = H100_SMS) -> tuple[int, int]:
    """(rows, shares) of the backward kernel. Query tiles of 64 rows where the launch
    has a 64-row tile for every SM, else of 32 or 16 so that the small launches still
    spread over the SMs. Block (s, kc, bh) takes the tiles [s T / S, (s + 1) T / S) of
    bh's T = ceil(Nq / rows) against its key tile kc: S = `shares` runs a bh, as many
    as leave every block in flight at once (`blocks_per_sm`, the card's occupancy;
    without it an estimate from shared memory), then as few as keep the longest run.
    Every plan gives the same bits on a rerun; plans that cut a bh's queries at the
    same points give the same bits as each other."""
    units = BH * -(-Nk // BWD_KEYS)
    rows = next((r for r in (64, 32) if units * -(-Nq // r) >= sms), 16)
    tiles = -(-Nq // rows)
    per_sm = blocks_per_sm or _bwd_blocks_per_sm_estimate(Nk, D, dtype == torch.bfloat16, rows)
    most = max(1, min(tiles, per_sm * sms // units))
    longest = -(-tiles // most)
    return rows, -(-tiles // longest)


def check_bwd_plan(plan, Nq: int, Nk: int, D: int, dtype) -> tuple[int, int]:
    """The backward plan as (rows, shares), or ValueError if the kernel does not take it."""
    try:
        rows, shares = (int(x) for x in plan)
    except (TypeError, ValueError):
        raise ValueError(f"flash_backward: plan {plan!r} is not (rows, shares)") from None
    if not (rows in BWD_ROWS and 1 <= shares <= -(-Nq // rows)
            and bwd_smem_bytes(Nk, D, dtype == torch.bfloat16, rows) <= SMEM_LIMIT):
        raise ValueError(f"flash_backward: plan {plan!r} is not one the kernel takes")
    return rows, shares


@functools.lru_cache(maxsize=256)
def _blocks_per_sm(Nk: int, D: int, bf16: bool, warps: int) -> int:
    lib = _build.load_library("attention")
    return lib.k4_flash_fwd_blocks_per_sm(Nk, D, int(bf16), warps)


@functools.lru_cache(maxsize=256)
def _bwd_blocks_per_sm(Nk: int, D: int, bf16: bool, rows: int) -> int:
    lib = _build.load_library("attention")
    return lib.k4_flash_bwd_blocks_per_sm(Nk, D, int(bf16), rows)


@functools.lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself where its data starts on 16 bytes (the kernel's 16-byte copies), else
    a copy that does."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                  plan=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA tensors: (o, lse), o (BH, Nq, D) in q's dtype and
    lse (BH, Nq) f32, the row logsumexp of the scaled scores. `plan`: a (warps,
    blocks) other than `flash_plan`'s, for tests and tuning."""
    BH, Nq, Nk, D = _check(q, k, v)
    bf16 = q.dtype == torch.bfloat16
    if plan is None:
        sms = _sms(q.device.index or 0)
        warps, _ = flash_plan(BH, Nq, Nk, D, q.dtype, sms=sms)
        per_sm = _blocks_per_sm(Nk, D, bf16, warps)
        if per_sm < 1:
            raise RuntimeError(f"k4_flash_fwd: {warps} warps at Nk = {Nk} fit no SM")
        plan = flash_plan(BH, Nq, Nk, D, q.dtype, per_sm, sms)
    warps, blocks = check_plan(plan, Nk, D, q.dtype)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    lse = torch.empty((BH, Nq), dtype=torch.float32, device=q.device)
    lib = _build.load_library("attention")
    with torch.cuda.device(q.device):
        err = lib.k4_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                               lse.data_ptr(), BH, Nq, Nk, D, float(scale), int(bf16), warps,
                               blocks, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "k4_flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             do: torch.Tensor, scale: float):
    """Plain K4 backward on any device: (dq, dk, dv), autograd through
    ``flash_attention_reference`` with cotangent do."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention_reference(*leaves, scale)
        return torch.autograd.grad(out, leaves, do.to(out.dtype))


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                   lse: torch.Tensor, do: torch.Tensor, scale: float,
                   plan=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel: (dq, dk, dv) in q's dtype from q, k, v, the forward's o and
    lse (its row logsumexp) and the cotangent do. `plan`: a (rows, shares) other than
    `bwd_plan`'s, for tests and tuning; checked on any device. On CPU tensors the plain
    version (o and lse unused)."""
    BH, Nq, Nk, D = _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or tuple(lse.shape) != (BH, Nq):
        raise ValueError(f"flash_backward: o and do {tuple(q.shape)}, lse {(BH, Nq)} expected, "
                         f"got {tuple(o.shape)}, {tuple(do.shape)}, {tuple(lse.shape)}")
    if o.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"flash_backward: o in {q.dtype} and lse in float32 expected, got "
                        f"{o.dtype}, {lse.dtype}")
    if plan is not None:
        check_bwd_plan(plan, Nq, Nk, D, q.dtype)
    if not q.is_cuda:
        return flash_backward_reference(q, k, v, do, scale)
    bf16 = q.dtype == torch.bfloat16
    if plan is None:
        sms = _sms(q.device.index or 0)
        rows, _ = bwd_plan(BH, Nq, Nk, D, q.dtype, sms=sms)
        per_sm = _bwd_blocks_per_sm(Nk, D, bf16, rows)
        if per_sm < 1:
            raise RuntimeError(f"k4_flash_bwd: {rows}-row tiles at Nk = {Nk} fit no SM")
        plan = bwd_plan(BH, Nq, Nk, D, q.dtype, per_sm, sms)
    rows, shares = check_bwd_plan(plan, Nq, Nk, D, q.dtype)
    q, k, v, o = _aligned(q), _aligned(k), _aligned(v), _aligned(o.contiguous())
    do = _aligned(do.to(q.dtype).contiguous())
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ws = torch.empty(bwd_workspace_floats(BH, Nq, Nk, D, shares), dtype=torch.float32,
                     device=q.device)
    lib = _build.load_library("attention")
    with torch.cuda.device(q.device):
        err = lib.k4_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                               do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                               dv.data_ptr(), ws.data_ptr(), BH, Nq, Nk, D, float(scale),
                               int(bf16), rows, shares, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "k4_flash_bwd")
    LAUNCHES["flash_bwd"] += 1
    return dq, dk, dv


def _check(q, k, v) -> tuple[int, int, int, int]:
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_attention: q (BH, Nq, D), k and v (BH, Nk, D) expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BH, Nq, D = q.shape
    Nk = k.shape[1]
    if D not in (32, 64):
        raise ValueError(f"flash_attention: the kernel takes D = 32 or 64, got {D}")
    if min(BH, Nq, Nk) < 1 or BH > 65535:
        raise ValueError(f"flash_attention: 1 <= BH <= 65535, Nq >= 1, Nk >= 1; got "
                         f"BH = {BH}, Nq = {Nq}, Nk = {Nk}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}; the kernel "
                        "takes float32 or bfloat16, the same for all three")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} not contiguous")
    return BH, Nq, Nk, D


class _Flash(torch.autograd.Function):
    """K4 on CUDA tensors: the forward kernel, and the backward kernel as its
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale, plan=None):
        o, lse = flash_forward(q, k, v, scale, plan)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = float(scale)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, *, plan=None) -> torch.Tensor:
    """K4 dispatcher: q (BH, Nq, D), k, v (BH, Nk, D) -> (BH, Nq, D), differentiable
    in q, k and v. `plan`: the forward kernel's (warps, blocks), for tests and
    tuning; checked on any device, used on the card."""
    if plan is not None:
        BH, Nq, Nk, D = _check(q, k, v)
        check_plan(plan, Nk, D, q.dtype)
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, scale)
    return _Flash.apply(q, k, v, scale, plan)


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Multi-head wrapper: q (B, nh, N, D), k, v (B, nh, Nk, D) -> (B, nh, N, D).
    The heads fold into the batch; a strided view (the heads of a Linear's
    output) is copied into that layout."""
    B, nh, N, D = q.shape
    Nk = k.shape[2]
    out = flash_attention(q.reshape(B * nh, N, D).contiguous(),
                          k.reshape(B * nh, Nk, D).contiguous(),
                          v.reshape(B * nh, Nk, D).contiguous(), scale)
    return out.reshape(B, nh, N, D)
