"""Kernel K6: the window-attention core of RSSFormer's `Mhca`, with the DAL gate.

On (NW, T, C) window batches, q already scaled by hd^-0.5, per head h:

    out[:, :, h] = sigmoid(sum(M_h) / hd^2 + max(M_h)) * softmax(q_h k_h^T) v_h
    M_h = q_h^T k_h            (hd, hd), summed over the T tokens of the window

with the heads written side by side, (NW, T, C). The counterpart of
``representationlearning_tpu/ops/pallas/isa_attention.py`` (``_core_pallas``, whose
body is ``_core_math``). Under ``dtype=bfloat16`` q, k, the probabilities and v
are rounded to bf16 before each product and the sums are f32, as there.

``isa_core`` runs the CUDA kernel (``csrc/rssformer/isa_attention.cu``: persistent
blocks walk the windows through a ``cp.async`` ring, warps share out the rows,
bf16 tensor-core products, the steps chosen by ``isa_plan``) on CUDA tensors and
``isa_core_reference``, the plain PyTorch version, on CPU tensors.
``isa_attention_core`` is the differentiable entry point: its forward is
``isa_core``, its backward recomputes the plain version under autograd, as the
JAX ``custom_vjp`` does (the JAX package has no backward kernel either).
"""
from __future__ import annotations

import functools
import math

import torch

from . import _build
from .mit_block import _check, mm

LAUNCHES = {"isa_core": 0}

# The kernel (csrc/rssformer/isa_attention.cu) holds a window's score rows in
# registers and a ring of `stages` steps of `windows` windows (q, k, v, rows at
# pitch `isa_pitch(C)`) in shared memory; the rows of a (window, head) are shared
# out to warps / (windows * nh) warps, in tiles of 16 rows (bf16) or 32 (f32).
ISA_MAX_T = 128
ISA_MAX_HD = 64
ISA_MAX_WARPS = 8
SMEM_LIMIT = 227 * 1024       # dynamic shared memory a block may ask for on sm_90


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def isa_core_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, nh: int,
                       dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch K6 on any device: `_core_math` head by head."""
    NW, T, C = q.shape
    hd = C // nh

    def heads(t):  # (NW, T, C) -> (NW, nh, T, hd)
        return t.float().reshape(NW, T, nh, hd).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    s = mm(qh, kh.transpose(-1, -2), dtype)                          # (NW, nh, T, T)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = mm(e / e.sum(dim=-1, keepdim=True), vh, dtype)               # (NW, nh, T, hd)
    m = mm(qh.transpose(-1, -2), kh, dtype)                          # (NW, nh, hd, hd)
    alpha = torch.sigmoid(m.sum(dim=(-2, -1), keepdim=True) / (hd * hd)
                          + m.amax(dim=(-2, -1), keepdim=True))
    return (alpha * o).transpose(1, 2).reshape(NW, T, C).to(q.dtype)


def isa_pitch(C: int) -> int:
    """Floats between two token rows of a stage: the least P >= C with P % 32 == 4."""
    return C + ((4 - C) & 31)


def isa_smem_bytes(T: int, C: int, nh: int, windows: int, stages: int) -> int:
    """The ring, and the gate of each (window, head) of a step."""
    return 4 * (stages * 3 * windows * T * isa_pitch(C) + windows * nh)


@functools.lru_cache(maxsize=256)
def isa_plan(NW: int, T: int, C: int, nh: int, dtype=torch.bfloat16) -> tuple[int, int, int]:
    """(windows, warps, stages) of the kernel: the windows a step, the warps a block
    and the stages of the ring. One window a step and two stages, so that four
    blocks share an SM at the predict path's shape; two warps a (window, head)
    where it has two row tiles (16 rows under bf16, 32 under f32), at most
    ISA_MAX_WARPS. (Measured on the H100 at 1444 windows of 49 x 32: PERF.md.) A
    function of the shapes only; every plan sums each output in the same order,
    so all give the same bits."""
    hd = C // nh
    if T > ISA_MAX_T or hd > ISA_MAX_HD:
        raise NotImplementedError(
            f"K6 holds a window's score rows in registers: T={T}, hd={hd}; it takes at "
            f"most {ISA_MAX_T} tokens a window and head width {ISA_MAX_HD}")
    if isa_smem_bytes(T, C, nh, 1, 2) > SMEM_LIMIT:
        raise NotImplementedError(
            f"K6 keeps two steps of a window in shared memory: T={T}, C={C} need "
            f"{isa_smem_bytes(T, C, nh, 1, 2)} bytes, a block has {SMEM_LIMIT}")
    parts = 2 if T > (16 if dtype == torch.bfloat16 else 32) else 1
    return 1, min(ISA_MAX_WARPS, nh * parts), 2


@functools.lru_cache(maxsize=256)
def _grid_per_sm(T, C, nh, bf16, windows, warps, stages) -> int:
    lib = _build.load_library("rssformer")
    return lib.k6_isa_blocks_per_sm(T, C, nh, bf16, windows, warps, stages)


@functools.lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def isa_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, nh: int,
             dtype=torch.float32, plan=None) -> torch.Tensor:
    """K6 without a gradient: the kernel on CUDA tensors, the plain version on
    CPU tensors. f32 tensors; `dtype` (f32 or bf16) is the operand type of the
    products. `plan`: a (windows, warps, stages) other than `isa_plan`'s, for tests
    and tuning; every plan gives the same bits."""
    NW, T, C = q.shape
    if C % nh:
        raise ValueError(f"isa_core: C={C} is not a multiple of nh={nh}")
    if not q.is_cuda:
        return isa_core_reference(q, k, v, nh=nh, dtype=dtype)
    _build.compute_dtype(dtype, "K6")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t, name, q.device, (NW, T, C))
    out = torch.empty_like(q)
    if not q.numel():
        return out
    windows, warps, stages = isa_plan(NW, T, C, nh, dtype)  # refuses what the kernel cannot take
    if plan is not None:
        windows, warps, stages = plan
        if not (windows >= 1 and 1 <= warps <= ISA_MAX_WARPS and stages in (2, 3)
                and isa_smem_bytes(T, C, nh, windows, stages) <= SMEM_LIMIT):
            raise ValueError(f"isa_core: plan {plan} is not one the kernel takes")
    bf16 = int(dtype == torch.bfloat16)
    per_sm = _grid_per_sm(T, C, nh, bf16, windows, warps, stages)
    if per_sm < 1:
        raise RuntimeError(f"k6_isa_core: plan {(windows, warps, stages)} fits no SM")
    blocks = min(math.ceil(NW / windows), per_sm * _sms(q.device.index or 0))
    lib = _build.load_library("rssformer")
    with torch.cuda.device(q.device):
        _build.check(lib.k6_isa_core(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     NW, T, C, nh, bf16, windows, warps, stages, blocks,
                                     torch.cuda.current_stream().cuda_stream), "k6_isa_core")
    LAUNCHES["isa_core"] += 1
    return out


class _IsaCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, nh, dtype):
        ctx.save_for_backward(q, k, v)
        ctx.nh, ctx.dtype = nh, dtype
        return isa_core(q, k, v, nh=nh, dtype=dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = isa_core_reference(q, k, v, nh=ctx.nh, dtype=ctx.dtype)
        return (*torch.autograd.grad(out, (q, k, v), g), None, None)


def isa_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nh: int,
                       dtype=torch.float32) -> torch.Tensor:
    """Windowed multi-head attention with the DAL channel gate, differentiable.
    q, k, v: (NW, T, C), q scaled by hd^-0.5. Returns (NW, T, C), the input of
    `out_proj`."""
    return _IsaCore.apply(q, k, v, nh, dtype)
