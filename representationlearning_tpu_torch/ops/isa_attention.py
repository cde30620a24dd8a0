"""Kernel K6: the window-attention core of RSSFormer's `Mhca`, with the DAL gate.

On (NW, T, C) window batches, q already scaled by hd^-0.5, per head h:

    out[:, :, h] = sigmoid(sum(M_h) / hd^2 + max(M_h)) * softmax(q_h k_h^T) v_h
    M_h = q_h^T k_h            (hd, hd), summed over the T tokens of the window

with the heads written side by side, (NW, T, C). The counterpart of
``representationlearning_tpu/ops/pallas/isa_attention.py`` (``_core_pallas``, whose
body is ``_core_math``). Under ``dtype=bfloat16`` q, k, the probabilities and v
are rounded to bf16 before each product and the sums are f32, as there.

``isa_core`` runs the CUDA kernel (``csrc/rssformer/isa_attention.cu``, one block a
window) on CUDA tensors and ``isa_core_reference``, the plain PyTorch version, on
CPU tensors. ``isa_attention_core`` is the differentiable entry point: its
forward is ``isa_core``, its backward recomputes the plain version under
autograd, as the JAX ``custom_vjp`` does (the JAX package has no backward
kernel either).
"""
from __future__ import annotations

import torch

from . import _build
from .mit_block import _check, mm

LAUNCHES = {"isa_core": 0}
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may ask for on sm_90


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


def _smem_bytes(T: int, C: int) -> int:
    return 4 * (3 * T * (C + 1) + T * T + 8)


def isa_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, nh: int,
             dtype=torch.float32) -> torch.Tensor:
    """K6 without a gradient: the kernel on CUDA tensors, the plain version on
    CPU tensors. f32 tensors; `dtype` (f32 or bf16) is the operand type of the
    products."""
    NW, T, C = q.shape
    if C % nh:
        raise ValueError(f"isa_core: C={C} is not a multiple of nh={nh}")
    if not q.is_cuda:
        return isa_core_reference(q, k, v, nh=nh, dtype=dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"K6 takes compute dtype float32 or bfloat16, got {dtype}")
    if _smem_bytes(T, C) > SMEM_LIMIT:
        raise NotImplementedError(
            f"K6 keeps a window in shared memory: T={T}, C={C} need {_smem_bytes(T, C)} "
            f"bytes, a block has {SMEM_LIMIT}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t, name, q.device, (NW, T, C))
    out = torch.empty_like(q)
    if q.numel():
        lib = _build.load_library("rssformer")
        _build.check(lib.k6_isa_core(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     NW, T, C, nh, int(dtype == torch.bfloat16),
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
