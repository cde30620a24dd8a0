"""Kernel K4: flash attention, forward and backward, for the MiT spatial-reduction
attention (`mix_transformer.py:94-133`).

The counterpart of ``representationlearning_tpu/ops/pallas/attention.py``
(``flash_attention``, ``mha_flash``): ``softmax(q k^T * scale) v`` with the
(Nq, Nk) scores kept out of device memory in both directions. q is (BH, Nq, D),
k and v are (BH, Nk, D); D is 32 or 64, the dtype f32 (f32 products) or bf16
(bf16 operands, f32 accumulation).

``flash_attention`` launches the CUDA kernels (``csrc/attention/flash_fwd.cu``,
``flash_bwd.cu``) on CUDA tensors through ``_Flash``, a ``torch.autograd.Function``
whose forward saves ``q, k, v, o`` and the row logsumexp and whose backward is the
backward kernel; any Nq >= 1 and Nk >= 1 runs on them (the TPU wrapper keeps its
kernel for tile multiples). On CPU tensors it runs ``flash_attention_reference``,
the plain softmax composition, which autograd differentiates. Nothing falls
back: a build or launch failure raises.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import _build

# launches since the last reset: one per forward call, one per backward call
# (the backward entry point runs its kernel and the two small sums over the
# dk / dv shares)
LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0}

TILE_Q = 64           # query rows per thread block tile (csrc/attention/common.cuh)
_TARGET_BLOCKS = 528  # 4 thread blocks on each of an H100's 132 SMs


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


def bwd_chunk(BH: int, Nq: int) -> int:
    """Query tiles one thread block of the backward kernel walks: as many as
    still leave about ``_TARGET_BLOCKS`` blocks. A function of the shape only,
    so a rerun sums the dk / dv shares in the same order."""
    nqt = -(-Nq // TILE_Q)
    return max(1, min(nqt, (BH * nqt) // _TARGET_BLOCKS))


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
    def forward(ctx, q, k, v, scale):
        BH, Nq, Nk, D = _check(q, k, v)
        o = torch.empty_like(q)
        lse = torch.empty((BH, Nq), dtype=torch.float32, device=q.device)
        lib = _build.load_library("attention")
        with torch.cuda.device(q.device):
            err = lib.k4_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                   lse.data_ptr(), BH, Nq, Nk, D, float(scale),
                                   int(q.dtype == torch.bfloat16),
                                   torch.cuda.current_stream().cuda_stream)
        _build.check(err, "k4_flash_fwd")
        LAUNCHES["flash_fwd"] += 1
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = float(scale)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        BH, Nq, D = q.shape
        Nk = k.shape[1]
        do = do.to(q.dtype).contiguous()
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        chunk = bwd_chunk(BH, Nq)
        nchunks = -(-(-(-Nq // TILE_Q)) // chunk)
        ws = torch.empty((2, BH, nchunks, Nk, D), dtype=torch.float32, device=q.device)
        lib = _build.load_library("attention")
        with torch.cuda.device(q.device):
            err = lib.k4_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                   do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                   dv.data_ptr(), ws.data_ptr(), BH, Nq, Nk, D, ctx.scale,
                                   chunk, int(q.dtype == torch.bfloat16),
                                   torch.cuda.current_stream().cuda_stream)
        _build.check(err, "k4_flash_bwd")
        LAUNCHES["flash_bwd"] += 1
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """K4 dispatcher: q (BH, Nq, D), k, v (BH, Nk, D) -> (BH, Nq, D), differentiable
    in q, k and v."""
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, scale)
    return _Flash.apply(q, k, v, scale)


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
