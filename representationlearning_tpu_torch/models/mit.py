"""Mix Vision Transformer (SegFormer MiT b0-b5), the port of
``representationlearning_tpu/models/mit.py``.

Modules keep the reference PyTorch names (`mix_transformer.py`): ``patch_embed1``,
``block1.0.attn.q``, ``block1.0.mlp.dwconv.dwconv``, ``norm1`` ... so a reference
checkpoint loads as it is. Images are NCHW; tokens inside a stage are (B, N, C).
``dtype`` is the compute dtype of the attention products (and of every product
of a fused block); the Linear layers of the plain ``Block`` stay f32, as in the
JAX package.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..ops.attention import mha_flash
from ..ops.mit_block import fused_block, mm, sr_reduce
from .layers import DropPath


class DWConv(nn.Module):
    """3x3 depthwise conv mixing inside the FFN (`mix_transformer.py:378-390`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        h = self.dwconv(x.transpose(1, 2).reshape(B, C, H, W))
        return h.flatten(2).transpose(1, 2)


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop = nn.Dropout(drop)

    def forward(self, x, H, W):
        x = F.gelu(self.dwconv(self.fc1(x), H, W))
        return self.drop(self.fc2(self.drop(x)))


class SRAttention(nn.Module):
    """Spatial-reduction attention returning (out, exported logits or None). The
    exported map is the raw q k^T, average-pooled over sr x sr query windows when
    sr > 1 so that it is (B, nh, Nk, Nk) (`mix_transformer.py:123-133`).

    ``use_flash`` runs kernel K4 (``ops/attention.py``) where the block exports
    nothing and no probability is dropped (eval, or ``attn_drop == 0``): q, k
    and v reach it in the dtype the Linear layers return, f32, whatever
    ``dtype`` says, as in the JAX package."""

    def __init__(self, dim, num_heads, sr_ratio=1, qkv_bias=True, attn_drop=0.0,
                 proj_drop=0.0, export_attn=True, use_flash=False, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.export_attn, self.dtype, self.use_flash = export_attn, dtype, use_flash
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = nn.Dropout(proj_drop)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, H, W):
        B, N, C = x.shape
        nh = self.num_heads
        hd = C // nh
        q = self.q(x).reshape(B, N, nh, hd).transpose(1, 2)
        if self.sr_ratio > 1 and min(H, W) < self.sr_ratio:
            # a map smaller than one sr x sr window reduces to no key token, as the
            # JAX package's VALID conv gives (B, 0, 0, C); the output is then proj's bias
            xs = x.new_zeros((B, 0, C))
        elif self.sr_ratio > 1:
            xs = self.sr(x.transpose(1, 2).reshape(B, C, H, W))
            xs = self.norm(xs.flatten(2).transpose(1, 2))
        else:
            xs = x
        Nk = xs.shape[1]
        kv = self.kv(xs).reshape(B, Nk, 2, nh, hd).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]                                          # (B, nh, Nk, hd)
        if self.use_flash and not self.export_attn and (
                not self.training or self.attn_drop.p == 0.0):
            out = mha_flash(q, k, v, hd ** -0.5).transpose(1, 2).reshape(B, N, C)
            return self.proj_drop(self.proj(out)), None
        logits = mm(q, k.transpose(-1, -2), self.dtype)              # (B, nh, N, Nk)
        attn = self.attn_drop(torch.softmax(logits * hd ** -0.5, dim=-1))
        out = mm(attn, v, self.dtype).transpose(1, 2).reshape(B, N, C)
        out = self.proj_drop(self.proj(out))
        if not self.export_attn:
            return out, None
        a = logits.reshape(B, nh, H, W, Nk)
        if self.sr_ratio > 1:
            s = self.sr_ratio
            Hp, Wp = H // s, W // s
            a = a[:, :, : Hp * s, : Wp * s]
            a = a.reshape(B, nh, Hp, s, Wp, s, Nk).mean(dim=(3, 5))
        return out, a.reshape(B, nh, Nk, Nk)


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, sr_ratio=1, qkv_bias=True,
                 drop=0.0, attn_drop=0.0, drop_path=0.0, export_attn=True,
                 use_flash=False, dtype=torch.float32):
        super().__init__()
        self.dim, self.num_heads, self.sr_ratio = dim, num_heads, sr_ratio
        self.export_attn, self.dtype = export_attn, dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = SRAttention(dim, num_heads, sr_ratio, qkv_bias, attn_drop, drop,
                                export_attn=export_attn, use_flash=use_flash, dtype=dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MixFFN(dim, int(dim * mlp_ratio), drop)

    def forward(self, x, H, W, drop_masks=(None, None)):
        """drop_masks: the keep masks of the two residual branches, as
        ``DropPath.draw`` gives them; None draws from the global generator."""
        h, attn = self.attn(self.norm1(x), H, W)
        x = x + self.drop_path(h, drop_masks[0])
        x = x + self.drop_path(self.mlp(self.norm2(x), H, W), drop_masks[1])
        return x, attn


class FusedBlock(Block):
    """Inference `Block` whose forward is kernel K1 (``ops/mit_block.py``): the
    CUDA kernels on the card, the plain version on the CPU. It holds the same
    submodules as `Block`, so the two share state_dict names and a checkpoint
    loads into either. Export (the raw pre-scale logits, (B, nh, N, N) f32) is
    for sr == 1 blocks only, as in the JAX package. ``pre_sr`` (sr > 1 blocks
    only) computes LN1 and the sr front by library calls (``sr_reduce``) and
    hands them to the block, the JAX package's `PRE_SR` variant; off as there."""

    block_fn = staticmethod(fused_block)  # an instance may swap in fused_block_reference

    def __init__(self, dim, num_heads, mlp_ratio=4.0, sr_ratio=1, qkv_bias=True,
                 drop=0.0, attn_drop=0.0, drop_path=0.0, export_attn=False,
                 use_flash=False, dtype=torch.float32, pre_sr=False):
        if export_attn and sr_ratio != 1:
            raise ValueError("FusedBlock attention export requires sr == 1; "
                             "use Block for exporting sr > 1 blocks")
        if not qkv_bias:
            raise ValueError("FusedBlock needs the q/kv biases (qkv_bias=True)")
        super().__init__(dim, num_heads, mlp_ratio, sr_ratio, qkv_bias, drop, attn_drop,
                         drop_path, export_attn, use_flash, dtype)
        self.pre_sr = pre_sr

    def kernel_params(self) -> dict[str, torch.Tensor]:
        a, m = self.attn, self.mlp
        p = {
            "ln1_weight": self.norm1.weight, "ln1_bias": self.norm1.bias,
            "q_weight": a.q.weight, "q_bias": a.q.bias,
            "kv_weight": a.kv.weight, "kv_bias": a.kv.bias,
            "proj_weight": a.proj.weight, "proj_bias": a.proj.bias,
            "ln2_weight": self.norm2.weight, "ln2_bias": self.norm2.bias,
            "fc1_weight": m.fc1.weight, "fc1_bias": m.fc1.bias,
            "dw_weight": m.dwconv.dwconv.weight, "dw_bias": m.dwconv.dwconv.bias,
            "fc2_weight": m.fc2.weight, "fc2_bias": m.fc2.bias,
        }
        if self.sr_ratio > 1:
            p.update(sr_weight=a.sr.weight, sr_bias=a.sr.bias,
                     srnorm_weight=a.norm.weight, srnorm_bias=a.norm.bias)
        return p

    def forward(self, x, H, W, drop_masks=(None, None)):
        if self.training:
            raise ValueError("FusedBlock is inference-only; call .eval() or build the "
                             "model with fused_blocks=False for training")
        p, sr = self.kernel_params(), self.sr_ratio
        front = {}
        if self.pre_sr and sr > 1:
            front["h"], front["xs"] = sr_reduce(x, p, H=H, W=W, sr=sr, dtype=self.dtype)
        res = self.block_fn(x, p, H=H, W=W, sr=sr, nh=self.num_heads, dtype=self.dtype,
                            export=self.export_attn, **front)
        return res if self.export_attn else (res, None)


class OverlapPatchEmbed(nn.Module):
    """Overlapping patch embed: conv (padding patch // 2) + LayerNorm. NCHW in,
    tokens (B, N, C) and the grid (H, W) out."""

    def __init__(self, patch_size: int, stride: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride, patch_size // 2)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x):
        x = self.proj(x)
        _, _, H, W = x.shape
        return self.norm(x.flatten(2).transpose(1, 2)), H, W


MIT_CONFIGS = {
    "mit_b0": dict(embed_dims=[32, 64, 160, 256], depths=[2, 2, 2, 2]),
    "mit_b1": dict(embed_dims=[64, 128, 320, 512], depths=[2, 2, 2, 2]),
    "mit_b2": dict(embed_dims=[64, 128, 320, 512], depths=[3, 4, 6, 3]),
    "mit_b3": dict(embed_dims=[64, 128, 320, 512], depths=[3, 4, 18, 3]),
    "mit_b4": dict(embed_dims=[64, 128, 320, 512], depths=[3, 8, 27, 3]),
    "mit_b5": dict(embed_dims=[64, 128, 320, 512], depths=[3, 6, 40, 3]),
}


class MixVisionTransformer(nn.Module):
    """Returns (stage features [NCHW x4], exported attention maps [per exporting
    block]).

    collect_attns: True/"all" | "last2" | False/"none" -- which blocks export.
    fused_blocks: run every non-exporting block, and every exporting sr == 1 block,
      as a FusedBlock (K1). Same state_dict either way.
    pre_sr: the fused sr > 1 blocks take the PRE_SR variant (see ``FusedBlock``).
    act_dtype: storage dtype of the residual stream between blocks; fused blocks
      take it directly, plain blocks get f32 (`models/mit.py:415-419` of the JAX
      package). None keeps f32.
    use_flash: kernel K4 under the attention of every block that exports nothing.
    remat: gradient checkpointing per block (``torch.utils.checkpoint``): the
      block's activations are recomputed in the backward pass, with the same
      drop-path masks. Every block is then a plain ``Block``, as in the JAX
      package.

    ``forward(x, generator=None)``: the drop-path masks of a training forward are
    drawn from ``generator`` (a CPU ``torch.Generator``), in block order.
    """

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 depths: Sequence[int] = (2, 2, 2, 2), num_heads=(1, 2, 5, 8),
                 mlp_ratios=(4, 4, 4, 4), sr_ratios=(8, 4, 2, 1), strides=(4, 2, 2, 1),
                 patch_sizes=(7, 3, 3, 3), in_chans: int = 3, qkv_bias: bool = True,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1, dtype=torch.float32, use_flash: bool = False,
                 collect_attns: bool | str = "last2", fused_blocks: bool = False,
                 act_dtype=None, remat: bool = False, pre_sr: bool = False):
        super().__init__()
        mode = {True: "all", False: "none"}.get(collect_attns, collect_attns)
        if mode not in ("all", "last2", "none"):
            raise ValueError(f"collect_attns: {collect_attns!r}")
        self.depths = list(depths)
        self.embed_dims = list(embed_dims)
        self.act_dtype, self.remat = act_dtype, remat
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        self.wants: list[list[bool]] = []
        cur = 0
        for s in range(4):
            setattr(self, f"patch_embed{s + 1}", OverlapPatchEmbed(
                patch_sizes[s], strides[s], in_chans if s == 0 else embed_dims[s - 1],
                embed_dims[s]))
            blocks, wants = [], []
            for b in range(depths[s]):
                want = mode == "all" or (mode == "last2" and cur + b >= total - 2)
                fused = fused_blocks and not remat and (not want or sr_ratios[s] == 1)
                cls, extra = (FusedBlock, dict(pre_sr=pre_sr)) if fused else (Block, {})
                blocks.append(cls(embed_dims[s], num_heads[s], mlp_ratios[s], sr_ratios[s],
                                  qkv_bias, drop_rate, attn_drop_rate, dpr[cur + b],
                                  export_attn=want, use_flash=use_flash, dtype=dtype,
                                  **extra))
                wants.append(want)
            setattr(self, f"block{s + 1}", nn.ModuleList(blocks))
            setattr(self, f"norm{s + 1}", nn.LayerNorm(embed_dims[s], eps=1e-6))
            self.wants.append(wants)
            cur += depths[s]

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        outs, attns = [], []
        for s in range(4):
            x, H, W = getattr(self, f"patch_embed{s + 1}")(x)
            for blk, want in zip(getattr(self, f"block{s + 1}"), self.wants[s]):
                if self.act_dtype is not None:
                    x = x.to(self.act_dtype if isinstance(blk, FusedBlock) else torch.float32)
                masks = tuple(blk.drop_path.draw(x.shape[0], x.device, generator)
                              for _ in range(2))
                if self.remat and torch.is_grad_enabled():
                    x, attn = checkpoint(blk, x, H, W, masks, use_reentrant=False)
                else:
                    x, attn = blk(x, H, W, masks)
                if want:
                    attns.append(attn)
            # stats in f32 on the (possibly bf16) stream; f32 out, as flax's LayerNorm
            x = getattr(self, f"norm{s + 1}")(x.float())
            x = x.transpose(1, 2).reshape(x.shape[0], self.embed_dims[s], H, W)
            outs.append(x)
        return outs, attns


def make_mit(name: str, strides=(4, 2, 2, 1), **kw) -> MixVisionTransformer:
    cfg = dict(MIT_CONFIGS[name])
    cfg.update(strides=tuple(strides), **kw)
    return MixVisionTransformer(**cfg)
