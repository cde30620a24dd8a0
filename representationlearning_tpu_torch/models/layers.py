"""Shared building blocks (the port of ``representationlearning_tpu/models/layers.py``).

Initialisers take an explicit ``torch.Generator`` (a CPU one) and draw on the
CPU whatever device the parameter lives on, so a seed gives the same weights on
the card and on the CPU. ``TorchConv`` of the JAX package is ``nn.Conv2d`` here,
whose integer padding it mirrored.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

GN_EPS = 1e-6   # flax nn.GroupNorm's epsilon (torch's nn.GroupNorm defaults to 1e-5)


def _draw(t: torch.Tensor, fill) -> torch.Tensor:
    """Fill `t` in place with what `fill` draws into a CPU tensor of its shape."""
    with torch.no_grad():
        if t.device.type == "cpu":
            return fill(t)
        return t.copy_(fill(torch.empty(t.shape, dtype=t.dtype)))


def trunc_normal_init(t: torch.Tensor, std: float = 0.02,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """Normal(0, std) truncated at +-2 std, in place (timm's trunc_normal_ as the
    JAX package applies it, `mix_transformer.py:31-43`)."""
    return _draw(t, lambda u: nn.init.trunc_normal_(u, 0.0, std, -2.0 * std, 2.0 * std,
                                                    generator=generator))


def fan_out_conv_init(w: torch.Tensor, groups: int = 1,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """Conv weight (O, I/groups, kh, kw) ~ Normal(0, sqrt(2 / fan_out)),
    fan_out = kh * kw * O / groups (`mix_transformer.py:38-43`), in place."""
    out_ch, _, kh, kw = w.shape
    fan_out = kh * kw * out_ch // groups
    return _draw(w, lambda u: nn.init.normal_(u, 0.0, math.sqrt(2.0 / fan_out),
                                              generator=generator))


def lecun_normal_init(w: torch.Tensor,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """Normal(0, 1 / sqrt(fan_in)) in place, fan_in = I * kh * kw (flax's
    lecun_normal scale, which the JAX AttnProj uses)."""
    return _draw(w, lambda u: nn.init.normal_(u, 0.0, w[0].numel() ** -0.5,
                                              generator=generator))


def init_weights(module: nn.Module, generator: torch.Generator | None = None) -> None:
    """The reference `_init_weights` over a module tree: Linear trunc-normal(0.02)
    with zero bias, LayerNorm/BatchNorm ones/zeros, Conv2d fan-out normal with
    zero bias (`mix_transformer.py:31-43`)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            trunc_normal_init(m.weight, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            fan_out_conv_init(m.weight, m.groups, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, AttnProj):
            lecun_normal_init(m.weight, generator=generator)
            nn.init.zeros_(m.bias)


class DropPath(nn.Module):
    """Stochastic depth: drops the whole residual branch per sample in training;
    the identity in eval.

    The per-sample keep mask is drawn on the CPU from ``generator`` (a CPU
    ``torch.Generator``; None is the global one) and then moved to x's device,
    so a seed gives the same masks on the card and on the CPU. A caller that
    runs the branch twice (gradient checkpointing) draws once with ``draw`` and
    passes ``mask``."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def draw(self, batch: int, device, generator: torch.Generator | None = None):
        """The keep mask (batch,) bool on ``device``; None where the module is
        the identity."""
        if self.rate == 0.0 or not self.training:
            return None
        return (torch.rand((batch,), generator=generator) < 1.0 - self.rate).to(device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if mask is None:
            mask = self.draw(x.shape[0], x.device, generator)
        mask = mask.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        return torch.where(mask, x / (1.0 - self.rate), torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Elementwise dropout, as flax's ``nn.Dropout``. Without a generator it is
    ``F.dropout``. With one (a CPU generator) the mask is drawn on x's device by
    a generator seeded from it, so the same seed gives the same mask on the same
    device without a mask-sized copy from the host."""
    if rate == 0.0 or not training:
        return x
    if generator is None:
        return nn.functional.dropout(x, rate, training=True)
    seed = int(torch.randint(2 ** 62, (1,), generator=generator))
    dev_gen = torch.Generator(device=x.device).manual_seed(seed)
    mask = torch.rand(x.shape, generator=dev_gen, device=x.device) >= rate
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


@contextlib.contextmanager
def bn_stats_frozen(model: nn.Module):
    """Inside, a training forward of ``model`` normalises with batch statistics
    and leaves the running ones alone: the JAX train step keeps the statistics
    of its first forward only."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d) and m.track_stats]
    for m in norms:
        m.track_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.track_stats = True


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``conv(x)`` as the JAX package's ``TorchConv(dtype=...)`` computes it:
    with a dtype, input, weight and bias are cast to it and the result comes out
    in it (bf16 for the tensor cores, f32 sums inside); None is the plain f32
    conv. The parameters stay f32."""
    if dtype is None or dtype == torch.float32:
        return conv(x.float())
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return nn.functional.conv2d(x.to(dtype), conv.weight.to(dtype), bias, conv.stride,
                                conv.padding, conv.dilation, conv.groups)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's conventions: statistics and output in f32
    for an input in f32 or narrower (in f64 for f64), and in training the
    running average takes the biased batch variance (torch's own update takes
    the unbiased one), at torch momentum 0.1 = flax momentum 0.9. ``track_stats
    = False`` (see ``bn_stats_frozen``) leaves the running statistics alone."""

    track_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.float64:
            x = x.float()
        if not self.training:
            return nn.functional.batch_norm(x, self.running_mean, self.running_var,
                                            self.weight, self.bias, False, 0.0, self.eps)
        if self.track_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked += 1
        return nn.functional.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                                        self.eps)


class AttnProj(nn.Module):
    """The TSCD affinity head (`TSCD_model.py:38,73-76`): a 1x1 conv with 2 * nh
    input channels over the channel concat of the last two exported attention
    maps. The parameters are those of ``nn.Conv2d(in_ch, 1, 1)`` (state_dict
    ``weight`` (1, in_ch, 1, 1), ``bias`` (1,)); the forward contracts each
    (B, nh, N, N) map against its slice of the weight instead of building the
    concat. Returns pre-sigmoid logits (B, N, N) in f32."""

    def __init__(self, in_ch: int):
        super().__init__()
        self.in_ch = in_ch
        self.weight = nn.Parameter(torch.empty(1, in_ch, 1, 1))
        self.bias = nn.Parameter(torch.zeros(1))
        lecun_normal_init(self.weight)

    def forward(self, attn_list) -> torch.Tensor:
        w = self.weight[0, :, 0, 0].float()
        out = None
        ofs = 0
        for a in attn_list:
            nh = a.shape[1]
            term = torch.einsum("bknm,k->bnm", a.float(), w[ofs:ofs + nh])
            out = term if out is None else out + term
            ofs += nh
        return out + self.bias[0].float()


class ConvBNReLU(nn.Module):
    """mmcv's ConvModule (`segformer_head.py:53-58`): a conv without bias, padding
    k // 2, the flax-convention ``BatchNorm2d`` (eps 1e-5, torch momentum 0.1),
    then ReLU where ``use_relu``. Names ``conv``, ``bn``. The JAX module's
    ``axis_name`` (BatchNorm statistics across replicas) belongs to the
    multi-device part, which is not ported: the statistics are this device's."""

    def __init__(self, in_ch: int, features: int, kernel_size=(1, 1), use_relu: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        kh, kw = kernel_size
        self.use_relu = use_relu
        self.conv = nn.Conv2d(in_ch, features, (kh, kw), padding=(kh // 2, kw // 2), bias=False)
        self.bn = BatchNorm2d(features, eps=1e-5, momentum=0.1)
        fan_out_conv_init(self.conv.weight, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.use_relu else x


class TorchLinear(nn.Linear):
    """``nn.Linear`` drawn as the JAX ``TorchLinear``: trunc-normal(0.02) weight,
    zero bias."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__(in_features, features, bias=use_bias)
        trunc_normal_init(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
