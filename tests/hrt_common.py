"""Shared pieces of the tests that hold the port's HRFormer backbone
(`representationlearning_tpu_torch/models/hrt.py`), the ASFF variants and the
modules named after the JAX package's scopes to the JAX package: the JAX
variables of a port state_dict, and the noise that makes the wiring of every
bias, norm and statistic show."""
import numpy as np
import torch

from representationlearning_tpu.convert.torch2jax import (convert_hrt, convert_rssformer,
                                                          state_dict_to_numpy)
from representationlearning_tpu_torch.models.layers import BatchNorm2d

HEADS = ("neck.", "head.", "headaux.")


def hrt_variables(sd) -> dict:
    """A port `HRNetFusion("hrt_*")` state_dict -> the JAX `HRNetFusion` variables:
    `convert_rssformer`'s rules on the neck and heads, `convert_hrt` on the
    backbone, both strict (every name consumed)."""
    sd = {k: np.array(t) for k, t in state_dict_to_numpy(sd).items()}   # copies
    top = {k: v for k, v in sd.items() if k.startswith(HEADS)}
    enc = {k.removeprefix("backbone.hrnet."): v for k, v in sd.items() if not k.startswith(HEADS)}
    a, b = convert_rssformer(top, strict=True), convert_hrt(enc, strict=True)
    return {"params": {**a["params"], **b["params"]},
            "batch_stats": {**a["batch_stats"], **b["batch_stats"]}}


def scoped_variables(sd, prefix: str = "") -> dict:
    """A state_dict whose module names are the JAX scopes joined by dots (the
    inverse of `from_jax.state_dict_from_jax(v, ".".join)`) -> JAX variables: a
    conv weight OIHW -> HWIO ``kernel``, a Linear weight -> its transpose, a
    norm's weight -> ``scale``, running statistics -> ``batch_stats``
    ``mean`` / ``var``; ``num_batches_tracked`` left out; other leaves as they
    are. Only the names under ``prefix`` are taken, without it."""
    out = {"params": {}, "batch_stats": {}}
    for name, t in state_dict_to_numpy(sd).items():
        if not name.startswith(prefix) or name.endswith("num_batches_tracked"):
            continue
        *path, leaf = name[len(prefix):].split(".")
        coll = "params"
        if leaf == "weight":
            leaf, t = ("scale", t) if t.ndim == 1 else \
                ("kernel", t.T if t.ndim == 2 else t.transpose(2, 3, 1, 0))
        elif leaf in ("running_mean", "running_var"):
            coll, leaf = "batch_stats", leaf.removeprefix("running_")
        node = out[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.array(t)   # a copy: the tensor may move on
    return out if out["batch_stats"] else {"params": out["params"]}


def jitter(module, seed, head_scale=0.1):
    """Noise on every bias, norm affine and BatchNorm statistic; BatchNorm scales
    halved, so that the stream stays of order 1 at random weights; the classifier
    scaled so that the softmax is not one-hot."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        if hasattr(module, "head"):
            module.head[0].weight.mul_(head_scale)
        for m in module.modules():
            if isinstance(m, BatchNorm2d):
                m.weight.mul_(0.5)
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            if not t.is_floating_point():
                continue
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.75)
            elif name.endswith(("bias", "running_mean")) or "norm" in name or ".bn" in name:
                t.add_(0.1 * torch.randn(t.shape, generator=g))
    return module


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().transpose(0, 2, 3, 1)
