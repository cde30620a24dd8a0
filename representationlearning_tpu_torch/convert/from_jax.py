"""JAX variable tree -> PyTorch state_dict: the exact inverse of
``representationlearning_tpu/convert/torch2jax.py::convert_tscd`` and of its MiT
and SegFormer-head rules (``WeTrBaseline`` too), of ``convert_rssformer`` /
``convert_hrnet`` / ``convert_hrt`` and of ``convert_wetr_attn_aff``; and the JAX
models without a forward converter (``RMLModel``, ``IRNNet``, WaveCAM's
``ClassPredictorWavecam``, DRFL's ``Softnet`` and ``PixelDiscriminator``, the ASFF
variants ``RsNetFusion`` and ``HRNetFusion2``, the fourteen models of the baseline
zoo) -> the port's.

The input is the ``{"params": ..., "batch_stats": ...}`` tree of nested dicts,
with numpy (or array-like) leaves. Layout rules, each the transpose of the
forward rule, so a round trip is bit for bit:

- Dense kernel (in, out)         -> Linear weight (out, in)
- Conv kernel HWIO               -> Conv2d weight OIHW (depthwise (3,3,1,C) -> (C,1,3,3))
- LayerNorm/BatchNorm ``scale``  -> ``weight``
- PReLU ``negative_slope`` ()    -> ``nn.PReLU(1)``'s ``weight`` (1,)
- batch_stats ``mean``/``var``   -> ``running_mean``/``running_var``, plus
  ``num_batches_tracked`` = 0, which the forward converter drops
- scopes: ``block{s}_{b}`` -> ``block{s}.{b}``, ``dwconv/Conv_0`` -> ``dwconv.dwconv``,
  ``decoder/linear_c{i}`` -> ``decoder.linear_c{i}.proj``
"""
from __future__ import annotations

import re
from typing import Any, Iterator, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix=()) -> Iterator[tuple[tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_name(scopes: tuple[str, ...]) -> str:
    out = []
    for i, s in enumerate(scopes):
        m = re.fullmatch(r"block(\d)_(\d+)", s)
        if m:
            out.append(f"block{m.group(1)}.{m.group(2)}")
        elif s == "Conv_0" and i > 0 and scopes[i - 1] == "dwconv":
            out.append("dwconv")
        elif re.fullmatch(r"linear_c\d", s) and i > 0 and scopes[i - 1] == "decoder":
            out.append(f"{s}.proj")
        else:
            out.append(s)
    return ".".join(out)


def _param(leaf: str, w: np.ndarray) -> tuple[str, np.ndarray]:
    if leaf == "kernel":
        if w.ndim == 2:
            return "weight", w.T
        if w.ndim == 4:
            return "weight", w.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {w.ndim}")
    if leaf == "scale":
        return "weight", w
    if leaf == "bias":
        return "bias", w
    if leaf == "negative_slope":   # flax nn.PReLU's scalar -> nn.PReLU(1)'s weight
        return "weight", w.reshape(1)
    raise KeyError(f"unknown param leaf {leaf!r}")


def state_dict_from_jax(variables: Mapping[str, Any],
                        module_name=_module_name) -> dict[str, torch.Tensor]:
    """Any MiT / SegFormer-head / TSCD variable tree (or a subtree of one, such
    as a single Block) -> the port's state_dict. ``module_name`` maps the flax
    scopes of a leaf to the dotted name of its module."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected collections {sorted(unknown)}")
    sd: dict[str, torch.Tensor] = {}

    def put(key, w):
        sd[key] = torch.from_numpy(np.array(w))  # a writable, contiguous copy

    def name(path, leaf):
        mod = module_name(path[:-1])
        return f"{mod}.{leaf}" if mod else leaf  # a module's own leaves have no prefix

    for path, w in _flatten(variables.get("params", {})):
        leaf, w = _param(path[-1], np.asarray(w))
        put(name(path, leaf), w)
    for path, w in _flatten(variables.get("batch_stats", {})):
        stat = {"mean": "running_mean", "var": "running_var"}.get(path[-1])
        if stat is None:
            raise KeyError(f"unknown batch_stats leaf {path!r}")
        put(name(path, stat), np.asarray(w))
        sd[name(path, "num_batches_tracked")] = torch.tensor(0, dtype=torch.int64)
    return sd


def tscd_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``TSCD`` variables -> the port's ``TSCD`` state_dict (inverse of
    ``convert_tscd``)."""
    return state_dict_from_jax(variables)


def _rml_module_name(scopes: tuple[str, ...]) -> str:
    """flax scopes of the JAX RML modules -> the port's module names: the neck's
    ``conv`` / ``bn`` are the reference's ``fuse_conv.0`` / ``fuse_conv.1``, and
    PATM's ``reweight_fc{1,2}`` (WaveBlock's ``mlp_fc{1,2}``) are ``reweight.fc{1,2}``
    (``mlp.fc{1,2}``)."""
    if scopes[:1] == ("neck",):
        return "neck.fuse_conv." + {"conv": "0", "bn": "1"}[scopes[1]]
    return _module_name(tuple(re.sub(r"^(reweight|mlp)_fc(\d)$", r"\1.fc\2", s)
                              for s in scopes))


def rml_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``RMLModel`` variables (or those of a ``PATM`` / ``WaveBlock``) -> the
    port's state_dict."""
    return state_dict_from_jax(variables, _rml_module_name)


def wetr_attn_aff_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``WeTrAttnAff`` variables -> the port's ``WeTrAttnAff`` state_dict: the
    inverse of ``convert_wetr_attn_aff`` (``num_batches_tracked``, which it drops,
    comes back as 0)."""
    return state_dict_from_jax(variables, _rml_module_name)


_HRNET_SCOPES = (
    (r"layer1_(\d)", r"layer1.\1"),
    (r"downsample_conv", "downsample.0"), (r"downsample_bn", "downsample.1"),
    (r"stage(\d)_m(\d)", r"stage\1.\2"),
    (r"branch(\d)_block(\d)", r"branches.\1.\2"),
    (r"t(\d)_conv", r"\1.0"), (r"t(\d)_bn", r"\1.1"),
    (r"t(\d)_conv(\d)", r"\1.\2.0"), (r"t(\d)_bn(\d)", r"\1.\2.1"),
)
_FUSE_LEAVES = ((r"conv", "0"), (r"bn", "1"), (r"conv(\d)", r"\1.0"), (r"bn(\d)", r"\1.1"),
                # HRTFuseDown's depthwise-separable steps
                (r"dw(\d)", r"\1.0"), (r"dwbn(\d)", r"\1.1"), (r"pw(\d)", r"\1.2"),
                (r"pwbn(\d)", r"\1.3"))


def _hrnet_module_name(prefix: str, scopes: tuple[str, ...]) -> str:
    """flax scopes inside a JAX ``HighResolutionNet`` or
    ``HighResolutionTransformerNet`` -> the reference's module name under
    ``prefix``: the inverse of the rules of ``convert_hrnet`` and ``convert_hrt``."""
    out = [prefix]
    for i, s in enumerate(scopes):
        m = re.fullmatch(r"fuse(\d)_(\d)", s)
        if m:
            out.append(f"fuse_layers.{m.group(1)}.{m.group(2)}")
            continue
        rules = _FUSE_LEAVES if i and re.fullmatch(r"fuse\d_\d", scopes[i - 1]) else _HRNET_SCOPES
        for pat, rep in rules:
            if re.fullmatch(pat, s):
                s = re.sub(pat, rep, s)
                break
        out.append(s)
    return ".".join(out)


def _rssformer_module_name(scopes: tuple[str, ...]) -> str:
    """flax scopes of the JAX ``HRNetFusion`` -> the reference's module name, the
    inverse of the rules of ``convert_rssformer`` with ``convert_hrnet`` or
    ``convert_hrt``."""
    if scopes[0] == "backbone":
        return _hrnet_module_name("backbone.hrnet", scopes[1:])
    if scopes[0] == "neck":
        return "neck.fuse_conv." + {"conv": "0", "bn": "1"}[scopes[1]]
    if scopes == ("head_conv",):
        return "head.0"
    if scopes == ("headaux",):
        return "headaux.0"
    raise KeyError(f"unknown scope {'/'.join(scopes)}")


def rssformer_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``HRNetFusion`` variables, with an HRNetV2 or an HRFormer (``hrt_*``)
    backbone -> the port's ``HRNetFusion`` state_dict: the inverse of
    ``convert_rssformer``, and for the HRFormer of its neck and heads' rules with
    ``convert_hrt``."""
    return state_dict_from_jax(variables, _rssformer_module_name)


def _hrnet_head_module_name(scopes: tuple[str, ...]) -> str:
    """flax scopes of the JAX ``RsNetFusion`` / ``HRNetFusion2`` -> the port's
    names: the HRNet's reference names under ``backbone``, the rest the scopes
    joined by dots."""
    if scopes[0] == "backbone":
        return _hrnet_module_name("backbone", scopes[1:])
    return ".".join(scopes)


def rsnet_fusion_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``RsNetFusion`` variables -> the port's ``RsNetFusion`` state_dict. The
    JAX package has no converter for it to invert."""
    return state_dict_from_jax(variables, _hrnet_head_module_name)


def hrnet_fusion2_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``HRNetFusion2`` variables -> the port's ``HRNetFusion2`` state_dict. The
    JAX package has no converter for it to invert."""
    return state_dict_from_jax(variables, _hrnet_head_module_name)


def wetr_baseline_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``WeTrBaseline`` variables -> the port's ``WeTrBaseline`` state_dict: the
    inverse of ``convert/torch2jax.py``'s MiT and SegFormer-head rules with the
    classifier's (``convert_tscd`` without ``attn_proj``)."""
    return state_dict_from_jax(variables)


def named_tree_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A tree shaped like the JAX ``params`` (the gradients, an optax moment
    such as ``mu`` or ``nu``) -> tensors under the port's parameter names. The
    layouts are linear maps, so the transposes that carry the weights carry
    these too; compare with ``dict(model.named_parameters())``, the ``.grad``s
    or ``optimizer.state[p]["exp_avg"]``. BatchNorm statistics go through
    ``state_dict_from_jax({"batch_stats": ...})``."""
    return state_dict_from_jax({"params": tree})


_RESNET_SCOPES = ((r"layer(\d)_(\d+)", r"layer\1.\2"), (r"downsample_conv", "downsample.0"),
                  (r"downsample_bn", "downsample.1"))


def _resnet_module_name(scopes: tuple[str, ...]) -> str:
    """flax scopes of the JAX ``ResNet50Backbone`` / ``Net`` -> the reference's
    module names (``layer2_0/downsample_bn`` -> ``layer2.0.downsample.1``), the
    inverse of ``_resnet50_mapper``."""
    out = []
    for s in scopes:
        for pat, rep in _RESNET_SCOPES:
            if re.fullmatch(pat, s):
                s = re.sub(pat, rep, s)
                break
        out.append(s)
    return ".".join(out)


def wavecam_net_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX WaveCAM ``Net`` variables -> the port's ``Net`` state_dict: the inverse
    of ``convert_wavecam_net`` (``num_batches_tracked``, which it drops, comes
    back as 0)."""
    return state_dict_from_jax(variables, _resnet_module_name)


def resnet50_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``ResNet50Backbone`` variables -> the port's ``ResNet50Backbone``
    state_dict (torchvision's names without a prefix): the inverse of
    ``convert_resnet50``."""
    return state_dict_from_jax(variables, _resnet_module_name)


def wavecam_predictor_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``ClassPredictorWavecam`` variables -> the port's state_dict. The port
    names its modules after JAX's scopes (``wave/theta_R_bn`` -> ``wave.theta_R_bn``);
    ``classifier_kernel`` (F, C) becomes ``classifier`` (C, F), its transpose. No
    reference checkpoint was at hand to check these names against."""
    params = dict(variables["params"])
    kernel = np.asarray(params.pop("classifier_kernel"))
    sd = state_dict_from_jax({"params": params,
                              "batch_stats": variables.get("batch_stats", {})}, ".".join)
    sd["classifier"] = torch.from_numpy(np.array(kernel.T))
    return sd


_IRN_HEAD_SCOPES = {"Conv_0": "0", "GroupNorm_0": "1"}


def _irn_module_name(scopes: tuple[str, ...]) -> str:
    """flax scopes of the JAX ``IRNNet`` -> the port's names, those of IRN's
    published ``resnet50_irn.py``: ``fc_edge1/Conv_0`` -> ``fc_edge1.0``,
    ``GroupNorm_0`` -> ``.1``, ``fc_dp7a`` -> ``fc_dp7.{0,1}``, ``fc_dp7b`` ->
    ``fc_dp7.3``; the backbone as ``_resnet_module_name``."""
    if scopes[0] == "resnet50":
        return _resnet_module_name(scopes)
    if scopes == ("fc_dp7b",):
        return "fc_dp7.3"
    head = "fc_dp7" if scopes[0] == "fc_dp7a" else scopes[0]
    return ".".join((head,) + tuple(_IRN_HEAD_SCOPES[s] for s in scopes[1:]))


def irn_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``IRNNet`` variables -> the port's ``IRNNet`` state_dict. The JAX
    package has no IRN converter to invert; the displacement field's running
    mean, ``batch_stats/dp_running_mean``, is ``mean_shift.running_mean``."""
    stats = dict(variables.get("batch_stats", {}))
    dp_mean = stats.pop("dp_running_mean")
    sd = state_dict_from_jax({"params": variables["params"], "batch_stats": stats},
                             _irn_module_name)
    sd["mean_shift.running_mean"] = torch.from_numpy(np.array(dp_mean))
    return sd


def _dcl_conv_transpose(scopes: tuple[str, ...]) -> bool:
    """The flax scopes of DCL's ``ConvTranspose`` modules: each ``DecodeLayer``'s
    ``up_conv`` and each ``EndLayer``'s ``conv``."""
    return scopes[-1:] == ("up_conv",) or scopes[-2:] in (("end", "conv"), ("end2", "conv"))


def dcl_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``Softnet`` variables -> the port's ``Softnet`` state_dict. The port
    names its modules after JAX's scopes, so a name is the scope path joined by
    dots; the layouts are ``state_dict_from_jax``'s, and besides: a transposed
    convolution's kernel (kh, kw, in, out) -> ``nn.ConvTranspose2d``'s weight
    (in, out, kh, kw) flipped in both spatial axes, ``prelu_alpha`` ->
    ``prelu.weight``, the position embeddings as they are. Strict: an unknown
    collection or leaf raises, and every leaf lands on a key (load the result
    with ``strict=True`` to hold it to the model's keys)."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected collections {sorted(unknown)}")
    sd = state_dict_from_jax({"batch_stats": variables.get("batch_stats", {})}, ".".join)
    for path, w in _flatten(variables.get("params", {})):
        w, leaf = np.asarray(w), path[-1]
        if leaf == "prelu_alpha":
            name = "prelu.weight"
        elif leaf in ("position_embeddings", "position_embeddings2"):
            name = leaf
        elif leaf == "kernel" and _dcl_conv_transpose(path[:-1]):
            name, w = "weight", w.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        else:
            name, w = _param(leaf, w)
        sd[".".join(path[:-1] + (name,))] = torch.from_numpy(np.array(w))   # a writable copy
    return sd


def pixel_discriminator_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``PixelDiscriminator`` variables -> the port's state_dict (the same
    names: ``conv1``, ``conv2``, ``bn``, ``conv3``)."""
    return state_dict_from_jax(variables, ".".join)


def _zoo_module_name(scopes: tuple[str, ...]) -> str:
    """flax scopes of a JAX baseline-zoo model -> the port's names: the
    ResNet-50 encoder (``resnet`` in ``models/baselines.py``, ``encoder`` in
    ``models/smp_zoo.py``) with the reference names of ``convert_resnet50``,
    ``trans``'s HRNet (``backbone``) with those of ``convert_hrnet``, the rest
    the scopes joined by dots."""
    if scopes[0] in ("resnet", "encoder"):
        return f"{scopes[0]}.{_resnet_module_name(scopes[1:])}"
    if scopes[0] == "backbone":
        return _hrnet_module_name("backbone", scopes[1:])
    return ".".join(scopes)


def zoo_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX variables of any of the baseline zoo's fourteen models
    (``models/smp_zoo.py::ZOO_MODELS``) -> the port model's state_dict. The JAX
    package has no converter for them to invert. Load the result with
    ``strict=True``: a PAN whose JAX variables were made at an input too small
    for all three levels of its FPA pyramid lacks the deeper levels' weights."""
    return state_dict_from_jax(variables, _zoo_module_name)
