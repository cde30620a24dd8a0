"""Checkpoint converter CLI, the port of
``representationlearning_tpu/cli/convert_checkpoint.py``.

The port keeps the reference's PyTorch names, so where the JAX CLI turns a
reference checkpoint into JAX variables, this one does the two jobs that leaves:

- A reference PyTorch checkpoint of a family (official SegFormer mit_b0..b5,
  trained TSCD, torchvision / WaveCAM ResNet-50, mmlab HRNetV2, trained RSSFormer
  ``HRNetFusion`` with an HRNetV2 or an HRFormer backbone) is loaded on the CPU,
  a ``"state_dict"`` entry unwrapped and DDP's ``module.`` prefix stripped; the
  entries that the JAX converter of the family drops are dropped
  (``num_batches_tracked``, which the port's model then holds at 0; MiT's
  classification head, ResNet-50's ``fc``, WaveCAM's duplicate module references
  and ``bg`` head, the HRNets' ImageNet head, HRFormer's dead ``norm2``,
  RSSFormer's ``loss.*``); the rest is loaded strictly into the family's port
  model and its ``state_dict`` saved.
- A JAX variables ``.npy`` (``--from-jax``) goes through ``convert/from_jax.py``
  into the port's ``state_dict`` (for ``train_wavecam``'s ``{"net", "pred"}`` file,
  a dict of the two), which is saved. The baseline zoo's families are its
  registry names, ``FarSegV1`` ... ``trans``.

The JAX converter needs no widths; the port loads by building the model, so a
family with several widths takes ``--arch`` (default the JAX package's default
for it); class counts are read from the checkpoint. ``--no-strict`` loads a
reference checkpoint with ``strict=False`` (entries without a place are left
out) where the JAX CLI ignores the names it cannot map. ``--report`` prints the
tensor and value counts.

Usage:
    python -m representationlearning_tpu_torch.cli.convert_checkpoint \\
        --family {mit,tscd,resnet50,wavecam_net,hrnet,rssformer} [--arch NAME] \\
        --src /path/model.pth --dst out.pt [--no-strict] [--report]
    python -m representationlearning_tpu_torch.cli.convert_checkpoint --from-jax \\
        --family {tscd,rml,rssformer,...} --src variables.npy --dst out.pt [--report]
"""
from __future__ import annotations

import argparse
import re

import numpy as np
import torch

from ..convert import from_jax as FJ
from ..models.hrnet import HRNET_EXTRA, HighResolutionNet
from ..models.hrt import HRT_CONFIGS
from ..models.mit import MIT_CONFIGS, MixVisionTransformer
from ..models.resnet import Net, ResNet50Backbone
from ..models.rssformer import HRNetFusion
from ..models.smp_zoo import ZOO_MODELS
from ..models.tscd import TSCD

NBT = r".*num_batches_tracked"
HRNET_HEAD = r"(incre_modules|downsamp_modules|final_layer|classifier)\..*"
ENCODER_PREFIXES = ("backbone.hrnet.", "backbone.model.", "backbone.encoder.", "backbone.")


def _rssformer_names(sd: dict) -> dict:
    """The reference's encoder wrappers (``backbone.hrnet.``, ``.model.``,
    ``.encoder.`` or none) as the port's ``backbone.hrnet.``; ``loss.*`` left out,
    as ``convert_rssformer`` does."""
    out = {}
    for k, v in sd.items():
        if k.startswith("loss."):
            continue
        if not k.startswith(("neck.", "head.", "headaux.")):
            pre = next((p for p in ENCODER_PREFIXES if k.startswith(p)), "")
            k = "backbone.hrnet." + k[len(pre):]
        out[k] = v
    return out


def _cpu(**kw):
    return dict(device="cpu", generator=torch.Generator().manual_seed(0), **kw)


# family -> (archs, default arch, model from (arch, state_dict), entries dropped)
REFERENCE = {
    "mit": (tuple(MIT_CONFIGS), "mit_b1",
            lambda arch, sd: MixVisionTransformer(**MIT_CONFIGS[arch]), r"head\.(weight|bias)"),
    "tscd": (tuple(MIT_CONFIGS), "mit_b1",
             lambda arch, sd: TSCD(arch, sd["classifier.weight"].shape[0] + 1, **_cpu()), None),
    "resnet50": ((), None, lambda arch, sd: ResNet50Backbone(), r"fc\.(weight|bias)"),
    "wavecam_net": ((), None,
                    lambda arch, sd: Net(n_classes=sd["classifier.weight"].shape[0], **_cpu()),
                    r"bg\.weight|stage\d\..*|backbone\..*|newly_added\..*"),
    "hrnet": (tuple(HRNET_EXTRA), "hrnetv2_w32",
              lambda arch, sd: HighResolutionNet(
                  arch, with_transformer=any(".transformer." in k for k in sd)), HRNET_HEAD),
    "rssformer": (tuple(HRNET_EXTRA) + tuple(HRT_CONFIGS), "hrnetv2_w32",
                  lambda arch, sd: HRNetFusion(
                      arch, sd["head.0.weight"].shape[0],
                      with_transformer=any(".transformer." in k for k in sd), **_cpu()),
                  r"backbone\.hrnet\.(" + HRNET_HEAD
                  + r"|stage\d\.\d+\.branches\.\d+\.\d+\.norm2\..*)"),
}


def _train_wavecam(variables) -> dict:
    return {"net": FJ.wavecam_net_state_dict_from_jax(variables["net"]),
            "pred": FJ.wavecam_predictor_state_dict_from_jax(variables["pred"])}


FROM_JAX = {
    "tscd": FJ.tscd_state_dict_from_jax,
    "wetr_baseline": FJ.wetr_baseline_state_dict_from_jax,
    "rml": FJ.rml_state_dict_from_jax,
    "rssformer": FJ.rssformer_state_dict_from_jax,
    "rsnet_fusion": FJ.rsnet_fusion_state_dict_from_jax,
    "hrnet_fusion2": FJ.hrnet_fusion2_state_dict_from_jax,
    "wavecam_net": FJ.wavecam_net_state_dict_from_jax,
    "wavecam_predictor": FJ.wavecam_predictor_state_dict_from_jax,
    "train_wavecam": _train_wavecam,
    "resnet50": FJ.resnet50_state_dict_from_jax,
    "irn": FJ.irn_state_dict_from_jax,
    "dcl": FJ.dcl_state_dict_from_jax,
    "pixel_discriminator": FJ.pixel_discriminator_state_dict_from_jax,
    **{name: FJ.zoo_state_dict_from_jax for name in ZOO_MODELS},   # the baseline zoo
}


def load_reference_checkpoint(path: str) -> dict:
    """A reference ``.pth``: tensors only (``weights_only``), a ``"state_dict"``
    entry unwrapped, DDP's ``module.`` prefixes stripped (RSSFormer `eval.py:31-38`)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}


def convert_reference(family: str, sd: dict, arch: str | None = None,
                      strict: bool = True) -> tuple[dict, object]:
    """A reference state_dict -> (the port's state_dict, the load's missing and
    unexpected keys)."""
    archs, default, build, drop = REFERENCE[family]
    arch = arch or default
    if archs and arch not in archs:
        raise ValueError(f"--arch {arch!r} is not one of {family}'s: {', '.join(archs)}")
    if family == "rssformer":
        sd = _rssformer_names(sd)
    dropped = re.compile(NBT if drop is None else f"{NBT}|{drop}")
    sd = {k: v for k, v in sd.items() if not dropped.fullmatch(k)}
    model = build(arch, sd)
    counters = {k: v for k, v in model.state_dict().items() if k.endswith("num_batches_tracked")}
    keys = model.load_state_dict({**counters, **sd}, strict=strict)
    return model.state_dict(), keys


def _counts(sd: dict) -> tuple[int, int]:
    leaves = [v for v in sd.values() if torch.is_tensor(v)] + [
        t for v in sd.values() if isinstance(v, dict) for t in v.values()]
    return len(leaves), sum(t.numel() for t in leaves)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", required=True,
                    help=f"reference: {', '.join(REFERENCE)}; --from-jax: {', '.join(FROM_JAX)}")
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--from-jax", action="store_true",
                    help="--src is a JAX variables .npy ({'params': ..., 'batch_stats': ...})")
    ap.add_argument("--arch", default=None,
                    help="the width of a reference family's model: mit_b0..b5, "
                         "hrnetv2_w18..w48, hrt_* (default: the JAX package's)")
    ap.add_argument("--no-strict", action="store_true",
                    help="load a reference checkpoint with strict=False instead of raising")
    ap.add_argument("--report", action="store_true")
    args = ap.parse_intermixed_args(argv)

    if args.from_jax:
        if args.family not in FROM_JAX:
            ap.error(f"--from-jax --family must be one of {', '.join(FROM_JAX)}")
        out = FROM_JAX[args.family](np.load(args.src, allow_pickle=True).item())
        n_src = None
    else:
        if args.family not in REFERENCE:
            ap.error(f"--family must be one of {', '.join(REFERENCE)}")
        sd = load_reference_checkpoint(args.src)
        out, keys = convert_reference(args.family, sd, args.arch, strict=not args.no_strict)
        n_src = len(sd)
        if args.report and (keys.missing_keys or keys.unexpected_keys):
            print(f"not loaded: {keys.unexpected_keys}; left at their initial values: "
                  f"{keys.missing_keys}")
    torch.save(out, args.dst)
    if args.report:
        n, total = _counts(out)
        print(f"state_dict: {n} tensors, {total:,} values")
        if n_src is not None:
            print(f"reference entries read: {n_src}")
    print(f"wrote {args.dst}")
    return out


if __name__ == "__main__":
    main()
