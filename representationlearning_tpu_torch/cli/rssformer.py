"""RSSFormer train / eval / predict CLI, the port of
``representationlearning_tpu/cli/rssformer.py`` (equivalents of
`RSSFormer-TIP2023/train.py`, `eval.py`, `predict.py`: config, registry, trainer;
dotted CLI overrides like `scripts/train.sh:14`).

Usage:
    python -m representationlearning_tpu_torch.cli.rssformer train --config configs/rssformer_loveda.yaml
    python -m representationlearning_tpu_torch.cli.rssformer eval  --config ... --ckpt_dir ... [--tta]
    python -m representationlearning_tpu_torch.cli.rssformer predict --config ... --ckpt_dir ... --out_dir viz

The commands, config, overrides, loop, logs and checkpoint layout are the JAX
package's. It runs on one device, the card unless ``main(..., device=)`` names
another (the tests pass "cpu"). The model is built from ``cfg.seed`` and trained
in f32; step ``it`` draws from ``cfg.seed + it`` (the drop path of an HRFormer
backbone, ``model.hrnet_type=hrt_*``), as the JAX CLI's step key does.
``model.fused_mlp`` puts every transformer block's FFN on kernel K5 in
``eval`` and ``predict`` (training never reaches it); K5's CUDA kernels take bf16
operands with f32 sums only (as the TPU's default precision does for the JAX
package's f32 model), so with ``model.fused_mlp`` on the card those two commands
build the model to compute in bf16 and load the f32 checkpoint into it.
``model.defer_bn_ema`` and ``model.conv_mm`` are TPU lowerings of the same
arithmetic; they are accepted and change nothing. With ``data.device_augment``
the host ships raw uint8 canvases and the LoveDA chain runs on the device before
each step; the host chain needs OpenCV.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .._device import resolve_device
from ..core.config import Config, load_yaml
from ..core.logging import AverageMeter, setup_logger
from ..data.device_transforms import (LoveDAAugConfig, augment_loveda_batch,
                                      sample_loveda_decisions)
from ..data.loveda import LoveDADataset, collate_loveda
from ..infer.tta import default_tta_config
from ..models.rssformer import HRNetFusion
from ..train import checkpoints as CK
from ..train.rssformer import (RSSFormerTrainConfig, create_rssformer_state, evaluate,
                               make_rssformer_eval_step, make_rssformer_train_step)
from ..utils.visualize import save_palette_png


def default_config() -> Config:
    return Config({
        "model": {"hrnet_type": "hrnetv2_w32", "classes": 7, "loss": {"ce": {}},
                   "defer_bn_ema": True,
                   # inference-only whole-FFN kernel K5 (ops/mlp_dwbn.py)
                   "fused_mlp": False,
                   # MlpDWBN's dilated branches as shifted matmuls on the TPU
                   "conv_mm": False},
        "data": {"image_dir": None, "mask_dir": None, "crop_size": 512,
                  "batch_size": 8, "synthetic_n": 16,
                  # device_augment: crop/flip/rot90/ShiftScaleRotate/normalize on
                  # the device before each step (data/device_transforms.py)
                  "device_augment": False, "canvas_size": 1024},
        "learning_rate": {"base_lr": 0.01, "power": 0.9, "max_iters": 30000},
        "optimizer": {"momentum": 0.9, "weight_decay": 1e-4, "grad_clip": 35.0},
        "train": {"num_iters": 30000, "log_interval_step": 50, "eval_interval": 2000},
        "work_dir": "work_rssformer",
        "seed": 2333,
    })


def compute_dtype(cfg, device: torch.device, inference: bool) -> torch.dtype:
    """The model's compute dtype: bf16 where an inference command runs K5 on the
    card (K5's CUDA kernels take bf16 only), f32 everywhere else."""
    fused = inference and device.type == "cuda" and fused_mlp(cfg)
    return torch.bfloat16 if fused else torch.float32


def fused_mlp(cfg) -> bool:
    return bool(cfg.model.get("fused_mlp", False)) and cfg.model.hrnet_type.startswith("hrnetv2")


def _build(cfg, device: torch.device, inference: bool = False):
    model = HRNetFusion(hrnet_type=cfg.model.hrnet_type, classes=cfg.model.classes,
                        loss_config=cfg.model.loss.to_dict(), fused_mlp=fused_mlp(cfg),
                        dtype=compute_dtype(cfg, device, inference),
                        generator=torch.Generator().manual_seed(cfg.seed), device=device)
    tcfg = RSSFormerTrainConfig(
        base_lr=cfg.learning_rate.base_lr, power=cfg.learning_rate.power,
        max_iters=cfg.learning_rate.max_iters, momentum=cfg.optimizer.momentum,
        weight_decay=cfg.optimizer.weight_decay, grad_clip=cfg.optimizer.grad_clip,
        num_classes=cfg.model.classes,
    )
    return model, tcfg


def _nchw(img: np.ndarray) -> torch.Tensor:
    """A normalised (H, W, 3) sample as a (1, 3, H, W) tensor."""
    return torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))[None]


def cmd_train(cfg, device: torch.device):
    log = setup_logger("rssformer")
    model, tcfg = _build(cfg, device)
    crop = cfg.data.crop_size
    state = create_rssformer_state(model, tcfg)
    ckpt_dir = os.path.join(cfg.work_dir, "checkpoints")
    if CK.latest_step(ckpt_dir) is not None:
        state = CK.restore(ckpt_dir, state)
        log.info("resumed at step %d", int(state.step))

    step_fn = make_rssformer_train_step(model, tcfg, device=device)
    device_aug = bool(cfg.data.get("device_augment", False))
    ds = LoveDADataset(image_dir=cfg.data.image_dir, mask_dir=cfg.data.mask_dir,
                       training=True, crop_size=crop, seed=cfg.seed,
                       synthetic_n=cfg.data.get("synthetic_n", 16),
                       raw=device_aug,
                       canvas_size=cfg.data.get("canvas_size", 1024))
    aug_cfg = LoveDAAugConfig(crop_size=crop, num_classes=cfg.model.classes)

    meter = AverageMeter()
    rng = np.random.default_rng(cfg.seed)
    for it in range(int(state.step), cfg.train.num_iters):
        idxs = rng.integers(0, len(ds), cfg.data.batch_size)
        samples = [ds[int(i)] for i in idxs]
        if device_aug:
            raw, hw, mask_raw = (torch.stack([s[j] for s in samples]).to(device)
                                 for j in (1, 2, 3))
            dec = sample_loveda_decisions(len(samples), aug_cfg,
                                          torch.Generator().manual_seed(cfg.seed + it), device)
            image, mask = augment_loveda_batch(raw, hw, mask_raw, dec, aug_cfg)
            batch = {"image": image, "mask": mask}
        else:
            _, imgs, masks = collate_loveda(samples)
            batch = {"image": torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous(),
                     "mask": torch.from_numpy(masks)}
        state, metrics = step_fn(state, batch, torch.Generator().manual_seed(cfg.seed + it))
        meter.add(**{k: float(v) for k, v in metrics.items()})
        if (it + 1) % cfg.train.log_interval_step == 0:
            log.info("iter %d/%d %s", it + 1, cfg.train.num_iters,
                     " ".join(f"{k}={v:.4f}" for k, v in meter.pop().items()))
        if (it + 1) % cfg.train.eval_interval == 0 or it + 1 == cfg.train.num_iters:
            CK.save(ckpt_dir, it + 1, state)
    return state


def _restore_for_eval(cfg, args, device: torch.device):
    """The model from ``cfg.seed`` in its inference compute dtype, with the latest
    checkpoint of ``--ckpt_dir`` (else the work directory's) loaded strictly into
    it where one exists."""
    model, tcfg = _build(cfg, device, inference=True)
    state = create_rssformer_state(model, tcfg)
    ckpt_dir = args.ckpt_dir or os.path.join(cfg.work_dir, "checkpoints")
    if CK.latest_step(ckpt_dir) is not None:
        state = CK.restore(ckpt_dir, state)
    return model, state


def _eval_dataset(cfg) -> LoveDADataset:
    return LoveDADataset(image_dir=cfg.data.image_dir, mask_dir=cfg.data.mask_dir,
                         training=False, synthetic_n=cfg.data.get("synthetic_n", 16))


def cmd_eval(cfg, args, device: torch.device):
    log = setup_logger("rssformer-eval")
    model, _ = _restore_for_eval(cfg, args, device)
    ds = _eval_dataset(cfg)
    batches = ((_nchw(img), torch.from_numpy(mask[None])) for _, img, mask in
               (ds[i] for i in range(len(ds))))
    tta_cfg = default_tta_config() if args.tta else None
    scores = evaluate(model, batches, cfg.model.classes, tta_cfg, device=device)
    log.info("eval: miou=%.4f pAcc=%.4f", scores["miou"], scores["pAcc"])
    return scores


def cmd_predict(cfg, args, device: torch.device):
    model, _ = _restore_for_eval(cfg, args, device)
    ds = _eval_dataset(cfg)
    os.makedirs(args.out_dir, exist_ok=True)
    fwd = make_rssformer_eval_step(model)
    for i in range(len(ds)):
        name, img, _ = ds[i]
        probs = fwd(_nchw(img).to(device))
        pred = probs.argmax(1)[0].cpu().numpy()
        save_palette_png(pred, os.path.join(args.out_dir, f"{name}.png"))
    return args.out_dir


def main(argv=None, device: torch.device | str | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("command", choices=["train", "eval", "predict"])
    ap.add_argument("--config", default=None)
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--out_dir", default="predictions")
    ap.add_argument("--tta", action="store_true")
    ap.add_argument("overrides", nargs="*")
    # overrides may follow the options: the parse_args of older Python 3.12
    # releases binds an empty `overrides` at the first option and refuses the rest
    args = ap.parse_intermixed_args(argv)

    cfg = default_config()
    if args.config:
        cfg.merge(load_yaml(args.config))
    cfg.apply_overrides(args.overrides)
    device = resolve_device(device)

    if args.command == "train":
        return cmd_train(cfg, device)
    if args.command == "eval":
        return cmd_eval(cfg, args, device)
    return cmd_predict(cfg, args, device)


if __name__ == "__main__":
    main()
