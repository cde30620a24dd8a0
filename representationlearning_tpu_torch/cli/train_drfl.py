"""DRFL train/test CLI, the port of ``representationlearning_tpu/cli/train_drfl.py``
(equivalents of `DRFL-EAAI2023/train.py` and `test.py` / `test_select.py`; the
YAML->config merge idiom of `util/util.py` cfg_from_file).

Usage:
    python -m representationlearning_tpu_torch.cli.train_drfl train --config configs/drfl.yaml
    python -m representationlearning_tpu_torch.cli.train_drfl test --config ... [--sweep]

The commands, config and overrides are the JAX package's. It runs on the card
(``main(..., device=)`` names another device, as the tests do with "cpu"); the
model is built for ``crop_size`` inputs from seed 0, and a dataset whose samples
have another side (a synthetic source smaller than the crop) is refused with a
``ValueError`` before anything runs.
"""
from __future__ import annotations

import argparse

import torch

from .._device import resolve_device
from ..core.config import Config, load_yaml
from ..core.logging import setup_logger
from ..data.medical import DRFLPairedDataset, collate_drfl
from ..infer.drfl_eval import evaluate_drfl, threshold_sweep
from ..models.dcl import Softnet
from ..train.drfl import DRFLConfig, create_drfl_state, load_checkpoint, train_drfl


def default_config() -> Config:
    return Config({
        "data_path": None, "input_nc": 3, "crop_size": 256, "batch_size": 1,
        "lr": 2e-4, "beta1": 0.5, "maintain_epoch": 30, "decay_epoch": 30,
        "output": "./checkpoints_drfl", "threshold": 150, "num_vit_layers": 12,
        "no_flip": True, "synthetic_n": 8, "synthetic_size": 64, "epochs": 60,
    })


def _batches_fn(ds, batch_size):
    def gen():
        for i in range(0, len(ds) - batch_size + 1, batch_size):
            yield collate_drfl([ds[j] for j in range(i, i + batch_size)])

    return gen


def main(argv=None, device: torch.device | str | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("command", choices=["train", "test"])
    ap.add_argument("--config", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--epoch", default="best")
    ap.add_argument("overrides", nargs="*")
    # overrides may follow the options: the parse_args of older Python 3.12
    # releases binds an empty `overrides` at the first option and refuses the rest
    args = ap.parse_intermixed_args(argv)

    cfg = default_config()
    if args.config:
        cfg.merge(load_yaml(args.config))
    cfg.apply_overrides(args.overrides)
    device = resolve_device(device)

    ds = DRFLPairedDataset(root=cfg.data_path, crop_size=cfg.crop_size,
                           no_flip=cfg.no_flip, synthetic_n=cfg.synthetic_n,
                           synthetic_size=cfg.synthetic_size)
    side = ds[0]["A"].shape[0]
    if side != cfg.crop_size:
        raise ValueError(
            f"the dataset's samples are {side} x {side} but crop_size is {cfg.crop_size}: "
            "Softnet's position embeddings fix the side it was built for (a source "
            "smaller than the crop is cropped to its own size); set crop_size or "
            "synthetic_size so that they agree")
    log = setup_logger("drfl")
    model = Softnet(input_nc=cfg.input_nc, num_vit_layers=cfg.num_vit_layers,
                    side=cfg.crop_size, generator=torch.Generator().manual_seed(0),
                    device=device)
    batches = _batches_fn(ds, cfg.batch_size)
    dcfg = DRFLConfig(lr=cfg.lr, beta1=cfg.beta1, maintain_epoch=cfg.maintain_epoch,
                      decay_epoch=cfg.decay_epoch, threshold=cfg.threshold)

    if args.command == "train":
        state, history = train_drfl(model, batches, batches, dcfg, epochs=cfg.epochs,
                                    work_dir=cfg.output, log=log, device=device)
        return history

    state = create_drfl_state(model, dcfg, 1)
    load_checkpoint(cfg.output, args.epoch, state)
    if args.sweep:
        res = threshold_sweep(model, batches())
        log.info("best threshold %d: %s", res["best_threshold"], res["best"])
        return res
    scores = evaluate_drfl(model, batches(), cfg.threshold)
    log.info("test: %s", scores)
    return scores


if __name__ == "__main__":
    main()
