"""RML trainer CLI, the port of ``representationlearning_tpu/cli/train_rml.py`` (the
`RML/scripts/dist_train_voc.py` equivalent: the reference's shipped script is
unrunnable due to broken imports, SURVEY.md §0; this implements the intended
behavior: SCD loop + CIML/MFML/APML mutual-learning losses with PAR).

Usage:
    python -m representationlearning_tpu_torch.cli.train_rml --config configs/rml_voc.yaml \\
        [key.sub=value ...]

The config, overrides, loop, log and checkpoint layout are the JAX package's
(``work_dir`` is a plain directory name here, as there). Ranks, devices and the
data-parallel loop as in ``cli/train_scd.py`` (``torch.distributed.run`` for
several; rank 0 writes); the fused CAM twin computes in bf16 on
the card and in f32 on the CPU, as in ``cli/train_scd.py``.
"""
from __future__ import annotations

import os

import torch

from ..core.config import Config
from ..core.logging import AverageMeter, Timer
from ..data.prefetch import ThreadedLoader
from ..data.voc import BatchLoader
from ..models.rml import RMLModel
from ..models.tscd import share_parameters
from ..parallel import mesh as M
from ..train import checkpoints as CK
from ..train.optim import make_poly_warmup_adamw, tscd_param_labels
from ..train.rml import RMLConfig, make_rml_train_step
from ..train.state import TrainState
from .train_scd import (check_max_present, make_aug_cfg, make_wsss_datasets, parse_config,
                        rank_setup, to_step_batch)


def default_config() -> Config:
    return Config({
        "backbone": {"config": "mit_b1", "stride": [4, 2, 2, 1]},
        # dataset.name: "voc" (default) or "coco" — one trainer, config-selected
        # loaders (the reference would ship a dist_train_coco.py mirror)
        "dataset": {"name": "voc",
                     "root_dir": None, "name_list_dir": None, "num_classes": 21,
                     "crop_size": 320, "ignore_index": 255, "synthetic_n": 32,
                     # device_augment: the on-device augmentation chain
                     # (data/device_transforms.py), as in the SCD CLI
                     "device_augment": False, "canvas_size": 512,
                     "rescale_range": [0.5, 2.0]},
        "train": {"split": "train_aug",
                   "samples_per_gpu": 2, "max_iters": 18000, "cam_iters": 2000,
                   "log_iters": 200, "eval_iters": 2000},
        "cam": {"bkg_score": 0.45, "high_thre": 0.55, "low_thre": 0.35,
                 "scales": [0.5, 1.0, 1.5]},
        "optimizer": {"learning_rate": 6e-5, "weight_decay": 0.01},
        "scheduler": {"warmup_iter": 1500, "warmup_ratio": 1e-6, "power": 1.0},
        "work_dir": "work_rml",
        "seed": 1,
    })


def build_models(cfg, device: torch.device):
    """The trained ``RMLModel`` from ``cfg.seed`` and its fused CAM twin on the
    same parameters, in eval mode (``FusedBlock`` refuses training mode), computing
    in f32 on every device as the JAX command line builds it."""
    kw = dict(backbone=cfg.backbone.config, num_classes=cfg.dataset.num_classes,
              strides=tuple(cfg.backbone.stride), device=device)
    model = RMLModel(generator=torch.Generator().manual_seed(cfg.seed), **kw)
    cam_twin = share_parameters(RMLModel(fused_blocks=True, collect_attns="none", **kw),
                                model).eval()
    return model, cam_twin


def main(argv=None, device: torch.device | str | None = None):
    cfg = parse_config(argv, default_config())
    device, mesh, main_rank, log = rank_setup(cfg.work_dir, "rml", device)

    rml_cfg = RMLConfig(
        num_classes=cfg.dataset.num_classes, crop_size=cfg.dataset.crop_size,
        cam_scales=tuple(cfg.cam.scales), bkg_score=cfg.cam.bkg_score,
        high_thre=cfg.cam.high_thre, low_thre=cfg.cam.low_thre,
        ignore_index=cfg.dataset.ignore_index, cam_iters=cfg.train.cam_iters,
        max_present=check_max_present(cfg),
    )
    model, cam_twin = build_models(cfg, device)

    global_batch = cfg.train.samples_per_gpu * mesh.shape[M.DATA_AXIS]
    aug_cfg = make_aug_cfg(cfg)
    device_aug = aug_cfg is not None
    # shared dataset selection (`dataset.name` voc|coco) with the SCD CLI
    ds, _ = make_wsss_datasets(cfg, device_aug)

    tx = make_poly_warmup_adamw(
        model, cfg.optimizer.learning_rate, cfg.optimizer.weight_decay,
        cfg.scheduler.warmup_iter, cfg.train.max_iters,
        cfg.scheduler.warmup_ratio, cfg.scheduler.power,
        param_labels=tscd_param_labels,
    )
    state = TrainState.create(model, tx)
    ckpt_dir = os.path.join(cfg.work_dir, "checkpoints")
    if CK.latest_step(ckpt_dir) is not None:
        state = CK.restore(ckpt_dir, state)
        log.info("resumed from step %d", int(state.step))
    M.replicate(mesh, model)

    step_fn = make_rml_train_step(model, rml_cfg, cam_model=cam_twin, device=device,
                                  aug_cfg=aug_cfg, data_group=mesh)
    loader = iter(ThreadedLoader(BatchLoader(ds, global_batch, seed=cfg.seed,
                                             shard=M.process_rank()), depth=4))
    meter = AverageMeter()
    timer = Timer(cfg.train.max_iters)
    start = int(state.step)
    for n_iter in range(start, cfg.train.max_iters):
        batch = to_step_batch(next(loader), device_aug)
        state, metrics = step_fn(state, batch,
                                 torch.Generator().manual_seed(cfg.seed * 977 + n_iter))
        meter.add(**{k: float(v) for k, v in metrics.items()})
        if (n_iter + 1) % cfg.train.log_iters == 0:
            log.info("iter %d/%d %s eta %.0fs", n_iter + 1, cfg.train.max_iters,
                     " ".join(f"{k}={v:.4f}" for k, v in meter.pop().items()),
                     timer.eta(n_iter + 1 - start))
        if main_rank and ((n_iter + 1) % cfg.train.eval_iters == 0
                          or n_iter + 1 == cfg.train.max_iters):
            CK.save(ckpt_dir, n_iter + 1, state)
    return state


if __name__ == "__main__":
    main()
