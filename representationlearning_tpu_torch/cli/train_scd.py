"""SCD end-to-end WSSS trainer CLI, the port of
``representationlearning_tpu/cli/train_scd.py`` (the `scripts/dist_train_voc.py`
equivalent, `SCD-AAAI2023/scripts/dist_train_voc.py:435-464`: YAML config + CLI
overrides, seeding, logging, periodic validation + checkpointing).

Usage:
    python -m representationlearning_tpu_torch.cli.train_scd --config configs/scd_voc.yaml \\
        [key.sub=value ...]
    python -m torch.distributed.run --nproc-per-node N \\
        -m representationlearning_tpu_torch.cli.train_scd --config ...

The config, overrides, loop, logs, events and checkpoint layout are the JAX
package's. A rank runs on the card unless ``main(..., device=)`` names another
device (the tests pass "cpu"): in a single process ``cuda``, under torchrun
``cuda:LOCAL_RANK`` with NCCL. With several ranks (the default process group, or
one ``init_distributed`` joins from torchrun's environment) training is data
parallel as in the JAX CLI: the global batch is ``train.samples_per_gpu`` times
the world size, each rank loads its rows of it, the step is the single-rank step
on the global batch (``train/scd.py``), validation is split over the ranks and
its histograms summed, and rank 0 alone writes the log, events, checkpoints and
images. Every rank resumes from the same checkpoint. The trained TSCD is f32; its two fused twins on
the same parameters (the validation model, which exports the stage-4 attention,
and the CAM model of the train step) run kernel K1, whose CUDA kernels take bf16
operands with f32 accumulation only (as the TPU's default precision does for the
JAX package's f32 twins), so on the card the twins compute in bf16 and on the
CPU in f32. With ``dataset.device_augment=true`` the host ships raw uint8
canvases and the classification chain runs on the device inside the step; the
host chain needs Pillow.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import Config, load_yaml
from ..core.logging import AverageMeter, Timer, setup_logger
from ..data.device_transforms import DeviceAugConfig
from ..data.prefetch import ThreadedLoader
from ..data.voc import BatchLoader, VOC12ClsDataset, VOC12ClsRawDataset, VOC12SegDataset
from ..metrics.seg import SegMetricAccumulator
from ..models.tscd import TSCD, share_parameters
from ..parallel import mesh as M
from ..train import checkpoints as CK
from ..train.optim import make_poly_warmup_adamw, tscd_param_labels
from ..train.scd import SCDConfig, make_scd_eval_step, make_scd_train_step
from ..train.state import TrainState
from ..utils.events import MetricsWriter
from ..utils.visualize import cam_overlay, encode_cmap, make_grid


def default_config() -> Config:
    return Config({
        "backbone": {"config": "mit_b1", "stride": [4, 2, 2, 1]},
        # dataset.name selects the family: "voc" (default) or "coco" — the
        # reference ships separate near-mirror entry points
        # (`scripts/dist_train_voc.py` / `dist_train_coco.py:181-453`); here one
        # trainer is dataset-agnostic and the config picks the loaders
        "dataset": {"name": "voc",
                     "root_dir": None, "name_list_dir": None, "num_classes": 21,
                     "crop_size": 320, "rescale_range": [0.5, 2.0], "ignore_index": 255,
                     "synthetic_n": 32,
                     # device_augment: host ships raw uint8 canvases; the
                     # scale/flip/pad/crop/normalize chain runs on the device
                     # inside the train step (data/device_transforms.py)
                     "device_augment": False, "canvas_size": 512},
        "work_dir": {"dir": "work_dir_voc"},
        "train": {"split": "train_aug", "samples_per_gpu": 2, "max_iters": 20000,
                   "cam_iters": 2000, "eval_iters": 2000, "log_iters": 200},
        "cam": {"bkg_score": 0.45, "high_thre": 0.55, "low_thre": 0.35,
                 "scales": [1.0, 0.5, 1.5]},
        "optimizer": {"learning_rate": 6e-5, "betas": [0.9, 0.999], "weight_decay": 0.01},
        "scheduler": {"warmup_iter": 1500, "warmup_ratio": 1e-6, "power": 1.0},
        "seed": 1,
    })


def make_wsss_datasets(cfg, device_aug: bool):
    """(train_ds, val_ds) for a WSSS trainer config — `dataset.name` picks the
    family. VOC matches `scripts/dist_train_voc.py:211-248`; COCO matches
    `scripts/dist_train_coco.py:188-210` (split "train"/"val", 81 classes,
    no resize_range on the val path). Both families share the sample shapes, so
    the trainer body is dataset-agnostic."""
    name = str(cfg.dataset.get("name", "voc")).lower()
    common = dict(
        root_dir=cfg.dataset.root_dir, name_list_dir=cfg.dataset.name_list_dir,
        num_classes=cfg.dataset.num_classes, ignore_index=cfg.dataset.ignore_index,
        synthetic_n=cfg.dataset.get("synthetic_n", 32),
    )
    if name == "coco":
        from ..data.coco import CocoClsDataset, CocoClsRawDataset, CocoSegDataset

        cls_cls = CocoClsRawDataset if device_aug else CocoClsDataset
        seg_cls = CocoSegDataset
    elif name == "voc":
        cls_cls = VOC12ClsRawDataset if device_aug else VOC12ClsDataset
        seg_cls = VOC12SegDataset
    else:
        raise ValueError(f"unknown dataset.name {name!r} (voc|coco)")
    if device_aug:
        train_ds = cls_cls(split=cfg.train.split,
                           canvas_size=cfg.dataset.get("canvas_size", 512), **common)
    else:
        train_ds = cls_cls(split=cfg.train.split, crop_size=cfg.dataset.crop_size,
                           rescale_range=tuple(cfg.dataset.rescale_range),
                           seed=cfg.seed, **common)
    val_ds = seg_cls(split="val", aug=False, seed=cfg.seed, **common)
    return train_ds, val_ds


def check_max_present(cfg):
    """`dataset.max_present` caps how many present classes the refine chain
    carries per image (`wsss/camutils.py::refine_cams_with_bkg_v2`); classes
    beyond the cap are SILENTLY dropped from refinement. VOC images carry at
    most ~6 classes, but COCO images can carry 10+, so a copied VOC cap
    corrupts pseudo-labels with no signal — refuse it."""
    mp = cfg.dataset.get("max_present", None)
    if mp is not None and str(cfg.dataset.get("name", "voc")).lower() == "coco":
        raise ValueError(
            f"dataset.max_present={mp} with dataset.name=coco: COCO images can "
            "carry more present classes than a VOC-sized cap, and classes over "
            "the cap are silently dropped from refinement. Unset max_present "
            "for COCO (or set it >= the dataset's max classes/image).")
    return mp


def parse_config(argv=None, cfg: Config | None = None) -> Config:
    """``cfg`` (this CLI's ``default_config()`` unless given), the YAML of
    ``--config`` merged in, then the ``key.sub=value`` overrides. Overrides may
    follow the options: the parse_args of older Python 3.12 releases binds an
    empty ``overrides`` at the first option and refuses the rest."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_intermixed_args(argv)
    cfg = default_config() if cfg is None else cfg
    if args.config:
        cfg.merge(load_yaml(args.config))
    return cfg.apply_overrides(args.overrides)


def make_aug_cfg(cfg) -> DeviceAugConfig | None:
    """The on-device chain's config when ``dataset.device_augment`` is set."""
    if not cfg.dataset.get("device_augment", False):
        return None
    return DeviceAugConfig(crop_size=cfg.dataset.crop_size,
                           scale_range=tuple(cfg.dataset.get("rescale_range", [0.5, 2.0])),
                           num_classes=cfg.dataset.num_classes,
                           ignore_index=cfg.dataset.ignore_index)


def to_step_batch(batch, device_aug: bool) -> dict[str, torch.Tensor]:
    """A ``BatchLoader`` batch of numpy samples as the step's dict of NCHW tensors
    on the host (the step moves it to its device)."""
    if device_aug:
        _, raw, hw, cls_label = batch
        return {"raw": torch.from_numpy(raw).permute(0, 3, 1, 2).contiguous(),
                "hw": torch.from_numpy(hw.astype(np.int32)),
                "cls_label": torch.from_numpy(cls_label)}
    _, img, cls_label, box = batch
    return {"image": torch.from_numpy(img).permute(0, 3, 1, 2).contiguous(),
            "cls_label": torch.from_numpy(cls_label),
            "img_box": torch.from_numpy(box.astype(np.int32))}


def build_models(cfg, device: torch.device):
    """The trained TSCD from ``cfg.seed``, and its validation and CAM twins on
    the same parameters, in eval mode (``FusedBlock`` refuses training mode); the
    twins compute in f32 on every device, as the JAX command line builds them."""
    kw = dict(backbone=cfg.backbone.config, num_classes=cfg.dataset.num_classes,
              strides=tuple(cfg.backbone.stride), device=device)
    model = TSCD(generator=torch.Generator().manual_seed(cfg.seed), **kw)
    model_eval = share_parameters(TSCD(fused_blocks=True, **kw), model).eval()
    cam_twin = share_parameters(TSCD(fused_blocks=True, collect_attns="none", **kw),
                                model).eval()
    return model, model_eval, cam_twin


class NoWriter:
    """The events writer of a rank other than 0: every call does nothing."""

    def __getattr__(self, name):
        return lambda *a, **k: None


def rank_setup(work_dir: str, name: str, device):
    """This rank's device, the data-parallel mesh over the default group (joined
    from torchrun's environment where there is none yet; one rank in a single
    process), whether this rank writes, and its logger (rank 0's writes
    ``work_dir/train.log``)."""
    device = M.rank_device(device)
    M.init_distributed(device=device)
    mesh = M.make_mesh()
    main_rank = M.process_rank()[0] == 0
    if main_rank:
        os.makedirs(work_dir, exist_ok=True)
    log = setup_logger(name, os.path.join(work_dir, "train.log") if main_rank else None,
                       is_main=main_rank)
    return device, mesh, main_rank, log


def main(argv=None, device: torch.device | str | None = None):
    cfg = parse_config(argv)
    device, mesh, main_rank, log = rank_setup(cfg.work_dir.dir, "scd", device)
    log.info("config: %s", cfg.to_dict())
    np.random.seed(cfg.seed)
    world = mesh.shape[M.DATA_AXIS]
    global_batch = cfg.train.samples_per_gpu * world

    scd_cfg = SCDConfig(
        num_classes=cfg.dataset.num_classes, crop_size=cfg.dataset.crop_size,
        cam_scales=tuple(cfg.cam.scales), bkg_score=cfg.cam.bkg_score,
        high_thre=cfg.cam.high_thre, low_thre=cfg.cam.low_thre,
        ignore_index=cfg.dataset.ignore_index, cam_iters=cfg.train.cam_iters,
        max_present=check_max_present(cfg),
    )
    # evaluation runs the fused twin that exports the stage-4 attention; the
    # train step's CAM forwards run the twin that exports none; training keeps
    # the standard differentiable blocks
    model, model_eval, cam_twin = build_models(cfg, device)

    aug_cfg = make_aug_cfg(cfg)
    device_aug = aug_cfg is not None
    train_ds, val_ds = make_wsss_datasets(cfg, device_aug)

    tx = make_poly_warmup_adamw(
        model, cfg.optimizer.learning_rate, cfg.optimizer.weight_decay,
        cfg.scheduler.warmup_iter, cfg.train.max_iters,
        cfg.scheduler.warmup_ratio, cfg.scheduler.power,
        betas=tuple(cfg.optimizer.betas), param_labels=tscd_param_labels,
    )
    state = TrainState.create(model, tx)
    ckpt_dir = os.path.join(cfg.work_dir.dir, "checkpoints")
    if CK.latest_step(ckpt_dir) is not None:
        state = CK.restore(ckpt_dir, state)
        log.info("resumed from step %d", int(state.step))
    M.replicate(mesh, model)

    step_fn = make_scd_train_step(model, scd_cfg, cam_model=cam_twin, device=device,
                                  aug_cfg=aug_cfg, data_group=mesh)
    eval_fn = make_scd_eval_step(model_eval, scd_cfg, device=device)

    # scalar/image sink, the reference's TB writer (`dist_train_voc.py:250,393-413`)
    writer = MetricsWriter(os.path.join(cfg.work_dir.dir, "events")) if main_rank else NoWriter()
    meter = AverageMeter()
    timer = Timer(cfg.train.max_iters)
    # background batch preparation overlaps host augmentation with the device
    # step (`DataLoader(num_workers=10)` analog, `dist_train_voc.py:229`); the
    # loader starts at epoch 0 on a resume too, as in the JAX package
    loader = iter(ThreadedLoader(BatchLoader(train_ds, global_batch, seed=cfg.seed,
                                             shard=M.process_rank()), depth=4))
    start = int(state.step)
    for n_iter in range(start, cfg.train.max_iters):
        batch = to_step_batch(next(loader), device_aug)
        state, metrics = step_fn(state, batch,
                                 torch.Generator().manual_seed(cfg.seed * 131 + n_iter))
        meter.add(**{k: float(v) for k, v in metrics.items()})

        if (n_iter + 1) % cfg.train.log_iters == 0:
            means = meter.pop()
            log.info("iter %d/%d %s eta %.0fs", n_iter + 1, cfg.train.max_iters,
                     " ".join(f"{k}={v:.4f}" for k, v in means.items()),
                     timer.eta(n_iter + 1 - start))
            writer.add_scalars(means, n_iter + 1, prefix="train/")
            writer.flush()
        if (n_iter + 1) % cfg.train.eval_iters == 0 or n_iter + 1 == cfg.train.max_iters:
            if main_rank:
                CK.save(ckpt_dir, n_iter + 1, state)
            scores = validate(val_ds, eval_fn, scd_cfg, group=mesh.data_group, device=device)
            log.info("validate @%d: seg_miou=%.4f cam_miou=%.4f ref_miou=%.4f",
                     n_iter + 1, scores["seg"]["miou"], scores["cam"]["miou"],
                     scores["ref"]["miou"])
            writer.add_scalar("val/seg_miou", scores["seg"]["miou"], n_iter + 1)
            writer.add_scalar("val/cam_miou", scores["cam"]["miou"], n_iter + 1)
            writer.add_scalar("val/ref_miou", scores["ref"]["miou"], n_iter + 1)
            if main_rank:
                _write_val_images(writer, val_ds, eval_fn, n_iter + 1)
            writer.flush()
    writer.close()
    return state


def _eval_batch(img: np.ndarray, cls_label: np.ndarray) -> dict[str, torch.Tensor]:
    """One validation sample as the eval step's batch of one (NCHW)."""
    return {"image": torch.from_numpy(img).permute(2, 0, 1)[None].contiguous(),
            "cls_label": torch.from_numpy(cls_label)[None]}


def _write_val_images(writer, val_ds, eval_fn, step, n_images: int = 4):
    """CAM-overlay + prediction-colormap grids, the reference's tensorboard_image /
    tensorboard_label dumps (`dist_train_voc.py:393-413`)."""
    imgs, preds, cams = [], [], []
    for i in range(min(len(val_ds), n_images)):
        _, img, label, cls_label = val_ds[i]
        out = eval_fn(_eval_batch(img, cls_label))
        imgs.append(img)
        preds.append(out["seg_pred"][0].cpu().numpy())
        cams.append(out["cam_label"][0].cpu().numpy())
    if not imgs:
        return
    imgs = np.stack(imgs)
    overlay = cam_overlay(imgs, np.stack(cams)[..., None].astype(np.float32)
                          / max(1, int(np.max(cams))))
    writer.add_image("val/cam_overlay", make_grid(overlay), step)
    pred_rgb = np.stack([encode_cmap(p) for p in preds]).astype(np.float32) / 255.0
    writer.add_image("val/seg_pred", make_grid(pred_rgb), step)


def validate(val_ds, eval_fn, scd_cfg, max_samples: int = 64, group=None, device=None):
    """Three score streams like the reference validate (`dist_train_voc.py:122-147`):
    seg preds, CAM pseudo labels, and affinity-propagated ref labels. ``eval_fn``
    is ``make_scd_eval_step`` of the validation twin, which holds the weights.
    With ``group`` each of its ranks takes its rank-strided share of the samples
    and the histograms are summed over the ranks (exact), so every rank returns
    the scores of one rank over all of them; ``device`` holds the zeros of a rank
    with no sample."""
    seg_acc = SegMetricAccumulator(scd_cfg.num_classes)
    cam_acc = SegMetricAccumulator(scd_cfg.num_classes)
    ref_acc = SegMetricAccumulator(scd_cfg.num_classes)
    samples = np.arange(min(len(val_ds), max_samples))
    if group is not None:
        samples = samples[dist.get_rank(group)::dist.get_world_size(group)]
    for i in samples.tolist():
        _, img, label, cls_label = val_ds[i]
        out = eval_fn(_eval_batch(img, cls_label))
        label = torch.from_numpy(np.asarray(label, np.int64))[None]
        seg_acc.update(label, out["seg_pred"])
        cam_acc.update(label, out["cam_label"])
        ref_acc.update(label, out["ref_label"])
    return {k: acc.compute(group, device)
            for k, acc in (("seg", seg_acc), ("cam", cam_acc), ("ref", ref_acc))}


if __name__ == "__main__":
    main()
