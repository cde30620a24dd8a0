"""WaveCAM pipeline CLI, the port of ``representationlearning_tpu/cli/run_wavecam.py``
(the `run_wavecam_voc.py` equivalent: boolean pass gates,
`WaveCAM-TMM2023/run_wavecam_voc.py:82-92`).

Usage:
    python -m representationlearning_tpu_torch.cli.run_wavecam --work_dir work_wavecam \\
        --train_cam_pass --make_cam_pass --eval_cam_pass [...]

The flags and defaults are the JAX package's (``--irn_num_epoches`` keeps its
spelling). The gated stages run in the pipeline's order, whatever the order of
the flags, on the card (``main(..., device=)`` names another device, as the
tests do with "cpu"); ``main`` returns the stages' results.
"""
from __future__ import annotations

import argparse

import torch

from ..wsss.wavecam_pipeline import WaveCAMConfig, WaveCAMPipeline

STAGES = [
    "train_cam", "train_wavecam", "make_cam", "make_wavecam", "eval_cam",
    "cam_to_ir_label", "train_irn", "make_sem_seg", "eval_sem_seg",
]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--work_dir", default="work_wavecam")
    ap.add_argument("--voc12_root", default=None)
    ap.add_argument("--coco_root", default=None)  # run_wavecam_coco's source
    ap.add_argument("--name_list_dir", default=None)
    ap.add_argument("--n_classes", type=int, default=20)
    ap.add_argument("--crop_size", type=int, default=512)
    ap.add_argument("--cam_batch_size", type=int, default=16)
    ap.add_argument("--cam_epochs", type=int, default=5)
    ap.add_argument("--cam_learning_rate", type=float, default=0.1)
    ap.add_argument("--cam_scales", type=float, nargs="+", default=[1.0, 0.5, 1.5, 2.0])
    ap.add_argument("--cam_eval_thres", type=float, default=0.21)
    ap.add_argument("--conf_fg_thres", type=float, default=0.35)
    ap.add_argument("--conf_bg_thres", type=float, default=0.1)
    ap.add_argument("--irn_crop_size", type=int, default=512)
    ap.add_argument("--irn_batch_size", type=int, default=32)
    ap.add_argument("--irn_num_epoches", type=int, default=3)
    ap.add_argument("--irn_learning_rate", type=float, default=0.1)
    ap.add_argument("--beta", type=float, default=10)
    ap.add_argument("--exp_times", type=int, default=8)
    ap.add_argument("--sem_seg_bg_thres", type=float, default=0.28)
    for s in STAGES:
        ap.add_argument(f"--{s}_pass", action="store_true")
    return ap


def main(argv=None, device: torch.device | str | None = None):
    args = build_parser().parse_intermixed_args(argv)
    cfg = WaveCAMConfig(
        work_dir=args.work_dir, voc12_root=args.voc12_root, coco_root=args.coco_root,
        n_classes=args.n_classes,
        name_list_dir=args.name_list_dir, crop_size=args.crop_size,
        cam_scales=tuple(args.cam_scales), cam_batch_size=args.cam_batch_size,
        cam_epochs=args.cam_epochs, cam_lr=args.cam_learning_rate,
        cam_eval_thres=args.cam_eval_thres, conf_fg_thres=args.conf_fg_thres,
        conf_bg_thres=args.conf_bg_thres, irn_crop_size=args.irn_crop_size,
        irn_batch_size=args.irn_batch_size, irn_epochs=args.irn_num_epoches,
        irn_lr=args.irn_learning_rate, beta=args.beta, exp_times=args.exp_times,
        sem_seg_bg_thres=args.sem_seg_bg_thres,
    )
    passes = [s for s in STAGES if getattr(args, f"{s}_pass")]
    return WaveCAMPipeline(cfg, device=device).run(passes)


if __name__ == "__main__":
    main()
