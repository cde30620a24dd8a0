"""The port of ``__graft_entry__.py::dryrun_multichip``: its four arms at the JAX
arms' sizes, on every rank of a gloo or NCCL group (or on one process, with no
group, as the single-rank reference).

1. the SCD data-parallel step: ``TSCD("mit_b0", 6)`` at 64², cam scales 1 and
   0.5, VARM at dilations 1, 2 for 2 iterations, 4 x 4 correlation samples,
   AdamW with the poly warm-up over 100 iterations; a global batch of 2 a rank;
2. the RML data-parallel step with the on-device augmentation: ``RMLModel``
   at the same size, raw 96² canvases (72 x 96 images) cropped to 64², PAR;
3. the RSSFormer data-parallel step: ``HRNetFusion("hrnetv2_w18", 7)`` at 64²,
   the CGFL loss, SGD at the poly rate with the clip at 35;
4. the model-axis sliding window: the SCD model's segmentation after its step,
   resized to the window, over an image of 32 rows a rank and 64 columns,
   window 64, stride 32, against the single-device path on the same padding.

Weights come from seed 0 (``torch.Generator``), batches from numpy's
``default_rng(0)`` in the JAX arms' order, each step's masks from a generator of
its own. ``run_arms`` returns each arm's global losses and, where asked, the
gradients (summed over the ranks, before the update), the parameters and buffers
after it, so a caller can hold n ranks against one.

    python -m representationlearning_tpu_torch.parallel.dryrun [--world 2] [--device cpu]

spawns ``--world`` gloo ranks (``parallel/launch.py``) and prints one line an arm;
the ranks run on the card (sharing it) unless ``--device`` names another.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data.device_transforms import DeviceAugConfig
from ..infer.sliding import pad_for_sliding, sharded_sliding_window_predict, \
    sliding_window_predict
from ..models.rml import RMLModel
from ..models.rssformer import HRNetFusion
from ..models.tscd import TSCD
from ..ops.image import resize_bilinear
from ..train.optim import make_poly_warmup_adamw, tscd_param_labels
from ..train.rml import RMLConfig, make_rml_train_step
from ..train.rssformer import (RSSFormerTrainConfig, create_rssformer_state,
                               make_rssformer_train_step)
from ..train.scd import SCDConfig, make_scd_train_step
from ..train.state import TrainState
from . import mesh as M

SIDE, CLASSES, PER_RANK = 64, 6, 2
SCD_CFG = SCDConfig(num_classes=CLASSES, crop_size=SIDE, cam_iters=-1, corr_samples=4,
                    varm_dilations=(1, 2), varm_iters=2, cam_scales=(1.0, 0.5))
RML_CFG = RMLConfig(num_classes=CLASSES, crop_size=SIDE, cam_iters=-1, cam_scales=(1.0, 0.5),
                    par_dilations=(1, 2), par_iters=2)
AUG_CFG = DeviceAugConfig(crop_size=SIDE, scale_range=(0.5, 2.0), num_classes=CLASSES)
RSS_CFG = RSSFormerTrainConfig(num_classes=7, max_iters=100)
WINDOW, STRIDE, ROWS_PER_RANK = 64, 32, 32
ARMS = ("scd", "rml", "rssformer", "sliding")


def arm_batches(world: int) -> dict:
    """The global batches of the arms for ``world`` ranks (2 a rank), NCHW CPU
    tensors, drawn in the JAX arms' order."""
    rng = np.random.default_rng(0)
    B = PER_RANK * world

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))

    scd = {"image": nchw(rng.standard_normal((B, SIDE, SIDE, 3)).astype(np.float32)),
           "cls_label": torch.from_numpy((rng.random((B, CLASSES - 1)) > 0.5).astype(np.float32)),
           "img_box": torch.tensor([[4, 60, 4, 60]] * B, dtype=torch.int32)}
    rml = {"raw": nchw(rng.integers(0, 256, (B, 96, 96, 3)).astype(np.uint8)),
           "hw": torch.tensor([[72, 96]] * B, dtype=torch.int32),
           "cls_label": torch.from_numpy((rng.random((B, CLASSES - 1)) > 0.5).astype(np.float32))}
    rss = {"image": nchw(rng.standard_normal((B, SIDE, SIDE, 3)).astype(np.float32)),
           "mask": torch.from_numpy(rng.integers(-1, 7, (B, SIDE, SIDE)))}
    big = torch.from_numpy(rng.standard_normal((3, world * ROWS_PER_RANK, SIDE)).astype(np.float32))
    return {"scd": scd, "rml": rml, "rssformer": rss, "big": big}


def _adamw(model):
    return make_poly_warmup_adamw(model, 6e-5, 0.01, warmup_iter=10, max_iter=100,
                                  param_labels=tscd_param_labels)


def _record(model, state, step, batch, seed: int, keep: bool) -> dict:
    """One step of ``step``; its global losses, and where ``keep`` the summed
    gradients before the update and the parameters and buffers after it (CPU)."""
    grads = {}
    apply = state.apply_gradients

    def capture():
        grads.update({n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        return apply()

    if keep:
        state.apply_gradients = capture
    try:
        _, metrics = step(state, batch, torch.Generator().manual_seed(seed))
    finally:
        state.apply_gradients = apply
    rec = {"metrics": {k: float(v) for k, v in metrics.items()}, "step": state.step}
    if keep:
        rec.update(grads=grads, state={k: v.detach().cpu().clone()
                                       for k, v in model.state_dict().items()})
    return rec


def scd_arm(batch, device, mesh=None, dtype=torch.float32, keep=False):
    model = TSCD("mit_b0", CLASSES, generator=torch.Generator().manual_seed(0),
                 device=device).to(dtype)
    state = TrainState.create(model, _adamw(model))
    step = make_scd_train_step(model, SCD_CFG, device=device, data_group=mesh)
    return model, _record(model, state, step, batch, 11, keep)


def rml_arm(batch, device, mesh=None, dtype=torch.float32, keep=False):
    model = RMLModel("mit_b0", CLASSES, generator=torch.Generator().manual_seed(0),
                     device=device).to(dtype)
    state = TrainState.create(model, _adamw(model))
    step = make_rml_train_step(model, RML_CFG, device=device, aug_cfg=AUG_CFG, data_group=mesh)
    return model, _record(model, state, step, batch, 12, keep)


def rssformer_arm(batch, device, mesh=None, dtype=torch.float32, keep=False):
    model = HRNetFusion("hrnetv2_w18", 7, loss_config={"ce": {}},
                        generator=torch.Generator().manual_seed(0), device=device).to(dtype)
    state = create_rssformer_state(model, RSS_CFG)
    step = make_rssformer_train_step(model, RSS_CFG, device=device, data_group=mesh)
    batch = {"image": batch["image"].to(dtype), "mask": batch["mask"]}
    return model, _record(model, state, step, batch, 13, keep)


def sliding_arm(model, image, device, mesh=None) -> dict:
    """The trained SCD model's segmentation, sharded over ``mesh``'s model axis,
    against the single-device path on the same padding."""
    model.eval()
    image = image.to(device)

    def seg_fn(tiles):
        seg = model(tiles.to(next(model.parameters()).dtype))[1]
        return resize_bilinear(seg, tiles.shape[-2:], align_corners=False)

    n = mesh.shape[M.MODEL_AXIS] if mesh is not None else 1
    out = sharded_sliding_window_predict(seg_fn, image, mesh, WINDOW, STRIDE, CLASSES)
    padded, (H, W) = pad_for_sliding(image, WINDOW, STRIDE, row_multiple=n)
    with torch.no_grad():
        single = sliding_window_predict(seg_fn, padded, WINDOW, STRIDE, CLASSES)[:, :H, :W]
    return {"shape": tuple(out.shape), "finite": bool(torch.isfinite(out).all()),
            "max_abs": float(single.abs().max()), "max_abs_err": float((out - single).abs().max()),
            "equal": torch.equal(out, single)}


def run_arms(rank: int, world: int, device=None, dtype=torch.float32, keep: bool = False,
             arms=ARMS, batch_world: int | None = None) -> dict:
    """The arms on this rank of a ``world``-rank default group (``world`` 1: one
    process, no group) at the global batches of ``batch_world`` ranks (None:
    ``world``; 1 rank with ``batch_world`` n is the single-rank reference of n
    ranks). The target of ``launch.spawn_ranks``; returns {arm: record}."""
    device = M.rank_device(device)
    dp = M.make_mesh(world, 1)
    batches = arm_batches(batch_world or world)
    out = {}
    if "scd" in arms or "sliding" in arms:
        scd_model, out["scd"] = scd_arm(M.shard_batch(dp, batches["scd"]), device, dp, dtype, keep)
    if "rml" in arms:
        out["rml"] = rml_arm(M.shard_batch(dp, batches["rml"]), device, dp, dtype, keep)[1]
    if "rssformer" in arms:
        out["rssformer"] = rssformer_arm(M.shard_batch(dp, batches["rssformer"]), device, dp,
                                         dtype, keep)[1]
    if "sliding" in arms:
        out["sliding"] = sliding_arm(scd_model, batches["big"], device, M.make_mesh(1, world))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the four multi-device arms on gloo ranks")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="every rank's device; the card (cuda:LOCAL_RANK) where not given")
    args = ap.parse_args(argv)
    from .launch import spawn_ranks

    results = spawn_ranks(run_arms, args.world, (args.device,), timeout=600.0)
    for arm, rec in results[0].items():
        print(f"dryrun {arm} on {args.world} ranks: {rec}")
    steps_ok = all(rec["step"] == 1 for arm, rec in results[0].items() if arm != "sliding")
    finite = all(np.isfinite(v) for arm, rec in results[0].items() if arm != "sliding"
                 for v in rec["metrics"].values())
    return 0 if steps_ok and finite and results[0]["sliding"]["finite"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
