"""Benchmarks of the port on one CUDA card: the seven workloads of the root
``bench.py``, under its metric names, shapes and batch sizes.

Prints one JSON line per workload, ``{"metric", "value", "unit", ...}``, with the
headline (512 x 512 SegFormer-B1 tiles/s) printed last so that a last-line parser
records it. All seven run through the port:

- ``segformer_b1``: ``TSCD("mit_b1", bf16, fused_blocks, act_dtype=bf16)``, 8 x 512²,
  ``model(x)[1].mean()``; K1 (84 launches a forward);
- ``scd_pseudo_labels``: ``TSCD("mit_b1", bf16)``, 4 x 512², multi-scale flip CAMs at
  (1, 0.5, 1.5), ``cam_to_label``; no hand-written kernel, as the root bench builds it;
- ``rssformer_predict``: ``HRNetFusion("hrnetv2_w32", 7, bf16, fused_mlp=True)``,
  4 x 512²; K5 (8 + 8 launches), not K6 (the JAX model cannot reach it);
- ``rssformer_tta_eval``: the same model unfused, 2 x 512², six-scale TTA; no kernel;
- ``rml_train``: the RML train step with on-card augmentation of 16 raw 512² canvases
  to 320² crops, the trained ``RMLModel("mit_b1", bf16)`` and its fused CAM twin;
  K1 (504 launches a step), K2 in ``par`` mode (1), K3 (10);
- ``rssformer_train``: the RSSFormer train step, ``HRNetFusion("hrnetv2_w32", 7,
  bf16)``, 8 x 512², the CGFL losses, SGD with the poly rate and the clip at 35;
  no hand-written kernel (K5 is inference only and the JAX model cannot reach K6);
- ``wavecam_cams``: WaveCAM's ResNet-50 ``Net(n_classes=20, bf16)``, one ``cam``
  over the 16 images of 8 x 512² and their flips, ReLU, flip sums; no hand-written
  kernel (the JAX package has none for it).

Method. Each workload is built from seed 0 (the models' own initialisation,
numpy draws of ``default_rng(0)`` as in the root bench), called once (which builds
and loads the kernels) and twice more to warm up, then timed by CUDA events
around ``reps`` loops of ``iters`` calls, one synchronisation a loop; the value is
all the examples of the loops over all their time, so that a stalled loop shows.
A train step's state moves on from call to call. Beside the value each line
carries the median time a call of the loops, the device's launches, busy time
and idle share (against the loops' mean time a call) from a ``torch.profiler``
trace of two more calls, the
peak memory of the timed loops, the hand-written kernels' launches a call (the
wrappers' ``LAUNCHES`` counters), the card and its power limit, and FLOPs:
``torch.utils.flop_counter.FlopCounterMode`` over one call of the same work with no
hand-written kernel in it (the counter cannot see the ctypes kernels, and it
counts matrix products and convolutions, forward and backward, not elementwise
work). ``mfu`` is against the card's dense bf16 peak where the card is in
``PEAK_BF16``, else null. TF32 is off for products and convolutions while a
workload is measured, as in the paths ``chip_smoke.py`` holds to their plain
versions: f32 stays f32 (PyTorch's default would give cuDNN's f32 convolutions
TF32, a change of the math that ROADMAP Queue 2 item 6 measures first).

Usage, from the root of the repository: ``python -m
representationlearning_tpu_torch.bench`` runs every workload, each in a process of
its own under a time cap inside a total budget (``BENCH_TOTAL_BUDGET_S``), after
building every kernel library once; ``--one NAME`` runs one workload in this
process and prints its line. The parent exits non-zero when a ported workload
printed an error record. Importing this module needs no card and builds nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ._device import resolve_device
from .data.device_transforms import DeviceAugConfig
from .infer.tta import default_tta_config, tta
from .models.mit import FusedBlock
from .models.resnet import Net
from .models.rml import RMLModel
from .models.rssformer import HRNetFusion
from .models.tscd import TSCD, share_parameters
from .ops import _build, affinity, attention, isa_attention, mit_block, mlp_dwbn, varm
from .train import optim
from .train.rml import RMLConfig, make_rml_train_step
from .train.rssformer import (RSSFormerTrainConfig, create_rssformer_state,
                              make_rssformer_train_step)
from .train.state import TrainState
from .wsss import camutils as CU

MODULE = "representationlearning_tpu_torch.bench"
ROOT = Path(__file__).resolve().parent.parent
NUM_CLASSES = 21
# dense bf16 tensor-core FLOP/s by the card's name (nvidia-smi); a card not named
# here gets no MFU
PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989e12}
# timed calls a loop: inference, TTA, and the train step (the root bench's k_long)
ITERS = {"segformer_b1": 10, "scd_pseudo_labels": 10, "rssformer_predict": 10,
         "rssformer_tta_eval": 3, "rml_train": 4, "rssformer_train": 4, "wavecam_cams": 10}
REPS, WARMUP, TRACED = 3, 2, 2
# the events of a Chrome trace that occupy the device
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Workload:
    """One workload, built: ``run()`` gives its output before the bench's
    reduction, ``reduce`` the scalar the root bench's function returns;
    ``count()`` is the same work with no hand-written kernel in it, for the FLOP
    count, and ``count_measured()`` (the train step only) the timed call's own
    work with its kernels swapped for their plain versions: the counter cannot
    see a kernel launched through ctypes."""

    run: Callable[[], Any]
    reduce: Callable[[Any], torch.Tensor]
    batch: int
    count: Callable[[], Any]
    count_measured: Callable[[], Any] | None = None
    model: torch.nn.Module | None = None
    inputs: dict = field(default_factory=dict)   # the numpy draws, as drawn
    state: Any = None                            # a train step's TrainState

    def call(self) -> torch.Tensor:
        return self.reduce(self.run())


def voc_like_labels(rng: np.random.Generator, batch: int, num_fg: int) -> np.ndarray:
    """Multi-hot labels at VOC12 density: 1-3 present classes an image
    (p = 0.7 / 0.2 / 0.1), the draws of the root bench's ``_voc_like_labels``."""
    out = np.zeros((batch, num_fg), np.float32)
    for i in range(batch):
        k = rng.choice([1, 2, 3], p=[0.7, 0.2, 0.1])
        out[i, rng.choice(num_fg, size=k, replace=False)] = 1.0
    return out


def _images(rng: np.random.Generator, batch: int, side: int,
            device) -> tuple[np.ndarray, torch.Tensor]:
    """Standard normal images drawn as the root bench draws them (NHWC), and the
    same as an NCHW f32 tensor on the device."""
    x = rng.standard_normal((batch, side, side, 3)).astype(np.float32)
    return x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(device)


# ------------------------------------------------------------------ workloads
def build_segformer_b1(device=None, *, backbone: str = "mit_b1", side: int = 512,
                       batch: int = 8, dtype=torch.bfloat16) -> Workload:
    """The headline: TSCD / MiT seg inference on K1; FLOPs on the unfused model
    with the same weights."""
    dev = resolve_device(device)
    x_np, x = _images(np.random.default_rng(0), batch, side, dev)
    model = TSCD(backbone, NUM_CLASSES, dtype=dtype, fused_blocks=True, act_dtype=dtype,
                 generator=torch.Generator().manual_seed(0), device=dev).eval()
    plain = share_parameters(TSCD(backbone, NUM_CLASSES, dtype=dtype, device=dev), model).eval()

    @torch.no_grad()
    def run():
        return model(x)[1]

    @torch.no_grad()
    def count():
        return plain(x)[1].mean()

    return Workload(run, lambda seg: seg.mean().float(), batch, count, model=model,
                    inputs={"x": x_np})


def build_scd_pseudo_labels(device=None, *, backbone: str = "mit_b1", side: int = 512,
                            batch: int = 4, dtype=torch.bfloat16) -> Workload:
    """SCD pseudo labels: multi-scale flip CAMs (1, 0.5, 1.5) of the plain model,
    thresholded at a background score of 0.45."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x_np, x = _images(rng, batch, side, dev)
    cls_np = (rng.random((batch, NUM_CLASSES - 1)) > 0.7).astype(np.float32)
    cls = torch.from_numpy(cls_np).to(dev)
    model = TSCD(backbone, NUM_CLASSES, dtype=dtype, use_flash=False,
                 generator=torch.Generator().manual_seed(0), device=dev).eval()

    def cam_fn(img):
        return model(img, cam_only=True)

    @torch.no_grad()
    def run():
        cam = CU.multi_scale_cam(cam_fn, x, (1.0, 0.5, 1.5))
        return CU.cam_to_label(cam, cls, bkg_score=0.45)

    return Workload(run, lambda label: label.sum().float(), batch, run, model=model,
                    inputs={"x": x_np, "cls_label": cls_np})


def build_rssformer_predict(device=None, *, hrnet_type: str = "hrnetv2_w32", side: int = 512,
                            batch: int = 4, dtype=torch.bfloat16) -> Workload:
    """RSSFormer predict with each transformer block's FFN on K5; FLOPs on the
    unfused model with the same weights."""
    dev = resolve_device(device)
    x_np, x = _images(np.random.default_rng(0), batch, side, dev)
    model = HRNetFusion(hrnet_type, 7, dtype=dtype, fused_mlp=True,
                        generator=torch.Generator().manual_seed(0), device=dev).eval()
    plain = share_parameters(HRNetFusion(hrnet_type, 7, dtype=dtype, device=dev), model).eval()

    @torch.no_grad()
    def run():
        return model(x)

    @torch.no_grad()
    def count():
        return plain(x).mean()

    return Workload(run, lambda prob: prob.mean().float(), batch, count, model=model,
                    inputs={"x": x_np})


def build_rssformer_tta_eval(device=None, *, hrnet_type: str = "hrnetv2_w32", side: int = 512,
                             batch: int = 2, dtype=torch.bfloat16) -> Workload:
    """RSSFormer eval TTA: the averaged probabilities over the six scales
    0.5-1.75, then the argmax."""
    dev = resolve_device(device)
    x_np, x = _images(np.random.default_rng(0), batch, side, dev)
    model = HRNetFusion(hrnet_type, 7, dtype=dtype,
                        generator=torch.Generator().manual_seed(0), device=dev).eval()

    @torch.no_grad()
    def run():
        return tta(model, x, default_tta_config())

    return Workload(run, lambda pred: pred.argmax(1).sum().float(), batch, run, model=model,
                    inputs={"x": x_np})


@contextlib.contextmanager
def plain_kernels(*modules: torch.nn.Module):
    """K1 in every ``FusedBlock`` of ``modules`` (models or the blocks
    themselves), and K2 and K3 where ``models/refine.py`` looks them up, swapped
    for their plain versions; the kernels again on leaving."""
    blocks = [m for module in modules for m in module.modules() if isinstance(m, FusedBlock)]
    kernels = (affinity.affinity, varm.varm_propagate)
    for b in blocks:
        b.block_fn = mit_block.fused_block_reference
    affinity.affinity = affinity.affinity_reference
    varm.varm_propagate = varm.varm_propagate_reference
    try:
        yield
    finally:
        for b in blocks:
            vars(b).pop("block_fn", None)   # back to the class attribute
        affinity.affinity, varm.varm_propagate = kernels


def build_rml_train(device=None, *, backbone: str = "mit_b1", canvas: int = 512,
                    crop: int = 320, image_hw: tuple[int, int] = (375, 500), batch: int = 16,
                    dtype=torch.bfloat16, cam_scales: tuple = (0.5, 1.0, 1.5)) -> Workload:
    """The RML train step with the classification augmentation on the card: raw
    uint8 canvases in, one AdamW update a call. FLOPs of the reference-equivalent
    step (no CAM twin: the trained model makes the CAMs, attention exported) and
    measured ones of the timed step, both with K1, K2 and K3 swapped for their
    plain versions.
    ``cam_scales`` is RMLConfig's default; a crop below about 200 needs scales
    without 0.5, since MiT's first reduction window (8 x 8 tokens) must fit the
    0.3-scale input's half-scale CAM forward."""
    dev = resolve_device(device)
    model = RMLModel(backbone, NUM_CLASSES, dtype=dtype,
                     generator=torch.Generator().manual_seed(0), device=dev)
    twin = share_parameters(RMLModel(backbone, NUM_CLASSES, dtype=dtype, fused_blocks=True,
                                     collect_attns="none", device=dev), model).eval()
    cfg = RMLConfig(crop_size=crop, cam_iters=-1, max_present=8, cam_scales=cam_scales)
    aug = DeviceAugConfig(crop_size=crop, scale_range=(0.5, 2.0), num_classes=NUM_CLASSES)
    state = TrainState.create(model, optim.make_poly_warmup_adamw(
        model, 6e-5, 0.01, warmup_iter=10, max_iter=1000, param_labels=optim.tscd_param_labels))
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (batch, canvas, canvas, 3)).astype(np.uint8)
    cls_np = voc_like_labels(rng, batch, NUM_CLASSES - 1)
    data = {"raw": torch.from_numpy(raw.transpose(0, 3, 1, 2).copy()).to(dev),
            "hw": torch.tensor([image_hw] * batch, dtype=torch.int32, device=dev),
            "cls_label": torch.from_numpy(cls_np).to(dev)}
    step = make_rml_train_step(model, cfg, cam_model=twin, device=dev, aug_cfg=aug)
    reference_step = make_rml_train_step(model, cfg, device=dev, aug_cfg=aug)
    gen = torch.Generator().manual_seed(0)   # decisions and drop-path masks

    def run():
        return step(state, data, gen)[1]

    def count():
        with plain_kernels(model):
            return reference_step(state, data, gen)

    def count_measured():
        with plain_kernels(twin):
            return step(state, data, gen)

    return Workload(run, lambda metrics: metrics["total"], batch, count, count_measured,
                    model=model, inputs={"raw": raw, "cls_label": cls_np}, state=state)


def build_rssformer_train(device=None, *, hrnet_type: str = "hrnetv2_w32", side: int = 512,
                          batch: int = 8, dtype=torch.bfloat16) -> Workload:
    """The RSSFormer train step (`configs/base/loveda.py`): standard normal images,
    then masks in [-1, 7) with -1 ignored, as the root bench draws them; one SGD
    update a call. The FLOP count runs the same step: it has no hand-written
    kernel."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x_np, x = _images(rng, batch, side, dev)
    mask_np = rng.integers(-1, 7, (batch, side, side))
    model = HRNetFusion(hrnet_type, 7, dtype=dtype, generator=torch.Generator().manual_seed(0),
                        device=dev)
    cfg = RSSFormerTrainConfig()
    state = create_rssformer_state(model, cfg)
    step = make_rssformer_train_step(model, cfg, device=dev)
    data = {"image": x, "mask": torch.from_numpy(mask_np).to(dev)}

    def run():
        return step(state, data)[1]

    return Workload(run, lambda metrics: metrics["total"], batch, run, model=model,
                    inputs={"x": x_np, "mask": mask_np}, state=state)


def build_wavecam_cams(device=None, *, side: int = 512, batch: int = 8,
                       dtype=torch.bfloat16) -> Workload:
    """WaveCAM CAM generation, the per-scale unit of ``make_cam``: one ``cam`` of
    the ResNet-50 ``Net`` over [x; flip(x)] (one batch of 2 x ``batch``), ReLU, the
    first half plus the flipped second half."""
    dev = resolve_device(device)
    x_np, x = _images(np.random.default_rng(0), batch, side, dev)
    model = Net(n_classes=20, dtype=dtype, generator=torch.Generator().manual_seed(0),
                device=dev).eval()

    @torch.no_grad()
    def run():
        cc = model.cam(torch.cat([x, x.flip(-1)]))
        return torch.relu(cc[:batch]) + torch.relu(cc[batch:]).flip(-1)

    return Workload(run, lambda cam: cam.mean().float(), batch, run, model=model,
                    inputs={"x": x_np})


@dataclass(frozen=True)
class Bench:
    metric: str
    unit: str
    build: Callable[..., Workload] | None
    missing: str = ""   # why a workload without a build function has no line yet


BENCHES = {
    "wavecam_cams": Bench("wavecam_resnet50_cams_per_sec_per_chip", "CAMs/s",
                          build_wavecam_cams),
    "rssformer_predict": Bench(
        "rssformer_w32_512_predict_tiles_per_sec_per_chip", "tiles/s", build_rssformer_predict),
    "scd_pseudo_labels": Bench(
        "scd_pseudo_label_images_per_sec_per_chip", "images/s", build_scd_pseudo_labels),
    "rssformer_train": Bench(
        "rssformer_w32_512_train_images_per_sec_per_chip", "images/s", build_rssformer_train),
    "rml_train": Bench("rml_mitb1_320_train_images_per_sec_per_chip", "images/s",
                       build_rml_train),
    "rssformer_tta_eval": Bench(
        "rssformer_w32_512_tta_eval_tiles_per_sec_per_chip", "tiles/s", build_rssformer_tta_eval),
    "segformer_b1": Bench("segformer_b1_512_tiles_per_sec_per_chip", "tiles/s",
                          build_segformer_b1),
}
PORTED = tuple(name for name, b in BENCHES.items() if b.build is not None)
# the headline runs first, so that nothing before it can starve it, and prints last
BENCH_RUN_ORDER = [
    "segformer_b1", "rml_train", "rssformer_train", "rssformer_tta_eval",
    "wavecam_cams", "rssformer_predict", "scd_pseudo_labels",
]
BENCH_PRINT_ORDER = [
    "wavecam_cams", "rssformer_predict", "scd_pseudo_labels",
    "rssformer_train", "rml_train", "rssformer_tta_eval", "segformer_b1",
]
# Total wall budget and each workload's cap, in seconds; every workload still
# pending keeps a floor, so a slow one cannot starve the rest, and one left with
# less than MIN_CHILD_S is skipped with an error line.
BENCH_TOTAL_BUDGET_S = float(os.environ.get("BENCH_TOTAL_BUDGET_S", 1500))
BENCH_FLOOR_S, MIN_CHILD_S = 90.0, 45.0
# Caps: at least three times each child's wall time in the first full run on an
# H100 80GB HBM3 at 700 W (18.7 / 22.4 / 6.3 / 29.6 / 6.4 / 21.3 / 21.8 s in run
# order, the libraries built by the parent in 42.4 s; PERF.md section 4);
# rssformer_train's at the slower of its first two runs, 27.7 / 39.3 s; wavecam_cams's at
# its first, 20.5 s (PERF.md section 6).
PER_CONFIG_MAX_S = {
    "segformer_b1": 120, "rml_train": 120, "rssformer_train": 120, "rssformer_tta_eval": 150,
    "wavecam_cams": 90, "rssformer_predict": 120, "scd_pseudo_labels": 120,
}


# ------------------------------------------------------------------ measurement
# the hand-written kernels' wrappers by kernel group, each with its ``LAUNCHES``
# counter and ``reset_launches``
KERNEL_GROUPS = {"K1": mit_block, "K2": affinity, "K3": varm, "K4": attention, "K5": mlp_dwbn,
                 "K6": isa_attention}


def kernel_launches(calls: int = 1) -> dict:
    """Every wrapper's launches since the counters were reset, per call."""
    def per_call(n):
        v = n / calls
        return int(v) if v.is_integer() else v

    return {k: {name: per_call(n) for name, n in mod.LAUNCHES.items()}
            for k, mod in KERNEL_GROUPS.items()}


def reset_kernel_launches() -> None:
    for mod in KERNEL_GROUPS.values():
        mod.reset_launches()


def device_busy(events: list[dict]) -> tuple[float, int]:
    """(µs in which a kernel, copy or fill ran, their count) of a Chrome trace:
    the union of the device events' intervals."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in DEVICE_EVENTS)
    if not spans:
        return 0.0, 0
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return busy + hi - lo, len(spans)


def trace_calls(fn: Callable[[], Any], n: int) -> tuple[float, float]:
    """(device busy ms, device events) a call, from a ``torch.profiler`` trace of
    ``n`` calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    busy_us, count = device_busy(events)
    if count == 0:
        raise RuntimeError("the trace holds no device event")
    return busy_us / n / 1e3, count / n


def count_flops(fn: Callable[[], Any]) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def card_and_power_limit() -> tuple[str, float | None]:
    """The card's name and power limit in W as nvidia-smi gives them (the name
    from PyTorch and no limit where nvidia-smi does not answer)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        name, _, watts = r.stdout.strip().splitlines()[0].rpartition(",")
        return name.strip(), float(watts.split()[0])
    except (OSError, subprocess.TimeoutExpired, IndexError, ValueError):
        return torch.cuda.get_device_name(0), None


def make_record(name: str, *, batch: int, loop_ms: list[float], iters: int, busy_ms: float,
                launches: float, peak_bytes: int, kernels: dict, flops: float,
                measured_flops: float | None, card: str, power_limit_w: float | None) -> dict:
    """One workload's line from its measurements: ``loop_ms`` are the timed
    loops of ``iters`` calls each; FLOPs are a call's."""
    spec = BENCHES[name]
    calls = iters * len(loop_ms)
    mean_ms = sum(loop_ms) / calls
    value = batch * 1e3 / mean_ms
    per_example = flops / batch
    peak = PEAK_BF16.get(card)
    rec = {"metric": spec.metric, "value": value, "unit": spec.unit,
           "achieved_tflops": value * per_example / 1e12,
           "mfu": value * per_example / peak if peak else None,
           "flops_per_example_g": per_example / 1e9}
    if measured_flops is not None:
        rec["measured_flops_per_example_g"] = measured_flops / batch / 1e9
    rec.update(ms_per_call=statistics.median(loop_ms) / iters, launches_per_call=launches,
               device_busy_ms_per_call=busy_ms, idle_share=1.0 - busy_ms / mean_ms,
               peak_mem_gib=peak_bytes / 2**30, kernels=kernels, card=card,
               power_limit_w=power_limit_w, batch=batch, iters=iters, reps=len(loop_ms))
    return rec


def error_record(name: str, error: str) -> dict:
    return {"metric": BENCHES[name].metric, "value": 0.0, "unit": "error", "error": error[:300]}


@contextlib.contextmanager
def no_tf32():
    """Full f32 products and convolutions inside, the settings before it after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def measure(name: str, *, iters: int | None = None, reps: int = REPS) -> dict:
    """Build, warm up, time, trace and count one workload on the card, TF32 off;
    its line."""
    spec = BENCHES[name]
    if spec.build is None:
        raise NotImplementedError(spec.missing)
    dev = resolve_device(None)
    iters = iters or ITERS[name]
    with no_tf32():
        w = spec.build(dev)
        w.call()   # builds and loads the kernels
        for _ in range(WARMUP):
            w.call()
        torch.cuda.synchronize()
        reset_kernel_launches()
        torch.cuda.reset_peak_memory_stats()
        loop_ms = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                w.call()
            end.record()
            end.synchronize()
            loop_ms.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated()
        kernels = kernel_launches(iters * reps)
        busy_ms, launches = trace_calls(w.call, TRACED)
        flops = count_flops(w.count)
        measured = count_flops(w.count_measured) if w.count_measured else None
    card, watts = card_and_power_limit()
    return make_record(name, batch=w.batch, loop_ms=loop_ms, iters=iters, busy_ms=busy_ms,
                       launches=launches, peak_bytes=peak, kernels=kernels, flops=flops,
                       measured_flops=measured, card=card, power_limit_w=watts)


def run_one(name: str) -> int:
    """Child process: one workload's line (its error record if it fails)."""
    spec = BENCHES[name]
    if spec.build is None:
        print(json.dumps(error_record(name, spec.missing)), flush=True)
        return 1
    try:
        rec = measure(name)
    except Exception as e:  # noqa: BLE001 -- the line reports it
        traceback.print_exc()
        print(json.dumps(error_record(name, f"{type(e).__name__}: {e}")), flush=True)
        return 1
    print(json.dumps(rec), flush=True)
    return 0


# ------------------------------------------------------------------ the parent
def child_timeout(name: str, position: int, left: float) -> float:
    """The cap of the workload at ``position`` of the run order with ``left``
    seconds of the budget: its own cap, less what the later ones keep."""
    pending = len(BENCH_RUN_ORDER) - position - 1
    return min(PER_CONFIG_MAX_S[name], left - BENCH_FLOOR_S * pending)


def last_record(stdout: str) -> str | None:
    """The last line of a child's output that parses as a {"metric": ...} record."""
    for line in reversed(stdout.strip().splitlines()):
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "metric" in rec:
            return line
    return None


def _versions() -> str:
    try:
        nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[-1]
    except (OSError, RuntimeError, subprocess.TimeoutExpired, IndexError) as e:
        nvcc = f"unavailable ({e})"
    return f"python {sys.version.split()[0]}, torch {torch.__version__}, " \
           f"CUDA {torch.version.cuda}, nvcc: {nvcc}"


def _note(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def main() -> int:
    """Build every kernel library once, then run each workload in a process of
    its own (this one never creates a CUDA context), relay each line as it
    completes, and print all seven again with the headline last."""
    deadline = time.monotonic() + BENCH_TOTAL_BUDGET_S
    _note(_versions())
    t0 = time.monotonic()
    try:
        _build.build_all()
    except Exception as e:  # noqa: BLE001 -- no workload can run without the kernels
        traceback.print_exc()
        lines = {n: json.dumps(error_record(n, f"kernel build failed: {type(e).__name__}: {e}"))
                 for n in BENCH_PRINT_ORDER}
        for n in BENCH_PRINT_ORDER:
            print(lines[n], flush=True)
        return 1
    _note(f"kernels built in {time.monotonic() - t0:.1f} s")
    lines = {}
    for i, name in enumerate(BENCH_RUN_ORDER):
        timeout_s = child_timeout(name, i, deadline - time.monotonic())
        line = None
        t0 = time.monotonic()
        if timeout_s < MIN_CHILD_S:
            line = json.dumps(error_record(
                name, f"skipped: bench budget exhausted ({timeout_s:.0f} s left)"))
        else:
            try:
                proc = subprocess.run([sys.executable, "-m", MODULE, "--one", name],
                                      capture_output=True, text=True, timeout=timeout_s, cwd=ROOT)
                line = last_record(proc.stdout)
                err = (proc.stderr or "").strip().splitlines()
                if line is None:
                    line = json.dumps(error_record(
                        name, f"exit={proc.returncode} " + " | ".join(err[-3:])))
                if json.loads(line)["unit"] == "error":
                    for e in err[-20:]:
                        _note(f"{name}: {e}")
            except subprocess.TimeoutExpired:
                line = json.dumps(error_record(name, f"timeout after {timeout_s:.0f} s"))
        _note(f"{name}: {time.monotonic() - t0:.1f} s")
        lines[name] = line
        print(line, flush=True)   # streamed, so that a cut run keeps what finished
    for name in BENCH_PRINT_ORDER:
        print(lines[name], flush=True)
    failed = [n for n in PORTED if json.loads(lines[n])["unit"] == "error"]
    if failed:
        _note(f"ported workloads without a value: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--one", choices=sorted(BENCHES), help="run one workload in this process")
    args = ap.parse_args()
    sys.exit(run_one(args.one) if args.one else main())
