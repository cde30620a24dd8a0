#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's fourteen paths and checks them. The first is TSCD / MiT-B1
segmentation inference at 512 x 512, batch 8, bf16 compute and a bf16 residual
stream, with every encoder block on kernel K1
(``representationlearning_tpu_torch/ops/mit_block.py``). The second is the SCD
pseudo-label call (``train/scd.py::scd_pseudo_labels``) at the configuration of
``configs/scd_voc.yaml``: batch 8 x 320 x 320, multi-scale flip CAMs through K1,
pseudo labels, background-aware VARM refinement through K2 (``ops/affinity.py``)
and K3 (``ops/varm.py``), affinity labels; and the trainer's validation step.
The third is the SCD train step (``train/scd.py::make_scd_train_step``) at the same
configuration: the trained ``TSCD("mit_b1", use_flash=True)`` in f32 with K4
(``ops/attention.py``, forward and backward) under the six attentions of stages
1-3, the bf16 fused CAM twin on the same parameters (K1), the refinement (K2,
K3), six losses, backward and one AdamW update a step. The fourth is the
RSSFormer predict (``models/rssformer.py::HRNetFusion``): ``hrnetv2_w32``, 7
classes, bf16 convolutions, 4 x 3 x 512 x 512, with the FFN of each of its eight
transformer blocks on K5 (``ops/mlp_dwbn.py``) and their window attention on K6
(``ops/isa_attention.py``). The fifth is the RML train step
(``train/rml.py::make_rml_train_step``) at the configuration of
``bench.py::bench_rml_train``: the trained ``RMLModel("mit_b1", dtype=bf16)``, its
bf16 fused CAM twin on the same parameters (K1 in six forwards of 32 a step),
16 raw 512 x 512 canvases augmented on the card to 320 x 320 crops, PAR
refinement (K2 in ``par`` mode, K3), the four RML losses, backward and one AdamW
update a step. The sixth is the RSSFormer train step
(``train/rssformer.py::make_rssformer_train_step``) at the configuration of
``bench.py::bench_rssformer_train``: ``HRNetFusion("hrnetv2_w32", 7, dtype=bf16)``,
8 x 3 x 512 x 512, the CGFL losses, backward, one SGD update a step; once more
with its window attention on K6 (``fused_attn``), and ``evaluate`` on K5. The seventh
is WaveCAM's pseudo-label inference (``wsss/wavecam_infer.py``), which has no
hand-written kernel: the ResNet-50 ``Net(n_classes=20, bf16)`` CAM pair of
``bench.py::bench_wavecam_cams``, then ``make_cam``, ``cam_to_ir_label`` and
``make_sem_seg_labels`` on one VOC-sized image. The eighth is DRFL's training,
evaluation and command line (``train/drfl.py``, ``infer/drfl_eval.py``,
``cli/train_drfl.py``; ``configs/drfl.yaml``), which has no hand-written kernel
either: ``Softnet(3, 12)`` at 256² on the synthetic source. The ninth is the SCD and
RML command lines (``cli/train_scd.py``, ``cli/train_rml.py``) run from
``configs/scd_voc.yaml``, ``scd_coco.yaml`` and ``rml_voc.yaml`` as a user runs them,
with the on-card augmentation and cut iteration counts: K1 in the fused twins, K2
and K3 in the refinement, K1's exporting form in the SCD validation. The tenth is
the RSSFormer command line (``cli/rssformer.py``) from ``configs/rssformer_loveda.yaml``:
``train`` at ``hrnetv2_w32``, 8 x 512² crops made by the LoveDA chain on the card (no
kernel), then ``eval --tta`` and ``predict`` with K5 under ``model.fused_mlp=True``.
The eleventh is WaveCAM's training half and command line (``cli/run_wavecam.py``,
``wsss/wavecam_pipeline.py``, ``models/wavecam.py``), which has no hand-written
kernel: the nine stages at ``WaveCAMConfig``'s defaults, the f32 ResNet-50 at
16 x 512² crops. The twelfth is the HRFormer backbone (``models/hrt.py``) through the
RSSFormer command line at ``model.hrnet_type=hrt_small``, with ``WeTrBaseline`` on K1, the
ASFF variants (``models/asff.py``) and ``cli/convert_checkpoint.py``. The thirteenth is the
RSSFormer baseline zoo (``models/baselines.py``, ``models/smp_zoo.py``), which has no
hand-written kernel: each of its fourteen models trained and evaluated through
``train/rssformer.py``. The fourteenth is several ranks (``parallel/``): the SCD, RML and
RSSFormer command lines data parallel over two gloo ranks that share the one card (NCCL
refuses two ranks on one GPU), each against one rank on the global batch, K1, K2 and K3 in
each rank's SCD and RML steps, and the row-sharded sliding window on K5 and K6. The headline
forward also runs with ``pre_sr=True``, the PRE_SR variant of K1 (K1').

1. environment: torch, CUDA, nvcc, the card and its power limit;
2. build: compiles the CUDA sources under ``representationlearning_tpu_torch/csrc``,
   the four libraries side by side;
3. kernel vs plain: each K1 kernel, and the whole block, against its plain
   PyTorch version on the same inputs, at the four MiT-B1 stage geometries of
   the 512 x 512 forward, with each kernel's bound and, where one PyTorch call
   computes the same function, that call's time (all five kernels and their
   library calls by replaying a CUDA graph, so that the host's time to launch does
   not count; `attention` split into the launches that export and those that do
   not; `linear` a line a stage for its five launches, `dwconv_gelu` one a stage
   with its library call in f32 and bf16);
   `attention` around the largest key count of its one-pass form, `sr_conv` at
   every number of K slices, `linear` at the edges of its tiles and with every
   tile its plan can choose, `dwconv_gelu` on grids of 1 to 15 rows and columns
   at hid 4 to 2048, each twice for equal bits, and what the wrappers
   refuse; `dwconv_gelu` at every plan at every geometry; the same comparison, untimed,
   at the twenty-four geometries of the CAM forwards (batch 16 at 320, 160
   and 480 pixels a side in the pseudo-label call and the train step, and at
   96, 48 and 144 in the train step's 0.3-scale set); then K2 in its three modes and K3 at 18
   and 42 channels at the refinement's own size;
4. slice: the model's forward through the kernels, its output shapes, the
   launch counts of every kernel, and seg / attn_pred against the same model run
   with the plain block; one ``cam_only`` forward;
5. pseudo labels: ``scd_pseudo_labels`` through the kernels, its launch counts,
   and its CAMs and labels against the same call with K1, K2 and K3 swapped for
   their plain versions; the validation step at batch 1 and 8 x 512 x 512;
6. K4 vs plain: flash attention forward and backward (dq, dk, dv against autograd
   through the plain version, random cotangent; two backward runs give equal
   bits) at the train step's six geometries, the three of the 512 x 512
   forward, Nk = 1 and one bf16 case; every backward plan of ``bwd_plans`` at the
   step's first geometry (twice each, equal bits); at the train geometries two more forward
   runs give o and the row logsumexp with equal bits, the logsumexp within 1e-5
   of ``torch.logsumexp``, and forward and backward, the plain version and the
   library call are timed by CUDA-graph replay (the 512 x 512 geometries'
   forward too, apart from the step's sums), beside the bounds (both directions as
   3xTF32 products, and as f32 multiply-adds) and the backward's plan and workspace
   a launch; ``TSCD(use_flash=True)`` in eval against
   ``use_flash=False`` on the same weights;
7. train step: a few steps through ``make_scd_train_step``; launch counts of
   every kernel per step; the first step's losses and gradient norms per
   parameter group against the same step on the plain path from the same seed
   and masks; frozen and updated parameters; step count and learning rate; the
   warm-up switch; a checkpoint saved and restored gives the same next step;
7a. RML train step: three steps through ``make_rml_train_step`` on one raw batch;
   launch counts of every kernel per step (K1 504, K2 1, K3 10, K4 / K5 / K6 0); the
   first step's losses, refined labels and gradient norms per parameter group
   against the same step with plain K1, K2 and K3 from the same seed; frozen and
   updated parameters; step count and learning rate; the warm-up switch; one move
   of the neck's running statistics a step;
7b. K5 / K6 / K1' vs plain: K5 and its two pieces at the predict path's shape
   (4, 16384, 32), hid 128, and at two small odd planes (one below the dilations,
   one non-square); `mlp_fc1` at the TTA's batch of 2 and at its edges (M of 1 to
   8517 rows, cin 16 to 256), every plan and a rerun for equal bits, the blocks an
   SM holds against its plan's estimate, and what it refuses; `mlp_taps` the same
   way at the TTA's planes (batch 2, 64 to 224 a side), at 3 x 13 x 29 (no tile
   divides it) and one token, every tile and a few block counts; K6 at (1444, 49, 32),
   2 heads, at one window and at 1443
   (fewer windows than, and a count not divided by, a step of four), at
   another window size, at windows whose gate matrix is all negative (head widths
   16 and 9), each launched twice for equal bits; the K1 block with ``h`` and ``xs`` handed in at the three sr > 1
   stage geometries; then the RSSFormer predict forward (exactly 8 launches of
   each K5 kernel and of K6, probabilities against the same model with both
   flags off) and the headline forward with ``pre_sr=True`` against
   ``pre_sr=False``, with its launch counts;
7c. RSSFormer train step: three steps through ``make_rssformer_train_step`` on the
   bench's batch; no hand-written kernel launched; the losses finite, the gradient
   norm before the clip printed; every BatchNorm's running statistics (f32) moved
   once a step; ``headaux``, which no loss reaches, moved by weight decay and
   momentum alone; step count and poly rate; the first step again with
   ``fused_attn=True`` from the same weights (K6 8 launches, forward only: the
   backward is the plain version's) against the unfused step, losses and the
   gradient norm of each parameter group within 2e-2 (+ 2e-3); then ``evaluate``
   on two batches of 4 with ``fused_mlp=True`` (K5 8 + 8 a forward, the trained
   weights calmed) against ``fused_mlp=False``: probabilities within 3e-2, classes
   equal on at least 99% of the pixels whose two best probabilities differ by more
   than that (trained on random masks, many pixels are near-ties);
7d. WaveCAM: the bench's cam pair (8 x 512² and their flips, batch 16) in bf16, its
   time, CAMs/s and peak memory, against the same call in f32 within 2e-2 of the
   largest magnitude (weights calmed); the three stages on one 375 x 500 image with
   1-3 present classes at ``WaveCAMConfig``'s defaults (scales 1, 0.5, 1.5, 2; the CRF
   grid at 0.35 / 0.1; IRN, radius 5, beta 10, eight squarings; background 0.28),
   each stage's time and peak memory, the transition matrix's size and the walk's
   rate; every column of the transition matrix sums to 1 within 1e-3, the labels lie
   in the keys, everything is on the card, no hand-written kernel is launched; the
   CRF label pass with the host lattice (``method="native"``) against the grid on at
   least 99% of the pixels; the whole chain at 64 x 96 on the card against the CPU
   in f32 (labels equal on at least 99.5%, the pseudo labels off near-ties);
7e. DRFL: ``Softnet(3, 12)`` at 256² (250.7 M parameters, f32) on the synthetic source
   at 256²; three steps of ``make_drfl_train_step`` at batch 1 (the yaml's) and three at
   8, each set's losses finite, every BatchNorm's running statistics moved, no
   parameter moved by more than the rate at the first step; then five steps timed (the
   median by CUDA events), a two-step trace (launches, idle share), peak memory and
   GFLOP an image (``FlopCounterMode``); the eval forward at batch 8 timed, then
   ``evaluate_drfl`` and ``threshold_sweep``; at 64² with one ViT layer the card
   against the CPU on the same weights and host-drawn dropout masks, the eval outputs,
   one step's losses and each module's gradient norm: in f64 equal within 1e-8, in f32
   within 1e-4 (outputs) and 1e-3, or ten times the CPU's own f32 error against its f64
   run where that is larger; ``cli/train_drfl.py``'s train and test --sweep on the card
   into a temporary directory; no hand-written kernel launched in the phase;
7f. WSSS command lines: ``cli.train_scd.main`` on ``configs/scd_voc.yaml`` (MiT-B1,
   320² crops, batch 2, 16 synthetic 96 x 128 images on 512² canvases augmented on the
   card): six steps, each step's losses finite (total = cls within the warm-up, above
   it after), K1 (its five kernels), K2 and K3 launched on every step with the same
   counts and no other kernel, two validations with three mIoUs in [0, 1] through
   the exporting twin, ``scalars.csv``'s train/ and val/ tags and the four PNGs,
   then a rerun that resumes from step 6 and ends at 7; ``configs/scd_coco.yaml``
   for two steps (81 classes: K3's masks printed, 2 x 81 channels an image) and a
   validation at 81 classes; ``cli.train_rml.main`` on ``configs/rml_voc.yaml`` for
   four steps (K2 in ``par`` mode); in the first step and the first validation of
   each run, every call of K1 (each piece and the whole block), K2 and K3 at a
   geometry not met before held against its plain version on the same inputs (the
   exporting K1 on the validation's non-square token grids, K3 at COCO's 2 x 81
   planes among them); then both CLIs again for 20 steps after the warm-up: the
   median ms a step through the command line (loader included) with its spread, the
   step alone by CUDA events, and the seconds a validation image;
7g. RSSFormer command line: the LoveDA chain (``augment_loveda_batch``) on 8 of LoveDA's
   1024² images on the card against the CPU on the same decisions (every flip / rot90
   op, half through ShiftScaleRotate): images within 1e-4, masks equal but where a
   nearest tap's source coordinate lies within 1e-4 of a half (counted); then
   ``cli.rssformer.main`` on configs/rssformer_loveda.yaml as it is (the f32
   ``hrnetv2_w32``, 8 x 512², SGD) with ``data.device_augment=true``: eight steps, each
   step's losses finite and no hand-written kernel launched, checkpoints at 4 and 8, a
   rerun that resumes at 8 and ends at 9; the checkpoint calmed as in 7c, then ``eval
   --tta`` and ``predict`` with ``model.fused_mlp=True`` (bf16 compute; K5 8 + 8 a
   forward over 16 images at six scales and at one, nothing else launched; each of K5's
   six new token grids held against the plain version at its first call) against the
   same commands at ``fused_mlp=False`` in bf16 (no launch): scores within 1e-2,
   probabilities within 3e-2, classes equal on at least 99% of the pixels that are not
   near-ties, one palette PNG an image equal to its argmax; the figures: ms a step
   through the CLI and the step alone, its launches and idle share, seconds an ``eval
   --tta`` image and a ``predict`` image;
7h. WaveCAM's training half and command line: ``cli.run_wavecam.main`` with all nine
   gates at ``WaveCAMConfig``'s defaults (the f32 ResNet-50 ``Net`` at stride 16, 20
   classes, 16 x 512² crops, scales 1, 0.5, 1.5, 2, the grid CRF, IRN at 512², radius
   10, beta 10, eight squarings) on the synthetic source (16 images of 64²), cut to one
   CAM epoch, one IRN epoch and IRN batch 16 (one IRN step), train_cam's initial
   ``Net`` calmed: 16 CAM dicts, IR labels and pseudo labels written, every loss
   finite (1, 5 and 1 steps), both mIoUs in [0, 1], make_wavecam's dicts unlike
   make_cam's, ``dp_running_mean`` set, no hand-written kernel launched; the first
   step of each trainer at 128², batch 2, card against CPU on the same weights and
   batch (losses 1e-4 relative, each top-level module's gradient norm 1e-3, the
   predictor's BatchNorm statistics 1e-4, make_wavecam's dict of one image 1e-4 of
   its largest); each trainer's step at 16 x 512² timed (CUDA events), traced
   (launches, idle share) with its peak memory, and the seconds of each stage;
7i. HRFormer, ASFF and the converter: (a) ``cli.rssformer.main`` on
   configs/rssformer_loveda.yaml as it is but ``model.hrnet_type=hrt_small`` (the f32
   ``HighResolutionTransformerNet``, 7 classes, 8 x 512², SGD) with
   ``data.device_augment=true``: four steps, each step's losses finite and no
   hand-written kernel launched, a checkpoint at 4, a rerun that resumes at 4 and ends at
   5, then ``eval --tta`` (scores in [0, 1]) and ``predict`` (one palette PNG an image,
   equal to its argmax), no kernel; (b) ``HRNetFusion("hrt_small", 7)`` at 2 x 128², f32,
   on the card against the CPU from the same calmed weights, batch and drop-path
   generator: eval probabilities within 1e-4, the first training forward and backward's
   losses within 1e-4 relative, the gradient norm of each module of the net within 1e-3,
   the running statistics within 1e-4 of max(their largest, 1e-3); (c)
   ``WeTrBaseline("mit_b1", fused_blocks=True, bf16)`` at 8 x 512², every block on K1
   (84 launches a forward, 22/40/6/8/8), each K1 geometry held against its plain version
   at its first call, ``cls_logits``, ``seg`` and the ``cam_only`` CAM against
   ``fused_blocks=False`` in bf16 within 2e-2 of each output's largest magnitude, and the
   ms of a forward both ways; (d) ``rsNetFusion`` and ``HRNetFusion2`` at ``hrnetv2_w32``,
   f32: an eval forward at 4 x 512², the CGFL loss and a backward at 2 x 512², the card
   against the CPU at 128² within 1e-4; (e) ``cli.convert_checkpoint --family rssformer
   --arch hrt_small`` on a DDP checkpoint (``module.`` names, the dead ``norm2``,
   ``num_batches_tracked``) of a seeded model, loaded strictly on the card, whose eval
   output equals the source model's bit for bit; the figures: ms a step through the CLI
   and alone, launches, idle share and peak GiB, seconds an ``eval --tta`` and a
   ``predict`` image, WeTrBaseline's ms a forward on K1 and with plain blocks;
7j. the baseline zoo: (a) each of the fourteen models (FarSegV1, SemanticFPN, PSPNet,
   FCN8s, AnyUNet, FactSeg, SemanticFPNDecouple, UNetPP, LinkNet, DeepLabV3,
   DeepLabV3Plus, MANet, PAN, trans) built by ``MODELS.build(name, classes=7)`` at its JAX
   defaults (``trans`` at ``hrnetv2_w48``), f32, three steps of ``make_rssformer_train_step``
   at ``RSSFormerTrainConfig()`` on ``rss_batch`` (8 x 512²): losses finite, every trained
   BatchNorm's running statistics moved once a step, the frozen ResNet-50 ones not, no
   hand-written kernel; the step timed (median of three, CUDA events) and traced (launches,
   idle share), peak GiB; ``evaluate`` on two batches of 4 x 512² (scores in [0, 1],
   probabilities summing to 1 within 1e-4, SemanticFPNDecouple's sigmoids in [0, 1]) and
   its seconds an image; (b) each at 2 x 128², f32, on the card against the CPU from the
   same calmed weights, batch and host-drawn dropout masks: eval probabilities within 1e-4,
   the training forward's losses within 1e-4 relative, each top-level module's gradient
   norm within 1e-3 and the running statistics within 1e-4 of max(their largest, 1e-3),
   these two in f64 on both sides where f32 misses (the pooled branches' BatchNorms over
   two images make the f32 gradients rounding noise); (c)
   ``utils/affine.py::apply_affine`` on the card against the CPU within 1e-5,
   ``utils/profiling.py::trace`` around one AnyUNet step (a trace file with kernel events),
   ``device_memory_stats`` naming the card;
7k. multi-device: two gloo ranks spawned on the card (``parallel/launch.py``; they load the
   kernels the build made): (a) ``psum_tree``, ``allreduce_grads``, ``sync_batch_stats``,
   ``halo_exchange_1d`` and ``all_gather`` on CUDA tensors against the values they must give;
   (b) ``cli.train_scd`` on configs/scd_voc.yaml (MiT-B1, 320² crops on the card, DP_SCD_STEPS
   steps, the warm-up to DP_CAM_ITERS, a checkpoint and a validation every DP_SCD_EVAL) at 2 x
   ``samples_per_gpu`` 2, then as one rank at 4 in this process: K1 504, K2 1, K3 10 launches a
   step a rank, each new kernel geometry held against its plain version at its first call, the
   ranks' global losses against one rank's (cls within DP_CLS_RTOL on the warm-up steps, all
   within DP_CAM_LOSS_RTOL), the first step's refined labels on at least DP_LABEL_SHARE of the
   pixels, the split validation's mIoUs within DP_MIOU_TOL, the weights after the warm-up; (c)
   ``cli.train_rml`` on configs/rml_voc.yaml the same way; (d) ``cli.rssformer train`` on
   configs/rssformer_loveda.yaml, 8 x 512² as 2 x 4: the first step's losses and each parameter
   group's gradient norm against one rank, no kernel; (e) ``sharded_sliding_window_predict`` of
   the calmed ``HRNetFusion("hrnetv2_w32", bf16, fused_mlp, fused_attn)`` over a 1024² tile,
   window 512, stride 256, against ``sliding_window_predict`` on the same padding (K5 and K6
   launched on each rank); each step alone timed (two ranks sharing a card measure
   correctness, not scaling); then a one-rank NCCL group: an all-reduce and a mesh over it;
8. timing: times of each kernel (K4, K5 and K6 and their library calls by
   CUDA-graph replay, K2 and K3 by CUDA events), of the whole forward, of the
   whole pseudo-label call, of the train step and of the RML train step, kernel path
   against plain path (with the RML step's peak memory and launches); the
   RSSFormer predict four ways (both flags on, each alone, both off) and the
   headline forward with and without ``pre_sr``;
9. bench: ``representationlearning_tpu_torch/bench.py``'s seven workloads
   (the headline, the SCD pseudo labels, the RSSFormer predict, TTA and train step,
   the RML train step, the WaveCAM CAM pair at ``bench.py``'s shapes) measured in this
   process at a loop
   of two calls: each line's value finite and positive, idle share in [0, 1),
   launches, peak memory and FLOPs positive, and the hand-written kernels' launches
   a call equal to those of phases 4, 7a, 7b and 7c (K1 84 a headline forward; K1
   504, K2 1, K3 10 an RML step; K5 8 + 8 a predict; none on the other four); then
   ``python -m representationlearning_tpu_torch.bench --one segformer_b1`` in a
   process of its own, whose last line must be the headline's record.

Run from the root of the repository: ``python3 chip_smoke.py [--seed N]``. Every
phase prints its results; the line before the last is a JSON object with one
entry per kernel (K1's five, K2, K3, K4 forward and backward, K5's two, K6 and the
K1' block; K1-K3 with their launches in a rank's data-parallel SCD step, K5 and K6 with
theirs in a rank's part of the sharded sliding window), and the last line is ``{"ok": true, ...}``. Without a CUDA
card, or without the package beside the script, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import inspect
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import zlib
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
PKG = "representationlearning_tpu_torch"
BATCH, IMAGE, NUM_CLASSES = 8, 512, 21
# (tokens per side, C, heads, sr, export) of the MiT-B1 blocks at 512 x 512
STAGES = [(128, 64, 1, 8, False), (64, 128, 2, 4, False), (32, 320, 5, 2, False),
          (32, 512, 8, 1, True)]
DEPTH = 2  # MiT-B1 blocks per stage
PALLAS = "representationlearning_tpu/ops/pallas/"
# kernel -> (source under csrc/, the TPU kernel it replaces)
KERNELS = {"ln_stats": ("mit_block/ln_stats.cu", PALLAS + "mit_block.py:259"),
           "linear": ("mit_block/gemm.cu", PALLAS + "mit_block.py:259"),
           "sr_conv": ("mit_block/sr_conv.cu", PALLAS + "mit_block.py:259"),
           "attention": ("mit_block/attention.cu", PALLAS + "mit_block.py:259"),
           "dwconv_gelu": ("mit_block/dwconv_gelu.cu", PALLAS + "mit_block.py:259"),
           "affinity": ("refine/affinity.cu", PALLAS + "affinity.py:134"),
           "varm_propagate": ("refine/varm.cu", PALLAS + "varm.py:91"),
           "flash_fwd": ("attention/flash_fwd.cu", PALLAS + "attention.py:95"),
           "flash_bwd": ("attention/flash_bwd.cu", PALLAS + "attention.py:134"),
           "mlp_fc1": ("rssformer/mlp_dwbn.cu", PALLAS + "mlp_dwbn.py:115"),
           "mlp_taps": ("rssformer/mlp_dwbn.cu", PALLAS + "mlp_dwbn.py:115"),
           "isa_core": ("rssformer/isa_attention.cu", PALLAS + "isa_attention.py:106"),
           # K1' is K1's kernels in another order of work: `linear` without its
           # LayerNorm prologue on h and xs handed in
           "mit_block_presr": ("mit_block/gemm.cu", PALLAS + "mit_block.py:230")}
TRAIN_KERNELS = ("ln_stats", "linear", "sr_conv", "attention", "dwconv_gelu", "affinity",
                 "varm_propagate", "flash_fwd", "flash_bwd")  # launched in a train step

# The RSSFormer predict (bench.py::bench_rssformer_predict): hrnetv2_w32, 7 classes,
# 4 x 512 x 512; its transformer blocks sit on branch 0 (width 32, 128 x 128 tokens,
# 7 x 7 windows over the grid padded to 133: 19 x 19 windows an image, 2 heads)
RSS_BATCH, RSS_CLASSES, RSS_DIM, RSS_HEADS, RSS_WINDOW = 4, 7, 32, 2, 7
RSS_BLOCKS = 8  # one a HighResolutionModule: 1 + 4 + 3 in stages 2-4

# The SCD pseudo-label path (configs/scd_voc.yaml): crop, CAM scales, refinement
# at half resolution with 2 * (max_present + 1) mask channels
CROP, CAM_SCALES, MAX_PRESENT = 320, (1.0, 0.5, 1.5), 8
DILATIONS, VARM_ITERS, DOWN_SCALE = (1, 2, 4, 8, 12, 24), 10, 2


# K4's (BH, Nq, Nk) in one train step, hd = 64: the non-exporting blocks of stages
# 1-3 (DEPTH launches each) of the main forward at CROP and of the second forward
# at int(0.3 * CROP); and at the 512 x 512 forward
HD = 64


def flash_shapes(side: int) -> list[tuple[int, int, int]]:
    t = side // 4
    return [(BATCH * nh, (t // f) ** 2, (t // f // sr) ** 2)
            for f, (_, _, nh, sr, export) in zip((1, 2, 4), STAGES) if not export]


# optimiser and schedule of configs/scd_voc.yaml
LR, WEIGHT_DECAY, WARMUP, MAX_ITERS = 6e-5, 0.01, 1500, 20000
TRAIN_STEPS = 3

# The RML train step (bench.py::bench_rml_train): batch 16 of raw uint8 512 x 512
# canvases holding a 375 x 500 image, augmented on the card to 320 x 320 crops
# (scale 0.5-2.0, flip, pad, crop, normalise); CAM scales (0.5, 1, 1.5) on the full
# and the 0.3-scale input, so K1 runs six [x; flip x] forwards of 32 a step; PAR
# refinement (K2 in `par` mode, then K3) at 160 x 160 with 2 * (8 + 1) planes
RML_BATCH, RML_CANVAS, RML_HW, RML_SCALES = 16, 512, (375, 500), (0.5, 1.0, 1.5)
RML_WARMUP, RML_MAX_ITERS = 10, 1000
RML_KERNELS = ("ln_stats", "linear", "sr_conv", "attention", "dwconv_gelu", "affinity",
               "varm_propagate")  # launched in an RML train step; no other kernel is

# The RSSFormer train step (bench.py::bench_rssformer_train): hrnetv2_w32, 7 classes,
# bf16 convolutions, 8 x 3 x 512 x 512, masks in [-1, 7) with -1 ignored, SGD with
# the poly rate and the clip at 35. The step itself launches no hand-written kernel;
# with fused_attn=True (a flag the JAX model lacks) each of the 8 transformer blocks'
# window attention runs on K6 under autograd, its backward the plain recomputation.
# evaluate() reads two batches of 4 with fused_mlp=True: K5 8 + 8 a forward.
RSS_TRAIN_STEPS, RSS_EVAL_BATCH = 3, 4

# WaveCAM (phase 7d). The bench's configuration (bench.py::bench_wavecam_cams): the
# ResNet-50 Net(n_classes=20, bf16), one cam over 8 x 512 x 512 images and their
# flips. The pseudo-label stages on one VOC-sized image with WaveCAMConfig's
# defaults: cam_scales, conf_fg_thres / conf_bg_thres (CRF method grid), rw_radius,
# beta, exp_times, sem_seg_bg_thres. The same chain at CHAIN_HW on the card and on
# the CPU.
WAVECAM_BATCH, WAVECAM_SIDE, WAVECAM_CLASSES = 8, 512, 20
VOC_HW, WAVECAM_SCALES = (375, 500), (1.0, 0.5, 1.5, 2.0)
CONF_FG, CONF_BG, SEM_BG = 0.35, 0.1, 0.28
RW_RADIUS, RW_BETA, RW_EXP = 5, 10.0, 8
CHAIN_HW = (64, 96)
WAVECAM_TOL = 2e-2     # bf16 CAMs against f32, of the largest magnitude (the headline's bound)
COLUMN_TOL = 1e-3      # every column of the transition matrix sums to 1
CRF_AGREE = 0.99       # grid against the host lattice (tests/test_indexing_crf.py's bound)
CHAIN_SHARE = 0.995    # card against CPU labels, off near-ties
NEAR_TIE = 1e-3        # two best scores this close: a near-tie

# DRFL (phase 7e; configs/drfl.yaml, no hand-written kernel). Softnet(3, 12) at 256²,
# the synthetic source at 256² (8 samples); three checked steps, then the timed ones,
# at the yaml's batch of 1 and at 8. The card against the CPU at 64² with one ViT
# layer on the same weights and the same host-drawn dropout masks, with the CPU in
# f64 as the reference. At 64² the bottom GroupNorms of both UNets normalise 2 x 2
# values a channel, which makes the f32 computation ill-conditioned: on the CPU the
# port and JAX, both f32, differ in module gradient norms by up to 1.7e-3
# (tests/test_torch_train_drfl.py). So each group (eval outputs, losses, module
# gradient norms) is held to its tolerance or to DRFL_ROUNDING times the CPU's own
# largest f32 error against f64 in the group, in the same run, whichever is larger:
# the card may differ from the CPU by what f32 rounding in another order gives.
# The card also runs the same in f64, where it must equal the CPU's f64 run to
# DRFL_F64_TOL: that holds the function, whatever the conditioning.
DRFL_SIDE, DRFL_LAYERS, DRFL_N, DRFL_BATCHES = 256, 12, 8, (1, 8)
DRFL_STEPS, DRFL_TIMED, DRFL_SMALL = 3, 5, 64
DRFL_EVAL_TOL = 1e-4   # eval outputs, card against CPU, of each output's largest entry
DRFL_LOSS_TOL = 1e-3   # the step's three losses, relative
DRFL_NORM_TOL = 1e-3   # the gradient norm of each top-level module, relative
DRFL_ROUNDING = 10     # times the CPU's f32 error against its f64 run
DRFL_F64_TOL = 1e-8    # the card in f64 against the CPU in f64, relative

# The WSSS command lines (phase 7f): cli/train_scd.py on configs/scd_voc.yaml (then a
# resume) and configs/scd_coco.yaml, cli/train_rml.py on configs/rml_voc.yaml, as the
# yamls give them (MiT-B1, 320² crops, batch 2) with on-card augmentation of WSSS_N
# synthetic 96 x 128 images on 512² canvases; iteration counts cut
WSSS_N, WSSS_SCD_STEPS, WSSS_SCD_EVAL, WSSS_CAM_ITERS = 16, 6, 3, 2
WSSS_COCO_STEPS, WSSS_RML_STEPS, WSSS_RML_CAM_ITERS = 2, 4, 1
# The kernel path against the plain path in 7f, both f32 (the twins compute in f32 on
# every device, as JAX builds them): the refined labels of each run's first step (the
# CAMs of the twin through K1, refined through K2 / K3, against the same CAMs and
# refinement through the plain versions), and its first validation's three mIoUs. Only
# f32 sums taken in another order differ, so a label flips only where two scores tie
# to about 1e-6.
WSSS_PATH_SHARE, WSSS_PATH_MIOU = 0.9999, 1e-3
# the figures: each CLI again, fresh, for this many steps after its warm-up, the yamls'
# log_iters, one validation at the end; the step alone as often
WSSS_TIMED = 20

# The RSSFormer command line (phase 7g): cli/rssformer.py on configs/rssformer_loveda.yaml as
# it is (hrnetv2_w32, 7 classes, 512² crops, batch 8, the f32 model, SGD poly 0.9, clip 35),
# data.device_augment=true on the synthetic source (16 images of 128² on the default 1024²
# canvases); cut: RSS_CLI_STEPS steps with a checkpoint every RSS_CLI_SAVE, then a resume for
# one more; then eval --tta and predict with model.fused_mlp=True (K5) and at fused_mlp=False,
# both in f32 as JAX builds them. The LoveDA chain on the card against the CPU on LoveDA's 1024²
# images: images within LOVEDA_IMG_TOL; masks equal but where a nearest tap's source
# coordinate lies within LOVEDA_NEAR_HALF of a half (the last bit of sin and cos decides).
RSS_CLI_STEPS, RSS_CLI_SAVE, RSS_CLI_ALONE = 8, 4, 5
RSS_CLI_BATCH, RSS_CLI_CANVAS, RSS_CLI_IMAGES = 8, 1024, 16
# its predict's probabilities, K5 against fused_mlp=False, both f32 (3xTF32 products against
# cuDNN's f32 convolutions, TF32 off): f32 sums in another order through eight blocks
RSS_F32_TOL = 1e-3
LOVEDA_IMG_TOL, LOVEDA_NEAR_HALF = 1e-4, 1e-4

# WaveCAM's training half and command line (phase 7h): cli/run_wavecam.py with its nine
# gates at WaveCAMConfig's defaults (the f32 ResNet-50 Net at stride 16, 20 classes, 512²
# crops, batch 16, scales 1, 0.5, 1.5, 2, the grid CRF, IRN crop 512, radius 10, beta 10,
# eight squarings) on the default synthetic source (16 images of 64²); cut: one CAM epoch,
# one IRN epoch, and IRN batch 16, so that train_irn takes one step on the 16 images
# (train_wavecam keeps its five epochs, which the CLI does not expose)
WC_ARGS = ["--cam_epochs", "1", "--irn_num_epoches", "1", "--irn_batch_size", "16"]
WC_FIGURES = {"irn_batch_size": 16}   # the timed steps: 16 x 512² each (IRN's cut batch)
WC_SMALL, WC_SMALL_BATCH = 128, 2   # the first steps, card against CPU
WC_LOSS_TOL = 1e-4        # a first step's loss, card against CPU, relative
WC_NORM_TOL = 1e-3        # the gradient norm of each top-level module, relative
WC_STATS_TOL = 1e-4       # the predictor's BatchNorm running statistics, of the largest
WC_CAM_TOL = 1e-4         # make_wavecam's CAM dict of one image, of its largest entry
WC_TIMED, WC_TRACED = 3, 2   # steps timed (CUDA events, median) and traced

# The HRFormer backbone, the ASFF variants and the converter (phase 7i). (a) cli/rssformer.py
# on configs/rssformer_loveda.yaml as it is but model.hrnet_type=hrt_small (the f32 model, 7
# classes, 8 x 512² crops, SGD; data.device_augment=true on the yaml's 16 synthetic images);
# cut: HRT_CLI_STEPS steps with a checkpoint at the last, then a resume for one more; eval
# --tta and predict from that checkpoint. (b) HRNetFusion("hrt_small", 7) at HRT_SMALL²,
# batch 2, f32, card against CPU on the same weights, batch and drop-path generator (the
# train-mode schedule is live). (c) WeTrBaseline("mit_b1", fused_blocks=True, bf16) on K1
# at WETR_BATCH x 512² against fused_blocks=False in bf16 (PATH_TOL). (d) rsNetFusion and
# HRNetFusion2 at hrnetv2_w32, f32: an eval forward at ASFF_EVAL_BATCH x 512², a loss and
# backward at ASFF_TRAIN_BATCH x 512², card against CPU at HRT_SMALL². (e) the converter on a
# DDP-prefixed hrt_small checkpoint, loaded on the card.
HRT_CLI_STEPS, HRT_CLI_ALONE, HRT_TRACED = 4, 5, 2
HRT_SMALL, HRT_SMALL_BATCH = 128, 2
HRT_EVAL_TOL = 1e-4    # eval probabilities, card against CPU
HRT_LOSS_TOL = 1e-4    # the first step's losses, relative
HRT_NORM_TOL = 1e-3    # the gradient norm of each module of the net, relative
HRT_STATS_TOL = 1e-4   # running statistics, of max(their largest entry, 1e-3)
WETR_BATCH, WETR_TIMED = 8, 10
ASFF_EVAL_BATCH, ASFF_TRAIN_BATCH = 4, 2
ASFF_TOL = 1e-4        # probabilities, card against CPU

# The baseline zoo (phase 7j): (a) each of the fourteen models of models/baselines.py and
# models/smp_zoo.py at its JAX defaults (trans at hrnetv2_w48, AnyUNet base 32, depth 4), f32,
# ZOO_STEPS steps of make_rssformer_train_step on rss_batch (8 x 512²), then ZOO_TIMED timed and
# ZOO_TRACED traced, and evaluate on ZOO_EVAL_BATCHES batches of ZOO_EVAL_BATCH x 512²; cut:
# the number of steps only. (b) each at ZOO_SMALL_BATCH x ZOO_SMALL², card against CPU on the
# same calmed weights, batch and dropout masks. (c) the utilities on the card.
ZOO_STEPS, ZOO_TIMED, ZOO_TRACED = 3, 3, 2
ZOO_EVAL_BATCHES, ZOO_EVAL_BATCH = 2, 4
ZOO_SMALL, ZOO_SMALL_BATCH = 128, 2
ZOO_EVAL_TOL = 1e-4     # eval probabilities, card against CPU
ZOO_LOSS_TOL = 1e-4     # the training forward's losses, relative
ZOO_NORM_TOL = 1e-3     # the gradient norm of each top-level module, relative
ZOO_STATS_TOL = 1e-4    # running statistics, of max(their largest entry, 1e-3)
ZOO_F32_K = 16.0        # where f32 misses: the card's worst f32 error against the CPU's f64
ZOO_F32_FLOOR = 1e-5    # run, at most this many times the CPU's own worst f32 error (or floor)
ZOO_AFFINE_TOL = 1e-5   # apply_affine, card against CPU

# Multi-device (phase 7k): DP_WORLD gloo ranks share the one card (NCCL refuses two ranks
# on one GPU, so their times measure correctness, not scaling), each against one rank on the
# global batch in this process. (b) cli/train_scd.py on configs/scd_voc.yaml as it is, with
# dataset.device_augment=true on WSSS_N synthetic images, at DP_WORLD x samples_per_gpu 2
# against 1 x 4; cut: DP_SCD_STEPS steps, the warm-up to DP_CAM_ITERS, a checkpoint and a
# validation every DP_SCD_EVAL. (c) cli/train_rml.py on configs/rml_voc.yaml the same way,
# DP_RML_STEPS steps. (d) cli/rssformer.py train on configs/rssformer_loveda.yaml (8 x 512² as
# DP_WORLD x 4), DP_RSS_STEPS steps. (e) sharded_sliding_window_predict over a LoveDA-sized
# DP_SLIDE_SIDE² tile, window DP_SLIDE_WINDOW, stride DP_SLIDE_STRIDE, on the RSSFormer
# predict's model, calmed, against sliding_window_predict on the same padding.
DP_WORLD = 2
DP_SCD_STEPS, DP_SCD_EVAL, DP_CAM_ITERS, DP_RML_STEPS, DP_RSS_STEPS = 4, 2, 1, 3, 3
DP_TIMED = 5   # the step alone, CUDA events, after the run
DP_SLIDE_SIDE, DP_SLIDE_WINDOW, DP_SLIDE_STRIDE = 1024, 512, 256
DP_RANK_TIMEOUT = 400.0   # each collective of the ranks' group, and their results
# The classification loss comes from the f32 model alone: before any update through the
# CAM-derived losses (the first DP_CAM_ITERS + 2 steps) n ranks and one differ by f32
# summation order only (cuDNN's algorithms for batch 2 and 4, the all-reduces).
DP_CLS_RTOL = 1e-4
# The other losses read labels made from the bf16 twins' CAMs, whose K1 plans and cuDNN
# algorithms may change with the batch: labels agree on at least DP_LABEL_SHARE of the
# pixels (a label within a bf16 spacing of a threshold may flip), and a mean over pixels
# moves by at most the share that flipped (1.4e-3) times twice the largest per-pixel loss
# over the mean (below 10 at random weights), so within DP_CAM_LOSS_RTOL.
DP_LABEL_SHARE = 0.9986
DP_CAM_LOSS_RTOL = 3e-2
# The weights after the warm-up's cls-only steps: as tests/test_torch_dp_steps.py, f32
# rounding for most tensors, and AdamW's sign-sized first updates where a gradient is noise.
DP_WEIGHT_MEDIAN_TOL = 1e-6
DP_MIOU_TOL = 1e-2   # validation mIoUs (the eval twin in bf16 on weights that differ in f32)
# RSSFormer at random weights is chaotic (tests/test_torch_train_rssformer.py's rules): the
# first step's losses within DP_RSS_LOSS_RTOL and each parameter group's gradient norm
# (summed over the ranks, before the clip) within DP_RSS_GROUP_RTOL of one rank's; after an
# update that differs in f32 rounding the trajectories part, so the later steps are held
# only to be finite and the same on every rank.
DP_RSS_LOSS_RTOL, DP_RSS_GROUP_RTOL = 2e-4, 1e-2
# The sharded sliding window against one device: bf16 probabilities of windows run in other
# batches (6 and 9 against 15), and index_add_'s atomics add in no fixed order (7c's bound).
DP_SLIDE_TOL = 3e-2


def cam_stages(side: int) -> list[tuple]:
    """The MiT-B1 block geometries of a `cam_only` forward at side x side: the
    token grids are side / 4, / 8, / 16, / 16, and no block exports its logits."""
    t = side // 4
    return [(hw, C, nh, sr, False)
            for hw, (_, C, nh, sr, _) in zip((t, t // 2, t // 4, t // 4), STAGES)]


# Published peaks of one H100 SXM at its full power limit: device memory bytes/s,
# dense bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
PEAK_TF32 = 494.7e12  # dense TF32 tensor-core FLOP/s

# Kernel against plain version on the SAME inputs; a result passes when
# max|kernel - plain| <= tol * max(1, max|plain|).
PIECE_TOL = {
    # f32 sums over C <= 512 in another order
    "ln_stats": 1e-5,
    # identical bf16 operands (the LayerNorm prologue rounds step by step, as
    # the plain version does); products exact in f32, only the order of the
    # f32 sums over K <= 4096 differs
    "linear": 1e-4,
    "sr_conv": 1e-4,
    # out: the probabilities are rounded to bf16 before p.v; the row sum is
    # accumulated online here and directly in the plain version, so a few
    # probabilities round to the neighbouring bf16 value (2^-8 relative)
    "attention": 1e-3,
    # f32 only; the multiply-adds may fuse, erf's exp differs in the last bit
    "dwconv_gelu": 1e-5,
}
# K2, absolute, on weights in [-w2, 1 + w2]: the sums over the K taps run in tap
# order in the kernel and in torch's order in the plain version, and `expf`
# differs from `torch.exp` in the last bits. K3 has no tolerance of its own: it
# must equal its plain version bit for bit, and fails beyond 1e-6 if it does not.
AFFINITY_TOL = 2e-5
VARM_TOL = 1e-6
# Labels of the kernel path against the plain path: both run the CAM forwards in
# bf16, so a pixel whose score lies within a bf16 spacing of a threshold or of
# the runner-up may fall on the other side.
LABEL_SHARE = 0.995
# The segmentation argmax of the validation step at random weights: the 21 class
# logits of a pixel lie close together, so the path difference (6e-2 at a largest
# logit of 11) flips more of them than it flips thresholded CAMs.
SEG_SHARE = 0.99
# The raw logits: f32 sums of hd = 64 exact bf16 products in another order.
LOGIT_TOL = 1e-4
# Whole block and whole model, kernel path against plain path: each side rounds
# its own f32 intermediates to bf16 operands, so where the two f32 sums fall on
# either side of a bf16 rounding boundary the results move by one bf16 spacing
# (2^-8 relative) and that propagates; the block output is stored in bf16.
# 2e-2 of the largest magnitude is about five bf16 spacings (the bound of the
# port's bf16 CPU parity test against the JAX package).
PATH_TOL = 2e-2
# K4 against its plain version, times max(1, max|plain|). f32: the same f32
# products, summed tile by tile under an online softmax in the kernel and under
# one softmax in the plain version; the JAX package holds its kernel to 1e-4
# forward and rtol 2e-4 (atol 2e-5) backward (tests/test_pallas_attention.py:56,108).
# bf16: the kernel rounds p and ds to bf16 before their products as the TPU kernel
# does, the plain version works in f32 and rounds its result: a few bf16 spacings.
FLASH_TOL = {"fwd": 1e-4, "bwd": 2e-4, "bf16": 2e-2}
# TSCD(use_flash=True) against use_flash=False, f32 on both sides through eight
# blocks and the head: the f32 end-to-end bound of the port's CPU parity tests.
FLASH_MODEL_TOL = 2e-4
# First train step, kernel path against plain path, same seed and masks. `cls`
# does not see the CAM twin: only K4 differs, f32 against f32. The other five
# read the twin's bf16 CAMs (within PATH_TOL of each other) and the labels made
# from them (equal on at least LABEL_SHARE of the pixels), so a loss, and the
# gradient norm of a parameter group, may move by about the share of pixels
# whose label flipped plus the CAM difference: 2e-2 of its value, with an
# absolute floor for losses near zero.
STEP_CLS_TOL = 1e-4
STEP_TOL, STEP_ATOL = 2e-2, 2e-3
# The RML step: `cls` and `mfml` read the trained model only, plain blocks on both
# paths, so they agree to f32 rounding (1e-4 of their value); `ciml` and `apml` read
# the twin's bf16 CAMs and the labels made from them (STEP_TOL, STEP_ATOL).
RML_EXACT_TOL = 1e-4
# The same step twice from a restored checkpoint: K1-K4 repeat bit for bit, but
# `index_add_` in the bilateral grid and the backward of gathers, `grid_sample`
# and resizes add with atomics in an order that changes from run to run.
RESUME_TOL = 1e-4
# The parameters after those two steps, absolute: the updates differ by that
# noise in the gradients, far below one f32 spacing of a parameter near 1
# (1.2e-7), so a parameter lands on the same f32 value or the next; a moment
# that was not restored would move it by the whole update (1.2e-6 in the heads
# at this step's learning rate).
RESUME_PARAM_TOL = 5e-7
# K5 against its plain version on the same inputs, times max(1, max|plain|). fc1
# stores its result in bf16: equal except where the kernel's f32 sum lands on the
# other side of a rounding boundary, then one bf16 spacing (2^-8 of the value,
# 2^-7 of the largest covers it). The taps piece and the whole block: such a
# flipped bf16 operand of the next product moves an output by a bf16 spacing of
# the hidden value (2^-9 of it, relative) times a weight. Some 3e-4 of the hidden
# values flip and an output reads 128 of them, so a few percent of the outputs
# move by about 2e-4 and fewer by more: 1e-2 of the largest magnitude bounds the
# worst, and all but a thousandth of the entries lie within 1e-3 of it.
K5_TOL = {"mlp_fc1": 2.0 ** -7, "mlp_taps": 1e-2, "whole": 1e-2}
# K5 with f32 operands (3xTF32 products, f32 to about 2^-21 of each) against the plain
# version's f32 products: f32 sums of up to 19 x 192 terms in another order
K5_F32_TOL = 1e-4
K5_NEAR, K5_FAR_SHARE = 1e-3, 1e-3
# K6: f32 sums of at most 100 products in another order, `expf` against
# `torch.exp`; with bf16 operands a probability next to a rounding boundary may
# take the neighbouring bf16 value (2^-8 of a value below 1).
K6_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
# SHA-256 (first 16 hex digits) of the bf16 `mlp_fc1` at HRNetV2's widths and phase 7l's planes
# (`tools/time_port_dwconv_fc1.py::fc1_bf16_digests`), recorded on an H100 before the f32 fc1
# became `fc1_wg_kernel`: the bf16 kernel keeps its bits
FC1_BF16_SHA256 = {
    "w18 8x128x128": "c3f76ee602176c8d", "w18 2x96x96": "b7c5249162610d63",
    "w18 2x7x9": "f1e5d19e408145ab", "w18 1x20x45": "c052e2c12aa8d958",
    "w18 3x13x29": "dde6c108890f8c88", "w18 1x1x1": "d79e40a86460f664",
    "w32 8x128x128": "87d246fac65c7063", "w32 2x96x96": "db6f8055925f6db9",
    "w32 2x7x9": "25685f58fc7827cb", "w32 1x20x45": "96be5a71ce66f270",
    "w32 3x13x29": "5afa072cc0878c2f", "w32 1x1x1": "635f041196642d45",
    "w40 8x128x128": "bb42e2c0fbbf626a", "w40 2x96x96": "192e7e443f81847b",
    "w40 2x7x9": "a9ac7919880028ab", "w40 1x20x45": "12348411121ae03f",
    "w40 3x13x29": "59dd9e1dfb4b1157", "w40 1x1x1": "4fe5573ddee7b479",
    "w48 8x128x128": "e1aafc27565f40e0", "w48 2x96x96": "5f3efe8b9cb19db6",
    "w48 2x7x9": "fa999bee839d2897", "w48 1x20x45": "dbc73d368108488c",
    "w48 3x13x29": "c005427b6a706b08", "w48 1x1x1": "0600053ac8e53a3a"}
# RSSFormer probabilities (in [0, 1]), K5 and K6 against the cuDNN convolutions
# and the plain attention core, both in bf16: the unfused FFN rounds each conv's
# result to bf16 and adds the three branches in bf16, K5 keeps f32 sums, so the
# two differ by a few bf16 spacings of the hidden values through eight blocks
# (1e-2 on the CPU at hrnetv2_w18); the classes agree on at least 99% of pixels.
RSS_TOL, RSS_SHARE = 3e-2, 0.99
# Phase 7l, f32 operands (3xTF32 products, f32 to about 2^-21 of each product) against the
# plain versions' f32 products, TF32 off: the f32 sums over K <= 4096 in another order (the
# pieces that always computed in f32 keep PIECE_TOL); the f32 TSCD end to end at the
# port's f32 CPU bound (tests/test_parity_torch_e2e.py:21), of the largest magnitude; the
# f32 HRNetFusion probabilities against both flags off (cuDNN f32 convolutions).
F32_PIECE_TOL = {**PIECE_TOL, "linear": 1e-4, "sr_conv": 1e-4, "attention": 1e-4,
                 "logits": LOGIT_TOL}
TSCD_F32_TOL = 2e-4
# Phase 7l's edges of the f32 attention: key counts around its key tile of 64 and the
# bf16 one-pass bound, the WSSS command lines' 25 / 100 / 225 and 400 / 900 (no multiple of
# the tile; 25 and 225 no multiple of 4: the export's unaligned rows), 1024; query counts
# around a warpgroup's 64 and a block's 128
K1_F32_ATTN_KEYS = (1, 7, 8, 25, 63, 64, 65, 100, 225, 255, 256, 257, 400, 900, 1024)
K1_F32_ATTN_QUERIES = (1, 63, 64, 65, 127, 129)
# (B, H, W, C, sr) of phase 7l's f32 `sr_conv` edges: grids cropped to full windows (H, W
# not multiples of sr, W != H), patch rows that cross images, one patch, one patch row of 65,
# one patch an image, tiles of a row more or less, the n32 / n96 / n160 / n192 tiles, and
# the WSSS command lines' CAM forwards at stage 1 (M 100 / 400 / 900)
K1_F32_SR_EDGES = ((2, 15, 13, 64, 8), (3, 13, 11, 128, 4), (5, 11, 7, 320, 2),
                   (3, 40, 24, 64, 8), (1, 8, 8, 64, 8), (1, 8, 520, 64, 8), (1, 2, 2, 32, 2),
                   (65, 2, 2, 96, 2), (129, 4, 2, 64, 2), (2, 7, 7, 192, 2), (5, 33, 17, 160, 2),
                   (4, 40, 40, 64, 8), (4, 80, 80, 64, 8), (4, 120, 120, 64, 8))
HRNET_F32_TOL = 1e-3


def log(msg: str = "") -> None:
    print(msg, flush=True)


def run_cmd(cmd: list[str]) -> str:
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (r.stdout.strip() or r.stderr.strip()) if r.returncode == 0 else \
        f"failed ({r.returncode}): {r.stderr.strip()}"


def max_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max |want|), in f32."""
    g, w = got.float(), want.float()
    return (g - w).abs().max().item(), w.abs().max().item()


def plain_kernels(*modules, plain: bool = True):
    """The bench's context manager, which swaps K1 in the FusedBlocks of
    ``modules`` and K2 and K3 everywhere for their plain versions; nothing where
    ``plain`` is false."""
    from representationlearning_tpu_torch.bench import plain_kernels as swap

    return swap(*modules) if plain else contextlib.nullcontext()


def calm(torch, module, gen) -> None:
    """Random weights a deep model can be checked with: the module's own
    initialisation, plus noise on every bias, norm affine and BatchNorm statistic
    (so their wiring shows), BatchNorm scales around 0.5 (so the residual stream
    of some forty blocks stays of order 1) and a classifier whose logits are of
    order 1 (its fan-out initialisation gives a one-hot softmax)."""
    from torch import nn

    def noise(t, scale):
        return (scale * torch.randn(t.shape, generator=gen)).to(t.device)

    head = getattr(module, "head", None)

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.mul_(0.5).add_(noise(m.weight, 0.05))
                m.running_mean.add_(noise(m.running_mean, 0.1))
                m.running_var.copy_((0.75 + 0.5 * torch.rand(m.running_var.shape, generator=gen))
                                    .to(m.running_var.device))
            elif isinstance(m, nn.LayerNorm):
                m.weight.add_(noise(m.weight, 0.1))
            if getattr(m, "bias", None) is not None:
                m.bias.add_(noise(m.bias, 0.1))
        if isinstance(head, nn.Sequential):   # HRNetFusion's; the zoo's heads stay
            head[0].weight.mul_(0.1)


def set_rss_flags(model, fused_mlp: bool, fused_attn: bool) -> None:
    """Switch every MlpDWBN between K5 and its convolutions, and every Mhca
    between K6 and its plain attention core; the parameters are the same."""
    from representationlearning_tpu_torch.models.rssformer_modules import Mhca, MlpDWBN

    for m in model.modules():
        if isinstance(m, MlpDWBN):
            m.fused = fused_mlp
        elif isinstance(m, Mhca):
            m.fused = fused_attn


def isa_trap_move(ti, q, k, want, nh: int, dtype) -> tuple[bool, float]:
    """(every entry of every M_h is negative, how far the K6 output `want` would
    move if the gate's max also took a padded entry of 0)."""
    NW, T, C = q.shape
    hd = C // nh
    m = ti.mm(q.reshape(NW, T, nh, hd).transpose(1, 2).transpose(-1, -2),
              k.reshape(NW, T, nh, hd).transpose(1, 2), dtype)
    s, mx = m.sum(dim=(-2, -1)) / (hd * hd), m.amax(dim=(-2, -1))
    ratio = (s + mx.clamp(min=0.0)).sigmoid() / (s + mx).sigmoid()   # (NW, nh)
    moved = want.reshape(NW, T, nh, hd) * (ratio - 1.0)[:, None, :, None]
    return bool((m < 0).all()), moved.abs().max().item()


def shape_of(args) -> str:
    """M x Nout x K of a `linear` call's positional arguments (a, w, ...)."""
    a, w = args[0], args[1]
    return f"{a.numel() // a.shape[-1]}x{w.shape[0]}x{w.shape[1]}"


def nbytes(*objs) -> int:
    """Bytes of every tensor among objs (tuples, lists and dict values opened)."""
    total = 0
    for o in objs:
        if isinstance(o, (tuple, list)):
            total += nbytes(*o)
        elif isinstance(o, dict):
            total += nbytes(*o.values())
        elif hasattr(o, "data_ptr"):
            total += o.numel() * o.element_size()
    return total


def k1_flops(name: str, a: tuple, kw: dict) -> tuple[float, float]:
    """(operations, the card's peak rate for them) of one K1 kernel call, from
    its arguments' shapes."""
    if name == "ln_stats":  # sum and sum of squares: 3 per element
        return 3.0 * a[0].numel(), PEAK_F32
    if name == "linear":  # (M, K) @ (K, Nout)
        n_out, k = a[1].shape
        return 2.0 * (a[0].numel() // k) * n_out * k, PEAK_BF16
    if name == "sr_conv":  # (B * Nk, sr * sr * C) @ (sr * sr * C, C)
        b, _, c = a[0].shape
        sr = kw["sr"]
        return 2.0 * b * (kw["H"] // sr) * (kw["W"] // sr) * c * sr * sr * c, PEAK_BF16
    if name == "attention":  # q k^T and p v: 2 * 2 * B * N * Nk * C
        b, n, c = a[0].shape
        return 4.0 * b * n * a[1].shape[1] * c, PEAK_BF16
    if name == "dwconv_gelu":  # 9 multiply-adds, bias, and about 20 for the GELU
        return 40.0 * a[0].numel(), PEAK_F32
    raise KeyError(name)


def dwconv_plans(tmb) -> list[tuple[int, int]]:
    """Every run of columns of the depthwise conv kernel, walking 1, 2, 3, 8 and 16
    rows."""
    return [(c, r) for c in tmb.DWCONV_COLUMNS for r in (1, 2, 3, 8, 16)]


def fc1_plans(tm, cin: int) -> list[tuple[int, int]]:
    """Every warp count of the bf16 fc1 kernel that fits at this width, walking 1, 2 and 3
    steps a block."""
    return [(w, per) for w in (1, 2, 4, 8) for per in (1, 2, 3) if tm.fc1_fits(cin, w)]


def fc1_f32_plans(tm, M: int, cin: int, hid: int) -> list[tuple[int, int]]:
    """Every tile of hidden features of the f32 fc1 kernel at this width, with 1, 3 and
    132 blocks, and the plan's own."""
    import torch

    f32 = torch.float32
    return sorted({(t, n) for t in tm.fc1_f32_tiles(cin, hid) for n in (1, 3, 132)}
                  | {tm.fc1_plan(M, cin, hid, f32)})


def taps_plans(tm, B: int, H: int, W: int, hid: int = 128, dtype=None) -> list[tuple[int, int]]:
    """Every tile of the taps kernel at this width and operand type (bf16 where none is
    given), with one block, three, and one wave of the blocks the card holds (or one a
    tile where there are fewer tiles)."""
    import torch

    dtype = torch.bfloat16 if dtype is None else dtype
    M = B * H * W
    return [(tile, blocks) for tile in tm.taps_tiles(hid, dtype)
            for blocks in sorted({1, 3, max(1, min(-(-M // tile), tm.taps_blocks_per_sm(
                tile, hid, dtype) * tm.TAPS_SMS))})]


def linear_plans(tmb, M: int, Nout: int, K: int, dtype) -> list:
    """Every tile of the linear kernel for this operand type: bf16 walking one and two M
    tiles a block; f32 with one persistent block, three, and the plan's count."""
    import torch

    if dtype == torch.float32:
        n = tmb.linear_plan(M, Nout, K, dtype)[1]
        return [(tile, b) for tile in tmb.linear_tiles(dtype) for b in sorted({1, 3, n})]
    return [(tile, per) for tile in tmb.LINEAR_TILES for per in (1, 2)]


def sr_conv_plans(tmb, M: int, C: int, K: int) -> list:
    """Every plan of the sr conv kernel with f32 operands at this shape: 64 and 128 rows a
    tile, at the plan's columns and the widest (`sr_conv_columns`), every number of K slices
    a cluster holds. Each cuts K its own way, so each adds in another order: it is held to
    the plain version, not to the others' bits."""
    import torch

    f32 = torch.float32
    widths = sorted({tmb.sr_conv_plan(M, C, K, f32)[0][1], tmb.sr_conv_columns(C)})
    return [((rows, cols), s) for rows in tmb.SR_WG_ROWS for cols in widths
            for s in tmb.sr_conv_slice_counts(K, f32)]


def attention_plans(tmb, B: int, N: int, Nk: int, C: int, nh: int) -> list[tuple[int, int]]:
    """Every plan of the attention kernel with f32 operands: 64 and 128 queries a block,
    with one persistent block, three, and the plan's count."""
    import torch

    n = tmb.attention_plan(B, N, Nk, C, nh, torch.float32)[1]
    return [(q, b) for q in tmb.ATTN_WG_QUERIES for b in sorted({1, 3, n})]


def varm_plans(tv, B: int, C: int, H: int, W: int, dilations) -> list[tuple[int, int, int]]:
    """Every K3 kernel that takes the shapes, with one block, three, and one wave of the
    blocks the card holds (or one a step where there are fewer steps)."""
    plans = []
    for k in sorted(tv.VARM_KERNELS):
        if tv.varm_takes(H, W, tuple(dilations), *k):
            smem = tv.varm_geometry(H, W, tuple(dilations), *k)[2]
            wave = min(tv.varm_units(B, C, H, W, *k), tv.varm_blocks_per_sm(*k, smem) * tv.SMS)
            plans += [(*k, blocks) for blocks in sorted({1, 3, max(1, wave)})]
    return plans


def affinity_plans(ta, H: int, W: int, dilations, mode: str) -> list[tuple[int, int]]:
    """Every K2 kernel that takes the shapes."""
    return [k for k in sorted(ta.AFFINITY_KERNELS)
            if ta.affinity_takes(H, W, tuple(dilations), mode, *k)]


def bwd_plans(tf, BH: int, Nq: int, Nk: int, D: int, dtype) -> list[tuple[int, int]]:
    """K4 backward's plans worth checking: every tile height with one share (no bh cut),
    two, seven and one tile a share, and `bwd_plan`'s own for an H100."""
    plans = {tf.bwd_plan(BH, Nq, Nk, D, dtype)}
    for rows in tf.BWD_ROWS:
        tiles = -(-Nq // rows)
        plans |= {(rows, s) for s in (1, 2, 7, tiles) if s <= tiles}
    return sorted(plans)


def pseudo_batch(torch, gen, device):
    """A training batch as the SCD loader gives it: normalised images whose
    denormalised values look like rand * 255, 1-3 present classes per image,
    and on every other image a box that leaves a zero-padded border."""
    import torch.nn.functional as F
    mean = torch.tensor([123.675, 116.28, 103.53])[None, :, None, None]
    std = torch.tensor([58.395, 57.12, 57.375])[None, :, None, None]
    coarse = torch.rand((BATCH, 3, CROP // 32, CROP // 32), generator=gen)
    raw = F.interpolate(coarse, size=(CROP, CROP), mode="bilinear", align_corners=False)
    raw = (0.75 * raw + 0.25 * torch.rand((BATCH, 3, CROP, CROP), generator=gen)) * 255.0
    x = (raw - mean) / std
    cls = torch.zeros((BATCH, NUM_CLASSES - 1))
    box = torch.tensor([[0, CROP, 0, CROP]] * BATCH)
    for i in range(BATCH):
        n = 1 + i % 3
        cls[i, torch.randperm(NUM_CLASSES - 1, generator=gen)[:n]] = 1.0
        if i % 2:
            y0, y1, x1 = 8 * i, CROP - 4 * i, CROP - 16 * i
            box[i] = torch.tensor([y0, y1, 0, x1])
            keep = torch.zeros((1, CROP, CROP), dtype=torch.bool)
            keep[:, y0:y1, :x1] = True
            x[i] = torch.where(keep, x[i], torch.zeros(()))
    return x.to(device), cls.to(device), box.to(device)


def rml_batch(torch, gen, device):
    """The raw batch of bench.py::bench_rml_train: uniform uint8 noise on the
    canvases, every image 375 x 500, and VOC-like labels (1, 2 or 3 present
    classes with p = 0.7 / 0.2 / 0.1, `bench.py::_voc_like_labels`)."""
    raw = torch.randint(0, 256, (RML_BATCH, 3, RML_CANVAS, RML_CANVAS), generator=gen,
                        dtype=torch.uint8)
    hw = torch.tensor([RML_HW] * RML_BATCH, dtype=torch.int32)
    cls = torch.zeros((RML_BATCH, NUM_CLASSES - 1))
    for i in range(RML_BATCH):
        k = 1 + int(torch.multinomial(torch.tensor([0.7, 0.2, 0.1]), 1, generator=gen))
        cls[i, torch.randperm(NUM_CLASSES - 1, generator=gen)[:k]] = 1.0
    return {"raw": raw.to(device), "hw": hw.to(device), "cls_label": cls.to(device)}


def rss_batch(torch, device):
    """The batch of bench.py::bench_rssformer_train, drawn as it draws it: from
    numpy's default_rng(0), standard normal images, then masks in [-1, 7)."""
    import numpy as np

    rng = np.random.default_rng(0)
    images = rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    masks = rng.integers(-1, RSS_CLASSES, (BATCH, IMAGE, IMAGE))
    return {"image": torch.from_numpy(images.transpose(0, 3, 1, 2).copy()).to(device),
            "mask": torch.from_numpy(masks).to(device)}


def voc_image(torch, gen, H: int, W: int, n_discs: int):
    """A VOC-like image: smooth colour fields, one disc of flat colour per present
    class, mild noise. Returns (image (3, H, W) in [0, 255], the same normalised,
    the discs' centres)."""
    import torch.nn.functional as F
    mean = torch.tensor([123.675, 116.28, 103.53])[:, None, None]
    std = torch.tensor([58.395, 57.12, 57.375])[:, None, None]
    coarse = torch.rand((1, 3, 4, 6), generator=gen)
    img = F.interpolate(coarse, size=(H, W), mode="bilinear", align_corners=False)[0] * 160 + 40
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    r, centres = min(H, W) // 5, []
    for _ in range(n_discs):
        cy = int(torch.randint(r, H - r, (1,), generator=gen))
        cx = int(torch.randint(r, W - r, (1,), generator=gen))
        img[:, (yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = torch.rand((3, 1), generator=gen) * 255
        centres.append((cy, cx))
    img = (img + 6 * torch.randn(img.shape, generator=gen)).clamp(0, 255)
    return img, (img - mean) / std, centres


def structured_classifier(torch, net, im, classes, centres) -> None:
    """A random classifier's CAMs are negative everywhere (the features are ReLU'd),
    so every pseudo label would be background. Each present class's weight becomes
    the feature at its disc's centre, less the image's mean feature and made
    orthogonal to it: its CAM is centred at 0 and high where the image looks like
    its disc."""
    with torch.no_grad():
        f = net.features(im[None])[0]                 # (2048, h, w)
        m = f.mean(dim=(1, 2))
        for c, (y, x) in zip(classes, centres):
            w = f[:, min(y // net.stride, f.shape[1] - 1), min(x // net.stride, f.shape[2] - 1)]
            w = w - m
            w = w - (w @ m) / (m @ m) * m
            net.classifier.weight[c, :, 0, 0] = w / w.norm()


def drfl_card_vs_cpu(torch, dev, seed: int) -> dict:
    """DRFL at DRFL_SMALL², one ViT layer, batch 2 of the synthetic source: the
    eval forward's five outputs and one train step (its three losses and each
    top-level module's gradient norm) on ``dev`` and on the CPU in f32, and on
    the CPU in f64 as the reference, all from the same weights, the dropout masks
    drawn once on the host (the f64 run draws them in its order of calls, the
    others replay them); and on ``dev`` in f64, which must give the reference to
    f64 rounding. The f32 steps go through ``make_drfl_train_step``, the f64 ones
    through ``drfl_losses`` and a backward. Returns {"eval": {output: {"card_cpu":
    max |card - cpu|, "top": max |f64|, run: max |run - f64|}}, "losses": {run:
    {name: value}}, "norms": {run: {module: norm}}} over the runs "f64", "cpu",
    "card" and "card64"."""
    from representationlearning_tpu_torch.data.medical import DRFLPairedDataset, collate_drfl
    from representationlearning_tpu_torch.models import dcl
    from representationlearning_tpu_torch.train import drfl as TT

    cpu = torch.device("cpu")
    side = DRFL_SMALL
    ds = DRFLPairedDataset(crop_size=side, synthetic_n=2, synthetic_size=side)
    batch = collate_drfl([ds[0], ds[1]])
    base = dcl.Softnet(3, 1, side, generator=torch.Generator().manual_seed(seed), device=cpu)
    runs = {"f64": (cpu, torch.float64), "cpu": (cpu, torch.float32), "card": (dev, torch.float32),
            "card64": (dev, torch.float64)}
    models = {}
    for name, (d, dtype) in runs.items():
        models[name] = dcl.Softnet(3, 1, side, device=d).to(dtype)
        models[name].load_state_dict(base.state_dict())
    masks, gen = [], torch.Generator().manual_seed(seed + 1)
    plain = dcl.dropout

    def draw(x, rate, training, generator=None):
        if rate == 0.0 or not training:
            return x
        masks.append(torch.rand(x.shape, generator=gen) >= rate)
        return torch.where(masks[-1].to(x.device), x / (1.0 - rate), torch.zeros_like(x))

    def replay(x, rate, training, generator=None):
        if rate == 0.0 or not training:
            return x
        return torch.where(next(left).to(x.device), x / (1.0 - rate), torch.zeros_like(x))

    outs, losses, norms = {}, {}, {}
    try:
        for name, (d, dtype) in runs.items():
            m = models[name]
            b = {k: v.to(dtype) for k, v in TT.drfl_batch(batch, d).items()}
            with torch.no_grad():
                outs[name] = [o.cpu().double() for o in m.eval()(b["A"])]
            left = iter(masks)
            dcl.dropout = draw if name == "f64" else replay
            sums = norms[name] = {}

            def record(m=m, sums=sums):
                for n, p in m.named_parameters():
                    top = n.split(".")[0]
                    sums[top] = sums.get(top, 0.0) + float(p.grad.double().pow(2).sum())

            if dtype == torch.float64:   # make_drfl_train_step's batch is f32
                m.train()
                total, parts = TT.drfl_losses(m, b)
                total.backward()
                record()
                metrics = {**parts, "total": total}
            else:
                state = TT.create_drfl_state(m, TT.DRFLConfig(), 1)
                state.tx.optimizer.register_step_pre_hook(lambda *a, r=record: r())
                _, metrics = TT.make_drfl_train_step(m, device=d)(state, batch)
            losses[name] = {k: float(v.detach()) for k, v in metrics.items()}
    finally:
        dcl.dropout = plain
    res = {"eval": {}, "losses": losses,
           "norms": {n: {k: v ** 0.5 for k, v in sums.items()} for n, sums in norms.items()}}
    for i, name in enumerate(("out", "out2", "bin", "d5_a", "d5sr_a")):
        o = {n: outs[n][i] for n in runs}
        res["eval"][name] = {"card_cpu": float((o["card"] - o["cpu"]).abs().max()),
                             "top": float(o["f64"].abs().max()),
                             **{n: float((o[n] - o["f64"]).abs().max()) for n in runs}}
    return res


def drfl_agreement(res: dict) -> list[tuple[bool, str]]:
    """``drfl_card_vs_cpu``'s result held to its bounds, as (ok, message): in f64
    the card equals the CPU to DRFL_F64_TOL (the same function); in f32 the eval
    outputs, the losses and the module gradient norms, card against CPU, within
    their tolerance or DRFL_ROUNDING times the CPU's own f32 error (the largest
    of the group's, against the f64 run), whichever is larger."""
    checks = []
    scale = max(e["cpu"] / e["top"] for e in res["eval"].values())
    for name, e in res["eval"].items():
        bound = max(DRFL_EVAL_TOL, DRFL_ROUNDING * scale) * e["top"]
        checks.append((e["card_cpu"] <= bound and e["card64"] <= DRFL_F64_TOL * e["top"],
                       f"{DRFL_SMALL}², eval {name} (largest {e['top']:.3e}): f32 card against the "
                       f"CPU {e['card_cpu']:.3e} (bound {bound:.3e}); against the CPU's f64 run: "
                       f"card {e['card']:.3e}, CPU {e['cpu']:.3e}, card in f64 {e['card64']:.3e} "
                       f"(tol {DRFL_F64_TOL:.0e} of the largest)"))
    for what, tol in (("losses", DRFL_LOSS_TOL), ("norms", DRFL_NORM_TOL)):
        v = res[what]

        def rel(run, k):
            return abs(v[run][k] / v["f64"][k] - 1.0)

        scale = max(rel("cpu", k) for k in v["f64"])
        bound = max(tol, DRFL_ROUNDING * scale)
        card_cpu = {k: abs(v["card"][k] / v["cpu"][k] - 1.0) for k in v["f64"]}
        worst = max(card_cpu, key=card_cpu.get)
        rel64 = max(rel("card64", k) for k in v["f64"])
        checks.append((max(card_cpu.values()) <= bound and rel64 <= DRFL_F64_TOL
                       and len(card_cpu) == (4 if what == "losses" else 15),
                       f"{DRFL_SMALL}², one step's {what} ({len(card_cpu)}), card against the CPU, "
                       f"the same masks: worst {worst} {card_cpu[worst]:.2e} relative in f32 "
                       f"(bound {bound:.2e}: tol {tol:.0e}, or {DRFL_ROUNDING} x the CPU's largest "
                       f"error against f64, {scale:.2e}; the card's largest "
                       f"{max(rel('card', k) for k in v['f64']):.2e}); in f64 the card within "
                       f"{rel64:.2e} (tol {DRFL_F64_TOL:.0e})"))
    return checks


def read_palette_png(torch, path) -> "torch.Tensor":
    """The (H, W) uint8 indices of an 8-bit palette PNG whose rows carry filter 0
    (``utils/events.py::write_png_palette``), read with zlib alone."""
    data, pos, chunks = Path(path).read_bytes(), 8, {}
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        chunks[data[pos + 4:pos + 8]] = chunks.get(data[pos + 4:pos + 8], b"") + data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h = (int.from_bytes(chunks[b"IHDR"][i:i + 4], "big") for i in (0, 4))
    if chunks[b"IHDR"][8:10] != bytes([8, 3]) or b"PLTE" not in chunks:
        raise ValueError(f"{path}: not an 8-bit palette PNG")
    rows = torch.frombuffer(bytearray(zlib.decompress(chunks[b"IDAT"])), dtype=torch.uint8)
    return rows.view(h, w + 1)[:, 1:]


def dp_wsss_argv(yaml: str, work_key: str, wd: Path, per_rank: int, steps: int) -> list[str]:
    """Phase 7k's WSSS command line: the yaml as it is, on-card augmentation of WSSS_N
    synthetic images, the iteration counts cut, ``per_rank`` samples a rank."""
    return ["--config", str(ROOT / "configs" / yaml), "dataset.device_augment=true",
            f"dataset.synthetic_n={WSSS_N}", "train.log_iters=1", f"train.cam_iters={DP_CAM_ITERS}",
            f"train.max_iters={steps}", f"train.eval_iters={DP_SCD_EVAL}",
            f"train.samples_per_gpu={per_rank}", f"{work_key}={wd}"]


def dp_rss_argv(wd: Path) -> list[str]:
    """Phase 7k's RSSFormer command line: configs/rssformer_loveda.yaml's global batch of
    8 x 512² with the LoveDA chain on the card, DP_RSS_STEPS steps."""
    return ["train", "--config", str(ROOT / "configs" / "rssformer_loveda.yaml"),
            "data.device_augment=true", "train.log_interval_step=1",
            f"train.eval_interval={DP_RSS_STEPS}", f"train.num_iters={DP_RSS_STEPS}",
            f"work_dir={wd}"]


def rss_group(name: str) -> str:
    """An HRNetFusion parameter's group: stem, layer1, each transition and stage, neck,
    head, headaux (tests/test_torch_train_rssformer.py's)."""
    import re

    part = name.split(".")
    if part[0] != "backbone":
        return part[0]
    return part[2] if re.fullmatch(r"layer1|stage\d|transition\d", part[2]) else "stem"


def _union_us(spans) -> float:
    """µs covered by the union of (start, end) spans."""
    total, hi = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > hi:
            total += b - max(a, hi)
            hi = b
    return total


def step_breakdown(torch, fn) -> dict:
    """Where one call of ``fn`` (a train step) spends its time, from a
    ``torch.profiler`` trace (CPU and CUDA): its wall ms under the profiler; the
    device's busy ms (the union of its kernels, copies and fills); the gloo
    all-reduces (``c10d::allreduce_`` calls, and the union of the ``gloo:all_reduce``
    spans in ms: the host waits on each, a CUDA tensor's copy to the host first
    waiting for the kernels before it); and the ms of the step's forward, backward
    and optimizer ranges."""
    from torch.profiler import ProfilerActivity, profile

    from representationlearning_tpu_torch.bench import device_busy

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    busy_us, n_dev = device_busy(events)
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == "gloo:all_reduce" and "dur" in e]
    ranges = {name: sum(e["dur"] for e in events if e.get("cat") == "user_annotation"
                        and e.get("name") == name) / 1e3
              for name in ("forward", "backward", "optimizer")}
    return {"wall_ms": wall, "device_busy_ms": busy_us / 1e3, "device_events": n_dev,
            "allreduces": sum(e.get("name") == "c10d::allreduce_" for e in events),
            "allreduce_ms": _union_us(spans) / 1e3, **{f"{k}_ms": v for k, v in ranges.items()}}


def dp_rank(rank: int, world: int, seed: int, tmp: str) -> dict:
    """Phase 7k on one of the gloo ranks that share the card (the target of
    ``parallel/launch.py::spawn_ranks``): what it printed, its failed checks and its
    results. The kernels were built by the parent; the rank loads them."""
    import torch

    from representationlearning_tpu_torch.ops import affinity as ta
    from representationlearning_tpu_torch.ops import attention as tf
    from representationlearning_tpu_torch.ops import isa_attention as ti
    from representationlearning_tpu_torch.ops import mit_block as tmb
    from representationlearning_tpu_torch.ops import mlp_dwbn as tm
    from representationlearning_tpu_torch.ops import varm as tv

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ph = Phases(torch, seed)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            out = ph.dp_rank_work(rank, world, (tmb, ta, tv, tf, tm, ti), Path(tmp))
        except Exception:  # noqa: BLE001 -- reported to the parent as a failed check
            traceback.print_exc(file=buf)
            ph.failures.append("raised")
            out = {}
    return {**out, "log": buf.getvalue(), "failures": ph.failures}


class Phases:
    def __init__(self, torch, seed: int):
        self.torch = torch
        self.seed = seed
        self.dev = torch.device("cuda", 0)
        self.failures: list[str] = []
        self.piece_err: dict[str, float] = {}
        self.piece_ms: dict[str, float] = {}
        self.piece_plain_ms: dict[str, float] = {}
        self.piece_library_ms: dict[str, float | None] = {}
        self.library_covers: dict[str, str] = {}
        # least time of each kernel's work, split into its two sides: [bytes, operations]
        self.piece_bound: dict[str, list[float]] = {}
        self.launches: dict[str, int] = {}          # in the path that owns the kernel
        self.launches_pseudo: dict[str, int] = {}   # K1's, in the pseudo-label call
        self.launches_train: dict[str, int] = {}    # every kernel's, in one train step
        self.launches_rml: dict[str, int] = {}      # every kernel's, in one RML train step
        # every kernel's in one RSSFormer train step with fused_attn, and in evaluate()
        self.launches_rss_train: dict[str, int] = {}
        self.launches_rss_eval: dict[str, int] = {}
        self.launches_rss_step: dict[str, int] = {}   # the bench's step: no fused_attn
        self.launches_wsss: dict[str, int] = {}   # every kernel's, in a step of cli.train_scd
        # every kernel's in a step of cli.rssformer train, and in its eval --tta and predict
        self.launches_rss_cli_step: dict[str, int] = {}
        self.launches_rss_cli: dict[str, dict[str, int]] = {}
        self.launches_wetr: dict[str, int] = {}   # K1's, in one WeTrBaseline forward
        # phase 7k: every kernel's in a data-parallel SCD step of one rank, and K5 / K6's in
        # one rank's part of the sharded sliding window
        self.launches_dp: dict[str, dict[str, int]] = {}
        self.plain_runs = 0   # phase 7f's comparisons with a plain version so far
        self.holding = False  # phase 7f: compare each new geometry's call with its plain version
        self.plain_path = None   # phase 7f: a context in which K1-K3 run their plain versions
        # phase 7l: each K1 / K5 piece with f32 operands {ms, bound [bytes, operations], lib,
        # err}; K5's figures at each width; K1's launches in the f32 TSCD forward, K5's and
        # K6's in an f32 HRNetFusion forward
        self.f32: dict[str, dict] = {}
        self.k5_widths: dict[str, dict] = {}
        self.k6_f32: dict[str, dict] = {}
        self.launches_f32: dict[str, int] = {}
        self.launches_hrnet_f32: dict[str, int] = {}
        self.refine_inputs = None
        # the 8 blocks of a headline forward, each as ONE function: least time
        # [bytes, operations], and the time the five kernels take for them
        self.block_bound = [0.0, 0.0]
        self.block_ms = 0.0
        # `attention` a headline forward, split: the launches that export the logits
        # and those that do not (the only ones the library call covers)
        self.attn_split = {k: {"launches": 0, "ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
                           for k in ("no_export", "export")}
        # `dwconv_gelu`: every plan and a rerun gave equal bits at every geometry so far;
        # the bf16 library call a headline forward
        self.dwconv_plans_same = True
        self.dwconv_library_bf16_ms = 0.0
        # the one stream every CUDA graph is captured on: cuBLAS keeps a workspace of its
        # own for each stream it has run on, which would stay allocated for the whole run
        self.capture_stream = None

    def add_bound(self, name: str, n_bytes: float, flops: float, peak: float,
                  times: int = 1) -> None:
        """Add one call's bound: bytes over the memory rate or operations over
        their peak rate, whichever is larger."""
        t_bytes, t_ops = 1e3 * n_bytes / PEAK_BYTES, 1e3 * flops / peak
        side = self.piece_bound.setdefault(name, [0.0, 0.0])
        side[0 if t_bytes >= t_ops else 1] += times * max(t_bytes, t_ops)

    def check(self, ok: bool, what: str) -> None:
        log(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.failures.append(what)

    def time_ms(self, fn, iters: int, warmup: int = 2) -> float:
        """Mean device time of fn() over iters launches, by CUDA events, after warm-up."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def event_median_ms(self, fn, iters: int, warmup: int = 2) -> float:
        """Median device time of fn() over iters calls, each between two CUDA
        events, after warm-up."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        torch.cuda.synchronize()
        for start, end in events:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)

    def graph_ms(self, fn, iters: int = 10, reps: int = 3) -> float:
        """Mean device time of fn(): `iters` calls captured in one CUDA graph, replayed
        `reps` times. The host's time to launch, which exceeds the device time of the
        port's smallest kernels, does not count."""
        torch = self.torch
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        if self.capture_stream is None:
            self.capture_stream = torch.cuda.Stream()
        stream = self.capture_stream
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            fn()
            with torch.cuda.graph(graph, stream=stream):
                for _ in range(iters):
                    fn()
        torch.cuda.synchronize()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (iters * reps)

    # ------------------------------------------------------------- phase 1
    def environment(self, nvcc: str) -> str:
        torch = self.torch
        log("== environment")
        log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")
        log(f"  nvcc: {run_cmd([nvcc, '--version']).splitlines()[-1]}")
        name = torch.cuda.get_device_name(0)
        log(f"  device: {name}, count {torch.cuda.device_count()}")
        card = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"])
        log("  card name and power limit (nvidia-smi):")
        log(card)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log("  TF32 off for matmul and cuDNN: the plain versions multiply in full f32")
        return card.splitlines()[0] if card else name

    # ------------------------------------------------------------- phase 2
    def build(self, _build) -> None:
        log("== build")
        t0 = time.perf_counter()
        names = sorted(_build.SIGNATURES)
        _build.build_all()  # one nvcc per source, all at once
        for name in names:
            _build.load_library(name)
        log(f"  {', '.join(names)}: {time.perf_counter() - t0:.1f} s")
        for name in names:
            info = _build.build_log[name]
            log(f"  {name} -> {info['path']}")
            for line in info["ptxas"].splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log(f"  ptxas: {line.strip()}")

    # ------------------------------------------------------------- phase 3
    def _block_params(self, C, nh, sr, export, gen):
        """A FusedBlock's parameters from the seed: the model's initialisation
        plus noise on every bias and LayerNorm affine, so their wiring shows."""
        torch = self.torch
        from representationlearning_tpu_torch.models.layers import init_weights
        from representationlearning_tpu_torch.models.mit import FusedBlock

        blk = FusedBlock(C, nh, 4.0, sr, export_attn=export, dtype=torch.bfloat16).eval()
        init_weights(blk, gen)
        with torch.no_grad():
            for name, t in blk.named_parameters():
                if name.endswith("bias") or name.startswith(("norm", "attn.norm")):
                    t.add_(0.1 * torch.randn(t.shape, generator=gen))
        return {k: v.detach().to(self.dev) for k, v in blk.kernel_params().items()}

    def _library_call(self, name, a, kw, dtype=None):
        """One PyTorch call that computes what a K1 kernel call computes, on the
        same inputs cast to `dtype` (bf16 unless given) beforehand; None where there
        is none. A yardstick only: nothing in the port calls these."""
        torch = self.torch
        import torch.nn.functional as F
        dt = dtype or torch.bfloat16
        if name == "linear":
            x, w, bias = a[0].to(dt), a[1], a[2].to(dt)
            return lambda: F.linear(x, w, bias)
        if name == "ln_stats":  # the mean and the variance, without the reciprocal root
            x = a[0]
            return lambda: torch.var_mean(x, -1, correction=0)
        if name == "dwconv_gelu":
            return self._dwconv_library(a, kw, torch.float32)
        if name == "sr_conv":
            x, stats, ln_w, ln_b, w_flat, bias = a
            B, _, C = x.shape
            H, W, sr = kw["H"], kw["W"], kw["sr"]
            h = ((x - stats[..., 0:1]) * stats[..., 1:2] * ln_w + ln_b).to(dt)
            h = h.reshape(B, H, W, C).permute(0, 3, 1, 2).contiguous()
            w = w_flat.reshape(C, sr, sr, C).permute(0, 3, 1, 2).contiguous()
            bias = bias.to(dt)
            return lambda: F.conv2d(h, w, bias, stride=sr)
        if name == "attention" and not kw.get("export") and a[1].shape[1]:
            q, kv = a
            B, N, C = q.shape
            nh = kw["nh"]

            def heads(t):  # (B, n, C) -> (B, nh, n, hd)
                return t.to(dt).reshape(B, -1, nh, C // nh).transpose(1, 2).contiguous()

            qh, kh, vh = heads(q), heads(kv[..., :C]), heads(kv[..., C:])
            return lambda: F.scaled_dot_product_attention(qh, kh, vh)
        return None

    def _dwconv_library(self, a, kw, dtype):
        """`F.conv2d(groups=hid, padding=1)` with its bias, without the GELU, on the
        same plane viewed as channels-last NCHW (no copy), in `dtype`."""
        torch = self.torch
        import torch.nn.functional as F
        f, w, bias = a
        B, _, hid = f.shape
        x = f.to(dtype).reshape(B, kw["H"], kw["W"], hid).permute(0, 3, 1, 2)
        w, bias = w.to(dtype), bias.to(dtype)
        return lambda: F.conv2d(x, w, bias, padding=1, groups=hid)

    def kernels_vs_plain(self, tmb) -> None:
        """Each piece of K1 against its plain version on the inputs the kernel
        path gives it, then the whole block: at every stage geometry of the
        headline forward, timed, and at every geometry the pseudo-label call's
        three `[x; flip x]` forwards give the kernels, checked only."""
        torch = self.torch
        gen = torch.Generator().manual_seed(self.seed)
        for k in PIECE_TOL:
            self.piece_err[k] = 0.0
            self.piece_ms[k] = self.piece_plain_ms[k] = 0.0
        self.piece_library_ms.update(ln_stats=0.0, dwconv_gelu=0.0, linear=0.0,
                                     sr_conv=0.0, attention=0.0)
        self.library_covers.update(
            ln_stats="torch.var_mean over the features, f32: mean and variance of every row, "
                     "without the reciprocal square root",
            dwconv_gelu="F.conv2d on the f32 plane viewed channels-last, groups=hid, padding 1, "
                        "with the bias: every launch, without the GELU",
            linear="F.linear on bf16: the product and the bias of every launch, "
                   "without the LayerNorm prologue and the residual",
            sr_conv="F.conv2d on bf16, stride sr, on the normalised tokens: every launch, "
                    "without the LayerNorm prologue",
            attention="F.scaled_dot_product_attention on bf16: the launches that "
                      "export no logits (6 of 8)")
        log(f"== kernel vs plain (same inputs), headline forward: B = {BATCH}, "
            f"{IMAGE} x {IMAGE}, bf16 compute")
        for stage in STAGES:
            self._block_vs_plain(tmb, gen, BATCH, *stage, timed=True)
        self._redesigned_at_their_edges(tmb, gen)
        # the CAM forwards at the crop (the pseudo-label call and the train step)
        # and at 0.3 of it (the train step's second set): there the token grids
        # are no multiples of sr, so `sr_conv` drops rows and columns, and at the
        # smallest the attention sees one key
        for base in (CROP, int(0.3 * CROP)):
            for scale in CAM_SCALES:
                side = int(scale * base)
                log(f"== kernel vs plain (same inputs), CAM forward: B = {2 * BATCH}, "
                    f"{side} x {side}, bf16 compute")
                worst = max(self._block_vs_plain(tmb, gen, 2 * BATCH, *stage, timed=False)
                            for stage in cam_stages(side))
                log(f"  K1 at {side} x {side}: largest error {worst:.3f} of its tolerance")
        self.check(self.dwconv_plans_same,
                   f"dwconv_gelu: a rerun and every plan {dwconv_plans(tmb)} give equal bits at "
                   f"the headline's four and the CAM forwards' twenty-four geometries")

    def _redesigned_at_their_edges(self, tmb, gen) -> None:
        """`attention` around the largest key count of its one-pass form, with and
        without export, both head widths, query counts below one tile; `sr_conv` at
        every number of K slices a plan can hold, both tile widths; `linear` at the
        edges of its tiles and with every tile a plan can choose; each twice for
        equal bits; and what the three wrappers refuse."""
        torch = self.torch
        from representationlearning_tpu_torch.ops import _build
        bf16 = torch.bfloat16
        bound = tmb.ATTN_ONE_PASS_KEYS
        log(f"== attention at the edge of its one-pass form ({bound} keys), sr_conv at every "
            f"number of K slices, linear at the edges of its tiles")
        self.check(_build.load_library("mit_block").k1_attention_one_pass_keys() == bound,
                   f"the kernel's one-pass bound is the wrapper's ({bound})")

        def rand(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=gen)).to(self.dev)

        worst, same = 0.0, True
        for Nk in (bound - 1, bound, bound + 1):
            for (C, nh), N in ((64, 2), 9), ((64, 1), 36), ((128, 2), 36), ((32, 1), 9):
                q, kv = rand(2, N, C), rand(2, Nk, 2 * C)
                for export in (False, True):
                    got = tmb.attention(q, kv, nh=nh, export=export)
                    again = tmb.attention(q, kv, nh=nh, export=export)
                    torch.cuda.synchronize()
                    want = tmb.attention_reference(q, kv, nh=nh, dtype=bf16, export=export)
                    for i, tol in ((0, PIECE_TOL["attention"]), (1, LOGIT_TOL)):
                        if got[i] is None:
                            continue
                        err, mag = max_err(got[i], want[i])
                        worst = max(worst, err / (tol * max(1.0, mag)))
                        same = same and torch.equal(got[i], again[i])
                        self.piece_err["attention"] = max(self.piece_err["attention"],
                                                          err if i == 0 else 0.0)
        self.check(worst <= 1.0, f"attention at Nk = {bound - 1}, {bound}, {bound + 1}, head "
                                 f"widths 32 and 64, N = 9 and 36, with and without export: "
                                 f"largest error {worst:.3f} of its tolerance")
        self.check(same, "attention: two runs give equal bits (output and logits)")

        worst, same, tried = 0.0, True, []
        for H, C, sr in ((16, 64, 8), (9, 320, 2)):
            x = rand(2, H * H, C)
            args = (x, tmb.ln_stats_reference(x), rand(C) + 1.0, rand(C, scale=0.1),
                    rand(C, sr * sr * C, scale=0.05).to(bf16), rand(C))
            want = tmb.sr_conv_reference(*args, H=H, W=H, sr=sr)
            counts = tmb.sr_conv_slice_counts(sr * sr * C)
            tried.append(counts)
            for tile in (64, 128):
                for slices in counts:
                    got = tmb.sr_conv(*args, H=H, W=H, sr=sr, plan=(tile, slices))
                    again = tmb.sr_conv(*args, H=H, W=H, sr=sr, plan=(tile, slices))
                    torch.cuda.synchronize()
                    err, mag = max_err(got, want)
                    worst = max(worst, err / (PIECE_TOL["sr_conv"] * max(1.0, mag)))
                    same = same and torch.equal(got, again)
                    self.piece_err["sr_conv"] = max(self.piece_err["sr_conv"], err)
        self.check(worst <= 1.0, f"sr_conv with K cut into {tried[0]} slices (K = 4096) and "
                                 f"{tried[1]} (K = 1280), tiles 64 and 128: largest error "
                                 f"{worst:.3f} of its tolerance")
        self.check(same, "sr_conv: two runs give equal bits at every number of slices")

        lib = _build.load_library("mit_block")
        for f32, want_held in ((0, tmb.LINEAR_BLOCKS_PER_SM), (1, tmb.LINEAR_BLOCKS_PER_SM_F32)):
            tiles = tmb.linear_tiles(torch.float32 if f32 else bf16)
            held = [[lib.k1_linear_blocks_per_sm(t, ln, f32) for ln in (0, 1)]
                    for t in range(len(tiles))]
            self.check(all(h == [n, n] for h, n in zip(held, want_held)),
                       f"linear ({'f32' if f32 else 'bf16'} operands): blocks an SM holds of each "
                       f"tile {list(tiles)}, without and with the LayerNorm prologue, "
                       f"{held}, are the plan's {list(want_held)}")
        # `linear`: M of one row and of one tile of rows less or more one, Nout that no
        # column tile divides, K of one, two and 64 steps, LayerNorm and residual each on
        # and off; every tile the plan can choose, one and two M tiles a block
        worst, same, n = 0.0, True, 0
        rows = sorted({r for r, _ in tmb.LINEAR_TILES})
        ms = sorted({1} | {r + d for r in rows for d in (-1, 1)})
        for M in ms:
            for Nout in (96, 640, 1280):
                for K in (32, 64, 2048):
                    a, w = rand(M, K), rand(Nout, K, scale=0.05).to(bf16)
                    for ln in (False, True):
                        for res in (False, True):
                            kw = dict(bias=rand(Nout))
                            if ln:
                                kw.update(stats=tmb.ln_stats_reference(a), ln_w=rand(K) + 1.0,
                                          ln_b=rand(K, scale=0.1))
                            if res:
                                kw["residual"] = rand(M, Nout)
                            got = tmb.linear(a, w, **kw)
                            runs = [tmb.linear(a, w, **kw)]
                            runs += [tmb.linear(a, w, plan=(tile, per), **kw)
                                     for tile in tmb.LINEAR_TILES for per in (1, 2)]
                            torch.cuda.synchronize()
                            err, mag = max_err(got, tmb.linear_reference(a, w, **kw))
                            worst = max(worst, err / (PIECE_TOL["linear"] * max(1.0, mag)))
                            same = same and all(torch.equal(got, r) for r in runs)
                            self.piece_err["linear"] = max(self.piece_err["linear"], err)
                            n += 1
        self.check(worst <= 1.0, f"linear at M = {ms}, Nout = 96, 640, 1280, K = 32, 64, 2048, "
                                 f"LayerNorm and residual on and off ({n} cases): largest error "
                                 f"{worst:.3f} of its tolerance")
        self.check(same, f"linear: a second run and every tile {list(tmb.LINEAR_TILES)} "
                         f"walking 1 and 2 M tiles a block give equal bits")

        bad = lib.k1_gelu_as_mismatches()
        self.check(bad == 0, f"gelu_as (a refined reciprocal in place of the division, the "
                             f"sign copied) differs from the formula with sign(x) and the IEEE "
                             f"division on {bad} of the 2^32 f32 inputs")
        # `dwconv_gelu`: grids of 1, 2, 3, 5 and 15 rows and columns, hid 4, 32, 96 and
        # 2048, batch 16; every plan and a rerun
        worst, same, n = 0.0, True, 0
        sides = (1, 2, 3, 5, 15)
        for hid in (4, 32, 96, 2048):
            w, b = rand(hid, 1, 3, 3, scale=0.3), rand(hid)
            for H in sides:
                for W in sides:
                    f = rand(16, H * W, hid)
                    got = tmb.dwconv_gelu(f, w, b, H=H, W=W)
                    runs = [tmb.dwconv_gelu(f, w, b, H=H, W=W)]
                    runs += [tmb.dwconv_gelu(f, w, b, H=H, W=W, plan=pl)
                             for pl in dwconv_plans(tmb)]
                    torch.cuda.synchronize()
                    err, mag = max_err(got, tmb.dwconv_gelu_reference(f, w, b, H=H, W=W))
                    worst = max(worst, err / (PIECE_TOL["dwconv_gelu"] * max(1.0, mag)))
                    same = same and all(torch.equal(got, r) for r in runs)
                    self.piece_err["dwconv_gelu"] = max(self.piece_err["dwconv_gelu"], err)
                    n += 1
        self.check(worst <= 1.0, f"dwconv_gelu at H, W in {sides}, hid 4, 32, 96, 2048, batch 16 "
                                 f"({n} cases): largest error {worst:.3f} of its tolerance")
        self.check(same, f"dwconv_gelu: a second run and every plan {dwconv_plans(tmb)} give "
                         f"equal bits at the edges")

        def raises(exc, fn) -> bool:
            try:
                fn()
            except exc:
                return True
            return False

        f, w, b = rand(2, 12, 36), rand(36, 1, 3, 3), rand(36)
        odd = rand(2 * 12 * 36 + 1)[1:].view(2, 12, 36)   # contiguous, 4 bytes off
        self.check(raises(ValueError, lambda: tmb.dwconv_gelu(f[..., :34].contiguous(), w[:34],
                                                              b[:34], H=3, W=4))
                   and raises(ValueError, lambda: tmb.dwconv_gelu(odd, w, b, H=3, W=4))
                   and raises(ValueError, lambda: tmb.dwconv_gelu(f, w, b, H=3, W=4, plan=(3, 4)))
                   and bool(torch.isfinite(tmb.dwconv_gelu(f, w, b, H=3, W=4)).all()),
                   "dwconv_gelu refuses hid % 4 != 0, data not 16-byte aligned and a column run "
                   "the kernel lacks, and goes on working")

        q, kv = rand(1, 8, 96), rand(1, 4, 192)
        x = rand(1, 16, 48)
        bad = (x, tmb.ln_stats_reference(x), rand(48), rand(48), rand(48, 192).to(bf16), rand(48))
        w_lin, b_lin, a_lin = rand(96, 64).to(bf16), rand(96), rand(8, 64)
        self.check(raises(ValueError, lambda: tmb.linear(x, rand(96, 48).to(bf16), b_lin))
                   and raises(ValueError, lambda: tmb.linear(a_lin, w_lin, b_lin,
                                                             plan=((64, 96), 1)))
                   and raises(ValueError, lambda: tmb.linear(a_lin, w_lin, b_lin,
                                                             plan=((64, 64), 0)))
                   and raises(ValueError, lambda: tmb.linear(a_lin, w_lin.float(), b_lin,
                                                             plan=((64, 128), 1),
                                                             dtype=torch.float32)),
                   "linear refuses K % 32 != 0, a tile the kernel lacks (bf16 (64, 96); with f32 "
                   "operands the bf16 kernel's (64, 128)) and no M tile a block")
        self.check(raises(NotImplementedError, lambda: tmb.attention(q, kv, nh=2))
                   and raises(ValueError, lambda: tmb.attention(q, kv[:, :, :96].contiguous(), nh=3))
                   and raises(ValueError, lambda: tmb.sr_conv(*bad, H=4, W=4, sr=2))
                   and raises(RuntimeError, lambda: tmb.sr_conv(*args, H=9, W=9, sr=2, plan=(64, 41)))
                   and raises(RuntimeError, lambda: tmb.sr_conv(*args, H=9, W=9, sr=2, plan=(96, 2))),
                   "the wrappers refuse head width 48, a kv of the wrong width, C % 32 != 0, "
                   "more slices than K steps and a tile width the kernel lacks")

    def _block_vs_plain(self, tmb, gen, B, hw, C, nh, sr, export, *, timed: bool) -> float:
        """One block geometry: every kernel call of the block against its plain
        version, the kernel sequence against `fused_block`, the whole block
        against its plain version; with `timed`, the times and bounds too.
        Returns the largest error found as a share of its tolerance."""
        torch = self.torch
        names = list(PIECE_TOL)
        N = hw * hw
        at = f"B={B} N={N} C={C}"
        x = torch.randn(B, N, C, generator=gen).to(self.dev, torch.bfloat16)
        p = self._block_params(C, nh, sr, export, gen)
        calls: list[tuple[str, tuple, dict]] = []
        block_flops = 0.0  # tensor-core operations of the whole block
        worst = 0.0  # largest error / tolerance of this geometry

        def recording(name):
            def run(*a, **kw):
                nonlocal block_flops, worst
                got = getattr(tmb, name)(*a, **kw)
                want = getattr(tmb, name + "_reference")(*a, **kw)
                got_t = got if isinstance(got, tuple) else (got,)
                want_t = want if isinstance(want, tuple) else (want,)
                for i, (g, w) in enumerate(zip(got_t, want_t)):
                    if g is None and w is None:
                        continue
                    err, mag = max_err(g, w)
                    tol = (LOGIT_TOL if i == 1 else PIECE_TOL[name]) * max(1.0, mag)
                    what = f"{name}{' logits' if i == 1 else ''} @ {at} shape {tuple(g.shape)}"
                    self.check(bool(torch.isfinite(g.float()).all()) and err <= tol,
                               f"{what}: max abs err {err:.3e} "
                               f"(max |plain| {mag:.3e}, tol {tol:.3e})")
                    self.piece_err[name] = max(self.piece_err[name], err)
                    worst = max(worst, err / tol)
                if name == "dwconv_gelu":   # every plan, and a second run: equal bits
                    runs = [getattr(tmb, name)(*a, **kw)]
                    runs += [getattr(tmb, name)(*a, plan=pl, **kw) for pl in dwconv_plans(tmb)]
                    same = all(torch.equal(got, r) for r in runs)
                    self.dwconv_plans_same = self.dwconv_plans_same and same
                    if not same:
                        self.check(False, f"dwconv_gelu @ {at}: a rerun or a plan of "
                                          f"{dwconv_plans(tmb)} gives other bits")
                flops, peak = k1_flops(name, a, kw)
                if peak == PEAK_BF16:
                    block_flops += flops
                # the least time for this call: every argument read once, every
                # output written once, against its operations at their peak rate
                n_bytes = nbytes(a, kw, got)
                calls.append((name, a, kw, 1e3 * max(n_bytes / PEAK_BYTES, flops / peak)))
                if timed:
                    self.add_bound(name, n_bytes, flops, peak, times=DEPTH)
                return got
            return run

        ops = SimpleNamespace(**{n: recording(n) for n in names})
        kw = dict(H=hw, W=hw, sr=sr, nh=nh, dtype=torch.bfloat16, export=export)
        with torch.no_grad():
            res = tmb._block(x, p, ops=ops, **kw)
            torch.cuda.synchronize()
            got = tmb.fused_block(x, p, **kw)
            want = tmb.fused_block_reference(x, p, **kw)
            torch.cuda.synchronize()
        got_t = got if export else (got,)
        want_t = want if export else (want,)
        same = all(torch.equal(a, b) for a, b in zip(res if export else (res,), got_t))
        self.check(same, f"block @ {at}: fused_block = the recorded kernel sequence")
        for i, (g, w) in enumerate(zip(got_t, want_t)):
            err, mag = max_err(g, w)
            rel = ((g.float() - w.float()).norm() / w.float().norm()).item()
            tol = PATH_TOL * mag
            self.check(bool(torch.isfinite(g.float()).all()) and err <= tol,
                       f"whole block{' logits' if i else ''} @ {at} nh={nh} "
                       f"sr={sr}: max abs err {err:.3e} (max |plain| {mag:.3e}, "
                       f"tol {tol:.3e}), rel L2 {rel:.2e}")
            worst = max(worst, err / tol)
        if not timed:
            return worst
        # the whole block as one function: the tokens in and out in the stream's
        # dtype, the parameters, the exported logits; the intermediates that the
        # five kernels hand to each other through device memory are not counted
        t_bytes = 1e3 * nbytes(x, p, got) / PEAK_BYTES
        t_ops = 1e3 * block_flops / PEAK_BF16
        self.block_bound[0 if t_bytes >= t_ops else 1] += DEPTH * max(t_bytes, t_ops)
        # device time of every piece over its calls in one block, x DEPTH blocks; the
        # kernels and their library calls by graph replay: some of their launches take
        # less time on the device than the host takes to launch them
        lin = []  # the five `linear` launches of the block: (kernel, bound, library) ms
        for name, a, kw_, bound in calls:
            k_ms = self.graph_ms(lambda: getattr(tmb, name)(*a, **kw_))
            p_ms = self.time_ms(lambda: getattr(tmb, name + "_reference")(*a, **kw_),
                                iters=10)
            self.piece_ms[name] += DEPTH * k_ms
            self.piece_plain_ms[name] += DEPTH * p_ms
            lib_fn = self._library_call(name, a, kw_)
            lib_ms = None if lib_fn is None else self.graph_ms(lib_fn)
            if lib_ms is not None:
                self.piece_library_ms[name] += DEPTH * lib_ms
            if name == "linear":
                lin.append((k_ms, bound, lib_ms))
            if name in ("ln_stats", "linear"):
                continue
            if name == "dwconv_gelu":
                bf16_ms = self.graph_ms(self._dwconv_library(a, kw_, torch.bfloat16))
                self.dwconv_library_bf16_ms += DEPTH * bf16_ms
                log(f"  dwconv_gelu @ stage N={N} hid={4 * C}, plan (columns, rows) "
                    f"{tmb.dwconv_plan(B, hw, hw, 4 * C)}, a launch: kernel {k_ms:.4f} ms, bound "
                    f"{bound:.4f} ms, library call {lib_ms:.4f} ms (bf16 {bf16_ms:.4f} ms), "
                    f"plain {p_ms:.4f} ms")
                continue
            exporting = name == "attention" and export
            if name == "attention":
                part = self.attn_split["export" if exporting else "no_export"]
                part["launches"] += DEPTH
                part["ms"] += DEPTH * k_ms
                part["bound_ms"] += DEPTH * bound
                part["library_ms"] += DEPTH * (lib_ms or 0.0)
            extra = f", plan (tile, K slices) {tmb.sr_conv_plan(B * (hw // sr) ** 2, C, sr * sr * C)}" \
                if name == "sr_conv" else (", exporting" if exporting else "")
            log(f"  {name} @ stage N={N} Nk={(hw // sr) ** 2} C={C}{extra}, a launch: kernel "
                f"{k_ms:.4f} ms, bound {bound:.4f} ms, library call "
                f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, plain {p_ms:.4f} ms")
        log(f"  linear @ stage N={N} C={C}, its {len(lin)} launches (q, kv, proj, fc1, fc2): "
            f"kernel {' / '.join(f'{k:.4f}' for k, _, _ in lin)} ms, bound "
            f"{' / '.join(f'{b:.4f}' for _, b, _ in lin)} ms, library call "
            f"{' / '.join(f'{l:.4f}' for _, _, l in lin)} ms; in all {sum(k for k, _, _ in lin):.4f}, "
            f"{sum(b for _, b, _ in lin):.4f}, {sum(l for _, _, l in lin):.4f} ms a block")
        with torch.no_grad():
            blk_ms = self.time_ms(lambda: tmb.fused_block(x, p, **kw), iters=10)
            plain_ms = self.time_ms(lambda: tmb.fused_block_reference(x, p, **kw), iters=10)
        self.block_ms += DEPTH * blk_ms
        log(f"  K1 block @ stage N={N} C={C}: kernels {blk_ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms per block; bound of the block as one function "
            f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, operations {t_ops:.4f})")
        return worst

    # ------------------------------------------------------------- phase 3b
    def _refine_images(self, gen, B, H, W):
        """Denormalised images in [0, 255] at the refinement's size: "smooth" is a
        coarse random field upsampled, with noise on top; "noise" is rand * 255;
        "border" is the smooth one inside a constant frame, as a zero-padded crop
        looks after denormalisation."""
        torch = self.torch
        import torch.nn.functional as F
        coarse = torch.rand((B, 3, H // 16, W // 16), generator=gen)
        smooth = F.interpolate(coarse, size=(H, W), mode="bilinear", align_corners=False)
        smooth = (0.85 * smooth + 0.15 * torch.rand((B, 3, H, W), generator=gen)) * 255.0
        border = torch.tensor([123.675, 116.28, 103.53])[None, :, None, None].expand(
            B, 3, H, W).clone()
        border[:, :, H // 8: H - H // 10, : W - W // 5] = \
            smooth[:, :, H // 8: H - H // 10, : W - W // 5]
        noise = torch.rand((B, 3, H, W), generator=gen) * 255.0
        return {k: v.contiguous().to(self.dev)
                for k, v in (("smooth", smooth), ("noise", noise), ("border", border))}

    def refine_kernels_vs_plain(self, ta, tv) -> None:
        """K2 in its three modes and K3 at the channel counts of the pseudo-label
        path, against their plain versions, at the refinement's own size."""
        torch = self.torch
        B, S, K = BATCH, CROP // DOWN_SCALE, 8 * len(DILATIONS)
        log(f"== K2 / K3 vs plain (same inputs), B = {B}, {S} x {S}, K = {K}, "
            f"{VARM_ITERS} iterations")
        gen = torch.Generator().manual_seed(self.seed + 1)
        images = self._refine_images(gen, B, S, S)
        self.piece_err["affinity"] = 0.0
        with torch.no_grad():
            for kind, img in images.items():
                for mode in ("par", "pamr", "varm"):
                    got = ta.affinity(img, DILATIONS, mode, w1=0.3, w2=0.01)
                    torch.cuda.synchronize()
                    want = ta.affinity_reference(img, DILATIONS, mode, w1=0.3, w2=0.01)
                    err = (got - want).abs().max().item()
                    self.piece_err["affinity"] = max(self.piece_err["affinity"], err)
                    self.check(bool(torch.isfinite(got).all()) and err <= AFFINITY_TOL,
                               f"affinity {mode} on the {kind} image, shape {tuple(got.shape)}: "
                               f"max abs err {err:.3e} (tol {AFFINITY_TOL:.0e}), values in "
                               f"[{got.min().item():.4f}, {got.max().item():.4f}]")
                    # every plan, each run twice, gives the same bits
                    plans = affinity_plans(ta, S, S, DILATIONS, mode)
                    bad = [pl for pl in plans for _ in range(2) if not torch.equal(
                        ta.affinity(img, DILATIONS, mode, w1=0.3, w2=0.01, plan=pl), got)]
                    self.check(not bad, f"affinity {mode} on the {kind} image: {len(plans)} plans, "
                                        f"each run twice, equal bits (not: {bad})")
                    if kind == "border" and mode != "par":
                        # deep in the frame every neighbour equals the centre
                        uniform = (1.0 if mode == "pamr" else 1.0 - 0.01) / K
                        dev_u = (got[:, :, :4, -4:] - uniform).abs().max().item()
                        self.check(dev_u <= 1e-7, f"affinity {mode}: uniform softmax on the "
                                                  f"flat frame (max deviation {dev_u:.1e})")
                    del got, want
            ref = ta.affinity(images["smooth"], DILATIONS, "varm")
            self.piece_err["varm_propagate"] = 0.0
            masks = {}
            for C in (2 * (MAX_PRESENT + 1), 2 * NUM_CLASSES):
                m = torch.softmax(4.0 * torch.randn((B, C, S, S), generator=gen), dim=1)
                masks[C] = m.to(self.dev)
                got = tv.varm_propagate(masks[C], ref, DILATIONS, VARM_ITERS)
                torch.cuda.synchronize()
                want = tv.varm_propagate_reference(masks[C], ref, DILATIONS, VARM_ITERS)
                same = torch.equal(got, want)
                err = (got - want).abs().max().item()
                self.piece_err["varm_propagate"] = max(self.piece_err["varm_propagate"], err)
                self.check(same or err <= VARM_TOL,
                           f"varm_propagate C = {C}, {VARM_ITERS} iterations: "
                           f"{'equal to the plain version bit for bit' if same else 'NOT equal'}"
                           f", max abs err {err:.3e}")
                # every plan, each run twice, gives the plain version's bits
                plans = varm_plans(tv, B, C, S, S, DILATIONS)
                bad = [pl for pl in plans for _ in range(2) if not torch.equal(
                    tv.varm_propagate(masks[C], ref, DILATIONS, VARM_ITERS, plan=pl), want)]
                self.check(not bad, f"varm_propagate C = {C}: {len(plans)} plans, each run twice, "
                                    f"equal to the plain version bit for bit (plan "
                                    f"{tv.varm_plan(B, C, S, S, DILATIONS)}; not: {bad})")
                del got, want
            self._refine_plans_vs_the_card(ta, tv, S)
        self.refine_inputs = (images["smooth"], ref, masks)

    def _refine_plans_vs_the_card(self, ta, tv, S: int) -> None:
        """The blocks an SM holds of each K2 and K3 kernel at the refinement's size, as
        the card reports them, against the plans' estimates."""
        from representationlearning_tpu_torch.ops import _build
        lib = _build.load_library("refine")
        rows = []
        for k in tv.VARM_KERNELS:
            smem = tv.varm_geometry(S, S, DILATIONS, *k)[2]
            rows.append((f"varm_propagate {k}", lib.k3_varm_blocks_per_sm(*k, smem),
                         tv.varm_blocks_per_sm(*k, smem)))
        for k in ta.AFFINITY_KERNELS:
            for mode in ("par", "varm"):
                smem = ta.affinity_smem_bytes(S, S, DILATIONS, mode, *k)
                rows.append((f"affinity {mode} {k}",
                             lib.k2_affinity_blocks_per_sm(ta.MODES[mode], *k, smem),
                             ta.affinity_blocks_per_sm(*k, mode, smem)))
        self.check(all(card == est for _, card, est in rows),
                   "blocks an SM holds, card against the plans' estimate: " +
                   ", ".join(f"{name} {card}/{est}" for name, card, est in rows))

    def time_refine_kernels(self, ta, tv) -> None:
        """Device times of K2 and K3 at the pseudo-label path's shapes, and their
        bounds: every input read once and every output written once, against the
        operations of the function as it is defined (not of the passes a kernel
        chooses to repeat)."""
        torch = self.torch
        img, ref, masks = self.refine_inputs
        B, _, H, W = img.shape
        K = ref.shape[1]
        with torch.no_grad():
            for mode in ("varm", "par", "pamr"):
                k_ms = self.graph_ms(lambda: ta.affinity(img, DILATIONS, mode))
                p_ms = self.time_ms(lambda: ta.affinity_reference(img, DILATIONS, mode), iters=3)
                log(f"  affinity {mode}: kernel {k_ms:.4f} ms (plan "
                    f"{ta.affinity_plan(B, H, W, DILATIONS, mode)}), plain {p_ms:.3f} ms")
                if mode == "varm":  # the pseudo-label path's mode
                    self.piece_ms["affinity"], self.piece_plain_ms["affinity"] = k_ms, p_ms
            # per pixel and tap: mean 3, variance 9, logit 14, softmax 4, and for
            # varm the variation term 21 and its softmax 5
            n_bytes, flops = nbytes(img, ref), 56.0 * B * H * W * K
            self.add_bound("affinity", n_bytes, flops, PEAK_F32)
            log(f"  affinity bound: {n_bytes / 1e6:.1f} MB a launch = "
                f"{1e3 * n_bytes / PEAK_BYTES:.4f} ms, {flops / 1e9:.2f} GFLOP = "
                f"{1e3 * flops / PEAK_F32:.4f} ms")
            for C, m in masks.items():
                k_ms = self.graph_ms(lambda: tv.varm_propagate(m, ref, DILATIONS, VARM_ITERS),
                                     iters=3)
                p_ms = self.time_ms(
                    lambda: tv.varm_propagate_reference(m, ref, DILATIONS, VARM_ITERS), iters=2)
                # one multiply and one add per tap, channel, pixel and iteration, unfused:
                # two f32 instructions at half the 67 TFLOP/s that counts an FMA as two
                n_bytes, flops = nbytes(m, ref, m), 2.0 * m.numel() * K
                log(f"  varm_propagate C = {C}: kernel {k_ms:.4f} ms per call of {VARM_ITERS} "
                    f"iterations ({1e3 * k_ms / VARM_ITERS:.2f} us a launch, plan "
                    f"{tv.varm_plan(B, C, H, W, DILATIONS)}), plain {p_ms:.3f} ms; a launch: "
                    f"{n_bytes / 1e6:.1f} MB = {1e6 * n_bytes / PEAK_BYTES:.2f} us, unfused "
                    f"multiply-add floor {1e6 * flops / (PEAK_F32 / 2):.2f} us")
                if C == 2 * (MAX_PRESENT + 1):  # the configured path (max_present = 8)
                    self.piece_ms["varm_propagate"] = k_ms
                    self.piece_plain_ms["varm_propagate"] = p_ms
                    self.add_bound("varm_propagate", n_bytes, flops * VARM_ITERS, PEAK_F32)
        self.piece_library_ms.update(affinity=None, varm_propagate=None)

    # ------------------------------------------------------------- phase 4
    def run_slice(self, tmb):
        torch = self.torch
        from representationlearning_tpu_torch.models.mit import FusedBlock
        from representationlearning_tpu_torch.models.tscd import TSCD

        log("== slice: TSCD(mit_b1, 21 classes, bf16, fused blocks, act bf16), "
            f"{BATCH} x 3 x {IMAGE} x {IMAGE}")
        gen = torch.Generator().manual_seed(self.seed)
        model = TSCD("mit_b1", NUM_CLASSES, dtype=torch.bfloat16, fused_blocks=True,
                     act_dtype=torch.bfloat16, collect_attns="last2",
                     generator=gen).eval()  # no device named: built on the card
        self.check(all(t.is_cuda for t in model.state_dict().values()),
                   "TSCD() without a device put its parameters and buffers on the card")
        blocks = [m for m in model.encoder.modules() if isinstance(m, FusedBlock)]
        self.check(len(blocks) == 8, f"{len(blocks)} of the 8 encoder blocks are FusedBlocks")
        x = torch.randn(BATCH, 3, IMAGE, IMAGE, generator=gen).to(self.dev)

        tmb.reset_launches()
        with torch.no_grad():
            cls, seg, attns, pred = model(x)
        torch.cuda.synchronize()
        self.launches = dict(tmb.LAUNCHES)
        log(f"  launches in one forward: {self.launches}")
        # per block: ln_stats on x, on y and (sr > 1) on the reduced tokens; five
        # linears; one sr_conv when sr > 1; one attention; one dwconv_gelu
        n_sr = sum(DEPTH for _, _, _, sr, _ in STAGES if sr > 1)
        want = {"ln_stats": 2 * 8 + n_sr, "linear": 5 * 8, "sr_conv": n_sr,
                "attention": 8, "dwconv_gelu": 8}
        self.check(self.launches == want, f"launch counts {want}: every one of the 8 "
                                          "blocks ran through the CUDA kernels")
        h4 = IMAGE // 16
        shapes = {"cls": (tuple(cls.shape), (BATCH, NUM_CLASSES - 1)),
                  "seg": (tuple(seg.shape), (BATCH, NUM_CLASSES, IMAGE // 4, IMAGE // 4)),
                  "attns": (tuple(tuple(a.shape) for a in attns),
                            ((BATCH, 8, h4 * h4, h4 * h4),) * 2),
                  "attn_pred": (tuple(pred.shape), (BATCH, h4 * h4, h4 * h4))}
        for k, (got, want_shape) in shapes.items():
            self.check(got == want_shape, f"{k} shape {got}")
        outs = [cls, seg, pred, *attns]
        self.check(all(bool(torch.isfinite(t.float()).all()) for t in outs),
                   "cls, seg, attns, attn_pred all finite")

        tmb.reset_launches()
        with plain_kernels(*blocks), torch.no_grad():
            p_cls, p_seg, _, p_pred = model(x)
        torch.cuda.synchronize()
        self.check(sum(tmb.LAUNCHES.values()) == 0, "plain path launched no kernel")
        for k, g, w in (("cls", cls, p_cls), ("seg", seg, p_seg), ("attn_pred", pred, p_pred)):
            err, mag = max_err(g, w)
            rel = ((g.float() - w.float()).norm() / w.float().norm()).item()
            self.check(err <= PATH_TOL * mag,
                       f"{k}: kernel path vs plain path max abs err {err:.3e} "
                       f"(max |plain| {mag:.3e}, tol {PATH_TOL * mag:.3e}), rel L2 {rel:.2e}")
        del p_cls, p_seg, p_pred, cls, seg, attns, pred, outs

        with torch.no_grad():
            cam, cam_pred = model(x, cam_only=True)
        torch.cuda.synchronize()
        self.check(tuple(cam.shape) == (BATCH, NUM_CLASSES - 1, h4, h4)
                   and tuple(cam_pred.shape) == (BATCH, h4 * h4, h4 * h4)
                   and bool(torch.isfinite(cam.float()).all()),
                   f"cam_only: cam {tuple(cam.shape)}, attn_pred {tuple(cam_pred.shape)}")
        return model, blocks, x

    # ------------------------------------------------------------- phase 5
    def _share(self, what: str, got, want, least: float = LABEL_SHARE) -> None:
        share = (got == want).float().mean().item()
        self.check(got.shape == want.shape and share >= least,
                   f"{what} {tuple(got.shape)}: the two agree on "
                   f"{100.0 * share:.3f}% of the entries (at least {100.0 * least:.1f}%)")

    def run_pseudo_labels(self, tmb, ta, tv, model, blocks):
        torch = self.torch
        from representationlearning_tpu_torch.models.mit import FusedBlock
        from representationlearning_tpu_torch.models.tscd import TSCD
        from representationlearning_tpu_torch.train import scd as ts

        S = CROP // DOWN_SCALE
        log(f"== pseudo labels: scd_pseudo_labels, {BATCH} x 3 x {CROP} x {CROP}, scales "
            f"{CAM_SCALES}, refinement at {S} x {S}, K = {8 * len(DILATIONS)}, "
            f"{VARM_ITERS} iterations")
        gen = torch.Generator().manual_seed(self.seed + 2)
        twin = TSCD("mit_b1", NUM_CLASSES, dtype=torch.bfloat16, fused_blocks=True,
                    act_dtype=torch.bfloat16, collect_attns="none", generator=gen).eval()
        twin_blocks = [m for m in twin.encoder.modules() if isinstance(m, FusedBlock)]
        x, cls, box = pseudo_batch(torch, gen, self.dev)
        cfg = ts.SCDConfig(num_classes=NUM_CLASSES, crop_size=CROP, cam_scales=CAM_SCALES,
                           varm_dilations=DILATIONS, varm_iters=VARM_ITERS,
                           max_present=MAX_PRESENT)
        attn_mask = ts._attn_mask(cfg)
        self.check(attn_mask.is_cuda, "_attn_mask() without a device made its mask on the card")
        mods = (tmb, ta, tv)

        def run(c):
            for mod in mods:
                mod.reset_launches()
            out = ts.scd_pseudo_labels(twin, x, cls, box, c, attn_mask=attn_mask)
            torch.cuda.synchronize()
            return out, {k: v for mod in mods for k, v in mod.LAUNCHES.items()}

        # three forwards of the [x; flip x] batch, 8 blocks each; per block as in
        # the headline slice; one K2 and VARM_ITERS K3 launches per refine call
        n_fwd = len(CAM_SCALES)
        n_sr = sum(DEPTH for _, _, _, sr, _ in STAGES if sr > 1)
        want = {"ln_stats": n_fwd * (2 * 8 + n_sr), "linear": n_fwd * 5 * 8,
                "sr_conv": n_fwd * n_sr, "attention": n_fwd * 8, "dwconv_gelu": n_fwd * 8,
                "affinity": 1, "varm_propagate": VARM_ITERS}
        results = {}
        for label, c in ((f"max_present = {MAX_PRESENT}", cfg),
                         ("max_present = None", cfg._replace(max_present=None))):
            out, counts = run(c)
            log(f"  launches, {label}: {counts}")
            self.check(counts == want, f"launch counts {want}: {n_fwd * 8} K1 block runs, "
                                       f"1 K2 and {VARM_ITERS} K3 launches ({label})")
            results[label] = out
            if c is cfg:
                self.launches_pseudo = {k: counts[k] for k in PIECE_TOL}
                self.launches.update(affinity=counts["affinity"],
                                     varm_propagate=counts["varm_propagate"])
        (cams, pseudo, refined, ref_label), full = results.values()
        N = (CROP // 16) ** 2
        self.check(tuple(cams.shape) == (BATCH, NUM_CLASSES - 1, CROP, CROP)
                   and tuple(pseudo.shape) == tuple(refined.shape) == (BATCH, CROP, CROP)
                   and tuple(ref_label.shape) == (BATCH, N, N),
                   f"shapes: cams {tuple(cams.shape)}, labels {tuple(refined.shape)}, "
                   f"affinity labels {tuple(ref_label.shape)}")
        self.check(bool(torch.isfinite(cams).all()) and 0.0 <= cams.min().item()
                   and cams.max().item() <= 1.0 + 1e-5, "cams finite and in [0, 1]")
        present = [set((cls[i] > 0).nonzero().flatten().add(1).tolist()) | {0, 255}
                   for i in range(BATCH)]
        self.check(all(set(refined[i].unique().tolist()) <= present[i] for i in range(BATCH)),
                   "refined labels hold only background, the present classes and ignore")
        self.check(bool((refined[1, : box[1, 0]] == 255).all()
                        and (refined[1, :, box[1, 3]:] == 255).all()),
                   "refined labels are ignore outside the image box")
        fg = ((refined > 0) & (refined < 255)).float().mean().item()
        log(f"  refined labels: {100.0 * fg:.1f}% foreground, "
            f"{100.0 * (refined == 255).float().mean().item():.1f}% ignore")
        self._share(f"refined labels, max_present = {MAX_PRESENT} against all "
                    f"{NUM_CLASSES - 1} classes,", refined, full[2])

        # the same call with K1, K2 and K3 swapped for their plain versions
        with plain_kernels(*twin_blocks):
            (p_cams, p_pseudo, p_refined, p_ref), counts = run(cfg)
        self.check(sum(counts.values()) == 0, "plain path launched no kernel")
        err, mag = max_err(cams, p_cams)
        self.check(err <= PATH_TOL * mag, f"cams: kernel path vs plain path max abs err "
                                          f"{err:.3e} (max |plain| {mag:.3e}, tol "
                                          f"{PATH_TOL * mag:.3e})")
        self._share("pseudo labels, kernel path against plain path,", pseudo, p_pseudo)
        self._share("refined labels, kernel path against plain path,", refined, p_refined)
        self._share("affinity labels, kernel path against plain path,", ref_label, p_ref)
        del results, full, p_cams, p_pseudo, p_refined, p_ref

        # the trainer's validation step, on the exporting model of the headline slice
        log(f"== eval step: make_scd_eval_step, {IMAGE} x {IMAGE}, collect_attns = last2")
        step = ts.make_scd_eval_step(model, cfg)
        for b in (1, BATCH):
            img = torch.randn((b, 3, IMAGE, IMAGE), generator=gen).to(self.dev)
            batch = {"image": img, "cls_label": cls[:b]}
            for mod in mods:
                mod.reset_launches()
            got = step(batch)
            torch.cuda.synchronize()
            ran = sum(tmb.LAUNCHES.values())
            with plain_kernels(*blocks):
                plain = step(batch)
                torch.cuda.synchronize()
            self.check(ran > 0 and all(tuple(got[k].shape) == (b, IMAGE, IMAGE)
                                       for k in ("seg_pred", "cam_label", "ref_label"))
                       and tuple(got["cls_pred"].shape) == (b, NUM_CLASSES - 1),
                       f"batch {b}: seg_pred, cam_label, ref_label {(b, IMAGE, IMAGE)}, "
                       f"cls_pred {tuple(got['cls_pred'].shape)}, {ran} K1 launches")
            self.check(int(got["seg_pred"].max()) < NUM_CLASSES
                       and int(got["ref_label"].max()) < NUM_CLASSES
                       and int(got["cam_label"].max()) < NUM_CLASSES,
                       f"batch {b}: every label below {NUM_CLASSES}")
            for k, least in (("seg_pred", SEG_SHARE), ("cam_label", LABEL_SHARE)):
                self._share(f"batch {b} {k}, kernel path against plain path,", got[k],
                            plain[k], least)
            del got, plain
        return twin, twin_blocks, (x, cls, box, cfg, attn_mask)

    # ------------------------------------------------------------- phase 6 (K4)
    def _flash_inputs(self, gen, BH, Nq, Nk, dtype):
        torch = self.torch
        q, k, v, do = (torch.randn(shape, generator=gen).to(self.dev, dtype)
                       for shape in ((BH, Nq, HD), (BH, Nk, HD), (BH, Nk, HD), (BH, Nq, HD)))
        return q.requires_grad_(), k.requires_grad_(), v.requires_grad_(), do

    def flash_vs_plain(self, tf) -> None:
        """K4 forward and backward against the plain softmax composition and
        autograd through it, on the same inputs and cotangent."""
        torch = self.torch
        import torch.nn.functional as F
        f32, bf16 = torch.float32, torch.bfloat16
        train = flash_shapes(CROP) + flash_shapes(int(CROP * 0.3))
        cases = [(s, f32, "train step") for s in train] \
            + [(s, f32, "512 x 512 forward") for s in flash_shapes(IMAGE)] \
            + [((3, 70, 1), f32, "Nk = 1"), (train[0], bf16, "bf16")]
        log(f"== K4 vs plain (same inputs): flash attention forward and backward, hd = {HD}")
        gen = torch.Generator().manual_seed(self.seed + 3)
        scale = HD ** -0.5
        for k in ("flash_fwd", "flash_bwd"):
            self.piece_err[k] = self.piece_ms[k] = self.piece_plain_ms[k] = 0.0
            self.piece_library_ms[k] = 0.0
        self.piece_err["flash_bf16"] = 0.0
        self.flash_fwd_fma_bound = self.flash_bwd_fma_bound = 0.0
        self.flash_bwd_workspace = {}  # bytes of the backward's workspace a launch
        self.flash_eval_ms = {"": 0.0, "library": 0.0}
        self.library_covers.update(
            flash_fwd="F.scaled_dot_product_attention on the same f32 tensors",
            flash_bwd="the backward of F.scaled_dot_product_attention on the same f32 tensors")
        if self.capture_stream is None:
            self.capture_stream = torch.cuda.Stream()
        for (BH, Nq, Nk), dtype, what in cases:
            q, k, v, do = self._flash_inputs(gen, BH, Nq, Nk, dtype)
            # the forwards run on the capture stream, so that the backward of each runs
            # there too and a CUDA graph can capture it
            self.capture_stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.capture_stream):
                out = tf.flash_attention(q, k, v, scale)
                want = tf.flash_attention_reference(q, k, v, scale)
                sdpa = F.scaled_dot_product_attention(q[None], k[None], v[None], scale=scale)
            torch.cuda.current_stream().wait_stream(self.capture_stream)
            grads = torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
            again = torch.autograd.grad(tf.flash_attention(q, k, v, scale), (q, k, v), do)
            want_grads = torch.autograd.grad(want, (q, k, v), do, retain_graph=True)
            torch.cuda.synchronize()
            at = f"(BH, Nq, Nk) = ({BH}, {Nq}, {Nk}) {str(dtype).split('.')[-1]}, {what}"
            for name, g, w in (("o", out, want), ("dq", grads[0], want_grads[0]),
                               ("dk", grads[1], want_grads[1]), ("dv", grads[2], want_grads[2])):
                side = "fwd" if name == "o" else "bwd"
                err, mag = max_err(g, w)
                tol = FLASH_TOL["bf16" if dtype == bf16 else side] * max(1.0, mag)
                self.check(g.dtype == dtype and bool(torch.isfinite(g.float()).all())
                           and err <= tol,
                           f"flash {name} @ {at}: max abs err {err:.3e} (max |plain| {mag:.3e}, "
                           f"tol {tol:.3e})")
                key = "flash_bf16" if dtype == bf16 else "flash_" + side
                self.piece_err[key] = max(self.piece_err[key], err)
            self.check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                       f"flash backward @ {at}: two runs on the same inputs give equal bits")
            if (BH, Nq, Nk) == train[0] and dtype == f32:
                self._flash_bwd_plans(tf, q, k, v, do, want_grads, scale, at)
            if what == "train step":
                with torch.no_grad():
                    runs = [tf.flash_forward(q, k, v, scale) for _ in range(2)]
                    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
                    lerr = (runs[0][1] - torch.logsumexp(s, dim=-1)).abs().max().item()
                self.check(torch.equal(runs[0][0], out) and torch.equal(runs[1][0], out)
                           and torch.equal(runs[0][1], runs[1][1]),
                           f"flash forward @ {at}: two more runs give o and lse with equal bits")
                self.check(lerr <= 1e-5, f"flash lse @ {at}: max abs err {lerr:.3e} against "
                           f"torch.logsumexp of the scaled scores (tol 1.000e-05)")
                del runs, s
            if what == "512 x 512 forward":  # the eval forward: timed, not a step's work
                with torch.no_grad():
                    ms = {"": self.graph_ms(lambda: tf.flash_attention(q, k, v, scale)),
                          "library": self.graph_ms(lambda: F.scaled_dot_product_attention(
                              q[None], k[None], v[None], scale=scale))}
                for which in ms:
                    self.flash_eval_ms[which] += DEPTH * ms[which]
                log(f"  flash_fwd @ ({BH}, {Nq}, {Nk}), 512 x 512 forward: kernel "
                    f"{ms['']:.4f} ms, library call {ms['library']:.4f} ms per launch "
                    f"(CUDA graph replay)")
            if what != "train step":
                continue
            # times and bounds of the DEPTH launches a step makes at this geometry, by
            # CUDA graph replay: a launch takes less device time than the host's launch
            with torch.no_grad():
                fwd = {"": lambda: tf.flash_attention(q, k, v, scale),
                       "plain": lambda: tf.flash_attention_reference(q, k, v, scale),
                       "library": lambda: F.scaled_dot_product_attention(q[None], k[None],
                                                                         v[None], scale=scale)}
                ms_fwd = {which: self.graph_ms(fn) for which, fn in fwd.items()}
            bwd = {"": lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True),
                   "plain": lambda: torch.autograd.grad(want, (q, k, v), do, retain_graph=True),
                   "library": lambda: torch.autograd.grad(sdpa, (q, k, v), do[None],
                                                          retain_graph=True)}
            ms_bwd = {which: self.graph_ms(fn) for which, fn in bwd.items()}
            for name, ms in (("flash_fwd", ms_fwd), ("flash_bwd", ms_bwd)):
                self.piece_ms[name] += DEPTH * ms[""]
                self.piece_plain_ms[name] += DEPTH * ms["plain"]
                self.piece_library_ms[name] += DEPTH * ms["library"]
                log(f"  {name} @ ({BH}, {Nq}, {Nk}): kernel {ms['']:.4f} ms, plain "
                    f"{ms['plain']:.4f} ms, library call {ms['library']:.4f} ms per launch "
                    f"(CUDA graph replay)")
            lse = BH * Nq * 4
            # forward: q, k, v read, o and the row logsumexp written; 2 products of
            # 2 BH Nq Nk hd operations, each f32-exact product three TF32 products on the
            # tensor cores (the bound); as f32 multiply-adds they would take 67 TFLOP/s
            ops = 4.0 * BH * Nq * Nk * HD
            self.add_bound("flash_fwd", nbytes(q, k, v, out) + lse, 3 * ops, PEAK_TF32,
                           times=DEPTH)
            self.flash_fwd_fma_bound += DEPTH * 1e3 * ops / PEAK_F32
            # backward: q, k, v, o, do, lse read, dq, dk, dv written; 5 products of
            # 2 BH Nq Nk hd operations, as three TF32 products each (the bound) and as f32
            # multiply-adds beside it
            ops = 10.0 * BH * Nq * Nk * HD
            self.add_bound("flash_bwd", nbytes(q, k, v, out, do, grads) + lse, 3 * ops,
                           PEAK_TF32, times=DEPTH)
            self.flash_bwd_fma_bound += DEPTH * 1e3 * ops / PEAK_F32
            rows, shares = tf.bwd_plan(BH, Nq, Nk, HD, f32, sms=tf._sms(0))
            plan = tf.bwd_plan(BH, Nq, Nk, HD, f32, tf._bwd_blocks_per_sm(Nk, HD, False, rows),
                               tf._sms(0))
            ws = 4 * tf.bwd_workspace_floats(BH, Nq, Nk, HD, plan[1])
            self.flash_bwd_workspace[f"({BH}, {Nq}, {Nk})"] = ws
            log(f"  flash_bwd @ ({BH}, {Nq}, {Nk}): plan (rows, shares) {plan}, workspace "
                f"{ws} bytes a launch")
            del out, want, sdpa, grads, again, want_grads

    def _flash_bwd_plans(self, tf, q, k, v, do, want_grads, scale, at) -> None:
        """Every backward plan of `bwd_plans` twice: equal bits on a rerun, within the
        tolerance; the one-share plans (no bh cut) equal to each other at every tile height."""
        torch = self.torch
        with torch.no_grad():
            o, lse = tf.flash_forward(q, k, v, scale)
            one_share, worst, same = None, 0.0, True
            plans = bwd_plans(tf, q.shape[0], q.shape[1], k.shape[1], HD, q.dtype)
            for plan in plans:
                got = tf.flash_backward(q, k, v, o, lse, do, scale, plan=plan)
                again = tf.flash_backward(q, k, v, o, lse, do, scale, plan=plan)
                same &= all(torch.equal(a, b) for a, b in zip(got, again))
                if plan[1] == 1:
                    one_share = one_share or got
                    same &= all(torch.equal(a, b) for a, b in zip(got, one_share))
                for g, w in zip(got, want_grads):
                    err, mag = max_err(g, w)
                    worst = max(worst, err / (FLASH_TOL["bwd"] * max(1.0, mag)))
            torch.cuda.synchronize()
        self.check(same, f"flash backward @ {at}: each of {len(plans)} plans {plans} twice gives "
                         "equal bits, the one-share plans equal at every tile height")
        self.check(worst <= 1.0, f"flash backward @ {at}: every plan within FLASH_TOL['bwd'] "
                                 f"(worst {worst:.3f} of it)")

    def flash_model(self, tf) -> None:
        """TSCD(use_flash=True) in eval against use_flash=False on the same weights."""
        torch = self.torch
        from representationlearning_tpu_torch.models.tscd import TSCD

        log(f"== TSCD(mit_b1, use_flash=True) against use_flash=False, eval, f32, "
            f"{BATCH} x 3 x {CROP} x {CROP}")
        gen = torch.Generator().manual_seed(self.seed + 4)
        flash = TSCD("mit_b1", NUM_CLASSES, use_flash=True, generator=gen).eval()
        plain = TSCD("mit_b1", NUM_CLASSES, use_flash=False).eval()
        plain.load_state_dict(flash.state_dict())
        x = pseudo_batch(torch, gen, self.dev)[0]
        tf.reset_launches()
        with torch.no_grad():
            got, want = flash(x), plain(x)
        torch.cuda.synchronize()
        self.check(tf.LAUNCHES == {"flash_fwd": 3 * DEPTH, "flash_bwd": 0},
                   f"launches {tf.LAUNCHES}: the six non-exporting attentions ran on K4")
        for name, g, w in (("cls", got[0], want[0]), ("seg", got[1], want[1]),
                           ("attn_pred", got[3], want[3])):
            err, mag = max_err(g, w)
            tol = FLASH_MODEL_TOL * max(1.0, mag)
            self.check(bool(torch.isfinite(g).all()) and err <= tol,
                       f"{name} {tuple(g.shape)}: max abs err {err:.3e} (max |plain| {mag:.3e}, "
                       f"tol {tol:.3e})")

    # ------------------------------------------------------------- phase 7
    def _trainer(self, gen, *, use_flash: bool, cam_iters: int = -1):
        """Model, fused CAM twin on the same parameters, optimiser state and step
        function of the train step's configuration."""
        torch = self.torch
        from representationlearning_tpu_torch.models.mit import FusedBlock
        from representationlearning_tpu_torch.models.tscd import TSCD, share_parameters
        from representationlearning_tpu_torch.train import optim
        from representationlearning_tpu_torch.train import scd as ts
        from representationlearning_tpu_torch.train.state import TrainState

        model = TSCD("mit_b1", NUM_CLASSES, use_flash=use_flash, collect_attns="last2",
                     generator=gen)
        twin = share_parameters(
            TSCD("mit_b1", NUM_CLASSES, dtype=torch.bfloat16, fused_blocks=True,
                 act_dtype=torch.bfloat16, collect_attns="none"), model).eval()
        cfg = ts.SCDConfig(num_classes=NUM_CLASSES, crop_size=CROP, cam_scales=CAM_SCALES,
                           varm_dilations=DILATIONS, varm_iters=VARM_ITERS,
                           max_present=MAX_PRESENT, energy_method="grid", cam_iters=cam_iters)
        state = TrainState.create(model, optim.make_poly_warmup_adamw(
            model, LR, WEIGHT_DECAY, WARMUP, MAX_ITERS, param_labels=optim.tscd_param_labels))
        return SimpleNamespace(
            model=model, twin=twin, cfg=cfg, state=state,
            twin_blocks=[m for m in twin.encoder.modules() if isinstance(m, FusedBlock)],
            step=ts.make_scd_train_step(model, cfg, cam_model=twin),
            labels=optim.tscd_param_labels(n for n, _ in model.named_parameters()))

    def _group_norms(self, t) -> dict[str, float]:
        """l2 norm of the gradients that lie in .grad, per parameter group."""
        sq = {}
        for n, p in t.model.named_parameters():
            sq[t.labels[n]] = sq.get(t.labels[n], 0.0) + p.grad.float().square().sum().item()
        return {k: v ** 0.5 for k, v in sq.items()}

    def _one_step(self, t, batch, seed: int, norms: dict | None = None):
        """One call of the step function; with `norms`, the gradient norms per
        group are read just before the optimiser consumes the gradients."""
        torch = self.torch
        if norms is not None:
            apply = t.state.apply_gradients

            def recording():
                norms.update(self._group_norms(t))
                return apply()

            t.state.apply_gradients = recording
        try:
            _, metrics = t.step(t.state, batch, torch.Generator().manual_seed(seed))
        finally:
            vars(t.state).pop("apply_gradients", None)
        torch.cuda.synchronize()
        return {k: v.item() for k, v in metrics.items()}

    def run_train_steps(self, tmb, ta, tv, tf):
        torch = self.torch
        from representationlearning_tpu_torch.train import checkpoints as ck
        from representationlearning_tpu_torch.train import optim

        log(f"== train step: make_scd_train_step, TSCD(mit_b1, use_flash=True) f32 + bf16 "
            f"fused CAM twin, {BATCH} x 3 x {CROP} x {CROP}, AdamW {LR}, warm-up {WARMUP}")
        gen = torch.Generator().manual_seed(self.seed + 5)
        x, cls, box = pseudo_batch(torch, gen, self.dev)
        batch = {"image": x, "cls_label": cls, "img_box": box}
        state_gen = gen.get_state()
        t = self._trainer(gen, use_flash=True)
        self.check(all(p.is_cuda for p in t.model.parameters())
                   and all(a is b for a, b in zip(t.twin.parameters(), t.model.parameters())),
                   "model built on the card; the CAM twin holds the model's own parameters")
        initial = {n: p.detach().clone() for n, p in t.model.named_parameters()}
        mods = (tmb, ta, tv, tf)
        n_fwd = 2 * len(CAM_SCALES)  # CAM forwards of the twin a step, 8 blocks each
        n_sr = sum(DEPTH for _, _, _, sr, _ in STAGES if sr > 1)
        want = {"ln_stats": n_fwd * (2 * 8 + n_sr), "linear": n_fwd * 5 * 8,
                "sr_conv": n_fwd * n_sr, "attention": n_fwd * 8, "dwconv_gelu": n_fwd * 8,
                "affinity": 1, "varm_propagate": VARM_ITERS,
                "flash_fwd": 2 * 3 * DEPTH, "flash_bwd": 2 * 3 * DEPTH}
        sched = optim.poly_warmup_schedule(LR, WARMUP, MAX_ITERS)
        first, norms = None, {}
        for i in range(TRAIN_STEPS):
            for mod in mods:
                mod.reset_launches()
            met = self._one_step(t, batch, self.seed + 100 + i, norms if i == 0 else None)
            counts = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
            first = first or met
            if i == 0:
                self.launches_train = counts
            log(f"  step {i + 1}: " + ", ".join(f"{k} {v:.6g}" for k, v in met.items()))
            self.check(counts == want,
                       f"step {i + 1} launch counts {counts}: 12 K4 forward, 12 K4 backward, "
                       f"{n_fwd * 8} K1 block runs, 1 K2, {VARM_ITERS} K3")
            self.check(all(map(lambda v: v == v and abs(v) != float("inf"), met.values())),
                       f"step {i + 1}: the six losses and the total are finite")
            lrs = t.state.learning_rates
            self.check(t.state.step == i + 1 and abs(lrs[0] - sched(i + 1)) <= 1e-12
                       and abs(lrs[1] - 10 * sched(i + 1)) <= 1e-11,
                       f"step count {t.state.step}, next learning rates {lrs[0]:.6e} (encoder) "
                       f"and {lrs[1]:.6e} (heads) as the schedule says")
        frozen = [n for n in initial if t.labels[n] == "norm"]
        params = dict(t.model.named_parameters())
        self.check(all(torch.equal(params[n], initial[n]) for n in frozen),
                   f"the {len(frozen)} frozen encoder norm tensors are unchanged after "
                   f"{TRAIN_STEPS} steps")
        still = [n for n in initial if t.labels[n] != "norm" and torch.equal(params[n], initial[n])]
        self.check(not still, f"every other parameter tensor ({len(initial) - len(frozen)}) "
                              f"changed after {TRAIN_STEPS} steps" + (f"; not {still[:4]}"
                                                                     if still else ""))
        bn = t.model.decoder.linear_fuse.bn
        self.check(int(bn.num_batches_tracked) == TRAIN_STEPS
                   and bool((bn.running_var != 1).all()),
                   "BatchNorm running statistics moved once a step (the main forward's)")

        # a checkpoint saved and restored gives the same next step
        with tempfile.TemporaryDirectory() as d:
            ck.save(d, t.state.step, t.state)
            a = self._one_step(t, batch, self.seed + 200)
            after_a = [p.detach().clone() for p in t.model.parameters()]
            self.check(ck.latest_step(d) == TRAIN_STEPS, f"checkpoint step_{TRAIN_STEPS} saved")
            ck.restore(d, t.state)
        self.check(t.state.step == TRAIN_STEPS, "restored the step count")
        b = self._one_step(t, batch, self.seed + 200)
        worst = max(abs(a[k] - b[k]) / max(1.0, abs(a[k])) for k in a)
        drift = max((u - w).abs().max().item() for u, w in zip(after_a, t.model.parameters()))
        self.check(worst <= RESUME_TOL and drift <= RESUME_PARAM_TOL
                   and t.state.step == TRAIN_STEPS + 1,
                   f"the step after the restore repeats the step after the save: losses within "
                   f"{worst:.2e} (tol {RESUME_TOL:.0e}), parameters within {drift:.2e} "
                   f"(tol {RESUME_PARAM_TOL:.0e})")

        # the warm-up switch: within cam_iters only `cls` is in the total
        gen.set_state(state_gen)
        w = self._trainer(gen, use_flash=True, cam_iters=2000)
        met = self._one_step(w, batch, self.seed + 100)
        self.check(met["total"] == met["cls"] and abs(met["cls"] - first["cls"]) <= 1e-5,
                   f"cam_iters = 2000: total {met['total']:.6f} = cls {met['cls']:.6f}, the same "
                   "cls as with all six losses in the total")
        del w

        # the same first step on the plain path: no K4, plain K1, K2, K3
        gen.set_state(state_gen)
        pl = self._trainer(gen, use_flash=False)
        self.check(all(torch.equal(p, initial[n]) for n, p in pl.model.named_parameters()),
                   "the plain-path model starts from the same weights")
        p_norms = {}
        for mod in mods:
            mod.reset_launches()
        with plain_kernels(*pl.twin_blocks):
            p_met = self._one_step(pl, batch, self.seed + 100, p_norms)
        self.check(sum(v for mod in mods for v in mod.LAUNCHES.values()) == 0,
                   "plain path launched no kernel")
        for k, v in first.items():
            tol = STEP_CLS_TOL * max(1.0, abs(p_met[k])) if k == "cls" \
                else STEP_TOL * abs(p_met[k]) + STEP_ATOL
            self.check(abs(v - p_met[k]) <= tol,
                       f"first step, {k}: kernel path {v:.6f}, plain path {p_met[k]:.6f} "
                       f"(tol {tol:.2e})")
        for k, v in norms.items():
            self.check(abs(v - p_norms[k]) <= STEP_TOL * p_norms[k],
                       f"first step, gradient norm of group {k}: kernel path {v:.6e}, plain "
                       f"path {p_norms[k]:.6e} (tol {STEP_TOL * p_norms[k]:.2e})")
        return t, pl, batch

    # ------------------------------------------------------------- phase 7a (RML)
    def _rml_trainer(self, gen, cam_iters: int = -1):
        """Model, fused CAM twin on the same parameters, optimiser state and step
        function of bench.py::bench_rml_train; the step augments raw canvases on
        the card."""
        torch = self.torch
        from representationlearning_tpu_torch.data.device_transforms import DeviceAugConfig
        from representationlearning_tpu_torch.models.mit import FusedBlock
        from representationlearning_tpu_torch.models.rml import RMLModel
        from representationlearning_tpu_torch.models.tscd import share_parameters
        from representationlearning_tpu_torch.train import optim
        from representationlearning_tpu_torch.train import rml as tr
        from representationlearning_tpu_torch.train.state import TrainState

        model = RMLModel("mit_b1", NUM_CLASSES, dtype=torch.bfloat16, generator=gen)
        twin = share_parameters(
            RMLModel("mit_b1", NUM_CLASSES, dtype=torch.bfloat16, fused_blocks=True,
                     collect_attns="none"), model).eval()
        cfg = tr.RMLConfig(num_classes=NUM_CLASSES, crop_size=CROP, cam_scales=RML_SCALES,
                           max_present=MAX_PRESENT, cam_iters=cam_iters)
        state = TrainState.create(model, optim.make_poly_warmup_adamw(
            model, LR, WEIGHT_DECAY, RML_WARMUP, RML_MAX_ITERS,
            param_labels=optim.tscd_param_labels))
        aug = DeviceAugConfig(crop_size=CROP, scale_range=(0.5, 2.0))
        return SimpleNamespace(
            model=model, twin=twin, cfg=cfg, state=state,
            twin_blocks=[m for m in twin.encoder.modules() if isinstance(m, FusedBlock)],
            step=tr.make_rml_train_step(model, cfg, cam_model=twin, aug_cfg=aug),
            labels=optim.tscd_param_labels(n for n, _ in model.named_parameters()))

    def _rml_step(self, t, batch, seed: int, norms: dict | None = None,
                  labels: dict | None = None):
        """`_one_step` of the RML trainer; with `labels`, the step's refined labels
        are kept there under "refined"."""
        from representationlearning_tpu_torch.train import rml as tr

        if labels is None:
            return self._one_step(t, batch, seed, norms)
        inner = tr.rml_losses

        def recording(*a, **kw):
            losses, aux = inner(*a, **kw)
            labels["refined"] = aux["refined_label"]
            return losses, aux

        tr.rml_losses = recording   # the step looks the function up in its module
        try:
            return self._one_step(t, batch, seed, norms)
        finally:
            tr.rml_losses = inner

    def run_rml_steps(self, mods):
        torch = self.torch
        from representationlearning_tpu_torch.train import optim

        tmb = mods[0]
        log(f"== RML train step: make_rml_train_step, RMLModel(mit_b1) bf16 + bf16 fused CAM "
            f"twin, {RML_BATCH} raw {RML_CANVAS} x {RML_CANVAS} canvases ({RML_HW[0]} x "
            f"{RML_HW[1]}) augmented on the card to {CROP} x {CROP}, PAR, AdamW {LR}, "
            f"warm-up {RML_WARMUP}")
        gen = torch.Generator().manual_seed(self.seed + 7)
        batch = rml_batch(torch, gen, self.dev)
        state_gen = gen.get_state()
        t = self._rml_trainer(gen)
        self.check(all(p.is_cuda for p in t.model.parameters())
                   and all(a is b for a, b in zip(t.twin.parameters(), t.model.parameters())),
                   "model built on the card; the CAM twin holds the model's own parameters")
        initial = {n: p.detach().clone() for n, p in t.model.named_parameters()}
        n_fwd = 2 * len(RML_SCALES)  # CAM forwards of the twin a step, batch 32, 8 blocks each
        n_sr = sum(DEPTH for _, _, _, sr, _ in STAGES if sr > 1)
        want = {k: 0 for mod in mods for k in mod.LAUNCHES}
        want.update(ln_stats=n_fwd * (2 * 8 + n_sr), linear=n_fwd * 5 * 8,
                    sr_conv=n_fwd * n_sr, attention=n_fwd * 8, dwconv_gelu=n_fwd * 8,
                    affinity=1, varm_propagate=VARM_ITERS)
        k1 = sum(want[k] for k in PIECE_TOL)
        sched = optim.poly_warmup_schedule(LR, RML_WARMUP, RML_MAX_ITERS)
        first, norms, labels = None, {}, {}
        for i in range(TRAIN_STEPS):
            for mod in mods:
                mod.reset_launches()
            met = self._rml_step(t, batch, self.seed + 300 + i, *((norms, labels) if i == 0
                                                                   else (None, None)))
            counts = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
            first = first or met
            if i == 0:
                self.launches_rml = counts
            log(f"  step {i + 1}: " + ", ".join(f"{k} {v:.6g}" for k, v in met.items()))
            self.check(counts == want,
                       f"step {i + 1} launch counts {counts}: K1 {k1} "
                       f"({'/'.join(str(want[k]) for k in PIECE_TOL)}), K2 1 (par), "
                       f"K3 {VARM_ITERS}, K4 / K5 / K6 0")
            self.check(all(map(lambda v: v == v and abs(v) != float("inf"), met.values())),
                       f"step {i + 1}: the four losses and the total are finite")
            lrs = t.state.learning_rates
            self.check(t.state.step == i + 1 and abs(lrs[0] - sched(i + 1)) <= 1e-12
                       and abs(lrs[1] - 10 * sched(i + 1)) <= 1e-11,
                       f"step count {t.state.step}, next learning rates {lrs[0]:.6e} (encoder) "
                       f"and {lrs[1]:.6e} (heads) as the schedule says")
        frozen = [n for n in initial if t.labels[n] == "norm"]
        params = dict(t.model.named_parameters())
        self.check(all(torch.equal(params[n], initial[n]) for n in frozen),
                   f"the {len(frozen)} frozen encoder norm tensors are unchanged after "
                   f"{TRAIN_STEPS} steps")
        still = [n for n in initial if t.labels[n] != "norm" and torch.equal(params[n], initial[n])]
        self.check(not still, f"every other parameter tensor ({len(initial) - len(frozen)}) "
                              f"changed after {TRAIN_STEPS} steps" + (f"; not {still[:4]}"
                                                                     if still else ""))
        bn = t.model.neck.fuse_conv[1]
        self.check(int(bn.num_batches_tracked) == TRAIN_STEPS
                   and bool((bn.running_var != 1).all()),
                   "the neck's BatchNorm running statistics moved once a step (the main "
                   "forward's)")

        # the warm-up switch: within cam_iters only `cls` is in the total
        gen.set_state(state_gen)
        w = self._rml_trainer(gen, cam_iters=2000)
        met = self._rml_step(w, batch, self.seed + 300)
        self.check(met["total"] == met["cls"] and abs(met["cls"] - first["cls"]) <= 1e-5,
                   f"cam_iters = 2000: total {met['total']:.6f} = cls {met['cls']:.6f}, the same "
                   "cls as with all four losses in the total")
        del w

        # the same first step on the plain path: plain K1, K2, K3, the same decisions
        # and drop-path masks from the same seed
        gen.set_state(state_gen)
        pl = self._rml_trainer(gen)
        self.check(all(torch.equal(p, initial[n]) for n, p in pl.model.named_parameters()),
                   "the plain-path model starts from the same weights")
        p_norms, p_labels = {}, {}
        for mod in mods:
            mod.reset_launches()
        with plain_kernels(*pl.twin_blocks):
            p_met = self._rml_step(pl, batch, self.seed + 300, p_norms, p_labels)
        self.check(sum(v for mod in mods for v in mod.LAUNCHES.values()) == 0,
                   "plain path launched no kernel")
        for k, v in first.items():
            tol = RML_EXACT_TOL * abs(p_met[k]) if k in ("cls", "mfml") \
                else STEP_TOL * abs(p_met[k]) + STEP_ATOL
            self.check(abs(v - p_met[k]) <= tol,
                       f"first step, {k}: kernel path {v:.6f}, plain path {p_met[k]:.6f} "
                       f"(tol {tol:.2e})")
        self._share("first step, refined labels", labels["refined"], p_labels["refined"])
        for k, v in norms.items():
            self.check(abs(v - p_norms[k]) <= STEP_TOL * p_norms[k],
                       f"first step, gradient norm of group {k}: kernel path {v:.6e}, plain "
                       f"path {p_norms[k]:.6e} (tol {STEP_TOL * p_norms[k]:.2e})")
        return t, pl, batch

    # ------------------------------------------------------------- phase 7c (RSSFormer train)
    def _rss_trainer(self, initial=None, fused_attn: bool = False):
        """bench.py::bench_rssformer_train's model (its seed-0 weights, or
        `initial`), optimiser state and step function; `labels` groups the
        parameters (stem, layer1, transitions, stages, neck, head, headaux)."""
        import re

        torch = self.torch
        from representationlearning_tpu_torch.models.rssformer import HRNetFusion
        from representationlearning_tpu_torch.train import rssformer as trs

        model = HRNetFusion("hrnetv2_w32", RSS_CLASSES, dtype=torch.bfloat16,
                            fused_attn=fused_attn, generator=torch.Generator().manual_seed(0))
        if initial is not None:
            model.load_state_dict(initial)
        cfg = trs.RSSFormerTrainConfig()

        def group(name):
            part = name.split(".")
            if part[0] != "backbone":
                return part[0]
            return part[2] if re.fullmatch(r"layer1|stage\d|transition\d", part[2]) else "stem"

        return SimpleNamespace(
            model=model, cfg=cfg, state=trs.create_rssformer_state(model, cfg),
            step=trs.make_rssformer_train_step(model, cfg),
            labels={n: group(n) for n, _ in model.named_parameters()})

    def run_rss_train(self, mods) -> None:
        torch = self.torch
        from representationlearning_tpu_torch.models.layers import BatchNorm2d
        from representationlearning_tpu_torch.train import optim
        from representationlearning_tpu_torch.train import rssformer as trs

        tm, ti = mods[4], mods[5]
        log(f"== RSSFormer train step: make_rssformer_train_step, HRNetFusion(hrnetv2_w32, "
            f"{RSS_CLASSES} classes, bf16), {BATCH} x 3 x {IMAGE} x {IMAGE}, CGFL losses, SGD "
            "0.01 poly 0.9, momentum 0.9, weight decay 1e-4, clip 35 (bench.py's configuration)")
        batch = rss_batch(torch, self.dev)
        t = self._rss_trainer()
        self.check(all(v.is_cuda for v in t.model.state_dict().values()),
                   "model built on the card")
        initial = {k: v.detach().clone() for k, v in t.model.state_dict().items()}
        norms = [m for m in t.model.modules() if isinstance(m, BatchNorm2d)]
        aux = {n: p.detach().clone() for n, p in t.model.headaux.named_parameters()}
        aux_mom = {n: torch.zeros_like(p) for n, p in aux.items()}
        sched = optim.poly_schedule(t.cfg.base_lr, t.cfg.max_iters, t.cfg.power)
        first, first_norms, prev = {}, {}, None
        for i in range(RSS_TRAIN_STEPS):
            for mod in mods:
                mod.reset_launches()
            t0 = time.perf_counter()
            met = self._one_step(t, batch, self.seed, first_norms if i == 0 else None)
            wall = time.perf_counter() - t0
            counts = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
            log(f"  step {i + 1} ({wall:.2f} s): " + ", ".join(f"{k} {v:.6g}"
                                                               for k, v in met.items()))
            if i == 0:
                first, self.launches_rss_step = met, counts
                pre = sum(v * v for v in first_norms.values()) ** 0.5
                log(f"  gradient norm before the clip, first step: {pre:.6g} (clip "
                    f"{t.cfg.grad_clip:g}: {'live' if pre > t.cfg.grad_clip else 'not reached'})"
                    "; by group " + ", ".join(f"{k} {v:.4g}" for k, v in first_norms.items()))
                self.check(pre == pre and 0 < pre < float("inf"),
                           "the gradient norm before the clip is finite and positive")
            self.check(not any(counts.values()),
                       f"step {i + 1}: no hand-written kernel launched (K1-K6 all 0)")
            self.check(all(v == v and abs(v) != float("inf") for v in met.values()),
                       f"step {i + 1}: fc_loss and total finite")
            stats = [torch.cat([m.running_mean, m.running_var]) for m in norms]
            self.check(all(int(m.num_batches_tracked) == i + 1 for m in norms)
                       and all(s.dtype == torch.float32 for s in stats)
                       and (prev is None or all(not torch.equal(a, b)
                                                for a, b in zip(stats, prev))),
                       f"step {i + 1}: the running statistics of all {len(norms)} BatchNorms "
                       "moved once (f32 in the bf16 model)")
            prev = stats
            # headaux gets no gradient: its update is weight decay and momentum alone
            lr = sched(i)
            for n, p in aux.items():
                aux_mom[n] = 0.9 * aux_mom[n] + t.cfg.weight_decay * p
                aux[n] = p - lr * aux_mom[n]
            got = dict(t.model.headaux.named_parameters())
            err = max(((got[n] - aux[n]).abs().max() / aux[n].abs().max()).item() for n in aux)
            self.check(err <= 1e-6, f"step {i + 1}: headaux moved by weight decay and momentum "
                                    f"alone (relative err {err:.1e} against p - lr (0.9 m + wd p))")
            self.check(t.state.step == i + 1
                       and abs(t.state.learning_rates[0] - sched(i + 1)) <= 1e-15,
                       f"step count {t.state.step}, next rate {t.state.learning_rates[0]:.9e} "
                       f"= 0.01 (1 - {i + 1} / 30000)^0.9")

        # the first step again with K6 under autograd: same weights, same batch
        f = self._rss_trainer(initial, fused_attn=True)
        f_norms = {}
        for mod in mods:
            mod.reset_launches()
        f_met = self._one_step(f, batch, self.seed, f_norms)
        counts = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
        self.launches_rss_train = counts
        want = {k: (RSS_BLOCKS if k == "isa_core" else 0) for k in counts}
        self.check(counts == want, f"fused_attn step: launch counts {counts}; K6 {RSS_BLOCKS} "
                                   "(one a transformer block, forward only), all else 0")
        for k, v in f_met.items():
            tol = STEP_TOL * abs(first[k]) + STEP_ATOL
            self.check(abs(v - first[k]) <= tol,
                       f"fused_attn step, {k}: {v:.6f} against the unfused step's "
                       f"{first[k]:.6f} (tol {tol:.2e})")
        for k, v in f_norms.items():
            tol = STEP_TOL * first_norms[k] + STEP_ATOL
            self.check(abs(v - first_norms[k]) <= tol,
                       f"fused_attn step, gradient norm of group {k}: {v:.6e} against "
                       f"{first_norms[k]:.6e} (tol {tol:.2e})")
        del f

        # evaluate() on K5: two batches of 4, weights calmed, against fused_mlp=False
        model = t.model
        calm(torch, model, torch.Generator().manual_seed(self.seed + 11))
        halves = [(batch["image"][j:j + RSS_EVAL_BATCH], batch["mask"][j:j + RSS_EVAL_BATCH])
                  for j in range(0, 2 * RSS_EVAL_BATCH, RSS_EVAL_BATCH)]
        set_rss_flags(model, True, False)
        tm.reset_launches()
        ti.reset_launches()
        scores = trs.evaluate(model, halves, RSS_CLASSES)
        counts = {**tm.LAUNCHES, **ti.LAUNCHES}
        self.launches_rss_eval = counts
        want = {"mlp_fc1": 2 * RSS_BLOCKS, "mlp_taps": 2 * RSS_BLOCKS, "isa_core": 0}
        self.check(counts == want, f"evaluate, two batches of {RSS_EVAL_BATCH}: launch counts "
                                   f"{counts} (K5 8 + 8 a forward)")
        log(f"  evaluate, fused_mlp=True: pAcc {scores['pAcc']:.4f}, mAcc {scores['mAcc']:.4f}, "
            f"mIoU {scores['miou']:.4f}")
        set_rss_flags(model, False, False)
        tm.reset_launches()
        plain = trs.evaluate(model, halves, RSS_CLASSES)
        self.check(sum(tm.LAUNCHES.values()) == 0
                   and all(abs(scores[k] - plain[k]) <= 1.0 - RSS_SHARE for k in ("pAcc", "mAcc")),
                   f"evaluate, fused_mlp=False (no K5 launch): pAcc {plain['pAcc']:.4f}, mAcc "
                   f"{plain['mAcc']:.4f}, within {1.0 - RSS_SHARE:.2f} of K5's")
        eval_step = trs.make_rssformer_eval_step(model)
        probs = {}
        for fused in (True, False):
            set_rss_flags(model, fused, False)
            probs[fused] = torch.cat([eval_step(img) for img, _ in halves])
        err = (probs[True] - probs[False]).abs().max().item()
        self.check(err <= RSS_TOL, f"evaluate's probabilities, K5 against fused_mlp=False: max "
                                   f"abs err {err:.3e} (tol {RSS_TOL:.0e})")
        # trained on random masks, the classes lie close together: a pixel whose two best
        # probabilities are within the bound above may flip, any other must not
        top2 = probs[False].topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > RSS_TOL
        same = probs[True].argmax(1) == probs[False].argmax(1)
        share = same[clear].float().mean().item() if bool(clear.any()) else 0.0
        self.check(bool(clear.any()) and share >= RSS_SHARE,
                   f"evaluate's classes, K5 against fused_mlp=False: equal on {100.0 * share:.3f}% "
                   f"of the {100.0 * clear.float().mean().item():.2f}% of pixels whose two best "
                   f"probabilities differ by more than {RSS_TOL:.0e} (at least "
                   f"{100.0 * RSS_SHARE:.1f}%); on {100.0 * same.float().mean().item():.3f}% of "
                   "all pixels")
        set_rss_flags(model, False, False)

    # ------------------------------------------------------------- phase 7d (WaveCAM)
    def run_wavecam(self) -> None:
        """WaveCAM's pseudo-label inference path: the bench's CAM configuration in
        bf16 against f32; the three stages on one VOC-sized image, each timed; the
        CRF pass with the host lattice against the grid; the whole chain at
        CHAIN_HW on the card against the CPU. No hand-written kernel runs here."""
        torch = self.torch
        from representationlearning_tpu_torch import bench as tb
        from representationlearning_tpu_torch.models.irn import IRNNet
        from representationlearning_tpu_torch.models.resnet import Net
        from representationlearning_tpu_torch.ops.crf import crf_inference_label
        from representationlearning_tpu_torch.wsss import wavecam_infer as TW
        from representationlearning_tpu_torch.wsss.indexing import propagate_to_edge

        dev, gen = self.dev, torch.Generator().manual_seed(self.seed + 7)
        B = WAVECAM_BATCH
        log(f"== WaveCAM: bench.py::bench_wavecam_cams, Net(n_classes={WAVECAM_CLASSES}, "
            f"bf16), one cam over {B} x {WAVECAM_SIDE}² and their flips (batch {2 * B}); "
            "weights calmed (chip_smoke.py::calm: FrozenBatchNorm scales around 0.5, noise "
            "on every statistic and bias), without which sixteen bottlenecks bring the bf16 "
            "error within a few tenths of the bound")
        w = tb.build_wavecam_cams(dev, side=WAVECAM_SIDE, batch=B)
        calm(torch, w.model, gen)
        tb.reset_kernel_launches()
        torch.cuda.reset_peak_memory_stats()
        cams = w.run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launched = {k: v for c in tb.kernel_launches().values() for k, v in c.items() if v}
        ms = self.time_ms(w.run, 5)
        log(f"  {ms:.3f} ms a call (CUDA events, mean of 5), {B * 1e3 / ms:.2f} CAMs/s, peak "
            f"{peak / 2**30:.2f} GiB")
        self.check(not launched, f"cam pair: hand-written kernels launched {launched or 'none'}")
        f32 = Net(n_classes=WAVECAM_CLASSES, device=dev).eval()
        f32.load_state_dict(w.model.state_dict())
        x = torch.from_numpy(w.inputs["x"].transpose(0, 3, 1, 2).copy()).to(dev)
        with torch.no_grad():
            cc = f32.cam(torch.cat([x, x.flip(-1)]))
            want = torch.relu(cc[:B]) + torch.relu(cc[B:]).flip(-1)
        err, top = max_err(cams, want)
        self.check(cams.shape == (B, WAVECAM_CLASSES, WAVECAM_SIDE // 16, WAVECAM_SIDE // 16)
                   and cams.dtype == torch.float32 and cams.is_cuda
                   and bool(torch.isfinite(cams).all()),
                   f"bf16 CAMs {tuple(cams.shape)} f32, finite, on the card")
        self.check(err <= WAVECAM_TOL * top,
                   f"bf16 CAMs against the same call in f32: max abs err {err:.3e} of "
                   f"{top:.3e} ({err / top:.2e}, tol {WAVECAM_TOL:.0e})")
        del w, f32, x, cams, cc, want
        torch.cuda.empty_cache()

        H, W = VOC_HW
        n = 1 + int(torch.randint(3, (1,), generator=gen))
        classes = torch.randperm(WAVECAM_CLASSES, generator=gen)[:n].tolist()
        img, im, centres = voc_image(torch, gen, H, W, n)
        img, im = img.to(dev), im.to(dev)
        onehot = torch.zeros(WAVECAM_CLASSES)
        onehot[classes] = 1.0
        net = Net(16, WAVECAM_CLASSES, generator=torch.Generator().manual_seed(self.seed),
                  device=dev).eval()
        irn = IRNNet(generator=torch.Generator().manual_seed(self.seed + 1), device=dev).eval()
        calm(torch, net, gen)
        calm(torch, irn, gen)
        structured_classifier(torch, net, im, classes, centres)
        log(f"== WaveCAM pseudo-label stages on one {H} x {W} image, classes {classes}: make_cam "
            f"Net(stride=16) f32 at scales {WAVECAM_SCALES}; cam_to_ir_label (CRF grid, "
            f"{CONF_FG} / {CONF_BG}); make_sem_seg_labels (IRN, radius {RW_RADIUS}, beta "
            f"{RW_BETA}, exp_times {RW_EXP}, background {SEM_BG}); weights calmed, each present "
            "class's classifier weight the centred feature of its disc "
            "(chip_smoke.py::structured_classifier); the second of two runs timed")

        def run_chain():
            times, out = {}, {}

            def stage(name, fn):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                r = fn()
                torch.cuda.synchronize()
                times[name] = (1e3 * (time.perf_counter() - t0), torch.cuda.max_memory_allocated())
                return r

            d = stage("make_cam", lambda: TW.make_cam(net, im, onehot, WAVECAM_SCALES))
            conf = stage("cam_to_ir_label", lambda: TW.cam_to_ir_label(img, d, CONF_FG, CONF_BG))
            sem = stage("make_sem_seg_labels", lambda: TW.make_sem_seg_labels(
                irn, im, d, RW_RADIUS, RW_BETA, RW_EXP, SEM_BG, out=out))
            cams = torch.as_tensor(d["cam"], device=dev)
            stage("random walk alone", lambda: propagate_to_edge(cams, out["edge"], RW_RADIUS,
                                                                 RW_BETA, RW_EXP))
            return d, conf, sem, out, times

        tb.reset_kernel_launches()
        run_chain()
        d, conf, sem, out, times = run_chain()
        launched = {k: v for c in tb.kernel_launches().values() for k, v in c.items() if v}
        N = out["trans"].shape[0]
        for name, (t, mem) in times.items():
            log(f"  {name}: {t:.1f} ms, peak {mem / 2**30:.2f} GiB")
        walk = 2.0 * N ** 3 * RW_EXP
        log(f"  transition matrix {N} x {N} f32, {out['trans'].numel() * 4 / 1e6:.0f} MB; "
            f"{RW_EXP} squarings {walk / 1e12:.1f} TFLOP, "
            f"{walk / times['random walk alone'][0] / 1e9:.1f} TFLOP/s in the walk alone")
        self.wavecam_stage_ms = {k: t for k, (t, _) in times.items()}
        keys = [0] + (d["keys"] + 1).tolist()
        cols = (out["trans"].sum(0) - 1).abs().max().item()
        self.check(cols <= COLUMN_TOL, f"every column of the transition matrix sums to 1 within "
                   f"{cols:.2e} (tol {COLUMN_TOL:.0e})")
        ir_vals, sem_vals = torch.unique(conf).tolist(), torch.unique(sem).tolist()
        log(f"  IR label classes {ir_vals}, pseudo label classes {sem_vals}; keys {keys}")
        self.check(set(ir_vals) <= set(keys) | {255} and set(sem_vals) <= set(keys),
                   "the labels lie in the keys (the IR label also 255, unsure)")
        self.check(all(t.is_cuda for t in (conf, sem, out["trans"], out["edge"], out["scores"])),
                   "the labels, edges, scores and transition matrix are on the card")
        self.check(not launched, f"the stages launch no hand-written kernel "
                   f"({launched or 'none'})")

        cams = torch.as_tensor(d["high_res"], device=dev)
        padded = torch.cat([torch.full((1, H, W), CONF_FG, device=dev), cams])
        labels = {}
        for method in ("grid", "native"):
            t0 = time.perf_counter()
            labels[method] = crf_inference_label(img, padded.argmax(0), n_labels=len(keys),
                                                 method=method)
            torch.cuda.synchronize()
            log(f"  CRF label pass, {method}: {1e3 * (time.perf_counter() - t0):.1f} ms")
        agree = (labels["grid"] == labels["native"]).float().mean().item()
        self.check(agree >= CRF_AGREE, f"CRF label pass, grid against the host lattice: equal "
                   f"on {100 * agree:.3f}% of the pixels (at least {100 * CRF_AGREE:.0f}%)")
        del out, net, irn, d, conf, sem, cams, padded, labels
        torch.cuda.empty_cache()
        self._wavecam_chain_vs_cpu()

    def _wavecam_chain_vs_cpu(self) -> None:
        """The whole chain at CHAIN_HW on the card and on the CPU in f32 from the
        same weights: the CAM dicts close, the IR labels equal on CHAIN_SHARE of
        the pixels, the pseudo labels on CHAIN_SHARE of those off near-ties."""
        torch = self.torch
        from representationlearning_tpu_torch.models.irn import IRNNet
        from representationlearning_tpu_torch.models.resnet import Net
        from representationlearning_tpu_torch.wsss import wavecam_infer as TW

        gen = torch.Generator().manual_seed(self.seed + 8)
        H, W = CHAIN_HW
        img, im, centres = voc_image(torch, gen, H, W, 2)
        classes = torch.randperm(WAVECAM_CLASSES, generator=gen)[:2].tolist()
        onehot = torch.zeros(WAVECAM_CLASSES)
        onehot[classes] = 1.0
        cpu = torch.device("cpu")
        nets = {cpu: Net(16, WAVECAM_CLASSES, generator=torch.Generator().manual_seed(3),
                         device=cpu).eval()}
        irns = {cpu: IRNNet(generator=torch.Generator().manual_seed(4), device=cpu).eval()}
        calm(torch, nets[cpu], gen)
        calm(torch, irns[cpu], gen)
        structured_classifier(torch, nets[cpu], im, classes, centres)
        nets[self.dev] = Net(16, WAVECAM_CLASSES, device=self.dev).eval()
        nets[self.dev].load_state_dict(nets[cpu].state_dict())
        irns[self.dev] = IRNNet(device=self.dev).eval()
        irns[self.dev].load_state_dict(irns[cpu].state_dict())
        res = {}
        for dev in (self.dev, cpu):
            out = {}
            d = TW.make_cam(nets[dev], im.to(dev), onehot, WAVECAM_SCALES)
            conf = TW.cam_to_ir_label(img.to(dev), d, CONF_FG, CONF_BG)
            sem = TW.make_sem_seg_labels(irns[dev], im.to(dev), d, RW_RADIUS, RW_BETA, RW_EXP,
                                         SEM_BG, out=out)
            res[dev.type] = (d, conf.cpu(), sem.cpu(), out["scores"].cpu())
        (dc, cc, sc, _), (dh, ch, sh, scores) = res["cuda"], res["cpu"]
        cam_err = max(float(abs(dc[k] - dh[k]).max()) for k in ("cam", "high_res"))
        top2 = scores.topk(2, dim=0).values
        clear = (top2[0] - top2[1]) > NEAR_TIE
        ir_share = (cc == ch).float().mean().item()
        sem_share = (sc == sh)[clear].float().mean().item()
        log(f"== WaveCAM chain at {H} x {W} on the card against the CPU (f32, the same weights): "
            f"CAM dicts max abs err {cam_err:.2e}; IR label classes {torch.unique(ch).tolist()}, "
            f"pseudo label classes {torch.unique(sh).tolist()}")
        self.check(list(dc["keys"]) == list(dh["keys"]) and cam_err <= 1e-3,
                   f"CAM dicts: the same keys, max abs err {cam_err:.2e} of 1 (tol 1e-3)")
        self.check(ir_share >= CHAIN_SHARE, f"IR labels equal on {100 * ir_share:.3f}% of all "
                   f"pixels (at least {100 * CHAIN_SHARE:.1f}%)")
        self.check(sem_share >= CHAIN_SHARE,
                   f"pseudo labels equal on {100 * sem_share:.3f}% of the "
                   f"{100 * clear.float().mean().item():.2f}% of pixels off near-ties "
                   f"(two best scores more than {NEAR_TIE:.0e} apart; at least "
                   f"{100 * CHAIN_SHARE:.1f}%)")

    # ------------------------------------------------------------- phase 7e (DRFL)
    def run_drfl(self, card: str) -> None:
        """DRFL's training, evaluation and command line (configs/drfl.yaml), which
        has no hand-written kernel: Softnet(3, DRFL_LAYERS) at DRFL_SIDE² on the
        synthetic source, steps at each of DRFL_BATCHES checked and timed, then
        ``evaluate_drfl`` and ``threshold_sweep``; the card against the CPU at
        DRFL_SMALL²; ``cli/train_drfl.py``'s train and test --sweep on the card."""
        torch = self.torch
        from representationlearning_tpu_torch import bench as tb
        from representationlearning_tpu_torch.cli.train_drfl import main as drfl_main
        from representationlearning_tpu_torch.data.medical import DRFLPairedDataset, collate_drfl
        from representationlearning_tpu_torch.infer import drfl_eval as TE
        from representationlearning_tpu_torch.models.dcl import Softnet
        from representationlearning_tpu_torch.train import drfl as TT

        tb.reset_kernel_launches()
        t_phase = time.perf_counter()
        dev = self.dev
        model = Softnet(3, DRFL_LAYERS, DRFL_SIDE,
                        generator=torch.Generator().manual_seed(self.seed + 9), device=dev)
        n_params = sum(p.numel() for p in model.parameters())
        ds = DRFLPairedDataset(crop_size=DRFL_SIDE, synthetic_size=DRFL_SIDE, synthetic_n=DRFL_N)
        samples = [ds[i] for i in range(len(ds))]
        cfg = TT.DRFLConfig()
        log(f"== DRFL: Softnet(3, {DRFL_LAYERS}) at {DRFL_SIDE}², {n_params:,} parameters, f32, "
            f"TF32 off; the synthetic source at {DRFL_SIDE}² ({DRFL_N} samples); Adam "
            f"(0.5, 0.999) at lr {cfg.lr}; {DRFL_STEPS} checked steps, then {DRFL_TIMED} timed "
            f"(CUDA events, median) at batch {' and '.join(map(str, DRFL_BATCHES))}; {card}")
        step = TT.make_drfl_train_step(model)   # the card by default
        for B in DRFL_BATCHES:
            batch = collate_drfl(samples[:B])
            state = TT.create_drfl_state(model, cfg, len(samples) // B)
            stats0 = {k: b.clone() for k, b in model.named_buffers() if "running" in k}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses = []
            for i in range(DRFL_STEPS):
                before = [p.detach().clone() for p in model.parameters()] if i == 0 else None
                _, metrics = step(state, batch, torch.Generator().manual_seed(i))
                losses.append({k: float(v) for k, v in metrics.items()})
                if before is not None:
                    moved = [(p.detach() - q).abs() for p, q in zip(model.parameters(), before)]
                    top = max(float(d.max()) for d in moved)
                    excess = max(float((d - cfg.lr - 2.4e-7 * q.abs()).max())
                                 for d, q in zip(moved, before))
                    del before, moved
            stale = [k for k, b in model.named_buffers() if "running" in k
                     and torch.equal(b, stats0[k])]
            self.check(all(all(map(math.isfinite, m.values())) for m in losses),
                       f"batch {B}: {DRFL_STEPS} steps' losses finite: " + "; ".join(
                           f"total {m['total']:.4f} (L1 {m['G_L1']:.4f}, G_bin {m['G_bin']:.4f}, "
                           f"bin {m['bin']:.4f})" for m in losses))
            self.check(not stale, f"batch {B}: every BatchNorm's running statistics moved "
                       f"({len(stats0)} buffers; unmoved: {stale[:3] or 'none'})")
            self.check(excess <= 1e-3 * cfg.lr and top >= 0.5 * cfg.lr,
                       f"batch {B}: the first step moved no parameter by more than the rate "
                       f"(largest move {top:.4e}, lr {cfg.lr:.1e}: Adam's first step is "
                       "lr * g / (|g| + eps))")

            def one_step():
                step(state, batch, torch.Generator().manual_seed(7))

            ms = self.event_median_ms(one_step, DRFL_TIMED)
            peak = torch.cuda.max_memory_allocated()
            busy, launches = tb.trace_calls(one_step, 2)
            flops = tb.count_flops(one_step)
            log(f"  batch {B}: {ms:.3f} ms a step, {B * 1e3 / ms:.2f} images/s; {launches:.0f} "
                f"launches a step, device busy {busy:.3f} ms, idle share {1 - busy / ms:.4f}; "
                f"peak {peak / 2**30:.2f} GiB; {flops / B / 1e9:.2f} GFLOP an image "
                f"({flops / B / 1e9 * B * 1e3 / ms / 1e3:.2f} TFLOP/s); {card}")
            del state
            torch.cuda.empty_cache()

        B = max(DRFL_BATCHES)
        batches = [collate_drfl(samples[i:i + B]) for i in range(0, len(samples) - B + 1, B)]
        x = TT.drfl_batch(batches[0], dev)["A"]
        model.eval()

        def forward():
            with torch.no_grad():
                model(x)

        ms = self.event_median_ms(forward, DRFL_TIMED)
        log(f"  eval forward, batch {B}: {ms:.3f} ms, {B * 1e3 / ms:.2f} images/s; {card}")
        scores = TE.evaluate_drfl(model, batches, cfg.threshold)
        sweep = TE.threshold_sweep(model, batches)
        log(f"  evaluate_drfl at {cfg.threshold}: {scores}; threshold_sweep: best "
            f"{sweep['best_threshold']}, {sweep['best']}")
        self.check(all(0.0 <= v <= 1.0 for v in scores.values())
                   and all(0.0 <= r["dice"] <= 1.0 for r in sweep["all"].values())
                   and len(sweep["all"]) == 20, "evaluate_drfl and the 20-threshold sweep: "
                   "every score in [0, 1]")
        del model, x
        torch.cuda.empty_cache()

        res = drfl_card_vs_cpu(torch, dev, self.seed + 10)
        log(f"  {DRFL_SMALL}² card / CPU / CPU f64: losses {res['losses']}; module gradient "
            f"norms {res['norms']}")
        for ok, msg in drfl_agreement(res):
            self.check(ok, msg)

        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            common = ["--config", str(ROOT / "configs" / "drfl.yaml"), "crop_size=64",
                      "synthetic_size=64", "synthetic_n=2", "batch_size=2", "epochs=1",
                      "num_vit_layers=1", f"output={tmp}"]
            history = drfl_main(["train"] + common)
            res = drfl_main(["test", "--sweep"] + common)
            files = sorted(p.name for p in Path(tmp).glob("net_*.pt"))
        self.check(len(history) == 1 and math.isfinite(history[0]["loss"])
                   and files == ["net_best.pt", "net_latest.pt"] and "best_threshold" in res,
                   f"cli.train_drfl train, then test --sweep, on the card by default: loss "
                   f"{history[0]['loss']:.4f}, best threshold {res.get('best_threshold')}, "
                   f"{files}, {time.perf_counter() - t0:.1f} s")
        launched = {k: v for c in tb.kernel_launches().values() for k, v in c.items() if v}
        self.check(not launched, f"DRFL's path launched no hand-written kernel "
                   f"({launched or 'none'})")
        log(f"  phase 7e: {time.perf_counter() - t_phase:.1f} s")

    # ------------------------------------------------------------- phase 7f (WSSS CLIs)
    def _cli_run(self, module, argv: list[str], mods, factory: str) -> SimpleNamespace:
        """``module.main(argv)`` on the card, with its train step and its
        ``validate`` (where it has one) instrumented: every kernel's launches a
        step (the counts set to 0 just before each step and read just after), the
        step's losses, the wall clock at its end; each validation's scores, time,
        class count and launches."""
        torch = self.torch
        rec = SimpleNamespace(steps=[], vals=[], t0=time.perf_counter())
        make, validate = getattr(module, factory), getattr(module, "validate", None)

        def counts():
            return {k: v for mod in mods for k, v in mod.LAUNCHES.items()}

        def reset():
            for mod in mods:
                mod.reset_launches()

        def instrumented(*a, **kw):
            step = make(*a, **kw)

            def run(state, batch, generator=None):
                reset()
                rec.last = (step, state, batch)
                held, self.holding = self.plain_runs, not rec.steps
                state, metrics = step(state, batch, generator)
                torch.cuda.synchronize()
                self.holding = False
                rec.steps.append({"end": time.perf_counter(), "launches": counts(),
                                  "losses": {k: float(v) for k, v in metrics.items()},
                                  "held": self.plain_runs != held})
                return state, metrics
            return run

        def timed_validate(val_ds, eval_fn, cfg, *a, **kw):
            reset()
            held, self.holding = self.plain_runs, not rec.vals
            t0 = time.perf_counter()
            scores = validate(val_ds, eval_fn, cfg, *a, **kw)
            torch.cuda.synchronize()
            launches, plain = counts(), None
            if self.holding and self.plain_path is not None:   # the same, on the plain path
                self.holding = False
                with self.plain_path():
                    plain = validate(val_ds, eval_fn, cfg, *a, **kw)
                self.plain_runs += 1
            self.holding = False
            rec.vals.append({"start": t0, "s": time.perf_counter() - t0,
                             "images": min(len(val_ds), 64), "classes": cfg.num_classes,
                             "scores": scores, "plain_scores": plain, "launches": launches,
                             "held": self.plain_runs != held})
            return scores

        setattr(module, factory, instrumented)
        if validate is not None:
            module.validate = timed_validate
        try:
            rec.state = module.main(argv)   # the card: no device named
        finally:
            setattr(module, factory, make)
            if validate is not None:
                module.validate = validate
        return rec

    def _cli_steps(self, what: str, rec, cam_iters: int, start: int = 0) -> float:
        """Check every step's losses and launches (K1's five kernels, K2 and K3 on
        every step, the same counts each step, no other kernel) and return the
        median ms a step after the warm-up, end to end through the CLI (loader,
        step, logging), over steps with no validation before them and no
        comparison with a plain version in them."""
        k1 = tuple(PIECE_TOL)
        for i, s in enumerate(rec.steps):
            n = start + i + 1   # the step count before it is n - 1: warm-up while <= cam_iters
            m, warm = s["losses"], n - 1 <= cam_iters
            self.check(all(map(math.isfinite, m.values())) and (
                m["total"] == m["cls"] if warm else m["total"] > m["cls"]),
                f"{what}, step {n}: losses finite, total {m['total']:.6f} "
                f"{'=' if warm else '>'} cls {m['cls']:.6f} "
                f"({'within' if warm else 'after'} the warm-up, cam_iters {cam_iters})")
        first = rec.steps[0]["launches"]
        on = set(k1) | {"affinity", "varm_propagate"}
        self.check(all(first.get(k, 0) > 0 for k in on)
                   and all(v == 0 for k, v in first.items() if k not in on)
                   and all(s["launches"] == first for s in rec.steps),
                   f"{what}: every step launched K1 ({'/'.join(str(first[k]) for k in k1)}), "
                   f"K2 {first['affinity']} and K3 {first['varm_propagate']}, the same each "
                   f"step, K4 / K5 / K6 never ({len(rec.steps)} steps)")
        gaps = [b["end"] - a["end"] for a, b, n in
                zip(rec.steps, rec.steps[1:], range(start + 2, start + len(rec.steps) + 1))
                if n - 1 > cam_iters and not b["held"]
                and not any(a["end"] < v["start"] < b["end"] for v in rec.vals)]
        ms = statistics.median(gaps) * 1e3 if gaps else float("nan")
        spread = (f"; {len(gaps)} steps, min {min(gaps) * 1e3:.1f}, quartiles "
                  f"{' / '.join(f'{q * 1e3:.1f}' for q in statistics.quantiles(gaps, n=4))}, "
                  f"max {max(gaps) * 1e3:.1f} ms") if len(gaps) >= 4 else ""
        log(f"  {what}: start-up to the first step's end {rec.steps[0]['end'] - rec.t0:.1f} s; "
            f"{', '.join(f'{g * 1e3:.1f}' for g in gaps)} ms a step after the warm-up with no "
            f"validation before it; median {ms:.1f} ms{spread}")
        return ms

    def _cli_step_alone(self, what: str, rec, reps: int = WSSS_TIMED) -> tuple[float, float]:
        """The CLI's own step function on its last batch, after the run, outside the
        loop: its time (CUDA events, median of ``reps``), launches and device-busy
        time a step from a two-step trace. Returns (ms, idle share)."""
        from representationlearning_tpu_torch import bench as tb

        step, state, batch = rec.last

        def again():
            step(state, batch, self.torch.Generator().manual_seed(0))

        ms = self.event_median_ms(again, reps)
        busy, launches = tb.trace_calls(again, 2)
        log(f"  {what}, the step alone: {ms:.1f} ms (CUDA events, median of {reps}), "
            f"{launches:.0f} launches, device busy {busy:.1f} ms, idle share {1 - busy / ms:.4f}")
        return ms, 1 - busy / ms

    def _cli_vals(self, what: str, rec, classes: int, want: int) -> float:
        ok = len(rec.vals) == want
        for v in rec.vals:
            mious = [v["scores"][k]["miou"] for k in ("seg", "cam", "ref")]
            ok &= (v["classes"] == classes and len(v["scores"]["seg"]["iou"]) == classes
                   and all(0.0 <= x <= 1.0 for x in mious)
                   and v["launches"]["attention"] > 0 and v["launches"]["flash_fwd"] == 0)
            log(f"  {what}, validation: seg / cam / ref mIoU "
                f"{' / '.join(f'{x:.4f}' for x in mious)}, {v['images']} images in "
                f"{v['s']:.3f} s{' (with the comparisons)' if v['held'] else ''}, K1 attention "
                f"{v['launches']['attention']}")
        self.check(ok, f"{what}: {want} validation(s) at {classes} classes, each with three "
                       "mIoUs in [0, 1], through K1 (the exporting twin)")
        clean = [v["s"] / v["images"] for v in rec.vals if not v["held"]]
        return statistics.median(clean) if clean else float("nan")

    def _held_at_first_call(self, held: dict, kernel: str, kernel_fn, plain_fn, tol_of):
        """``kernel_fn`` as a function that, while ``self.holding``, also runs
        ``plain_fn`` on the same inputs at the first call of every geometry it
        meets and checks each output within ``tol_of(output index, max |plain|)``;
        ``held[kernel]`` maps each geometry to its largest error as a share of its
        tolerance. The plain versions launch nothing, so no count moves."""
        torch = self.torch

        def shape(v):
            if torch.is_tensor(v):
                return tuple(v.shape), str(v.dtype).removeprefix("torch.")
            return len(v) if isinstance(v, dict) else v

        def run(*a, **kw):
            got = kernel_fn(*a, **kw)
            if not self.holding:
                return got
            at = tuple(map(shape, a)) + tuple(sorted((k, shape(v)) for k, v in kw.items()))
            if at in held.setdefault(kernel, {}):
                return got
            with torch.no_grad():
                want = plain_fn(*a, **kw)
            self.plain_runs += 1
            worst = 0.0
            got_t = got if isinstance(got, tuple) else (got,)
            want_t = want if isinstance(want, tuple) else (want,)
            for i, (g, w) in enumerate(zip(got_t, want_t)):
                if g is None and w is None:
                    continue
                err, mag = max_err(g, w) if g.numel() else (0.0, 0.0)
                tol = tol_of(i, mag)
                if not (bool(torch.isfinite(g.float()).all()) and err <= tol):
                    self.check(False, f"{kernel} @ {at}, output {i}: max abs err {err:.3e} "
                                      f"(max |plain| {mag:.3e}, tol {tol:.3e})")
                worst = max(worst, err / tol)
            held[kernel][at] = worst
            return got
        return run

    @contextlib.contextmanager
    def _held_to_plain(self, mods, held: dict):
        """Phase 7f's kernels as the command lines call them, each held against its
        plain version on the same inputs at the first call of every geometry it
        meets while ``self.holding`` (the first step and the first validation of
        each run: a run gives the same geometries every step and every validation
        image). K1's five pieces at PIECE_TOL (the exported logits at LOGIT_TOL) and
        the whole block at PATH_TOL, K2 at AFFINITY_TOL, K3 at VARM_TOL. ``held``
        maps each kernel to {geometry: largest error as a share of its tolerance}."""
        tmb, ta, tv = mods[:3]
        from representationlearning_tpu_torch.models.mit import FusedBlock

        def held_at_first_call(kernel, kernel_fn, plain_fn, tol_of):
            return self._held_at_first_call(held, kernel, kernel_fn, plain_fn, tol_of)

        pieces = {n: getattr(tmb.DISPATCH, n) for n in PIECE_TOL}
        block = FusedBlock.__dict__["block_fn"]
        refine = (ta.affinity, tv.varm_propagate)
        for n, fn in pieces.items():
            setattr(tmb.DISPATCH, n, held_at_first_call(
                n, fn, getattr(tmb, n + "_reference"),
                lambda i, mag, n=n: (LOGIT_TOL if i == 1 else PIECE_TOL[n]) * max(1.0, mag)))
        FusedBlock.block_fn = staticmethod(held_at_first_call(
            "block", tmb.fused_block, tmb.fused_block_reference, lambda i, mag: PATH_TOL * mag))
        ta.affinity = held_at_first_call("affinity", ta.affinity, ta.affinity_reference,
                                         lambda i, mag: AFFINITY_TOL)
        tv.varm_propagate = held_at_first_call("varm_propagate", tv.varm_propagate,
                                               tv.varm_propagate_reference,
                                               lambda i, mag: VARM_TOL)
        try:
            yield held
        finally:
            for n, fn in pieces.items():
                setattr(tmb.DISPATCH, n, fn)
            FusedBlock.block_fn = block
            ta.affinity, tv.varm_propagate = refine

    @contextlib.contextmanager
    def _plain_path(self, mods):
        """K1 in every FusedBlock, K2 and K3 swapped for their plain versions."""
        tmb, ta, tv = mods[:3]
        from representationlearning_tpu_torch.models.mit import FusedBlock

        saved = (FusedBlock.__dict__["block_fn"], ta.affinity, tv.varm_propagate)
        FusedBlock.block_fn = staticmethod(tmb.fused_block_reference)
        ta.affinity, tv.varm_propagate = ta.affinity_reference, tv.varm_propagate_reference
        try:
            yield
        finally:
            FusedBlock.block_fn, ta.affinity, tv.varm_propagate = saved

    @contextlib.contextmanager
    def _paths_compared(self, mods, shares: list):
        """While ``self.holding`` (a run's first step), the step's multi-scale CAMs are
        made a second time on the plain path and refined there too: ``shares`` gets
        the share of refined labels on which the two paths agree. ``self.plain_path``
        lets the first validation of a run do the same (``_cli_run``)."""
        torch = self.torch
        from representationlearning_tpu_torch.wsss import camutils as CU

        cams_fn, refine_fn = CU.multi_scale_cam_with_ref_mat, CU.refine_cams_with_bkg_v2
        pending = {}

        def cams(cam_fn, images, *a, **kw):   # also reached through CU.multi_scale_cam
            got = cams_fn(cam_fn, images, *a, **kw)
            if self.holding:
                with self._plain_path(mods), torch.no_grad():
                    pending["cams"] = cams_fn(cam_fn, images, *a, **kw)[0]
                self.plain_runs += 1
            return got

        def refine(rf, images, cams_, *a, **kw):
            got = refine_fn(rf, images, cams_, *a, **kw)
            plain_cams = pending.pop("cams", None)
            if plain_cams is not None and plain_cams.shape == cams_.shape:
                with self._plain_path(mods), torch.no_grad():
                    want = refine_fn(rf, images, plain_cams, *a, **kw)
                shares.append((got == want).float().mean().item())
            return got

        CU.multi_scale_cam_with_ref_mat, CU.refine_cams_with_bkg_v2 = cams, refine
        self.plain_path = lambda: self._plain_path(mods)
        try:
            yield shares
        finally:
            CU.multi_scale_cam_with_ref_mat, CU.refine_cams_with_bkg_v2 = cams_fn, refine_fn
            self.plain_path = None

    def _paths_summary(self, what: str, shares: list, rec) -> None:
        """The refined labels and validation mIoUs of the kernel path against the plain
        path (``_paths_compared``), at WSSS_PATH_SHARE and WSSS_PATH_MIOU."""
        self.check(bool(shares) and min(shares) >= WSSS_PATH_SHARE,
                   f"{what}: refined labels of the first step, kernel path against plain path "
                   f"(f32): equal on {' / '.join(f'{100.0 * x:.4f}' for x in shares)}% "
                   f"(at least {100.0 * WSSS_PATH_SHARE:.2f}%)")
        del shares[:]
        for v in rec.vals:
            if v["plain_scores"] is None:
                continue
            d = max(abs(v["scores"][k]["miou"] - v["plain_scores"][k]["miou"])
                    for k in ("seg", "cam", "ref"))
            self.check(d <= WSSS_PATH_MIOU, f"{what}: validation mIoUs (seg, cam, ref), kernel "
                                            f"path against plain path: within {d:.2e} "
                                            f"(tol {WSSS_PATH_MIOU:.0e})")

    def _held_summary(self, held: dict) -> None:
        """One line a kernel: the geometries phase 7f held against the plain version
        and the largest error as a share of its tolerance; the exporting blocks' token
        grids and the refinement's shapes named."""
        for kernel, seen in held.items():
            worst = max(seen.values(), default=0.0)
            self.check(bool(seen) and worst <= 1.0,
                       f"7f {kernel}: {len(seen)} geometries held against the plain version "
                       f"at their first call, largest error {worst:.3f} of its tolerance")
        blocks = held.get("block", {})
        # a block's geometry: ((B, N, C), dtype), p, then H, W, dtype, export, nh, sr by name
        grids = sorted({(dict(at[2:])["H"], dict(at[2:])["W"], at[0][0][0], at[0][0][2],
                         dict(at[2:])["export"]) for at in blocks})
        log(f"  7f K1 blocks held (H, W, B, C, export): {grids}")
        dtypes = {str(dict(at[2:])["dtype"]) for at in blocks}
        self.check(dtypes == {"torch.float32"}, f"7f: every K1 block the twins ran computed in "
                                                f"{sorted(dtypes)} (float32, as JAX builds them)")
        self.check(any(e and h != w for h, w, _, _, e in grids),
                   "7f: the exporting K1 held on a non-square token grid (validation)")
        log(f"  7f affinity held at (shape, mode) "
            f"{sorted((at[0][0], at[2]) for at in held.get('affinity', {}))}, varm_propagate "
            f"at {sorted(at[0][0] for at in held.get('varm_propagate', {}))}")
        self.check(any(at[0][0][1] == 2 * 81 for at in held.get("varm_propagate", {})),
                   "7f: K3 held at COCO's 2 x 81 planes")

    def run_wsss_cli(self, mods, card: str) -> None:
        """``cli/train_scd.py`` on configs/scd_voc.yaml and configs/scd_coco.yaml and
        ``cli/train_rml.py`` on configs/rml_voc.yaml and configs/rml_coco.yaml, as a user
        runs them: the yamls' MiT-B1 at 320² crops, on-card augmentation of the synthetic
        source, iteration counts cut, in a temporary directory; the fused twins in f32,
        their first step's refined labels and first validation held to the plain path."""
        torch = self.torch
        from representationlearning_tpu_torch.cli import train_rml, train_scd

        tv = mods[2]
        t_phase = time.perf_counter()
        log(f"== WSSS command lines: cli.train_scd (configs/scd_voc.yaml, scd_coco.yaml) "
            f"and cli.train_rml (configs/rml_voc.yaml, rml_coco.yaml), MiT-B1, f32 twins, 320² crops from 512² "
            f"canvases augmented on the card, {WSSS_N} synthetic images (96 x 128); {card}")
        held: dict = {}
        shares: list = []
        with tempfile.TemporaryDirectory() as tmp, self._held_to_plain(mods, held), \
                self._paths_compared(mods, shares):
            tmp = Path(tmp)
            common = ["dataset.device_augment=true", f"dataset.synthetic_n={WSSS_N}",
                      "train.log_iters=1"]
            # (a) SCD on VOC, then a resume
            wd = tmp / "scd_voc"
            argv = ["--config", str(ROOT / "configs" / "scd_voc.yaml"), *common,
                    f"train.cam_iters={WSSS_CAM_ITERS}", f"train.eval_iters={WSSS_SCD_EVAL}",
                    f"work_dir.dir={wd}"]
            rec = self._cli_run(train_scd, argv + [f"train.max_iters={WSSS_SCD_STEPS}"], mods,
                                "make_scd_train_step")
            self.check(rec.state.step == WSSS_SCD_STEPS and len(rec.steps) == WSSS_SCD_STEPS,
                       f"(a) SCD on VOC: the state reached step {rec.state.step}")
            scd_ms = self._cli_steps("(a) SCD on VOC", rec, WSSS_CAM_ITERS)
            self.launches_wsss = rec.steps[0]["launches"]
            val_s = self._cli_vals("(a) SCD on VOC", rec, NUM_CLASSES, 2)
            self._paths_summary("(a) SCD on VOC", shares, rec)
            rows = [line.split(",") for line in
                    (wd / "events" / "scalars.csv").read_text().splitlines()[1:]]
            tags = {t for _, t, _ in rows}
            pngs = sorted(p.name for p in (wd / "events" / "images").glob("*.png"))
            want_pngs = sorted(f"val_{k}_{s:07d}.png" for k in ("cam_overlay", "seg_pred")
                               for s in (WSSS_SCD_EVAL, WSSS_SCD_STEPS))
            self.check(any(t.startswith("train/") for t in tags)
                       and {"val/seg_miou", "val/cam_miou", "val/ref_miou"} <= tags
                       and all(math.isfinite(float(v)) for _, t, v in rows
                               if t.startswith("train/")) and pngs == want_pngs,
                       f"(a) scalars.csv: {len(rows)} rows, tags {sorted(tags)}; PNGs {pngs}")
            resumed = self._cli_run(train_scd, argv + [f"train.max_iters={WSSS_SCD_STEPS + 1}"],
                                    mods, "make_scd_train_step")
            self.check(resumed.state.step == WSSS_SCD_STEPS + 1 and len(resumed.steps) == 1
                       and f"resumed from step {WSSS_SCD_STEPS}" in (wd / "train.log").read_text(),
                       f"(a) rerun with train.max_iters={WSSS_SCD_STEPS + 1}: resumed from step "
                       f"{WSSS_SCD_STEPS}, ended at {resumed.state.step}")
            self._cli_steps("(a) SCD on VOC, resumed", resumed, WSSS_CAM_ITERS, WSSS_SCD_STEPS)
            del rec, resumed

            # (b) SCD on COCO: 81 classes, no max_present
            planes = []
            propagate = tv.varm_propagate

            def recording(masks, *a, **kw):
                planes.append(tuple(masks.shape))
                return propagate(masks, *a, **kw)

            tv.varm_propagate = recording
            try:
                coco = self._cli_run(train_scd, [
                    "--config", str(ROOT / "configs" / "scd_coco.yaml"), *common,
                    f"train.max_iters={WSSS_COCO_STEPS}", "train.cam_iters=-1",
                    f"train.eval_iters={WSSS_COCO_STEPS}", f"work_dir.dir={tmp / 'scd_coco'}"],
                    mods, "make_scd_train_step")
            finally:
                tv.varm_propagate = propagate
            self.check(coco.state.step == WSSS_COCO_STEPS, f"(b) SCD on COCO: the state reached "
                       f"step {coco.state.step}")
            self._cli_steps("(b) SCD on COCO", coco, -1)
            self._paths_summary("(b) SCD on COCO", shares, coco)
            log(f"  (b) K3's masks a refine (B, C, H, W): {sorted(set(planes))}, "
                f"{planes[0][0] * planes[0][1] if planes else 0} planes")
            self.check(bool(planes) and all(p[1] == 2 * 81 for p in planes),
                       "(b) K3 refined all 81 channels twice (both thresholds) an image: "
                       "COCO has no max_present")
            self._cli_vals("(b) SCD on COCO", coco, 81, 1)

            # (c) RML on VOC
            rml = self._cli_run(train_rml, [
                "--config", str(ROOT / "configs" / "rml_voc.yaml"), *common,
                f"train.max_iters={WSSS_RML_STEPS}", f"train.cam_iters={WSSS_RML_CAM_ITERS}",
                f"work_dir={tmp / 'rml_voc'}"], mods, "make_rml_train_step")
            self.check(rml.state.step == WSSS_RML_STEPS
                       and (tmp / "rml_voc" / "checkpoints" / f"step_{WSSS_RML_STEPS}"
                            / "state.pt").is_file(),
                       f"(c) RML on VOC: the state reached step {rml.state.step}, checkpoint "
                       "written")
            self._cli_steps("(c) RML on VOC (K2 in par mode)", rml, WSSS_RML_CAM_ITERS)
            self._paths_summary("(c) RML on VOC", shares, rml)
            del rml

            # (d) RML on COCO: 81 classes
            rml = self._cli_run(train_rml, [
                "--config", str(ROOT / "configs" / "rml_coco.yaml"), *common,
                f"train.max_iters={WSSS_COCO_STEPS}", "train.cam_iters=-1",
                f"work_dir={tmp / 'rml_coco'}"], mods, "make_rml_train_step")
            self.check(rml.state.step == WSSS_COCO_STEPS, f"(d) RML on COCO: the state reached "
                                                          f"step {rml.state.step}")
            self._cli_steps("(d) RML on COCO", rml, -1)
            self._paths_summary("(d) RML on COCO", shares, rml)
            del rml

            # the figures: (a) and (c) again, WSSS_TIMED steps after the warm-up each
            timed = {}
            for what, module, factory, cam, argv in (
                    ("SCD on VOC", train_scd, "make_scd_train_step", WSSS_CAM_ITERS,
                     ["--config", str(ROOT / "configs" / "scd_voc.yaml"),
                      f"work_dir.dir={tmp / 'scd_timed'}"]),
                    ("RML on VOC", train_rml, "make_rml_train_step", WSSS_RML_CAM_ITERS,
                     ["--config", str(ROOT / "configs" / "rml_voc.yaml"),
                      f"work_dir={tmp / 'rml_timed'}"])):
                steps = cam + 1 + WSSS_TIMED
                rec = self._cli_run(module, argv + [
                    "dataset.device_augment=true", f"dataset.synthetic_n={WSSS_N}",
                    f"train.cam_iters={cam}", f"train.max_iters={steps}",
                    f"train.eval_iters={steps}"], mods, factory)
                self.check(rec.state.step == steps, f"{what}, timed: the state reached step "
                                                    f"{rec.state.step} of {steps}")
                timed[what] = self._cli_steps(f"{what}, timed (log_iters as the yaml)", rec, cam)
                self._paths_summary(f"{what}, timed", shares, rec)
                self._cli_step_alone(f"{what}, timed", rec)
                del rec
            scd_ms, rml_ms = timed["SCD on VOC"], timed["RML on VOC"]
        self._held_summary(held)
        log(f"  phase 7f figures ({card}): SCD on VOC {scd_ms:.1f} ms a step "
            f"(batch 2, median of {WSSS_TIMED}, through the CLI with the loader), RML on VOC "
            f"{rml_ms:.1f} ms a step, validation {val_s:.4f} s an image (96 x 128, three CAM "
            f"scales and flips)")
        log(f"  phase 7f: {time.perf_counter() - t_phase:.1f} s")

    # ------------------------------------------------------------- phase 7g (RSSFormer CLI)
    def _loveda_chain_vs_cpu(self) -> None:
        """The LoveDA chain (``augment_loveda_batch``) on the card against the same
        chain on the CPU, on the same decisions and canvases: LoveDA's 1024² images
        on the CLI's canvas, crop 512, every flip / rot90 op, half of the batch
        through ShiftScaleRotate."""
        torch = self.torch
        from representationlearning_tpu_torch.data import device_transforms as TD
        from representationlearning_tpu_torch.data.loveda import LoveDADataset

        cfg = TD.LoveDAAugConfig()
        ds = LoveDADataset(raw=True, canvas_size=RSS_CLI_CANVAS, synthetic_n=RSS_CLI_BATCH,
                           synthetic_size=(RSS_CLI_CANVAS, RSS_CLI_CANVAS))
        samples = [ds[i] for i in range(RSS_CLI_BATCH)]
        raw, hw, masks = (torch.stack([s[j] for s in samples]) for j in (1, 2, 3))
        dec = TD.sample_loveda_decisions(RSS_CLI_BATCH, cfg,
                                         torch.Generator().manual_seed(self.seed + 21))
        dec["fr_on"][:6] = True
        dec["op"][:] = torch.tensor([0, 1, 2, 2, 2, 0, 1, 2], dtype=torch.int32)
        dec["rot_k"][:] = torch.tensor([1, 1, 1, 2, 3, 2, 3, 1], dtype=torch.int32)
        dec["ssr_on"][:] = torch.arange(RSS_CLI_BATCH) % 2 == 0
        want_img, want_mask = TD.augment_loveda_batch(raw, hw, masks, dec, cfg)
        on_card = [t.to(self.dev) for t in (raw, hw, masks)]
        card_dec = {k: v.to(self.dev) for k, v in dec.items()}

        def chain():
            return TD.augment_loveda_batch(*on_card, card_dec, cfg)

        got_img, got_mask = chain()
        self.check(got_img.is_cuda and got_mask.is_cuda, "the LoveDA chain ran on the card")
        err = (got_img.cpu() - want_img).abs().max().item()
        sx, sy = TD._affine_source_coords(cfg.crop_size, cfg.crop_size, dec["angle"],
                                          dec["ssr_scale"], dec["shift"])
        near = torch.zeros_like(sx, dtype=torch.bool)
        for c in (sx, sy):
            near |= ((c - torch.floor(c)) - 0.5).abs() < LOVEDA_NEAR_HALF
        near &= dec["ssr_on"][:, None, None]
        differ = got_mask.cpu() != want_mask
        ms = self.event_median_ms(chain, 10)
        log(f"  (b) the LoveDA chain, {RSS_CLI_BATCH} x {RSS_CLI_CANVAS}² canvases -> "
            f"{cfg.crop_size}² crops: {ms:.3f} ms on the card (CUDA events, median of 10); "
            f"{int(near.sum())} mask pixels with a nearest tap's source coordinate within "
            f"{LOVEDA_NEAR_HALF:g} of a half, {int(differ[near].sum())} of them differ")
        self.check(err <= LOVEDA_IMG_TOL, f"(b) the LoveDA chain, card against CPU: images max "
                                          f"abs err {err:.3e} (tol {LOVEDA_IMG_TOL:.0e})")
        self.check(not bool(differ[~near].any()),
                   f"(b) masks equal but near a half: {int(differ[~near].sum())} of "
                   f"{int((~near).sum())} other pixels differ")

    @contextlib.contextmanager
    def _k5_held_to_plain(self, tm, held: dict):
        """K5's two kernels as the RSSFormer CLI calls them (f32), each held against its
        plain version at the first call of every geometry while ``self.holding``, at
        K5_F32_TOL of max(1, max |plain|); the plain taps read the hidden plane at its
        own width (the kernel's comes padded to `padded_hid`)."""
        torch = self.torch
        kernels = (tm.mlp_fc1, tm.mlp_taps)

        def fc1_plain(x, w1, *a, **kw):   # at the kernel's padded width
            h = tm.mlp_fc1_reference(x, w1, *a, **kw)
            return torch.nn.functional.pad(h, (0, tm.padded_hid(w1.shape[0]) - h.shape[-1]))

        def taps_plain(h, taps, *a, **kw):
            return tm.mlp_taps_reference(h[..., :taps.shape[1]], taps, *a, **kw)

        tm.mlp_fc1 = self._held_at_first_call(held, "mlp_fc1", tm.mlp_fc1, fc1_plain,
                                              lambda i, mag: K5_F32_TOL * max(1.0, mag))
        tm.mlp_taps = self._held_at_first_call(held, "mlp_taps", tm.mlp_taps, taps_plain,
                                               lambda i, mag: K5_F32_TOL * max(1.0, mag))
        try:
            yield held
        finally:
            tm.mlp_fc1, tm.mlp_taps = kernels

    def _rss_cli_infer(self, rc, trs, argv: list[str], mods):
        """One ``eval`` or ``predict`` of the RSSFormer CLI on the card: its forwards
        counted (and their probabilities kept for ``predict``), its launches, its
        wall time."""
        torch = self.torch
        rec = SimpleNamespace(forwards=0, probs=[])
        makers = (rc.make_rssformer_eval_step, trs.make_rssformer_eval_step)

        def counting(model):
            fwd = makers[0](model)

            def run(image):
                probs = fwd(image)
                rec.forwards += 1
                if argv[0] == "predict":
                    rec.probs.append(probs.float().cpu())
                return probs
            return run

        rc.make_rssformer_eval_step = trs.make_rssformer_eval_step = counting
        for mod in mods:
            mod.reset_launches()
        try:
            t0 = time.perf_counter()
            rec.out = rc.main(argv)
            torch.cuda.synchronize()
            rec.s = time.perf_counter() - t0
        finally:
            rc.make_rssformer_eval_step, trs.make_rssformer_eval_step = makers
        rec.launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
        return rec

    def run_rss_cli(self, mods, card: str) -> None:
        """``cli/rssformer.py`` on configs/rssformer_loveda.yaml as a user runs it:
        ``train`` at the yaml's hrnetv2_w32, 8 x 512² crops, with the LoveDA chain
        on the card, a resume; then ``eval --tta`` and ``predict`` with
        ``model.fused_mlp=True`` (K5, f32 as JAX builds the model) against the same
        commands without it."""
        torch = self.torch
        from representationlearning_tpu_torch.cli import rssformer as rc
        from representationlearning_tpu_torch.models.rssformer import HRNetFusion
        from representationlearning_tpu_torch.train import checkpoints as CK
        from representationlearning_tpu_torch.train import rssformer as trs

        tm = mods[4]
        t_phase = time.perf_counter()
        log(f"== RSSFormer command line: cli.rssformer train / eval --tta / predict "
            f"(configs/rssformer_loveda.yaml: hrnetv2_w32, 7 classes, {RSS_CLI_BATCH} x 512² "
            f"crops, the f32 model), the LoveDA chain on the card, 16 synthetic 128² images "
            f"on {RSS_CLI_CANVAS}² canvases; {card}")
        self._loveda_chain_vs_cpu()
        yaml = str(ROOT / "configs" / "rssformer_loveda.yaml")
        with tempfile.TemporaryDirectory() as tmp:
            wd = Path(tmp) / "work"
            argv = ["train", "--config", yaml, "data.device_augment=true",
                    "train.log_interval_step=1", f"train.eval_interval={RSS_CLI_SAVE}",
                    f"work_dir={wd}"]
            # (a) train, then a resume
            rec = self._cli_run(rc, argv + [f"train.num_iters={RSS_CLI_STEPS}"], mods,
                                "make_rssformer_train_step")
            saved = sorted(p.name for p in (wd / "checkpoints").iterdir())
            self.check(rec.state.step == RSS_CLI_STEPS == len(rec.steps)
                       and saved == [f"step_{n}" for n in range(RSS_CLI_SAVE, RSS_CLI_STEPS + 1,
                                                                 RSS_CLI_SAVE)]
                       and next(rec.state.model.parameters()).dtype == torch.float32,
                       f"(a) train: the f32 model reached step {rec.state.step}, checkpoints "
                       f"{saved}")
            for i, st in enumerate(rec.steps):
                m = st["losses"]
                self.check(all(map(math.isfinite, m.values())) and not any(st["launches"].values()),
                           f"(a) step {i + 1}: " + ", ".join(f"{k} {v:.4f}" for k, v in m.items())
                           + "; no hand-written kernel launched (K1-K6 all 0)")
            self.launches_rss_cli_step = rec.steps[0]["launches"]
            gaps = [b["end"] - a["end"] for n, (a, b) in enumerate(zip(rec.steps, rec.steps[1:]),
                                                                   start=1)
                    if n > 1 and n % RSS_CLI_SAVE]   # not the first, none after a save
            cli_ms = statistics.median(gaps) * 1e3
            log(f"  (a) start-up to the first step's end {rec.steps[0]['end'] - rec.t0:.1f} s; "
                f"{', '.join(f'{g * 1e3:.1f}' for g in gaps)} ms a step (no save before it); "
                f"median {cli_ms:.1f} ms")
            alone_ms, idle = self._cli_step_alone("(a) train", rec, RSS_CLI_ALONE)
            del rec
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                resumed = self._cli_run(rc, argv + [f"train.num_iters={RSS_CLI_STEPS + 1}"],
                                        mods, "make_rssformer_train_step")
            log("  " + buf.getvalue().strip().replace("\n", "\n  "))
            self.check(resumed.state.step == RSS_CLI_STEPS + 1 and len(resumed.steps) == 1
                       and f"resumed at step {RSS_CLI_STEPS}" in buf.getvalue(),
                       f"(a) rerun with train.num_iters={RSS_CLI_STEPS + 1}: resumed at step "
                       f"{RSS_CLI_STEPS}, ended at {resumed.state.step}")
            del resumed

            # (c) eval --tta and predict with K5, from the checkpoint calmed as phase 7c's
            model = HRNetFusion("hrnetv2_w32", RSS_CLASSES, generator=torch.Generator())
            state = trs.create_rssformer_state(model, trs.RSSFormerTrainConfig())
            CK.restore(str(wd / "checkpoints"), state)
            calm(torch, model, torch.Generator().manual_seed(self.seed + 22))
            calmed = Path(tmp) / "calmed"
            CK.save(str(calmed), state.step, state)
            del model, state
            common = ["--config", yaml, f"work_dir={wd}", "--ckpt_dir", str(calmed)]
            ds_n = RSS_CLI_IMAGES   # the yaml's synthetic source
            held: dict = {}
            runs = {}
            with self._k5_held_to_plain(tm, held):
                for fused in (True, False):
                    flag = f"model.fused_mlp={fused}"   # a Python literal: "false" is a truthy string
                    self.holding = fused
                    try:
                        runs[fused] = (
                            self._rss_cli_infer(rc, trs, ["eval", "--tta", *common, flag], mods),
                            self._rss_cli_infer(rc, trs, ["predict", *common, flag, "--out_dir",
                                                          str(Path(tmp) / f"pred_{fused}")],
                                                mods))
                    finally:
                        self.holding = False
            (ev, pr), (ev0, pr0) = runs[True], runs[False]
            for what, r, n in (("eval --tta", ev, ds_n * 6), ("predict", pr, ds_n)):
                want = {k: 0 for k in r.launches}
                want.update(mlp_fc1=RSS_BLOCKS * n, mlp_taps=RSS_BLOCKS * n)
                self.check(r.forwards == n and r.launches == want,
                           f"(c) {what} with model.fused_mlp=True: {r.forwards} forwards, launches "
                           f"{ {k: v for k, v in r.launches.items() if v} } (K5 8 + 8 a forward, "
                           "nothing else)")
            self.launches_rss_cli = {"eval_tta": ev.launches, "predict": pr.launches}
            self.check(not any(ev0.launches.values()) and not any(pr0.launches.values()),
                       "(c) the same commands at model.fused_mlp=False launched nothing")
            for k, seen in held.items():
                worst = max(seen.values(), default=0.0)
                tokens = sorted({at[0][0][1] for at in seen})
                self.check(len(seen) == 6 and worst <= 1.0,
                           f"(c) {k}: {len(seen)} geometries (tokens {tokens}) held against the "
                           f"plain version at their first call, largest error {worst:.3f} of "
                           "its tolerance")
            scores, plain = ev.out, ev0.out
            log(f"  (c) eval --tta: K5 pAcc {scores['pAcc']:.4f} mAcc {scores['mAcc']:.4f} mIoU "
                f"{scores['miou']:.4f}; fused_mlp=False pAcc {plain['pAcc']:.4f} mAcc "
                f"{plain['mAcc']:.4f} mIoU {plain['miou']:.4f}")
            self.check(all(abs(scores[k] - plain[k]) <= 1.0 - RSS_SHARE for k in ("pAcc", "mAcc")),
                       f"(c) eval --tta, K5 against fused_mlp=False: pAcc and mAcc within "
                       f"{1.0 - RSS_SHARE:.2f}")
            probs, probs0 = torch.stack(pr.probs), torch.stack(pr0.probs)
            err = (probs - probs0).abs().max().item()
            self.check(err <= RSS_F32_TOL, f"(c) predict's probabilities, K5 against "
                                           f"fused_mlp=False, f32: max abs err {err:.3e} (tol "
                                           f"{RSS_F32_TOL:.0e})")
            top2 = probs0.topk(2, dim=2).values
            clear = (top2[:, :, 0] - top2[:, :, 1]) > RSS_F32_TOL
            same = probs.argmax(2) == probs0.argmax(2)
            share = same[clear].float().mean().item() if bool(clear.any()) else 0.0
            self.check(bool(clear.any()) and share >= RSS_SHARE,
                       f"(c) predict's classes, K5 against fused_mlp=False: equal on "
                       f"{100.0 * share:.3f}% of the {100.0 * clear.float().mean().item():.2f}% "
                       f"of pixels that are not near-ties (at least {100.0 * RSS_SHARE:.1f}%)")
            pngs = sorted(Path(pr.out).glob("*.png"))
            index = [read_palette_png(torch, p) for p in pngs]
            self.check(len(pngs) == ds_n and all(
                torch.equal(ix, p[0].argmax(0).to(torch.uint8)) for ix, p in zip(index, pr.probs)),
                f"(c) predict wrote {len(pngs)} palette PNGs, each the argmax of its forward")
        log(f"  phase 7g figures ({card}): train {cli_ms:.1f} ms a step through the CLI (batch "
            f"{RSS_CLI_BATCH} x 512², f32, LoveDA chain on the card; median of {len(gaps)}), the "
            f"step alone {alone_ms:.1f} ms, idle share {idle:.4f}; with K5: eval --tta "
            f"{ev.s / ds_n:.3f} s an image (6 scales, {ev.s:.2f} s for {ds_n}), predict "
            f"{pr.s / ds_n:.3f} s an image ({pr.s:.2f} s); unfused: eval --tta "
            f"{ev0.s / ds_n:.3f} s, predict {pr0.s / ds_n:.3f} s an image; whole commands with "
            "the model build, the checkpoint load and, with K5, the 12 first-call holds")
        log(f"  phase 7g: {time.perf_counter() - t_phase:.1f} s")

    # ------------------------------------------------------------- phase 7h (WaveCAM training)
    def run_wavecam_train(self, card: str) -> None:
        """WaveCAM's training half and ``cli/run_wavecam.py``: (a) the command line
        with its nine gates as a user runs it, at full width; (b) the first steps of
        the three trainers and make_wavecam's dict, card against CPU; (c) each
        trainer's step at 16 x 512², timed and traced. No hand-written kernel runs
        here."""
        torch = self.torch
        from representationlearning_tpu_torch import bench as tb
        from representationlearning_tpu_torch.cli import run_wavecam as rw
        from representationlearning_tpu_torch.wsss import wavecam_pipeline as wp

        t_phase = time.perf_counter()
        net_cls = wp.Net

        def calmed(*a, **kw):
            """train_cam's initial Net (the one built from the seed), calmed: at
            ResNet-50's own random initialisation, without the reference's ImageNet
            weights, the stream grows through sixteen bottlenecks, train_wavecam's
            first loss at 512² is of order 1e7 and the next ones are NaN."""
            net = net_cls(*a, **kw)
            if kw.get("generator") is not None:
                calm(torch, net, torch.Generator().manual_seed(self.seed + 11))
            return net

        wp.Net = calmed
        try:
            with tempfile.TemporaryDirectory() as tmp:
                work = Path(tmp)
                tb.reset_kernel_launches()
                self._wavecam_cli(rw, wp, work, card)
                self._wavecam_card_vs_cpu(wp, work)
                self._wavecam_step_figures(wp, work, card)
                launched = {k: v for c in tb.kernel_launches().values() for k, v in c.items()
                            if v}
                self.check(not launched, f"(a-c) WaveCAM's training and command line launched "
                           f"no hand-written kernel ({launched or 'none'})")
        finally:
            wp.Net = net_cls
        log(f"  phase 7h: {time.perf_counter() - t_phase:.1f} s")

    def _wavecam_cli(self, rw, wp, work: Path, card: str) -> None:
        import numpy as np

        torch = self.torch
        argv = ["--work_dir", str(work)] + WC_ARGS + [f"--{s}_pass" for s in rw.STAGES]
        log(f"== WaveCAM command line: python -m representationlearning_tpu_torch.cli.run_wavecam "
            f"{' '.join(argv[2:])} (WaveCAMConfig's defaults: f32 ResNet-50 Net at stride 16, 20 "
            f"classes, 16 x 512² crops, scales 1/0.5/1.5/2, grid CRF, IRN at 512², radius 10, "
            f"beta 10, eight squarings; 16 synthetic 64² images; cut: CAM and IRN epochs 1, IRN "
            f"batch 16); train_cam's initial Net calmed (chip_smoke.py::calm); {card}")
        pipe_cls = wp.WaveCAMPipeline
        times, losses, stage = {}, {}, [None]
        stages = {"train_cam": "train_cam", "train_wavecam": "train_wavecam",
                  "make_cam": None, "eval_cam": "eval_cam", "cam_to_ir_label": "cam_to_ir_label",
                  "train_irn": "train_irn", "make_sem_seg_labels": "make_sem_seg",
                  "eval_sem_seg": "eval_sem_seg"}
        originals = {m: getattr(pipe_cls, m) for m in stages}
        update = wp.sgd_update

        def timed(method, key):
            def run(self_, *a, **kw):
                name = key or ("make_wavecam" if kw.get("use_wave_weight") else "make_cam")
                stage[0] = name
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = originals[method](self_, *a, **kw)
                torch.cuda.synchronize()
                times[name] = time.perf_counter() - t0
                if name == "make_cam":   # make_wavecam writes over these
                    shutil.copytree(self_.cfg.dir("cam"), work / "cam_plain")
                return out
            return run

        def recording(tx, loss):
            losses.setdefault(stage[0], []).append(float(loss.detach()))
            update(tx, loss)

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            for m, key in stages.items():
                setattr(pipe_cls, m, timed(m, key))
            wp.sgd_update = recording
            results = rw.main(argv)
        finally:
            for m, f in originals.items():
                setattr(pipe_cls, m, f)
            wp.sgd_update = update
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        log("  seconds a stage: " + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
            + f"; {wall:.1f} s in all, peak {peak / 2**30:.2f} GiB")
        log("  losses: " + "; ".join(f"{k} " + ", ".join(f"{v:.4f}" for v in vs)
                                     for k, vs in losses.items()))
        n = wp.WaveCAMConfig().synthetic_n
        counts = {sub: len(list((work / sub).glob("*.npy"))) for sub in ("cam", "ir_label",
                                                                          "sem_seg")}
        self.check(list(results) == rw.STAGES and counts == {k: n for k in counts},
                   f"(a) all nine stages ran; CAM dicts, IR labels and pseudo labels written: "
                   f"{counts} (want {n} each)")
        want_steps = {"train_cam": 1, "train_wavecam": 5, "train_irn": 1}
        self.check({k: len(losses.get(k, [])) for k in want_steps} == want_steps
                   and all(math.isfinite(v) for vs in losses.values() for v in vs),
                   f"(a) every loss finite, steps {({k: len(v) for k, v in losses.items()})} "
                   f"(want {want_steps})")
        self.check(all(0.0 <= results[k] <= 1.0 for k in ("eval_cam", "eval_sem_seg")),
                   f"(a) mIoU in [0, 1]: eval_cam {results['eval_cam']:.4f}, eval_sem_seg "
                   f"{results['eval_sem_seg']:.4f}")
        differ = 0
        for f in sorted((work / "cam").glob("*.npy")):
            a = np.load(work / "cam_plain" / f.name, allow_pickle=True).item()
            b = np.load(f, allow_pickle=True).item()
            differ += not np.array_equal(a["high_res"], b["high_res"])
        self.check(differ > 0, f"(a) make_wavecam's CAM dicts differ from make_cam's on "
                   f"{differ} of {counts['cam']} images")
        labels = [np.load(f) for f in sorted((work / "sem_seg").glob("*.npy"))]
        self.check(all(lab.dtype == np.uint8 for lab in labels), "(a) pseudo labels uint8")
        dp = np.load(work / "weights" / "irn.npy", allow_pickle=True).item()[
            "mean_shift.running_mean"]
        self.check(bool(np.isfinite(dp).all() and np.abs(dp).max() > 0),
                   f"(a) irn.npy's dp_running_mean set by the calibration: {dp.tolist()}")
        self.wavecam_cli = {"stage_s": times, "wall_s": wall, "peak": peak}

    def _wavecam_card_vs_cpu(self, wp, work: Path) -> None:
        """The first step of each trainer at WC_SMALL², batch WC_SMALL_BATCH, and
        make_wavecam's dict of one image with the stepped weights, on the card and on
        the CPU from the same weights (the seeds; cam.npy and the IR labels of (a))."""
        import numpy as np

        torch = self.torch
        from representationlearning_tpu_torch.data import transforms as T
        from representationlearning_tpu_torch.data.voc import cls_onehot_from_mask
        from representationlearning_tpu_torch.wsss import wavecam_infer as TW

        def norms(module, prefix=""):
            sums = {}
            for name, p in module.named_parameters():
                top = prefix + name.split(".")[0]
                sums[top] = sums.get(top, 0.0) + float(p.grad.double().pow(2).sum())
            return {k: v ** 0.5 for k, v in sums.items()}

        cfg = wp.WaveCAMConfig(work_dir=str(work), crop_size=WC_SMALL,
                               cam_batch_size=WC_SMALL_BATCH, irn_crop_size=WC_SMALL,
                               irn_batch_size=WC_SMALL_BATCH)
        res = {}
        for run, dev in (("card", self.dev), ("cpu", torch.device("cpu"))):
            pipe = wp.WaveCAMPipeline(cfg, device=dev)
            r = res[run] = {"loss": {}, "norm": {}}
            _, img, label = next(pipe._batches(WC_SMALL, WC_SMALL_BATCH, 1))
            net, tx = pipe.build_cam()
            r["loss"]["train_cam"] = float(wp.cam_step(net, tx, *pipe.tensors(img, label)))
            r["norm"].update(norms(net, "train_cam: "))
            net, pred, tx = pipe.build_wavecam()
            loss, _ = wp.wavecam_step(net, pred, tx, *pipe.tensors(img, label))
            r["loss"]["train_wavecam"] = float(loss)
            r["norm"].update(norms(net, "train_wavecam: net."))
            r["norm"].update(norms(pred, "train_wavecam: pred."))
            r["stats"] = {k: b.cpu() for k, b in pred.named_buffers() if "running" in k}
            _, im, mask = pipe.source.get(0)
            r["dict"] = TW.make_cam(
                net.eval(), pipe.tensors(T.normalize_img(im.astype(np.float32)))[0],
                cls_onehot_from_mask(mask, cfg.n_classes + 1), cfg.cam_scales,
                reweight=pred.classifier.detach()[:, :, None, None])
            model, head, labeler, tx = pipe.build_irn()
            samples = pipe.irn_samples(WC_SMALL // 4, labeler)[:WC_SMALL_BATCH]
            r["loss"]["train_irn"] = float(wp.irn_step(model, head, tx, *pipe.irn_batch(samples)))
            r["norm"].update(norms(model, "train_irn: "))
            del net, pred, model, tx
        card, cpu = res["card"], res["cpu"]

        def rel(a, b):
            return abs(a - b) / abs(b) if b else abs(a)

        log(f"== WaveCAM's first steps at {WC_SMALL}², batch {WC_SMALL_BATCH}, f32, card against "
            f"the CPU on the same weights and batch: losses card {card['loss']} / CPU "
            f"{cpu['loss']}")
        worst = max(cpu["loss"], key=lambda k: rel(card["loss"][k], cpu["loss"][k]))
        err = rel(card["loss"][worst], cpu["loss"][worst])
        self.check(err <= WC_LOSS_TOL and all(map(math.isfinite, cpu["loss"].values())),
                   f"(b) the three first steps' losses: worst {worst} {err:.2e} relative "
                   f"(tol {WC_LOSS_TOL:.0e})")
        worst = max(cpu["norm"], key=lambda k: rel(card["norm"][k], cpu["norm"][k]))
        err = rel(card["norm"][worst], cpu["norm"][worst])
        frozen = cpu["norm"]["train_irn: resnet50"]
        self.check(err <= WC_NORM_TOL and set(card["norm"]) == set(cpu["norm"]) and frozen == 0,
                   f"(b) gradient norm of each of the {len(cpu['norm'])} top-level modules: worst "
                   f"{worst} {err:.2e} relative (tol {WC_NORM_TOL:.0e}); IRN's frozen backbone "
                   f"{frozen}")
        err = max(float((card["stats"][k] - v).abs().max() / v.abs().max())
                  for k, v in cpu["stats"].items())
        self.check(err <= WC_STATS_TOL, f"(b) the predictor's BatchNorm running statistics after "
                   f"the step: {err:.2e} of the largest (tol {WC_STATS_TOL:.0e})")
        dc, dh = card["dict"], cpu["dict"]
        err = max(float(np.abs(dc[k] - dh[k]).max() / max(np.abs(dh[k]).max(), 1e-30))
                  for k in ("cam", "high_res"))
        self.check(list(dc["keys"]) == list(dh["keys"]) and err <= WC_CAM_TOL,
                   f"(b) make_wavecam's CAM dict of one image (keys {list(dh['keys'])}): "
                   f"{err:.2e} of the largest (tol {WC_CAM_TOL:.0e})")

    def _wavecam_step_figures(self, wp, work: Path, card: str) -> None:
        """Each trainer's step at the defaults (16 x 512²): ms (CUDA events, median
        of WC_TIMED after one), launches and idle share a step (a WC_TRACED-step
        ``torch.profiler`` trace), peak memory."""
        torch = self.torch
        from representationlearning_tpu_torch import bench as tb

        pipe = wp.WaveCAMPipeline(wp.WaveCAMConfig(work_dir=str(work), **WC_FIGURES))
        cfg = pipe.cfg
        _, img, label = next(pipe._batches(cfg.crop_size, cfg.cam_batch_size, 1))
        batch = pipe.tensors(img, label)

        def figures(name, step, images):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = self.event_median_ms(step, WC_TIMED, warmup=1)
            peak = torch.cuda.max_memory_allocated()
            busy, launches = tb.trace_calls(step, WC_TRACED)
            log(f"  {name}: {ms:.2f} ms a step ({images * 1e3 / ms:.1f} images/s), {launches:.0f} "
                f"launches a step, device busy {busy:.2f} ms, idle share {1 - busy / ms:.4f}, "
                f"peak {peak / 2**30:.2f} GiB; {card}")
            self.wavecam_steps[name] = (ms, launches, 1 - busy / ms, peak)

        self.wavecam_steps = {}
        log(f"== WaveCAM trainers' steps at {cfg.cam_batch_size} x {cfg.crop_size}² (IRN "
            f"{cfg.irn_batch_size} x {cfg.irn_crop_size}²), f32, TF32 off, on the synthetic "
            f"batches the stages draw")
        net, tx = pipe.build_cam()
        figures("train_cam", lambda: wp.cam_step(net, tx, *batch), cfg.cam_batch_size)
        del net, tx
        net, pred, tx = pipe.build_wavecam()
        figures("train_wavecam", lambda: wp.wavecam_step(net, pred, tx, *batch),
                cfg.cam_batch_size)
        del net, pred, tx, batch
        model, head, labeler, tx = pipe.build_irn()
        samples = pipe.irn_samples(cfg.irn_crop_size // 4, labeler)[:cfg.irn_batch_size]
        self.check(len(samples) == cfg.irn_batch_size,
                   f"(c) train_irn timed on {len(samples)} crops (want {cfg.irn_batch_size})")
        irn_batch = pipe.irn_batch(samples)
        figures("train_irn", lambda: wp.irn_step(model, head, tx, *irn_batch), len(samples))
        del model, tx, irn_batch
        torch.cuda.empty_cache()

    # ------------------------------------------------------------- phase 7i (HRFormer, ASFF)
    def run_hrt(self, mods, card: str) -> None:
        """The HRFormer backbone through ``cli/rssformer.py`` at full width, the card
        against the CPU, ``WeTrBaseline`` on K1, the ASFF variants and
        ``cli/convert_checkpoint.py`` on the card. Each part reports its own failure
        and the next one runs."""
        torch = self.torch
        t_phase = time.perf_counter()
        self.hrt_figures = {}
        with tempfile.TemporaryDirectory() as tmp:
            for name, part in (("(a) the RSSFormer CLI with hrt_small",
                                lambda: self._hrt_cli(mods, Path(tmp), card)),
                               ("(b) hrt_small card against CPU", self._hrt_card_vs_cpu),
                               ("(c) WeTrBaseline on K1", lambda: self._wetr_on_k1(mods, card)),
                               ("(d) rsNetFusion and HRNetFusion2", lambda: self._asff_models(mods)),
                               ("(e) cli.convert_checkpoint",
                                lambda: self._convert_on_card(mods, Path(tmp)))):
                try:
                    part()
                except Exception:  # noqa: BLE001 -- report the part, go on with the next
                    traceback.print_exc()
                    self.failures.append(f"phase 7i {name} raised")
                torch.cuda.empty_cache()
        f = self.hrt_figures
        if "cli_ms" in f:
            log(f"  phase 7i figures ({card}): hrt_small train {f['cli_ms']:.1f} ms a step "
                f"through the CLI (8 x 512², f32, the LoveDA chain on the card), the step alone "
                f"{f['alone_ms']:.1f} ms (CUDA events), {f['launches']:.0f} launches, idle share "
                f"{f['idle']:.4f}, peak {f['peak'] / 2**30:.2f} GiB; eval --tta {f['eval_s']:.3f} "
                f"s an image, predict {f['predict_s']:.3f} s an image")
        if "wetr_ms" in f:
            log(f"  phase 7i figures ({card}): WeTrBaseline(mit_b1, bf16) {WETR_BATCH} x 512² "
                f"{f['wetr_ms']:.3f} ms a forward on K1, {f['wetr_plain_ms']:.3f} ms with "
                "fused_blocks=False")
        log(f"  phase 7i: {time.perf_counter() - t_phase:.1f} s")

    def _no_launch(self, mods, what: str, fn):
        """fn() with every kernel's count set to 0 before it; checks that it
        launched no hand-written kernel, and returns its result."""
        for mod in mods:
            mod.reset_launches()
        out = fn()
        self.torch.cuda.synchronize()
        launched = {k: v for mod in mods for k, v in mod.LAUNCHES.items() if v}
        self.check(not launched, f"{what}: no hand-written kernel launched "
                                 f"({launched or 'K1-K6 all 0'})")
        return out

    def _hrt_cli(self, mods, tmp: Path, card: str) -> None:
        torch = self.torch
        from representationlearning_tpu_torch import bench as tb
        from representationlearning_tpu_torch.cli import rssformer as rc
        from representationlearning_tpu_torch.train import rssformer as trs

        yaml = str(ROOT / "configs" / "rssformer_loveda.yaml")
        wd = tmp / "hrt_work"
        log(f"== HRFormer: cli.rssformer train / eval --tta / predict with "
            f"model.hrnet_type=hrt_small (configs/rssformer_loveda.yaml: 7 classes, "
            f"{RSS_CLI_BATCH} x 512² crops, the f32 model, SGD), the LoveDA chain on the card, "
            f"16 synthetic 128² images on {RSS_CLI_CANVAS}² canvases; cut: {HRT_CLI_STEPS} "
            f"steps and a resume; {card}")
        argv = ["train", "--config", yaml, "model.hrnet_type=hrt_small",
                "data.device_augment=true", "train.log_interval_step=1",
                f"train.eval_interval={HRT_CLI_STEPS}", f"work_dir={wd}"]
        torch.cuda.reset_peak_memory_stats()
        rec = self._cli_run(rc, argv + [f"train.num_iters={HRT_CLI_STEPS}"], mods,
                            "make_rssformer_train_step")
        saved = sorted(p.name for p in (wd / "checkpoints").iterdir())
        net = rec.state.model.backbone.hrnet
        self.check(rec.state.step == HRT_CLI_STEPS == len(rec.steps)
                   and saved == [f"step_{HRT_CLI_STEPS}"]
                   and type(net).__name__ == "HighResolutionTransformerNet"
                   and all(p.dtype == torch.float32 and p.is_cuda
                           for p in rec.state.model.parameters()),
                   f"(a) train: the f32 {type(net).__name__} on the card reached step "
                   f"{rec.state.step}, checkpoints {saved}")
        for i, st in enumerate(rec.steps):
            m = st["losses"]
            self.check(all(map(math.isfinite, m.values())) and not any(st["launches"].values()),
                       f"(a) step {i + 1}: " + ", ".join(f"{k} {v:.4f}" for k, v in m.items())
                       + "; no hand-written kernel launched (K1-K6 all 0)")
        gaps = [b["end"] - a["end"] for a, b in zip(rec.steps[1:], rec.steps[2:])]
        f = self.hrt_figures
        f["cli_ms"] = statistics.median(gaps) * 1e3
        log(f"  (a) start-up to the first step's end {rec.steps[0]['end'] - rec.t0:.1f} s; "
            f"{', '.join(f'{g * 1e3:.1f}' for g in gaps)} ms a step after the first; median "
            f"{f['cli_ms']:.1f} ms; peak through the CLI "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        step, state, batch = rec.last

        def again():
            step(state, batch, torch.Generator().manual_seed(0))

        torch.cuda.reset_peak_memory_stats()
        f["alone_ms"] = self.event_median_ms(again, HRT_CLI_ALONE)
        f["peak"] = torch.cuda.max_memory_allocated()
        busy, f["launches"] = tb.trace_calls(again, HRT_TRACED)
        f["idle"] = 1 - busy / f["alone_ms"]
        log(f"  (a) the step alone: {f['alone_ms']:.1f} ms (CUDA events, median of "
            f"{HRT_CLI_ALONE}), {f['launches']:.0f} launches, device busy {busy:.1f} ms, idle "
            f"share {f['idle']:.4f}, peak {f['peak'] / 2**30:.2f} GiB")
        del rec, step, state, batch, net
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            resumed = self._cli_run(rc, argv + [f"train.num_iters={HRT_CLI_STEPS + 1}"], mods,
                                    "make_rssformer_train_step")
        log("  " + buf.getvalue().strip().replace("\n", "\n  "))
        self.check(resumed.state.step == HRT_CLI_STEPS + 1 and len(resumed.steps) == 1
                   and f"resumed at step {HRT_CLI_STEPS}" in buf.getvalue()
                   and all(map(math.isfinite, resumed.steps[0]["losses"].values())),
                   f"(a) rerun with train.num_iters={HRT_CLI_STEPS + 1}: resumed at step "
                   f"{HRT_CLI_STEPS}, ended at {resumed.state.step}")
        del resumed

        common = ["--config", yaml, "model.hrnet_type=hrt_small", f"work_dir={wd}"]
        ev = self._rss_cli_infer(rc, trs, ["eval", "--tta", *common], mods)
        pr = self._rss_cli_infer(rc, trs, ["predict", *common, "--out_dir", str(tmp / "pred")],
                                 mods)
        n = RSS_CLI_IMAGES
        scores = ev.out
        self.check(ev.forwards == 6 * n and pr.forwards == n
                   and all(0.0 <= scores[k] <= 1.0 for k in ("miou", "pAcc", "mAcc")),
                   f"(a) eval --tta from step {HRT_CLI_STEPS + 1}: {ev.forwards} forwards, pAcc "
                   f"{scores['pAcc']:.4f} mAcc {scores['mAcc']:.4f} mIoU {scores['miou']:.4f}; "
                   f"predict {pr.forwards} forwards")
        self.check(not any(ev.launches.values()) and not any(pr.launches.values()),
                   "(a) eval --tta and predict launched no hand-written kernel (K1-K6 all 0)")
        pngs = sorted(Path(pr.out).glob("*.png"))
        self.check(len(pngs) == n and all(
            torch.equal(read_palette_png(torch, p), q[0].argmax(0).to(torch.uint8))
            for p, q in zip(pngs, pr.probs)),
            f"(a) predict wrote {len(pngs)} palette PNGs, each the argmax of its forward")
        f["eval_s"], f["predict_s"] = ev.s / n, pr.s / n

    def _hrt_card_vs_cpu(self) -> None:
        """HRNetFusion("hrt_small") at HRT_SMALL², f32, on the card and on the CPU from
        the same weights (seeded, calmed), batch and drop-path generator: eval
        probabilities, then one training forward and backward: the CGFL losses, the
        gradient norm of each module of the net and of the neck and heads, the running
        statistics."""
        torch = self.torch
        from representationlearning_tpu_torch.models.rssformer import HRNetFusion
        from representationlearning_tpu_torch.train import rssformer as trs

        gen = torch.Generator().manual_seed(self.seed + 23)
        x = torch.randn(HRT_SMALL_BATCH, 3, HRT_SMALL, HRT_SMALL, generator=gen)
        y = torch.randint(-1, RSS_CLASSES, (HRT_SMALL_BATCH, HRT_SMALL, HRT_SMALL), generator=gen)
        res = {}
        for run, dev in (("card", self.dev), ("cpu", torch.device("cpu"))):
            m = HRNetFusion("hrt_small", RSS_CLASSES,
                            generator=torch.Generator().manual_seed(self.seed + 24), device=dev)
            calm(torch, m, torch.Generator().manual_seed(self.seed + 25))
            with torch.no_grad():
                probs = m.eval()(x.to(dev)).cpu()
            losses = trs.rssformer_losses(m.train(), {"image": x.to(dev), "mask": y.to(dev)},
                                          torch.Generator().manual_seed(self.seed + 26))
            sum(losses.values()).backward()
            sums = {}
            for k, p in m.named_parameters():
                top = k.split(".")[2] if k.startswith("backbone.") else k.split(".")[0]
                g = 0.0 if p.grad is None else float(p.grad.double().square().sum())
                sums[top] = sums.get(top, 0.0) + g
            res[run] = dict(probs=probs, losses={k: float(v.detach()) for k, v in losses.items()},
                            norms={k: v ** 0.5 for k, v in sums.items()},
                            stats={k: b.cpu() for k, b in m.named_buffers() if "running" in k})
            del m, losses
        card, cpu = res["card"], res["cpu"]

        def rel(a, b):
            return abs(a - b) / abs(b) if b else abs(a)

        err = float((card["probs"] - cpu["probs"]).abs().max())
        log(f"== hrt_small card against the CPU at {HRT_SMALL_BATCH} x {HRT_SMALL}², f32, TF32 "
            f"off, the same weights, batch and drop-path generator")
        self.check(err <= HRT_EVAL_TOL, f"(b) eval probabilities: max abs err {err:.3e} (tol "
                                        f"{HRT_EVAL_TOL:.0e})")
        worst = max(cpu["losses"], key=lambda k: rel(card["losses"][k], cpu["losses"][k]))
        err = rel(card["losses"][worst], cpu["losses"][worst])
        self.check(err <= HRT_LOSS_TOL and all(map(math.isfinite, cpu["losses"].values())),
                   f"(b) first train step's losses card {card['losses']} / CPU {cpu['losses']}: "
                   f"worst {worst} {err:.2e} relative (tol {HRT_LOSS_TOL:.0e})")
        worst = max(cpu["norms"], key=lambda k: rel(card["norms"][k], cpu["norms"][k]))
        err = rel(card["norms"][worst], cpu["norms"][worst])
        self.check(err <= HRT_NORM_TOL and set(card["norms"]) == set(cpu["norms"])
                   and cpu["norms"]["headaux"] == 0.0,
                   f"(b) gradient norm of each of the {len(cpu['norms'])} modules: worst {worst} "
                   f"{err:.2e} relative (tol {HRT_NORM_TOL:.0e}); headaux, which no loss reaches, 0")
        worst, err = max(((k, float((card["stats"][k] - v).abs().max())
                           / max(float(v.abs().max()), 1e-3)) for k, v in cpu["stats"].items()),
                         key=lambda kv: kv[1])
        self.check(err <= HRT_STATS_TOL, f"(b) running statistics after the step: worst {worst} "
                                         f"{err:.2e} of max(its largest, 1e-3) (tol "
                                         f"{HRT_STATS_TOL:.0e})")

    def _wetr_on_k1(self, mods, card: str) -> None:
        """WeTrBaseline(mit_b1, fused_blocks=True, bf16) at WETR_BATCH x 512²: every
        block on K1, each new K1 geometry held against its plain version at its first
        call, the launches of one forward, both return forms against the same
        weights with fused_blocks=False."""
        torch = self.torch
        tmb = mods[0]
        from representationlearning_tpu_torch.models.mit import FusedBlock
        from representationlearning_tpu_torch.models.tscd import WeTrBaseline

        log(f"== WeTrBaseline(mit_b1, 21 classes, fused_blocks=True, bf16), {WETR_BATCH} x 3 x "
            f"{IMAGE}², against fused_blocks=False in bf16 on the same weights")
        gen = torch.Generator().manual_seed(self.seed + 27)
        model = WeTrBaseline("mit_b1", NUM_CLASSES, fused_blocks=True, dtype=torch.bfloat16,
                             generator=gen).eval()
        blocks = [m for m in model.encoder.modules() if isinstance(m, FusedBlock)]
        plain = WeTrBaseline("mit_b1", NUM_CLASSES, dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(0)).eval()
        plain.load_state_dict(model.state_dict())
        self.check(len(blocks) == 8 and all(t.is_cuda for t in model.state_dict().values()),
                   f"(c) {len(blocks)} of the 8 encoder blocks are FusedBlocks, on the card")
        x = torch.randn(WETR_BATCH, 3, IMAGE, IMAGE, generator=gen).to(self.dev)
        held: dict = {}
        with self._held_to_plain(mods, held), torch.no_grad():
            for mod in mods:
                mod.reset_launches()
            self.holding = True
            try:
                cls, seg = model(x)
                torch.cuda.synchronize()
            finally:
                self.holding = False
            self.launches_wetr = {k: v for k, v in tmb.LAUNCHES.items()}
            others = {k: v for mod in mods[1:] for k, v in mod.LAUNCHES.items() if v}
            cam = model(x, cam_only=True)
        n_sr = sum(DEPTH for _, _, _, sr, _ in STAGES if sr > 1)
        want = {"ln_stats": 2 * 8 + n_sr, "linear": 5 * 8, "sr_conv": n_sr, "attention": 8,
                "dwconv_gelu": 8}
        self.check(self.launches_wetr == want and not others,
                   f"(c) K1 launches in one forward {self.launches_wetr} (the headline's 84: "
                   f"{'/'.join(str(v) for v in want.values())}), no other kernel")
        for kernel, seen in held.items():
            worst = max(seen.values(), default=0.0)
            self.check(bool(seen) and worst <= 1.0,
                       f"(c) {kernel}: {len(seen)} geometries held against the plain version at "
                       f"their first call, largest error {worst:.3f} of its tolerance")
        self.check(len(held.get("block", {})) == 4, f"(c) the whole block held at the "
                   f"{len(held.get('block', {}))} stage geometries (want 4)")
        with torch.no_grad():
            for mod in mods:
                mod.reset_launches()
            p_cls, p_seg = plain(x)
            p_cam = plain(x, cam_only=True)
            torch.cuda.synchronize()
        self.check(not any(v for mod in mods for v in mod.LAUNCHES.values()),
                   "(c) fused_blocks=False launched no kernel")
        h4 = IMAGE // 16
        for k, g, w, shape in (("cls_logits", cls, p_cls, (WETR_BATCH, NUM_CLASSES - 1)),
                               ("seg", seg, p_seg, (WETR_BATCH, NUM_CLASSES, IMAGE // 4, IMAGE // 4)),
                               ("cam", cam, p_cam, (WETR_BATCH, NUM_CLASSES - 1, h4, h4))):
            err, mag = max_err(g, w)
            self.check(tuple(g.shape) == shape and bool(torch.isfinite(g.float()).all())
                       and err <= PATH_TOL * mag,
                       f"(c) {k} {tuple(g.shape)}: K1 against fused_blocks=False max abs err "
                       f"{err:.3e} (max |plain| {mag:.3e}, tol {PATH_TOL * mag:.3e})")
        del cls, seg, cam, p_cls, p_seg, p_cam
        with torch.no_grad():
            f = self.hrt_figures
            f["wetr_ms"] = self.time_ms(lambda: model(x), WETR_TIMED)
            f["wetr_plain_ms"] = self.time_ms(lambda: plain(x), WETR_TIMED)
        log(f"  (c) {f['wetr_ms']:.3f} ms a forward on K1, {f['wetr_plain_ms']:.3f} ms with "
            f"fused_blocks=False (CUDA events around {WETR_TIMED} forwards; {card})")

    def _asff_models(self, mods) -> None:
        """rsNetFusion and HRNetFusion2 at hrnetv2_w32, f32: an eval forward, a loss and
        a backward at 512², and the card against the CPU at HRT_SMALL²."""
        torch = self.torch
        from representationlearning_tpu_torch.losses.cgfl import segmentation_loss
        from representationlearning_tpu_torch.models.asff import HRNetFusion2, RsNetFusion

        gen = torch.Generator().manual_seed(self.seed + 28)
        for cls in (RsNetFusion, HRNetFusion2):
            name = cls.__name__
            log(f"== {name}(hrnetv2_w32, 7 classes), f32")

            def build(dev):
                m = cls("hrnetv2_w32", RSS_CLASSES, generator=torch.Generator().manual_seed(
                    self.seed + 29), device=dev)
                calm(torch, m, torch.Generator().manual_seed(self.seed + 30))
                return m

            m = build(self.dev)
            x = torch.randn(ASFF_EVAL_BATCH, 3, IMAGE, IMAGE, generator=gen).to(self.dev)
            with torch.no_grad():
                probs = self._no_launch(mods, f"(d) {name} eval", lambda: m.eval()(x))
            self.check(tuple(probs.shape) == (ASFF_EVAL_BATCH, RSS_CLASSES, IMAGE, IMAGE)
                       and bool(torch.isfinite(probs).all())
                       and float((probs.sum(1) - 1).abs().max()) < 1e-4,
                       f"(d) {name} eval forward at {ASFF_EVAL_BATCH} x {IMAGE}²: probabilities "
                       f"{tuple(probs.shape)}, finite, summing to 1")
            del probs, x
            x = torch.randn(ASFF_TRAIN_BATCH, 3, IMAGE, IMAGE, generator=gen).to(self.dev)
            y = torch.randint(-1, RSS_CLASSES, (ASFF_TRAIN_BATCH, IMAGE, IMAGE),
                              generator=gen).to(self.dev)

            def train_step():
                losses = segmentation_loss(m.train()(x), y, m.loss_config or {"ce": {}},
                                           m.ignore_index)
                sum(losses.values()).backward()
                return losses

            losses = self._no_launch(mods, f"(d) {name} loss and backward", train_step)
            losses = {k: float(v.detach()) for k, v in losses.items()}
            self.check(all(map(math.isfinite, losses.values()))
                       and all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                               for p in m.parameters()),
                       f"(d) {name} at {ASFF_TRAIN_BATCH} x {IMAGE}²: losses "
                       f"{ {k: round(v, 4) for k, v in losses.items()} }, every gradient "
                       "finite")
            del m, x, y, losses
            xs = torch.randn(ASFF_TRAIN_BATCH, 3, HRT_SMALL, HRT_SMALL, generator=gen)
            with torch.no_grad():
                card = build(self.dev).eval()(xs.to(self.dev)).cpu()
                cpu = build(torch.device("cpu")).eval()(xs)
            err = float((card - cpu).abs().max())
            self.check(err <= ASFF_TOL, f"(d) {name} at {HRT_SMALL}², card against CPU: "
                                        f"probabilities max abs err {err:.3e} (tol {ASFF_TOL:.0e})")

    def _convert_on_card(self, mods, tmp: Path) -> None:
        """A DDP checkpoint of a seeded hrt_small HRNetFusion (``module.`` names, a
        ``"state_dict"`` entry, the dead ``norm2`` and ``num_batches_tracked``)
        through ``cli.convert_checkpoint``, loaded strictly on the card: its eval
        output equals the source model's."""
        torch = self.torch
        from representationlearning_tpu_torch.cli import convert_checkpoint as cc
        from representationlearning_tpu_torch.models.rssformer import HRNetFusion

        log("== cli.convert_checkpoint --family rssformer --arch hrt_small on a DDP checkpoint")
        src = HRNetFusion("hrt_small", RSS_CLASSES,
                          generator=torch.Generator().manual_seed(self.seed + 31))
        calm(torch, src, torch.Generator().manual_seed(self.seed + 32))
        sd = {}
        for k, v in src.state_dict().items():
            sd["module." + k] = v.cpu() + 3 if k.endswith("num_batches_tracked") else v.cpu()
            if k.endswith("norm1.weight"):   # the reference's dead norm2 beside each norm1
                sd["module." + k.replace("norm1", "norm2")] = torch.ones_like(v.cpu())
                sd["module." + k.replace("norm1.weight", "norm2.bias")] = torch.zeros_like(v.cpu())
        torch.save({"state_dict": sd}, tmp / "hrt_ref.pth")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cc.main(["--family", "rssformer", "--arch", "hrt_small", "--src",
                     str(tmp / "hrt_ref.pth"), "--dst", str(tmp / "hrt.pt"), "--report"])
        log("  " + buf.getvalue().strip().replace("\n", "\n  "))
        model = HRNetFusion("hrt_small", RSS_CLASSES, generator=torch.Generator())
        model.load_state_dict(torch.load(tmp / "hrt.pt", map_location=self.dev,
                                         weights_only=True), strict=True)
        x = torch.randn(2, 3, IMAGE, IMAGE, generator=torch.Generator().manual_seed(self.seed + 33))
        with torch.no_grad():
            want, got = self._no_launch(mods, "(e) the converted and the source model's eval",
                                        lambda: (src.eval()(x.to(self.dev)),
                                                 model.eval()(x.to(self.dev))))
        n_norm2 = sum(".norm2." in k for k in sd)
        n_blocks = sum(k.endswith("norm1.weight") for k in src.state_dict())
        self.check(torch.equal(got, want) and n_norm2 == 2 * n_blocks == 2 * 44,
                   f"(e) {len(sd)} entries ({n_norm2} dead norm2, 'module.' names) converted and "
                   f"loaded strictly on the card: eval output equal to the source model's bits "
                   f"(max abs err {float((got - want).abs().max()):.1e})")

    # ------------------------------------------------------------- phase 7j (the baseline zoo)
    def run_zoo(self, mods, card: str) -> None:
        """The RSSFormer baseline zoo (``models/baselines.py``, ``models/smp_zoo.py``),
        which has no hand-written kernel: (a) each of the fourteen models at full width
        through ``make_rssformer_train_step`` and ``evaluate``; (b) each on the card
        against the CPU at ZOO_SMALL²; (c) ``utils/affine.py`` and ``utils/profiling.py``
        on the card. Each model and part reports its own failure and the next one runs."""
        torch = self.torch
        from representationlearning_tpu_torch.models.smp_zoo import ZOO_MODELS

        t_phase = time.perf_counter()
        self.zoo_figures = {}
        batch = rss_batch(torch, self.dev)
        for name in ZOO_MODELS:
            for part, fn in (("(a) full width", lambda: self._zoo_full_width(mods, name, batch)),
                             ("(b) card against CPU", lambda: self._zoo_card_vs_cpu(name))):
                try:
                    fn()
                except Exception:  # noqa: BLE001 -- report the model, go on with the next
                    traceback.print_exc()
                    self.failures.append(f"phase 7j {part} {name} raised")
                torch.cuda.empty_cache()
        try:
            self._zoo_utilities(mods, batch)
        except Exception:  # noqa: BLE001
            traceback.print_exc()
            self.failures.append("phase 7j (c) the utilities raised")
        del batch
        torch.cuda.empty_cache()
        log(f"  phase 7j figures ({card}; f32, TF32 off, {BATCH} x {IMAGE}² a step, evaluate on "
            f"{ZOO_EVAL_BATCHES} x {ZOO_EVAL_BATCH} x {IMAGE}²):")
        for name, f in self.zoo_figures.items():
            log(f"    {name:20s} {f['params'] / 1e6:7.2f} M parameters, {f['ms']:9.2f} ms a step, "
                f"{f['launches']:6.0f} launches a step, idle share {f['idle']:.4f}, peak "
                f"{f['peak'] / 2**30:6.2f} GiB, evaluate {f['eval_s']:.4f} s an image")
        log("  phase 7j figures as JSON: " + json.dumps(self.zoo_figures))
        log(f"  phase 7j: {time.perf_counter() - t_phase:.1f} s")

    def _zoo_build(self, name: str, dev, seed: int):
        from representationlearning_tpu_torch.core.registry import MODELS
        from representationlearning_tpu_torch.models import smp_zoo  # noqa: F401 (registers)

        # FactSeg and SemanticFPNDecouple have losses of their own and no loss_config
        kw = {"loss_config": {"ce": {}}} if "loss_config" in inspect.signature(
            MODELS.get(name)).parameters else {}
        return MODELS.build(name, classes=RSS_CLASSES, **kw,
                            generator=self.torch.Generator().manual_seed(seed), device=dev)

    def _zoo_full_width(self, mods, name: str, batch) -> None:
        """``name`` at its JAX defaults, f32: ZOO_STEPS steps of
        ``make_rssformer_train_step`` at ``RSSFormerTrainConfig()`` on the bench's
        8 x 512² batch (losses finite, every trained BatchNorm2d's statistics moved once
        a step, the frozen ResNet ones not, no hand-written kernel), the step timed and
        traced, then ``evaluate`` on ZOO_EVAL_BATCHES batches of ZOO_EVAL_BATCH."""
        torch = self.torch
        from representationlearning_tpu_torch import bench as tb
        from representationlearning_tpu_torch.models.layers import BatchNorm2d
        from representationlearning_tpu_torch.models.resnet import FrozenBatchNorm
        from representationlearning_tpu_torch.train import rssformer as trs

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = self._zoo_build(name, None, self.seed + 40)
        n_params = sum(p.numel() for p in model.parameters())
        cfg = trs.RSSFormerTrainConfig()
        state = trs.create_rssformer_state(model, cfg)
        step_fn = trs.make_rssformer_train_step(model, cfg)
        gen = torch.Generator().manual_seed(self.seed + 41)
        trained = {n: m for n, m in model.named_modules() if isinstance(m, BatchNorm2d)}
        frozen = {n: m for n, m in model.named_modules() if isinstance(m, FrozenBatchNorm)}
        frozen_before = {n: m.running_mean.clone() for n, m in frozen.items()}
        ok_losses, ok_moved, losses = True, True, {}
        for i in range(ZOO_STEPS):
            before = {n: m.running_mean.clone() for n, m in trained.items()}
            _, met = self._no_launch(mods, f"(a) {name} step {i + 1}",
                                     lambda: step_fn(state, batch, gen))
            losses = {k: float(v) for k, v in met.items()}
            ok_losses &= all(map(math.isfinite, losses.values()))
            ok_moved &= all(int(m.num_batches_tracked) == i + 1
                            and not torch.equal(m.running_mean, before[n])
                            for n, m in trained.items())
        self.check(ok_losses and ok_moved and bool(trained)
                   and all(torch.equal(m.running_mean, frozen_before[n])
                           for n, m in frozen.items()),
                   f"(a) {name} ({n_params / 1e6:.2f} M parameters) {ZOO_STEPS} steps at "
                   f"{BATCH} x {IMAGE}²: losses finite (last {losses}), the statistics of all "
                   f"{len(trained)} trained BatchNorms moved once a step, the {len(frozen)} "
                   f"frozen ones not")
        ms = self.event_median_ms(lambda: step_fn(state, batch, gen), ZOO_TIMED, warmup=0)
        busy, launches = tb.trace_calls(lambda: step_fn(state, batch, gen), ZOO_TRACED)
        peak = torch.cuda.max_memory_allocated()
        del state, step_fn
        gen = torch.Generator().manual_seed(self.seed + 42)
        evals = [(torch.randn(ZOO_EVAL_BATCH, 3, IMAGE, IMAGE, generator=gen),
                  torch.randint(0, RSS_CLASSES, (ZOO_EVAL_BATCH, IMAGE, IMAGE), generator=gen))
                 for _ in range(ZOO_EVAL_BATCHES)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = self._no_launch(mods, f"(a) {name} evaluate",
                                 lambda: trs.evaluate(model, evals, RSS_CLASSES))
        eval_s = (time.perf_counter() - t0) / (ZOO_EVAL_BATCH * ZOO_EVAL_BATCHES)
        with torch.no_grad():
            probs = model.eval()(evals[0][0].to(self.dev))
        sig = name == "SemanticFPNDecouple"
        in_unit = bool(torch.isfinite(probs).all()) and 0.0 <= float(probs.min()) \
            and float(probs.max()) <= 1.0
        sums = float((probs.sum(1) - 1).abs().max())
        channels = RSS_CLASSES - 1 if sig else RSS_CLASSES
        self.check(all(0.0 <= scores[k] <= 1.0 for k in ("pAcc", "mAcc", "miou")) and in_unit
                   and tuple(probs.shape) == (ZOO_EVAL_BATCH, channels, IMAGE, IMAGE)
                   and (sig or sums <= 1e-4),
                   f"(a) {name} evaluate on {ZOO_EVAL_BATCHES} x {ZOO_EVAL_BATCH} x {IMAGE}²: "
                   f"pAcc {scores['pAcc']:.4f} mAcc {scores['mAcc']:.4f} mIoU "
                   f"{scores['miou']:.4f} in [0, 1]; outputs {tuple(probs.shape)} in [0, 1]"
                   + (" (sigmoids)" if sig else f", summing to 1 within {sums:.1e}"))
        self.zoo_figures[name] = dict(params=n_params, ms=ms, launches=launches,
                                      idle=1 - busy / ms, peak=peak, eval_s=eval_s,
                                      losses=losses)
        log(f"  (a) {name}: {ms:.2f} ms a step (median of {ZOO_TIMED}, CUDA events), "
            f"{launches:.0f} launches a step and idle share {1 - busy / ms:.4f} "
            f"({ZOO_TRACED}-step trace), peak {peak / 2**30:.2f} GiB, evaluate "
            f"{eval_s:.4f} s an image")
        del model, probs, evals

    def _zoo_card_vs_cpu(self, name: str) -> None:
        """``name`` at ZOO_SMALL_BATCH x ZOO_SMALL², f32, on the card and on the CPU from
        the same seeded, calmed weights, batch and dropout masks (drawn on the host):
        eval probabilities, the training forward's loss dict, each top-level module's
        gradient norm and the running statistics. Where the gradient norms or the
        statistics miss their bounds in f32, both sides run again in f64, where they must
        meet the same bounds, and the card's f32 run is held against the CPU's f64 run:
        its worst module's gradient error, as a vector, and its worst statistic's error at
        most ZOO_F32_K times the CPU's own in f32. In f32 the forward's rounding flips some
        ReLU and max-pool decisions, more where a BatchNorm normalises channels of a large
        mean and a small spread (or of two values, PAN's pooled branches), and each flip
        moves the gradient: so two f32 runs can differ by more than ZOO_NORM_TOL."""
        torch = self.torch
        from representationlearning_tpu_torch.models import baselines

        cpu = torch.device("cpu")
        base = self._zoo_build(name, cpu, self.seed + 43)
        calm(torch, base, torch.Generator().manual_seed(self.seed + 44))
        gen = torch.Generator().manual_seed(self.seed + 45)
        x = torch.randn(ZOO_SMALL_BATCH, 3, ZOO_SMALL, ZOO_SMALL, generator=gen)
        y = torch.randint(-1, RSS_CLASSES, (ZOO_SMALL_BATCH, ZOO_SMALL, ZOO_SMALL), generator=gen)
        masks, plain = [], baselines.dropout

        def draw(t, rate, training, generator=None):
            if rate == 0.0 or not training:
                return t
            masks.append(torch.rand(t.shape, generator=gen) >= rate)
            return torch.where(masks[-1].to(t.device), t / (1.0 - rate), torch.zeros_like(t))

        def replay(t, rate, training, generator=None):
            if rate == 0.0 or not training:
                return t
            return torch.where(next(left).to(t.device), t / (1.0 - rate), torch.zeros_like(t))

        def rel(a, b):
            return abs(a - b) / abs(b) if b else abs(a)

        def worst_norm(got, want):
            k = max(want["norms"], key=lambda k: rel(got["norms"][k], want["norms"][k]))
            return k, rel(got["norms"][k], want["norms"][k])

        def stat_errs(got, want):
            return {k: float((got["stats"][k] - v).abs().max()) / max(float(v.abs().max()), 1e-3)
                    for k, v in want["stats"].items()}

        def grad_errs(got, want):   # each module's |g - g_want| / |g_want|, as vectors
            return {k: float((got["grads"][k] - w).norm()) / (float(w.norm()) or 1.0)
                    for k, w in want["grads"].items()}

        res = {}
        try:
            for run, dev, dtype in (("cpu", cpu, torch.float32), ("card", self.dev, torch.float32),
                                    ("cpu64", cpu, torch.float64),
                                    ("card64", self.dev, torch.float64)):
                if run == "cpu64" and worst_norm(res["card"], res["cpu"])[1] <= ZOO_NORM_TOL \
                        and max(stat_errs(res["card"], res["cpu"]).values()) <= ZOO_STATS_TOL:
                    break
                m = copy.deepcopy(base).to(dev, dtype)
                with torch.no_grad():
                    probs = m.eval()(x.to(dev, dtype)).cpu().double()
                left = iter(masks)
                baselines.dropout = draw if run == "cpu" else replay
                losses = m.train()(x.to(dev, dtype), y.to(dev))
                sum(losses.values()).backward()
                grads = {}
                for k, p in m.named_parameters():
                    g = (torch.zeros_like(p) if p.grad is None else p.grad).detach().double()
                    grads.setdefault(k.split(".")[0], []).append(g.flatten().cpu())
                grads = {k: torch.cat(v) for k, v in grads.items()}
                res[run] = dict(probs=probs,
                                losses={k: float(v.detach()) for k, v in losses.items()},
                                grads=grads, norms={k: float(g.norm()) for k, g in grads.items()},
                                stats={k: b.cpu().double() for k, b in m.named_buffers()
                                       if "running" in k})
                del m, losses
        finally:
            baselines.dropout = plain
        card, cpu32 = res["card"], res["cpu"]
        err = float((card["probs"] - cpu32["probs"]).abs().max())
        worst_l = max(cpu32["losses"], key=lambda k: rel(card["losses"][k], cpu32["losses"][k]))
        err_l = rel(card["losses"][worst_l], cpu32["losses"][worst_l])
        (worst_n, err_n), stats = worst_norm(card, cpu32), stat_errs(card, cpu32)
        worst_s = max(stats, key=stats.get)
        ok = err_n <= ZOO_NORM_TOL and stats[worst_s] <= ZOO_STATS_TOL
        held = (f"statistics worst {worst_s} {stats[worst_s]:.2e} (tol {ZOO_STATS_TOL:.0e}); "
                f"gradient norms of {len(cpu32['norms'])} modules worst {worst_n} {err_n:.2e} (tol "
                f"{ZOO_NORM_TOL:.0e})")
        if "card64" in res:   # f32 missed: f64 on both sides, and the f32 card against f64
            (worst_n, err_n), stats = (worst_norm(res["card64"], res["cpu64"]),
                                       stat_errs(res["card64"], res["cpu64"]))
            worst_s = max(stats, key=stats.get)
            g_card, g_cpu = grad_errs(card, res["cpu64"]), grad_errs(cpu32, res["cpu64"])
            s_card, s_cpu = stat_errs(card, res["cpu64"]), stat_errs(cpu32, res["cpu64"])
            worst = {w: max(e, key=e.get) for w, e in
                     (("g_card", g_card), ("g_cpu", g_cpu), ("s_card", s_card), ("s_cpu", s_cpu))}
            ratio_g = g_card[worst["g_card"]] / max(g_cpu[worst["g_cpu"]], ZOO_F32_FLOOR)
            ratio_s = s_card[worst["s_card"]] / max(s_cpu[worst["s_cpu"]], ZOO_F32_FLOOR)
            ok = (err_n <= ZOO_NORM_TOL and stats[worst_s] <= ZOO_STATS_TOL
                  and ratio_g <= ZOO_F32_K and ratio_s <= ZOO_F32_K)
            held = (f"in f32 {held}; so in f64: statistics worst {worst_s} {stats[worst_s]:.2e}, "
                    f"gradient norms worst {worst_n} {err_n:.2e}; the f32 card's worst error "
                    f"against the f64 CPU over the f32 CPU's (floor {ZOO_F32_FLOOR:.0e}; tol "
                    f"{ZOO_F32_K:g}): gradients, as vectors, {worst['g_card']} "
                    f"{g_card[worst['g_card']]:.2e} / {worst['g_cpu']} {g_cpu[worst['g_cpu']]:.2e}"
                    f" = {ratio_g:.2f}, statistics {worst['s_card']} {s_card[worst['s_card']]:.2e}"
                    f" / {worst['s_cpu']} {s_cpu[worst['s_cpu']]:.2e} = {ratio_s:.2f}; each "
                    f"module's gradient error card / CPU: "
                    + ", ".join(f"{k} {g_card[k]:.2e} / {g_cpu[k]:.2e}" for k in g_card))
        self.check(ok and err <= ZOO_EVAL_TOL and err_l <= ZOO_LOSS_TOL
                   and set(card["norms"]) == set(cpu32["norms"])
                   and all(map(math.isfinite, cpu32["losses"].values())),
                   f"(b) {name} at {ZOO_SMALL_BATCH} x {ZOO_SMALL}², card against CPU: eval "
                   f"{err:.2e} (tol {ZOO_EVAL_TOL:.0e}); losses {cpu32['losses']} worst "
                   f"{err_l:.2e} relative (tol {ZOO_LOSS_TOL:.0e}); {len(masks)} dropout masks; "
                   + held)

    def _zoo_utilities(self, mods, batch) -> None:
        """``apply_affine`` on the card against the CPU, ``profiling.trace`` around one
        AnyUNet step, ``device_memory_stats``."""
        torch = self.torch
        import numpy as np
        from representationlearning_tpu_torch.train import rssformer as trs
        from representationlearning_tpu_torch.utils import affine, profiling

        aug = affine.AffineAugmentation(patch_ratio=0.9)
        x = torch.randn(4, 3, 96, 80, generator=torch.Generator().manual_seed(self.seed + 46))
        for what, M in (("identity", np.eye(2, 3)), ("sampled", aug.sample(
                np.random.default_rng(self.seed)))):
            got = affine.apply_affine(x.to(self.dev), M)
            err = float((got.cpu() - affine.apply_affine(x, M)).abs().max())
            self.check(got.is_cuda and err <= ZOO_AFFINE_TOL,
                       f"(c) apply_affine at a {what} M on the card against the CPU: max abs err "
                       f"{err:.1e} (tol {ZOO_AFFINE_TOL:.0e})")
        model = self._zoo_build("AnyUNet", None, self.seed + 47)
        cfg = trs.RSSFormerTrainConfig()
        state, step = trs.create_rssformer_state(model, cfg), trs.make_rssformer_train_step(model,
                                                                                          cfg)
        step(state, batch)
        with tempfile.TemporaryDirectory() as tmp:
            with profiling.trace(tmp) as prof:
                step(state, batch)
                torch.cuda.synchronize()
            files = [p for p in Path(tmp).iterdir() if p.name.endswith(".pt.trace.json")]
            size = sum(p.stat().st_size for p in files)
            events = json.loads(files[0].read_text())["traceEvents"] if files else []
        kernels = sum(e.get("cat") == "kernel" for e in events)
        self.check(len(files) == 1 and size > 0 and kernels > 0,
                   f"(c) profiling.trace around one AnyUNet step wrote {len(files)} trace file(s), "
                   f"{size} bytes, {kernels} kernel events; "
                   f"{len(prof.key_averages())} operator rows")
        stats = profiling.device_memory_stats()
        self.check(list(stats) == ["cuda:0"] and stats["cuda:0"].get("allocated_bytes.all.peak", 0)
                   > 0, f"(c) device_memory_stats() names {list(stats)}, peak allocated "
                        f"{stats.get('cuda:0', {}).get('allocated_bytes.all.peak', 0) / 2**30:.2f} "
                        f"GiB")
        del model, state, step

    # ------------------------------------------------------------- phase 7b (K5, K6, K1')
    # ------------------------------------------------------------- phase 7k (multi-device)
    def _dp_collectives(self, rank: int, world: int) -> None:
        """(a) The collectives on CUDA tensors over the ranks' gloo group, against the
        values they must give."""
        torch = self.torch
        import torch.distributed as dist

        from representationlearning_tpu_torch.parallel import collectives as C
        from representationlearning_tpu_torch.parallel import mesh as M

        g, dev = dist.group.WORLD, self.dev
        tot = world * (world + 1) // 2
        base = torch.arange(1.0, 7.0, device=dev)
        tree = C.psum_tree({"w": (rank + 1) * base.view(2, 3),
                            "b": [(rank + 1) * base[:2].double()]}, g)
        p = torch.nn.Parameter(torch.zeros(3, device=dev))
        p.grad = torch.full((3,), rank + 1.0, device=dev)
        with C.data_parallel(M.make_mesh(world, 1)):
            C.allreduce_grads([p])
        self.check(tree["w"].is_cuda and torch.equal(tree["w"], tot * base.view(2, 3))
                   and torch.equal(tree["b"][0], tot * base[:2].double())
                   and torch.equal(p.grad, torch.full_like(p.grad, float(tot))),
                   f"(a) psum_tree (an f32 and an f64 buffer) and allreduce_grads on the card: "
                   f"the sum over {world} ranks")
        x = (3.0 * torch.randn((8 * world, 5), generator=torch.Generator().manual_seed(self.seed))
             + 1.5).to(dev)
        part = x.view(world, 8, 5)[rank]
        m, v = C.sync_batch_stats(part.mean(0), part.var(0, unbiased=False), g)
        err = max(float((m - x.mean(0)).abs().max()),
                  float((v - x.var(0, unbiased=False)).abs().max()))
        self.check(err <= 1e-5, f"(a) sync_batch_stats on the card: the global mean and variance "
                                f"within 1e-5 ({err:.2e})")
        slab = torch.arange(4.0 * world, device=dev).view(world, 4, 1)[rank]
        ext = C.halo_exchange_1d(slab, 1, 0, g)[:, 0].tolist()
        want = ([4.0 * rank - 1 if rank else 0.0] + slab[:, 0].tolist()
                + [4.0 * rank + 4 if rank < world - 1 else 0.0])
        got = torch.stack(C.all_gather(torch.full((2,), float(rank), device=dev), g))
        self.check(ext == want and got.is_cuda
                   and torch.equal(got, torch.arange(world, device=dev).float()[:, None].expand(-1, 2)),
                   f"(a) halo_exchange_1d {ext} (zeros at the edge ranks) and all_gather on the "
                   f"card, through host memory under {dist.get_backend(g)}")

    def _dp_cli(self, module, factory: str, argv: list[str], mods, capture=None,
                groups: bool = False) -> dict:
        """``module.main(argv)`` through ``_cli_run`` (launches and losses a step,
        validations); the first step's refined labels where ``capture`` names the
        losses function that returns them; with ``groups`` the gradient norm of each
        RSSFormer parameter group at the first update (summed over the ranks, before
        the clip); then the step alone on its last batch, by CUDA events."""
        torch = self.torch
        from representationlearning_tpu_torch.train.state import TrainState

        labels, norms = [], []
        patches = []
        if groups:
            apply = TrainState.apply_gradients

            def recording(state):
                if not norms:
                    sq = {}
                    for n, q in state.model.named_parameters():
                        sq[rss_group(n)] = (sq.get(rss_group(n), 0.0)
                                            + q.grad.double().square().sum().item())
                    norms.append({k: v ** 0.5 for k, v in sq.items()})
                return apply(state)
            patches.append((TrainState, "apply_gradients", recording))
        if capture is not None:
            owner, name = capture
            losses_fn = getattr(owner, name)

            def rec_losses(*a, **kw):
                out = losses_fn(*a, **kw)
                if not labels:
                    labels.append(out[1]["refined_label"].cpu())
                return out
            patches.append((owner, name, rec_losses))
        saved = [(o, n, getattr(o, n)) for o, n, _ in patches]
        for o, n, f in patches:
            setattr(o, n, f)
        try:
            rec = self._cli_run(module, argv, mods, factory)
        finally:
            for o, n, f in saved:
                setattr(o, n, f)
        step, state, batch = rec.last
        ms = self.event_median_ms(lambda: step(state, batch, torch.Generator().manual_seed(0)),
                                  DP_TIMED)
        trace = step_breakdown(torch, lambda: step(state, batch, torch.Generator().manual_seed(0)))
        return {"steps": [{"losses": st["losses"], "launches": st["launches"]} for st in rec.steps],
                "vals": [{k: v["scores"][k]["miou"] for k in ("seg", "cam", "ref")}
                         for v in rec.vals],
                "labels": labels[0] if labels else None, "norms": norms[0] if norms else None,
                "ms": ms, "trace": trace, "step": rec.state.step}

    def _dp_sliding(self, mods, world: int) -> dict:
        """(e) The RSSFormer predict's model, calmed, over a DP_SLIDE_SIDE² tile: sharded
        over ``world`` ranks' model axis, or (world 1) sliding_window_predict on the same
        padding. The output (on the host), its seconds and K5 / K6's launches."""
        torch = self.torch
        from representationlearning_tpu_torch.infer import sliding as S
        from representationlearning_tpu_torch.models.rssformer import HRNetFusion
        from representationlearning_tpu_torch.parallel import mesh as M

        tm, ti = mods[4], mods[5]
        model = HRNetFusion("hrnetv2_w32", RSS_CLASSES, dtype=torch.bfloat16, fused_mlp=True,
                            fused_attn=True, generator=torch.Generator().manual_seed(self.seed),
                            device=self.dev)
        calm(torch, model, torch.Generator().manual_seed(self.seed + 1))
        model.eval()
        image = torch.randn((3, DP_SLIDE_SIDE, DP_SLIDE_SIDE),
                            generator=torch.Generator().manual_seed(self.seed + 2)).to(self.dev)
        tm.reset_launches()
        ti.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            if world > 1:
                out = S.sharded_sliding_window_predict(model, image, M.make_mesh(1, world),
                                                       DP_SLIDE_WINDOW, DP_SLIDE_STRIDE, RSS_CLASSES)
            else:
                padded, (H, W) = S.pad_for_sliding(image, DP_SLIDE_WINDOW, DP_SLIDE_STRIDE,
                                                   row_multiple=DP_WORLD)
                out = S.sliding_window_predict(model, padded, DP_SLIDE_WINDOW, DP_SLIDE_STRIDE,
                                               RSS_CLASSES)[:, :H, :W]
        torch.cuda.synchronize()
        return {"out": out.cpu(), "s": time.perf_counter() - t0,
                "launches": {**tm.LAUNCHES, **ti.LAUNCHES}}

    def dp_rank_work(self, rank: int, world: int, mods, tmp: Path) -> dict:
        """One rank's part of phase 7k: (a) the collectives, (b) the SCD and (c) the RML
        command lines, each kernel geometry held against its plain version at its first
        call, (d) the RSSFormer command line, (e) the sharded sliding window."""
        from representationlearning_tpu_torch.cli import rssformer as rc
        from representationlearning_tpu_torch.cli import train_rml, train_scd
        from representationlearning_tpu_torch.train import rml as tr_rml
        from representationlearning_tpu_torch.train import scd as tr_scd

        self._dp_collectives(rank, world)
        held: dict = {}
        out = {}
        with self._held_to_plain(mods, held):
            out["scd"] = self._dp_cli(train_scd, "make_scd_train_step",
                                      dp_wsss_argv("scd_voc.yaml", "work_dir.dir", tmp / "scd2", 2,
                                                   DP_SCD_STEPS), mods, (tr_scd, "scd_losses"))
            out["rml"] = self._dp_cli(train_rml, "make_rml_train_step",
                                      dp_wsss_argv("rml_voc.yaml", "work_dir", tmp / "rml2", 2,
                                                   DP_RML_STEPS), mods, (tr_rml, "rml_losses"))
        out["held"] = {k: (len(v), max(v.values(), default=0.0)) for k, v in held.items()}
        out["rss"] = self._dp_cli(rc, "make_rssformer_train_step", dp_rss_argv(tmp / "rss2"), mods,
                                  groups=True)
        out["slide"] = self._dp_sliding(mods, world)
        return out

    def _dp_wsss_vs_one(self, what: str, two: list[dict], one: dict, wd2: Path, wd1: Path,
                        lr_top: float) -> None:
        """(b) / (c): each rank's launches a step, the global losses, the first step's
        labels, the validations and the weights after the warm-up against one rank."""
        torch = self.torch
        k1 = tuple(PIECE_TOL)
        for r, res in enumerate(two):
            for i, st in enumerate(res["steps"]):
                n = st["launches"]
                self.check(sum(n[k] for k in k1) == 504 and n["affinity"] == 1
                           and n["varm_propagate"] == 10
                           and all(v == 0 for k, v in n.items()
                                   if k not in k1 + ("affinity", "varm_propagate")),
                           f"{what}, rank {r}, step {i + 1}: K1 {sum(n[k] for k in k1)} "
                           f"({'/'.join(str(n[k]) for k in k1)}), K2 {n['affinity']}, "
                           f"K3 {n['varm_propagate']}, nothing else")
        self.check([st["launches"] for st in one["steps"]] == [st["launches"] for st in two[0]["steps"]],
                   f"{what}: one rank on the global batch launched the same kernels a step")
        for i, (st, want) in enumerate(zip(two[0]["steps"], one["steps"])):
            got, want = st["losses"], want["losses"]
            rel = {k: abs(got[k] - w) / max(abs(w), 1e-12) for k, w in want.items()}
            cls_ok = i >= DP_CAM_ITERS + 2 or rel["cls"] <= DP_CLS_RTOL
            self.check(all(r["steps"][i]["losses"] == got for r in two) and cls_ok
                       and all(v <= DP_CAM_LOSS_RTOL for v in rel.values()),
                       f"{what}, step {i + 1}: the ranks report the same global losses; against "
                       f"one rank relative " + ", ".join(f"{k} {v:.1e}" for k, v in rel.items())
                       + f" (cls {DP_CLS_RTOL:g} to step {DP_CAM_ITERS + 2}, all {DP_CAM_LOSS_RTOL:g})")
        labels = torch.cat([r["labels"] for r in two])
        share = float((labels == one["labels"]).float().mean())
        self.check(labels.shape == one["labels"].shape and share >= DP_LABEL_SHARE,
                   f"{what}: the first step's refined labels of the ranks, joined, equal one "
                   f"rank's on {100 * share:.3f}% of the pixels (at least {100 * DP_LABEL_SHARE:.2f}%)")
        for v2, v1 in zip(two[0]["vals"], one["vals"]):
            self.check(all(abs(v2[k] - v1[k]) <= DP_MIOU_TOL for k in v1)
                       and all(r["vals"] == two[0]["vals"] for r in two),
                       f"{what}, validation split over the ranks: mIoU "
                       + ", ".join(f"{k} {v2[k]:.4f} / {v1[k]:.4f}" for k in v1)
                       + f" (within {DP_MIOU_TOL})")
        path = f"checkpoints/step_{DP_SCD_EVAL}/state.pt"
        a = torch.load(wd2 / path, map_location="cpu", weights_only=True)["model"]
        b = torch.load(wd1 / path, map_location="cpu", weights_only=True)["model"]
        errs = sorted(float((a[n].float() - b[n].float()).abs().max()) for n in b
                      if b[n].is_floating_point())
        med, worst = errs[len(errs) // 2], errs[-1]
        self.check(med <= DP_WEIGHT_MEDIAN_TOL and worst <= 2 * DP_SCD_EVAL * lr_top,
                   f"{what}: the weights after {DP_SCD_EVAL} warm-up steps (rank 0's checkpoint "
                   f"against one rank's): median tensor {med:.1e} (at most "
                   f"{DP_WEIGHT_MEDIAN_TOL:g}), worst {worst:.1e} (AdamW's sign-sized first "
                   f"steps where a gradient is noise: at most {2 * DP_SCD_EVAL * lr_top:.1e})")

    def _dp_nccl(self) -> None:
        """A one-rank NCCL group on the card: one all-reduce and the mesh over it."""
        torch = self.torch
        import torch.distributed as dist

        from representationlearning_tpu_torch.parallel import collectives as C
        from representationlearning_tpu_torch.parallel import mesh as M

        with tempfile.TemporaryDirectory() as t:
            dist.init_process_group("nccl", store=dist.FileStore(str(Path(t) / "store"), 1),
                                    rank=0, world_size=1)
            try:
                x = torch.full((4,), 3.0, device=self.dev)
                dist.all_reduce(x)
                tree = C.psum_tree({"g": torch.ones(3, device=self.dev)}, dist.group.WORLD)
                torch.cuda.synchronize()
                mesh = M.make_mesh()
                ok = (dist.get_backend() == "nccl" and torch.equal(x, torch.full_like(x, 3.0))
                      and torch.equal(tree["g"], torch.ones(3, device=self.dev))
                      and mesh.shape == {M.DATA_AXIS: 1, M.MODEL_AXIS: 1}
                      and M.init_distributed() is True)
            finally:
                dist.destroy_process_group()
        self.check(ok, "(a) a one-rank NCCL group on the card: all_reduce and psum_tree, "
                       "make_mesh over it, init_distributed takes the group that exists")

    def run_dp(self, mods, card: str) -> None:
        """Phase 7k: DP_WORLD gloo ranks on the one card against one rank on the global
        batch, and a one-rank NCCL group."""
        torch = self.torch
        from representationlearning_tpu_torch.cli import rssformer as rc
        from representationlearning_tpu_torch.cli import train_rml, train_scd
        from representationlearning_tpu_torch.parallel.launch import spawn_ranks
        from representationlearning_tpu_torch.train import rml as tr_rml
        from representationlearning_tpu_torch.train import scd as tr_scd

        t_phase = time.perf_counter()
        log(f"== multi-device: {DP_WORLD} gloo ranks sharing the one card (NCCL refuses two ranks "
            f"on one GPU: their times measure correctness, not scaling), each against one rank "
            f"on the global batch; the SCD and RML command lines (configs/scd_voc.yaml, "
            f"rml_voc.yaml: MiT-B1, 320² crops, {DP_WORLD} x 2 against 1 x 4), the RSSFormer "
            f"command line (configs/rssformer_loveda.yaml: hrnetv2_w32, 8 x 512² as "
            f"{DP_WORLD} x 4), the sharded sliding window over a {DP_SLIDE_SIDE}² tile; {card}")
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            t0 = time.perf_counter()
            two = spawn_ranks(dp_rank, DP_WORLD, (self.seed, str(tmp)), timeout=DP_RANK_TIMEOUT)
            log(f"  the {DP_WORLD} ranks: {time.perf_counter() - t0:.1f} s (start-up included)")
            for r, res in enumerate(two):
                log(f"  -- rank {r}:")
                log("\n".join("  " + line for line in res["log"].rstrip().splitlines()))
                self.failures += [f"7k rank {r}: {f}" for f in res["failures"]]
            if any(res["failures"] for res in two):
                return
            for r, res in enumerate(two):
                for kernel, (n, worst) in res["held"].items():
                    self.check(n > 0 and worst <= 1.0,
                               f"rank {r}: {kernel} held against its plain version at {n} "
                               f"geometries, largest error {worst:.3f} of its tolerance")
            held: dict = {}
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), self._held_to_plain(mods, held):
                one_scd = self._dp_cli(train_scd, "make_scd_train_step",
                                       dp_wsss_argv("scd_voc.yaml", "work_dir.dir", tmp / "scd1", 4,
                                                    DP_SCD_STEPS), mods, (tr_scd, "scd_losses"))
                one_rml = self._dp_cli(train_rml, "make_rml_train_step",
                                       dp_wsss_argv("rml_voc.yaml", "work_dir", tmp / "rml1", 4,
                                                    DP_RML_STEPS), mods, (tr_rml, "rml_losses"))
            with contextlib.redirect_stdout(buf):
                one_rss = self._dp_cli(rc, "make_rssformer_train_step", dp_rss_argv(tmp / "rss1"),
                                       mods, groups=True)
            one_slide = self._dp_sliding(mods, 1)
            for kernel, seen in held.items():
                worst = max(seen.values(), default=0.0)
                self.check(bool(seen) and worst <= 1.0,
                           f"one rank: {kernel} held against its plain version at {len(seen)} "
                           f"geometries, largest error {worst:.3f} of its tolerance")
            self._dp_wsss_vs_one("(b) SCD", [r["scd"] for r in two], one_scd, tmp / "scd2",
                                 tmp / "scd1", 10 * 6e-5)
            self._dp_wsss_vs_one("(c) RML", [r["rml"] for r in two], one_rml, tmp / "rml2",
                                 tmp / "rml1", 10 * 6e-5)
            # (d) RSSFormer
            got, want = [r["rss"] for r in two], one_rss
            for i, want_st in enumerate(want["steps"]):
                mine = got[0]["steps"][i]["losses"]
                rel = {k: abs(mine[k] - w) / max(abs(w), 1e-12)
                       for k, w in want_st["losses"].items()}
                self.check(all(g["steps"][i]["losses"] == mine for g in got)
                           and all(map(math.isfinite, mine.values()))
                           and (i > 0 or all(v <= DP_RSS_LOSS_RTOL for v in rel.values()))
                           and not any(v for g in got for v in g["steps"][i]["launches"].values()),
                           f"(d) RSSFormer, step {i + 1}: the ranks report the same finite global "
                           f"losses; against one rank relative "
                           + ", ".join(f"{k} {v:.1e}" for k, v in rel.items())
                           + (f" (at most {DP_RSS_LOSS_RTOL:g})" if i == 0 else " (not held)")
                           + "; no hand-written kernel")
            gn, wn = got[0]["norms"], want["norms"]
            self.check(set(gn) == set(wn) and all(abs(gn[k] - w) <= DP_RSS_GROUP_RTOL * w + 1e-12
                                                  for k, w in wn.items()),
                       "(d) RSSFormer, the first update's gradient norm a group (summed over the "
                       "ranks, before the clip) against one rank's: "
                       + ", ".join(f"{k} {gn.get(k, float('nan')):.4g} / {w:.4g}"
                                   for k, w in wn.items()) + f" (within {DP_RSS_GROUP_RTOL:g})")
            # (e) the sliding window
            err = max(float((r["slide"]["out"] - one_slide["out"]).abs().max()) for r in two)
            launched = [{k: r["slide"]["launches"].get(k, 0) for k in ("mlp_fc1", "mlp_taps", "isa_core")}
                        for r in two]
            self.check(all(r["slide"]["out"].shape == (RSS_CLASSES, DP_SLIDE_SIDE, DP_SLIDE_SIDE)
                           for r in two) and err <= DP_SLIDE_TOL
                       and all(torch.equal(r["slide"]["out"], two[0]["slide"]["out"]) for r in two)
                       and all(min(n.values()) > 0 for n in launched),
                       f"(e) sharded_sliding_window_predict over {DP_WORLD} ranks, "
                       f"{DP_SLIDE_SIDE}² tile, window {DP_SLIDE_WINDOW}, stride {DP_SLIDE_STRIDE}: "
                       f"every rank gathers the same map, within {err:.2e} of one device on the "
                       f"same padding (at most {DP_SLIDE_TOL:g}); K5 / K6 launches a rank {launched}")
            self.launches_dp = {"scd_step": two[0]["scd"]["steps"][0]["launches"],
                                "sliding": launched[0]}
            figures = {"card": card, "scd_ms_a_step": [r["scd"]["ms"] for r in two],
                       "scd_ms_one_rank": one_scd["ms"],
                       "rml_ms_a_step": [r["rml"]["ms"] for r in two], "rml_ms_one_rank": one_rml["ms"],
                       "rss_ms_a_step": [r["rss"]["ms"] for r in two], "rss_ms_one_rank": one_rss["ms"],
                       "sliding_s": [r["slide"]["s"] for r in two], "sliding_s_one": one_slide["s"]}
            log(f"  phase 7k figures as JSON ({DP_WORLD} ranks sharing one card: correctness, not "
                f"scaling; the step alone, CUDA events, median of {DP_TIMED}): {json.dumps(figures)}")
            traces = {f"{what}_rank{r}": res[what]["trace"] for r, res in enumerate(two)
                      for what in ("scd", "rml", "rss")}
            traces.update(scd_one_rank=one_scd["trace"], rml_one_rank=one_rml["trace"],
                          rss_one_rank=one_rss["trace"])
            for name, t in traces.items():
                self.check(t["device_events"] > 0, f"{name}: the step's trace holds "
                                                   f"{t['device_events']} device events")
            log(f"  phase 7k step traces as JSON (one step each under torch.profiler: wall, device "
                f"busy, gloo all-reduces and their host spans, the step's ranges; ms): "
                f"{json.dumps(traces)}")
        self._dp_nccl()
        log(f"  phase 7k: {time.perf_counter() - t_phase:.1f} s")

    def _err_check(self, what: str, got, want, tol: float, far_share: float | None = None) -> float:
        """max |got - want| against tol * max(1, max |want|); with `far_share`,
        also the share of entries beyond K5_NEAR of that magnitude."""
        torch = self.torch
        err, mag = max_err(got, want)
        scale = max(1.0, mag)
        ok = bool(torch.isfinite(got.float()).all()) and err <= tol * scale
        msg = (f"{what} {tuple(got.shape)}: max abs err {err:.3e} (max |plain| {mag:.3e}, "
               f"tol {tol * scale:.3e})")
        if far_share is not None:
            far = ((got.float() - want.float()).abs() > K5_NEAR * scale).float().mean().item()
            ok = ok and far <= far_share
            msg += f", {100.0 * far:.4f}% of the entries beyond {K5_NEAR * scale:.1e}"
        self.check(ok, msg)
        return err

    def mlp_vs_plain(self, tm) -> None:
        """K5 and its two kernels against their plain versions on the same inputs."""
        torch = self.torch
        from representationlearning_tpu_torch.models.layers import init_weights
        from representationlearning_tpu_torch.models.rssformer_modules import MlpDWBN

        bf16 = torch.bfloat16
        hid, cout, side = 4 * RSS_DIM, RSS_DIM, IMAGE // 4
        log(f"== K5 vs plain (same inputs): MlpDWBN feed-forward block, Cin {RSS_DIM}, hid {hid}, "
            f"out {cout}, bf16 operands")
        gen = torch.Generator().manual_seed(self.seed + 6)
        mod = MlpDWBN(RSS_DIM, hid, cout, dtype=bf16, fused=True).eval()
        init_weights(mod, gen)
        calm(torch, mod, gen)
        mod.to(self.dev)
        with torch.no_grad():
            p = {k: v.detach() for k, v in mod.kernel_params().items()}
        f1 = (p["fc1_weight"].reshape(hid, RSS_DIM).to(bf16), p["fc1_bias"], p["bn1_scale"],
              p["bn1_shift"])
        rest = (tm.tap_weights(p).to(bf16).contiguous(), p["dw_bias"], p["bn2_scale"],
                p["bn2_shift"], p["fc2_weight"].reshape(cout, hid).to(bf16), p["fc2_bias"],
                p["bn3_scale"], p["bn3_shift"])
        for k in ("mlp_fc1", "mlp_taps", "mlp_whole"):
            self.piece_err[k] = 0.0
        for B, H, W, what in ((RSS_BATCH, side, side, "the predict path's shape"),
                              (2, 7, 9, "a plane below both dilations"),
                              (1, 20, 45, "a non-square plane of 900 tokens")):
            x = torch.randn(B, H * W, RSS_DIM, generator=gen).to(self.dev)
            with torch.no_grad():
                h, hp = tm.mlp_fc1(x, *f1), tm.mlp_fc1_reference(x, *f1)
                out = tm.mlp_taps(hp, *rest, H=H, W=W)
                got = tm.fused_mlp_dwbn(x, p, H=H, W=W, dtype=bf16)
                torch.cuda.synchronize()
                outp = tm.mlp_taps_reference(hp, *rest, H=H, W=W)
                want = tm.fused_mlp_dwbn_reference(x, p, H=H, W=W, dtype=bf16)
            log(f"  B = {B}, {H} x {W} ({what})")
            for name, g, w in (("mlp_fc1", h, hp), ("mlp_taps", out, outp), ("whole", got, want)):
                err = self._err_check(f"{name} @ B={B} {H}x{W}", g, w, K5_TOL[name],
                                      None if name == "mlp_fc1" else K5_FAR_SHARE)
                key = "mlp_whole" if name == "whole" else name
                self.piece_err[key] = max(self.piece_err[key], err)
            if H == side:
                self.mlp_inputs = (mod, x, p, f1, rest, hp, out, h)
        self._fc1_at_its_edges(tm, gen)
        self._taps_at_its_edges(tm, gen, rest)

    def _fc1_at_its_edges(self, tm, gen) -> None:
        """`mlp_fc1` at the TTA's batch of 2 and at its edges: M of one row, of a tile less
        or more one, and not a multiple of any plan's step; cin 16, 32, 64 and 256; every
        plan and a rerun for equal bits; the blocks an SM holds against the plan's estimate."""
        torch = self.torch
        from representationlearning_tpu_torch.ops import _build
        bf16, hid = torch.bfloat16, 4 * RSS_DIM

        def rand(*shape, scale=1.0, shift=0.0):
            return (scale * torch.randn(shape, generator=gen) + shift).to(self.dev)

        lib = _build.load_library("rssformer")
        side = IMAGE // 4
        warps = {cin: tm.fc1_plan(2 * side * side, cin)[0] for cin in (16, 32, 64, 256)}
        held = {cin: lib.k5_fc1_blocks_per_sm(cin, cin, hid, 0, w) for cin, w in warps.items()}
        want_held = {cin: tm.fc1_blocks_per_sm(cin, w) for cin, w in warps.items()}
        self.check(held == want_held, f"mlp_fc1: blocks an SM holds of the plan's {warps} warps "
                                      f"at cin 16, 32, 64, 256: {held}, the plan's estimate "
                                      f"{want_held}")
        cases = [(2 * side * side, RSS_DIM)]   # the TTA's batch of 2
        cases += [(M, cin) for cin in (16, 32, 64, 256) for M in (1, 15, 17, 1000, 8517)]
        worst, same = 0.0, True
        for M, cin in cases:
            x = rand(1, M, cin)
            f1 = (rand(hid, cin, scale=cin ** -0.5).to(bf16), rand(hid, scale=0.1),
                  rand(hid, scale=0.2, shift=1.0), rand(hid, scale=0.1))
            with torch.no_grad():
                got = tm.mlp_fc1(x, *f1)
                runs = [tm.mlp_fc1(x, *f1)]
                runs += [tm.mlp_fc1(x, *f1, plan=pl) for pl in fc1_plans(tm, cin)]
                torch.cuda.synchronize()
                err, mag = max_err(got, tm.mlp_fc1_reference(x, *f1))
            worst = max(worst, err / (K5_TOL["mlp_fc1"] * max(1.0, mag)))
            same = same and all(torch.equal(got, r) for r in runs)
            self.piece_err["mlp_fc1"] = max(self.piece_err["mlp_fc1"], err)
        self.check(worst <= 1.0, f"mlp_fc1 at M = {2 * side * side} (cin {RSS_DIM}) and M = 1, 15, "
                                 f"17, 1000, 8517 at cin 16, 32, 64, 256: largest error "
                                 f"{worst:.3f} of its tolerance")
        self.check(same, "mlp_fc1: a second run and every plan (1, 2, 4, 8 warps walking 1, 2, 3 "
                         "steps a block) give equal bits")
        odd = rand(16 * 32 + 1)[1:].view(1, 16, 32)   # contiguous, 4 bytes off
        f1 = (rand(hid, 32).to(bf16), rand(hid), rand(hid), rand(hid))

        def raises(fn) -> bool:
            try:
                fn()
            except ValueError:
                return True
            return False

        self.check(raises(lambda: tm.mlp_fc1(odd, *f1))
                   and raises(lambda: tm.mlp_fc1(odd.clone(), *f1, plan=(9, 1)))
                   and raises(lambda: tm.mlp_fc1(odd.clone(), *f1, plan=(4, 0))),
                   "mlp_fc1 refuses data not 16-byte aligned, 9 warps and no step a block")

    def _taps_at_its_edges(self, tm, gen, rest) -> None:
        """`mlp_taps` at the TTA's planes (batch 2, 64 to 224 a side), at planes whose
        token count no tile divides, and at one token; every plan and a rerun for equal
        bits; the blocks an SM holds against the plan's estimate; what it refuses."""
        torch = self.torch
        from representationlearning_tpu_torch.ops import _build
        bf16, hid = torch.bfloat16, 4 * RSS_DIM

        lib = _build.load_library("rssformer")
        held = {t: lib.k5_taps_blocks_per_sm(hid, 0, t) for t in tm.TAPS_TILES}
        want_held = {t: tm.taps_blocks_per_sm(t) for t in held}
        self.check(held == want_held, f"mlp_taps: blocks an SM holds of each tile: "
                                      f"{held}, the plan's estimate {want_held}")
        cases = [(2, s, s) for s in (64, 96, 160, 192, 224)] + [(3, 13, 29), (1, 1, 1)]
        worst, far_worst, same = 0.0, 0.0, True
        for B, H, W in cases:
            hp = (torch.randn(B, H * W, hid, generator=gen) * 0.5).to(self.dev, bf16)
            with torch.no_grad():
                got = tm.mlp_taps(hp, *rest, H=H, W=W)
                runs = [tm.mlp_taps(hp, *rest, H=H, W=W)]
                runs += [tm.mlp_taps(hp, *rest, H=H, W=W, plan=pl)
                         for pl in taps_plans(tm, B, H, W)]
                torch.cuda.synchronize()
                want = tm.mlp_taps_reference(hp, *rest, H=H, W=W)
            err, mag = max_err(got, want)
            scale = max(1.0, mag)
            far = ((got - want).abs() > K5_NEAR * scale).float().mean().item()
            ok = bool(torch.isfinite(got).all())
            worst = max(worst, err / (K5_TOL["mlp_taps"] * scale) if ok else float("inf"))
            far_worst = max(far_worst, far)
            same = same and all(torch.equal(got, r) for r in runs)
            self.piece_err["mlp_taps"] = max(self.piece_err["mlp_taps"], err)
            log(f"  mlp_taps @ B={B} {H}x{W}: max abs err {err:.3e} (max |plain| {mag:.3e}), "
                f"{100.0 * far:.4f}% beyond {K5_NEAR * scale:.1e}, "
                f"plan {tm.taps_plan(B, H, W, RSS_DIM)}")
        self.check(worst <= 1.0 and far_worst <= K5_FAR_SHARE,
                   f"mlp_taps at the TTA planes (batch 2, 64-224 a side), 3 x 13 x 29 and 1 x 1: "
                   f"largest error {worst:.3f} of its tolerance, at most "
                   f"{100.0 * far_worst:.4f}% of the entries beyond {K5_NEAR:.0e} of the largest")
        self.check(same, "mlp_taps: a second run and every plan (tiles 128 and 256, 1, 3 and a "
                         "wave of blocks) give equal bits")
        odd = torch.zeros(16 * hid + 1, device=self.dev, dtype=bf16)[1:].view(1, 16, hid)

        def raises(fn) -> bool:
            try:
                fn()
            except ValueError:
                return True
            return False

        self.check(raises(lambda: tm.mlp_taps(odd, *rest, H=4, W=4))
                   and raises(lambda: tm.mlp_taps(odd.clone(), *rest, H=4, W=4, plan=(64, 1)))
                   and raises(lambda: tm.mlp_taps(odd.clone(), *rest, H=4, W=4, plan=(128, 0))),
                   "mlp_taps refuses data not 16-byte aligned, a 64-token tile and no block")

    def isa_vs_plain(self, ti) -> None:
        """K6 against its plain version on the same inputs."""
        torch = self.torch
        f32, bf16 = torch.float32, torch.bfloat16
        side = IMAGE // 4
        per_side = -(-side // RSS_WINDOW)               # the grid is padded to 7 * 19 = 133
        NW, T = RSS_BATCH * per_side * per_side, RSS_WINDOW * RSS_WINDOW
        log(f"== K6 vs plain (same inputs): window attention with the DAL gate, "
            f"{NW} windows of {T} x {RSS_DIM}, {RSS_HEADS} heads")
        gen = torch.Generator().manual_seed(self.seed + 7)
        self.piece_err["isa_core"] = self.piece_err["isa_core_f32"] = 0.0
        log(f"  the predict path's plan (windows a step, warps, ring stages): "
            f"{ti.isa_plan(NW, T, RSS_DIM, RSS_HEADS, bf16)}")
        wide = {"plan": (4, 8, 2)}  # four windows a step
        for nw, t, C, nh, dtype, sign, kw, what in (
                (NW, T, RSS_DIM, RSS_HEADS, bf16, False, {}, "the predict path's shape"),
                (1, T, RSS_DIM, RSS_HEADS, bf16, False, wide,
                 "one window, fewer than a step of plan (4, 8, 2)"),
                (NW - 1, T, RSS_DIM, RSS_HEADS, bf16, False, wide,
                 "a window count that a step of plan (4, 8, 2) does not divide"),
                (37, 16, RSS_DIM, RSS_HEADS, bf16, False, {}, "4 x 4 windows"),
                (64, T, RSS_DIM, RSS_HEADS, bf16, True, {}, "every entry of M_h negative"),
                (64, T, 18, 2, bf16, True, {}, "every entry of M_h negative, head width 9"),
                (NW, T, RSS_DIM, RSS_HEADS, f32, False, {}, "f32 operands"),
                (64, T, RSS_DIM, RSS_HEADS, f32, True, {}, "f32, every entry of M_h negative"),
                (5, 100, 18, 2, f32, False, {}, "head width 9, 10 x 10 windows")):
            q, k, v = (torch.randn(nw, t, C, generator=gen).to(self.dev) for _ in range(3))
            if sign:  # q >= 0 and k <= 0, small: every entry of M_h lies a little below 0
                q, k = 0.2 * q.abs(), -0.4 * k.abs()
            q = q * (C // nh) ** -0.5
            got = ti.isa_core(q, k, v, nh=nh, dtype=dtype, **kw)
            again = ti.isa_core(q, k, v, nh=nh, dtype=dtype, **kw)
            torch.cuda.synchronize()
            want = ti.isa_core_reference(q, k, v, nh=nh, dtype=dtype)
            name = str(dtype).split(".")[-1]
            err = self._err_check(f"isa_core @ {what}, {name}", got, want, K6_TOL[name])
            self.check(torch.equal(got, again), "  the same bits from a second launch")
            if sign:
                neg, moved = isa_trap_move(ti, q, k, want, nh, dtype)
                tol = K6_TOL[name] * max(1.0, want.abs().max().item())
                self.check(neg and moved > tol,
                           f"  every M_h entry negative, and a max that let a padded 0 in "
                           f"would move the output by {moved:.3e} (> tol {tol:.3e})")
            key = "isa_core" if dtype == bf16 else "isa_core_f32"
            self.piece_err[key] = max(self.piece_err[key], err)
            if nw == NW and dtype == bf16:
                self.isa_inputs = (q, k, v, got)

    def presr_vs_plain(self, tmb) -> None:
        """K1': the block with h = ln1(x) and xs = srnorm(srconv(h) + b) handed in,
        kernels against plain version, at the three sr > 1 stage geometries of
        the headline forward; timed, with the bound of the block as one function."""
        torch = self.torch
        bf16 = torch.bfloat16
        log(f"== K1' vs plain (same inputs): the block with h and xs handed in, B = {BATCH}")
        gen = torch.Generator().manual_seed(self.seed + 8)
        name = "mit_block_presr"
        self.piece_err[name] = self.piece_ms[name] = self.piece_plain_ms[name] = 0.0
        self.piece_library_ms[name] = None
        self.presr_front_ms = 0.0
        # the two fronts of the same six blocks by graph replay, like with like: the
        # library calls of `sr_reduce`, and K1's own ln_stats, sr_conv, ln_stats
        self.front_graph_ms = {"library": 0.0, "k1": 0.0}
        for hw, C, nh, sr, _ in STAGES:
            if sr == 1:
                continue
            N, Nk = hw * hw, (hw // sr) ** 2
            x = torch.randn(BATCH, N, C, generator=gen).to(self.dev, bf16)
            p = self._block_params(C, nh, sr, False, gen)
            kw = dict(H=hw, W=hw, sr=sr, nh=nh, dtype=bf16)
            with torch.no_grad():
                h, xs = tmb.sr_reduce(x, p, H=hw, W=hw, sr=sr, dtype=bf16)
                tmb.reset_launches()
                got = tmb.fused_block(x, p, h=h, xs=xs, **kw)
                counts = dict(tmb.LAUNCHES)
                torch.cuda.synchronize()
                want = tmb.fused_block_reference(x, p, h=h, xs=xs, **kw)
                whole = tmb.fused_block(x, p, **kw)
            self.check(counts == {"ln_stats": 1, "linear": 5, "sr_conv": 0, "attention": 1,
                                  "dwconv_gelu": 1},
                       f"block @ N={N} C={C} sr={sr}: launches {counts}, no sr_conv and no "
                       "ln_stats of the front")
            for what, ref in (("its plain version", want), ("the block without the variant", whole)):
                err, mag = max_err(got, ref)
                self.check(bool(torch.isfinite(got.float()).all()) and err <= PATH_TOL * mag,
                           f"block with h, xs @ N={N} C={C} sr={sr} against {what}: max abs err "
                           f"{err:.3e} (max {mag:.3e}, tol {PATH_TOL * mag:.3e})")
                if ref is want:
                    self.piece_err[name] = max(self.piece_err[name], err)
            with torch.no_grad():
                k_ms = self.time_ms(lambda: tmb.fused_block(x, p, h=h, xs=xs, **kw), iters=10)
                p_ms = self.time_ms(lambda: tmb.fused_block_reference(x, p, h=h, xs=xs, **kw),
                                    iters=5)
                f_ms = self.time_ms(lambda: tmb.sr_reduce(x, p, H=hw, W=hw, sr=sr, dtype=bf16),
                                    iters=10)
                w_ms = self.time_ms(lambda: tmb.fused_block(x, p, **kw), iters=10)
                xf = x.float()
                w_flat = p["sr_weight"].to(bf16).permute(0, 2, 3, 1).reshape(C, -1).contiguous()

                def k1_front():
                    s1 = tmb.ln_stats(xf)
                    return tmb.ln_stats(tmb.sr_conv(xf, s1, p["ln1_weight"], p["ln1_bias"], w_flat,
                                                    p["sr_bias"], H=hw, W=hw, sr=sr))

                fronts = {"library": lambda: tmb.sr_reduce(x, p, H=hw, W=hw, sr=sr, dtype=bf16),
                          "k1": k1_front}
                for which, fn in fronts.items():
                    self.front_graph_ms[which] += DEPTH * self.graph_ms(fn, iters=10)
            self.piece_ms[name] += DEPTH * k_ms
            self.piece_plain_ms[name] += DEPTH * p_ms
            self.presr_front_ms += DEPTH * f_ms
            # the block as one function: x, h, xs, the parameters it reads, out; its
            # products: q, proj (C x C), fc1, fc2 (C x 4C), kv (Nk rows), q k^T and p v
            used = {k: v for k, v in p.items() if not k.startswith(("sr", "ln1"))}
            flops = BATCH * (20.0 * N * C * C + 4.0 * Nk * C * C + 4.0 * N * Nk * C)
            self.add_bound(name, nbytes(x, h, xs, used, got), flops, PEAK_BF16, times=DEPTH)
            log(f"  K1' block @ N={N} C={C} sr={sr}: kernels {k_ms:.3f} ms + front "
                f"(F.layer_norm, F.conv2d, F.layer_norm) {f_ms:.3f} ms, plain {p_ms:.3f} ms; "
                f"the block without the variant {w_ms:.3f} ms")

    def run_rssformer(self, tm, ti):
        torch = self.torch
        from representationlearning_tpu_torch.models.rssformer import HRNetFusion

        log(f"== RSSFormer predict: HRNetFusion(hrnetv2_w32, {RSS_CLASSES} classes, bf16, "
            f"fused_mlp, fused_attn), {RSS_BATCH} x 3 x {IMAGE} x {IMAGE}")
        gen = torch.Generator().manual_seed(self.seed + 9)
        model = HRNetFusion("hrnetv2_w32", RSS_CLASSES, dtype=torch.bfloat16, fused_mlp=True,
                            fused_attn=True, generator=gen).eval()  # no device named: the card
        self.check(all(t.is_cuda for t in model.state_dict().values()),
                   "HRNetFusion() without a device put its parameters and buffers on the card")
        calm(torch, model, gen)
        x = torch.randn(RSS_BATCH, 3, IMAGE, IMAGE, generator=gen).to(self.dev)

        def forward(fused_mlp, fused_attn):
            set_rss_flags(model, fused_mlp, fused_attn)
            tm.reset_launches()
            ti.reset_launches()
            with torch.no_grad():
                out = model(x)
            torch.cuda.synchronize()
            return out, {**tm.LAUNCHES, **ti.LAUNCHES}

        prob, counts = forward(True, True)
        log(f"  launches in one forward: {counts}")
        want = {"mlp_fc1": RSS_BLOCKS, "mlp_taps": RSS_BLOCKS, "isa_core": RSS_BLOCKS}
        self.check(counts == want, f"launch counts {want}: the FFN and the attention core of "
                                   f"each of the {RSS_BLOCKS} transformer blocks ran on K5 and K6")
        self.launches.update(counts)
        self.check(tuple(prob.shape) == (RSS_BATCH, RSS_CLASSES, IMAGE, IMAGE)
                   and prob.dtype == torch.float32 and bool(torch.isfinite(prob).all()),
                   f"probabilities {tuple(prob.shape)} {prob.dtype}, finite")
        rows = (prob.sum(dim=1) - 1.0).abs().max().item()
        self.check(rows <= 1e-4 and 0.0 <= prob.min().item() and prob.std().item() > 0.01,
                   f"probabilities sum to 1 over the classes (max deviation {rows:.1e}), spread "
                   f"{prob.std().item():.3f}, largest {prob.max().item():.3f}")
        plain, counts = forward(False, False)
        self.check(sum(counts.values()) == 0, "both flags off: no K5 or K6 launch (cuDNN "
                                              "convolutions, plain attention core)")
        err = (prob - plain).abs().max().item()
        self.check(err <= RSS_TOL, f"probabilities, K5 + K6 against both flags off: max abs err "
                                   f"{err:.3e} (tol {RSS_TOL:.0e})")
        self._share("classes (argmax), K5 + K6 against both flags off,", prob.argmax(1),
                    plain.argmax(1), RSS_SHARE)
        self.rss_err = err
        for flags, want in (((True, False), {"mlp_fc1": RSS_BLOCKS, "mlp_taps": RSS_BLOCKS,
                                             "isa_core": 0}),
                            ((False, True), {"mlp_fc1": 0, "mlp_taps": 0,
                                             "isa_core": RSS_BLOCKS})):
            out, counts = forward(*flags)
            e = (out - plain).abs().max().item()
            self.check(counts == want and e <= RSS_TOL,
                       f"fused_mlp, fused_attn = {flags}: launches {counts}, max abs err against "
                       f"both off {e:.3e}")
        set_rss_flags(model, True, True)
        return model, x

    def run_presr(self, tmb, model, blocks, x) -> None:
        """The headline TSCD forward with `pre_sr=True` against `pre_sr=False`."""
        torch = self.torch
        log(f"== K1' in the model: the headline forward with pre_sr=True, "
            f"{BATCH} x 3 x {IMAGE} x {IMAGE}")

        def forward(pre_sr):
            for b in blocks:
                b.pre_sr = pre_sr
            tmb.reset_launches()
            with torch.no_grad():
                out = model(x)
            torch.cuda.synchronize()
            return out, dict(tmb.LAUNCHES)

        try:
            got, counts = forward(True)
        finally:
            for b in blocks:
                b.pre_sr = False
        ref, ref_counts = forward(False)
        n_sr = sum(DEPTH for _, _, _, sr, _ in STAGES if sr > 1)
        # an sr > 1 block keeps the ln_stats of LN2 only; an sr == 1 block is as before
        want = {"ln_stats": n_sr + 2 * (8 - n_sr), "linear": 5 * 8, "sr_conv": 0,
                "attention": 8, "dwconv_gelu": 8}
        log(f"  launches with pre_sr: {counts}; without: {ref_counts}")
        self.check(counts == want, f"launch counts {want}: no sr_conv, {ref_counts['ln_stats']} "
                                   f"-> {want['ln_stats']} ln_stats")
        self.launches["mit_block_presr"] = sum(counts.values())
        for k, g, w in (("cls", got[0], ref[0]), ("seg", got[1], ref[1]),
                        ("attn_pred", got[3], ref[3])):
            err, mag = max_err(g, w)
            self.check(bool(torch.isfinite(g.float()).all()) and err <= PATH_TOL * mag,
                       f"{k}: pre_sr=True against pre_sr=False max abs err {err:.3e} "
                       f"(max {mag:.3e}, tol {PATH_TOL * mag:.3e})")

    # ------------------------------------------------------------- phase 8
    def timing(self, model, blocks, x, card: str) -> None:
        torch = self.torch
        log(f"== timing of the forward (CUDA events, {card})")

        def forward():
            with torch.no_grad():
                model(x)

        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            with plain_kernels(*blocks, plain=which == "plain"):
                times[which].append(self.time_ms(forward, iters=3))
        for which, ts in times.items():
            ms = min(ts)
            log(f"  forward, {which} path: {', '.join(f'{t:.2f}' for t in ts)} ms per batch "
                f"of {BATCH} -> {BATCH * 1000.0 / ms:.1f} tiles/s (best run)")
        torch.cuda.reset_peak_memory_stats()
        forward()
        log(f"  peak device memory, kernel path: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for k in PIECE_TOL:
            lib = self.piece_library_ms[k]
            log(f"  {k}: {self.piece_ms[k]:.3f} ms per forward (plain "
                f"{self.piece_plain_ms[k]:.3f} ms, bound {sum(self.piece_bound[k]):.4f} ms, "
                f"library call {'none' if lib is None else f'{lib:.3f} ms'})")
        for which, part in self.attn_split.items():
            lib = part["library_ms"]
            log(f"  attention, the {part['launches']} launches with {which.replace('_', ' ')}: "
                f"{part['ms']:.3f} ms, bound {part['bound_ms']:.4f} ms, library call "
                f"{f'{lib:.3f} ms' if lib else 'none'}")
        by_bytes, by_ops = self.block_bound
        log(f"  K1, the 8 blocks of a forward each as one function (tokens in and out in "
            f"bf16, parameters, exported logits; 2 M K N operations at the bf16 peak): "
            f"bound {by_bytes + by_ops:.4f} ms ({by_bytes:.4f} by bytes, {by_ops:.4f} by "
            f"operations), kernels {self.block_ms:.3f} ms; the per-kernel bounds above "
            f"take the f32 tensors between the five kernels as given")

    def timing_pseudo(self, twin, twin_blocks, args, card: str) -> None:
        """The whole pseudo-label call, kernel path against plain path in turns,
        and the kernel path's stages one by one."""
        torch = self.torch
        from representationlearning_tpu_torch.models.refine import varm_refine
        from representationlearning_tpu_torch.train import scd as ts
        from representationlearning_tpu_torch.wsss import camutils as cu

        x, cls, box, cfg, attn_mask = args
        log(f"== timing of the pseudo-label call (CUDA events, {card})")

        def call():
            ts.scd_pseudo_labels(twin, x, cls, box, cfg, attn_mask=attn_mask)

        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            with plain_kernels(*twin_blocks, plain=which == "plain"):
                times[which].append(self.time_ms(call, iters=3, warmup=1))
        for which, ts_ms in times.items():
            ms = min(ts_ms)
            log(f"  scd_pseudo_labels, {which} path: {', '.join(f'{t:.2f}' for t in ts_ms)} ms "
                f"per batch of {BATCH} -> {BATCH * 1000.0 / ms:.1f} images/s (best run)")
        torch.cuda.reset_peak_memory_stats()
        call()
        log(f"  peak device memory, kernel path: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        with torch.no_grad():
            cams, _ = cu.multi_scale_cam_with_ref_mat(
                lambda a: twin(a, cam_only=True), x, cfg.cam_scales)
            denorm = x * x.new_tensor(cfg.std)[None, :, None, None] \
                + x.new_tensor(cfg.mean)[None, :, None, None]

            def refine_fn(im, m):
                return varm_refine(im, m, dilations=cfg.varm_dilations, num_iter=cfg.varm_iters)

            def refine():
                return cu.refine_cams_with_bkg_v2(refine_fn, denorm, cams, cls, box,
                                                  max_present=cfg.max_present)

            refined = refine()
            stages = {
                "multi_scale_cam (3 x 16 forwards on K1, resizes)":
                    lambda: cu.multi_scale_cam_with_ref_mat(
                        lambda a: twin(a, cam_only=True), x, cfg.cam_scales),
                "cam_to_label": lambda: cu.cam_to_label(cams, cls, box, ignore_mid=True),
                "refine_cams_with_bkg_v2 (resizes, softmax, K2, K3, argmax)": refine,
                "cams_to_refine_label": lambda: cu.cams_to_refine_label(refined, mask=attn_mask),
            }
            for name, fn in stages.items():
                log(f"  stage {name}: {self.time_ms(fn, iters=5, warmup=1):.3f} ms")
            from representationlearning_tpu_torch.ops.image import flip_lr, resize_bilinear
            for scale in cfg.cam_scales:
                side = int(scale * CROP)
                xs = resize_bilinear(x, (side, side))
                cat = torch.cat([xs, flip_lr(xs)], dim=0)
                ms = self.time_ms(lambda: twin(cat, cam_only=True), iters=5, warmup=1)
                log(f"  cam_only forward of {tuple(cat.shape)}: {ms:.3f} ms")

    def timing_train(self, t, pl, batch, card: str) -> None:
        """The whole train step, kernel path against plain path in turns."""
        torch = self.torch
        log(f"== timing of the train step (CUDA events, {card})")

        def stepper(tr):
            return lambda: tr.step(tr.state, batch, torch.Generator().manual_seed(self.seed))

        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            plain = which == "plain"
            with plain_kernels(*pl.twin_blocks, plain=plain):
                times[which].append(self.time_ms(stepper(pl if plain else t), iters=3, warmup=1))
        for which, ts_ms in times.items():
            ms = min(ts_ms)
            log(f"  train step, {which} path: {', '.join(f'{v:.2f}' for v in ts_ms)} ms per "
                f"batch of {BATCH} -> {BATCH * 1000.0 / ms:.1f} images/s (best run)")
        torch.cuda.reset_peak_memory_stats()
        stepper(t)()
        torch.cuda.synchronize()
        log(f"  peak device memory, kernel path: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for k in ("flash_fwd", "flash_bwd"):
            log(f"  {k}: {self.piece_ms[k]:.3f} ms per step over its {self.launches_train[k]} "
                f"launches, each timed alone (plain {self.piece_plain_ms[k]:.3f} ms, bound "
                f"{sum(self.piece_bound[k]):.4f} ms, library call "
                f"{self.piece_library_ms[k]:.3f} ms)")

    def timing_rml(self, t, pl, batch, card: str) -> None:
        """The whole RML train step, augmentation included, kernel path against
        plain path in turns."""
        torch = self.torch
        log(f"== timing of the RML train step (CUDA events, {card})")

        def stepper(tr):
            return lambda: tr.step(tr.state, batch, torch.Generator().manual_seed(self.seed))

        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            plain = which == "plain"
            with plain_kernels(*pl.twin_blocks, plain=plain):
                times[which].append(self.time_ms(stepper(pl if plain else t), iters=3, warmup=1))
        for which, ts_ms in times.items():
            ms = min(ts_ms)
            log(f"  RML train step, {which} path: {', '.join(f'{v:.2f}' for v in ts_ms)} ms per "
                f"batch of {RML_BATCH} -> {RML_BATCH * 1000.0 / ms:.1f} images/s (best run)")
        torch.cuda.reset_peak_memory_stats()
        stepper(t)()
        torch.cuda.synchronize()
        log(f"  peak device memory, kernel path: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"  launches a step: " + ", ".join(f"{k} {self.launches_rml[k]}"
                                               for k in RML_KERNELS))

    def timing_presr(self, model, blocks, x, card: str) -> None:
        torch = self.torch
        log(f"== timing of the headline forward with and without pre_sr (CUDA events, {card})")

        def forward():
            with torch.no_grad():
                model(x)

        times = {False: [], True: []}
        try:
            for pre_sr in (False, True, True, False):
                for b in blocks:
                    b.pre_sr = pre_sr
                times[pre_sr].append(self.time_ms(forward, iters=3))
        finally:
            for b in blocks:
                b.pre_sr = False
        for pre_sr, ts in times.items():
            log(f"  forward, pre_sr={pre_sr}: {', '.join(f'{t:.2f}' for t in ts)} ms per batch "
                f"of {BATCH} -> {BATCH * 1000.0 / min(ts):.1f} tiles/s (best run)")
        k = "mit_block_presr"
        log(f"  {k}: the 6 sr > 1 blocks of a forward with h, xs handed in {self.piece_ms[k]:.3f} "
            f"ms (plain {self.piece_plain_ms[k]:.3f} ms, bound {sum(self.piece_bound[k]):.4f} "
            f"ms), their library front {self.presr_front_ms:.3f} ms")
        log(f"  the front of those 6 blocks by graph replay: F.layer_norm, F.conv2d, F.layer_norm "
            f"{self.front_graph_ms['library']:.3f} ms; K1's ln_stats, sr_conv, ln_stats "
            f"{self.front_graph_ms['k1']:.3f} ms (its LayerNorms are applied in the prologues "
            f"of sr_conv and of the q and kv linears)")

    def timing_rss(self, tm, ti, model, x, card: str) -> None:
        """K5 and K6 a forward with their bounds, the unfused module beside K5, and
        the whole predict four ways."""
        torch = self.torch
        import torch.nn.functional as F
        bf16 = torch.bfloat16
        log(f"== timing of K5, K6 and the RSSFormer predict (the kernels and their library "
            f"calls by CUDA-graph replay, the rest by CUDA events; {card})")
        mod, xm, p, f1, rest, hp, out, h = self.mlp_inputs
        H = W = IMAGE // 4
        M, hid, cout = xm.shape[0] * xm.shape[1], 4 * RSS_DIM, RSS_DIM
        xb, b1 = xm.to(bf16), f1[1].to(bf16)
        with torch.no_grad():
            fns = {"mlp_fc1": (lambda: tm.mlp_fc1(xm, *f1), lambda: tm.mlp_fc1_reference(xm, *f1),
                               lambda: F.linear(xb, f1[0], b1)),
                   "mlp_taps": (lambda: tm.mlp_taps(hp, *rest, H=H, W=W),
                                lambda: tm.mlp_taps_reference(hp, *rest, H=H, W=W), None)}
            for name, (kern, plain, lib) in fns.items():
                self.piece_ms[name] = RSS_BLOCKS * self.graph_ms(kern)
                self.piece_plain_ms[name] = RSS_BLOCKS * self.time_ms(plain, iters=3)
                self.piece_library_ms[name] = None if lib is None else \
                    RSS_BLOCKS * self.graph_ms(lib)
            whole = self.time_ms(lambda: tm.fused_mlp_dwbn(xm, p, H=H, W=W, dtype=bf16), iters=20)
            mod.fused = False
            unfused = self.time_ms(lambda: mod(xm, H, W), iters=20)
            mod.fused = True
        self.library_covers["mlp_fc1"] = "F.linear on bf16: the product and the bias, without " \
                                         "bn1 and the GELU"
        # fc1: x, the weight and three vectors read, the bf16 plane written; taps: the
        # plane, 19 + 1 weights and six vectors read, the tokens written; a tap counts
        # only where its source lies inside the plane (outside it is zero by definition)
        self.add_bound("mlp_fc1", nbytes(xm, f1, h), 2.0 * M * RSS_DIM * hid, PEAK_BF16,
                       times=RSS_BLOCKS)
        tap_tokens = xm.shape[0] * sum(max(0, H - abs(dy)) * max(0, W - abs(dx))
                                       for dy, dx in tm.tap_offsets())
        self.add_bound("mlp_taps", nbytes(hp, rest, out),
                       2.0 * hid * (hid * tap_tokens + M * cout), PEAK_BF16, times=RSS_BLOCKS)
        self.unfused_mlp_ms = RSS_BLOCKS * unfused
        log(f"  K5 a launch: fc1 {self.piece_ms['mlp_fc1'] / RSS_BLOCKS:.4f} ms + taps "
            f"{self.piece_ms['mlp_taps'] / RSS_BLOCKS:.4f} ms; fused_mlp_dwbn (the two and the "
            f"weight packing) {whole:.4f} ms; the unfused MlpDWBN module (cuDNN bf16 convs, f32 "
            f"BatchNorm and GELU) {unfused:.4f} ms")
        q, k, v, got = self.isa_inputs
        nh, hd = RSS_HEADS, RSS_DIM // RSS_HEADS
        NW, T, C = q.shape

        def heads(t):
            return t.to(bf16).reshape(NW, T, nh, hd).transpose(1, 2).contiguous()

        qh, kh, vh = heads(q), heads(k), heads(v)
        with torch.no_grad():  # the kernel and the library call by graph replay
            self.piece_ms["isa_core"] = RSS_BLOCKS * self.graph_ms(
                lambda: ti.isa_core(q, k, v, nh=nh, dtype=bf16))
            self.isa_f32_ms = RSS_BLOCKS * self.graph_ms(
                lambda: ti.isa_core(q, k, v, nh=nh, dtype=torch.float32))
            self.piece_plain_ms["isa_core"] = RSS_BLOCKS * self.time_ms(
                lambda: ti.isa_core_reference(q, k, v, nh=nh, dtype=bf16), iters=5)
            self.piece_library_ms["isa_core"] = RSS_BLOCKS * self.graph_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0))
        self.library_covers["isa_core"] = "F.scaled_dot_product_attention on bf16 heads: the " \
                                          "softmax attention without the DAL gate"
        # q k^T and p v: 2 * 2 T T C a window; the gate's q^T k: 2 T C hd
        self.add_bound("isa_core", nbytes(q, k, v, got), NW * (4.0 * T * T * C + 2.0 * T * C * hd),
                       PEAK_BF16, times=RSS_BLOCKS)
        for name in ("mlp_fc1", "mlp_taps", "isa_core"):
            lib = self.piece_library_ms[name]
            log(f"  {name}: {self.piece_ms[name]:.3f} ms per forward of {RSS_BLOCKS} launches "
                f"(plain {self.piece_plain_ms[name]:.3f} ms, bound "
                f"{sum(self.piece_bound[name]):.4f} ms by "
                f"{'bytes' if self.piece_bound[name][0] else 'operations'}, library call "
                f"{'none' if lib is None else f'{lib:.3f} ms'})")
        log(f"  isa_core with f32 operands: {self.isa_f32_ms:.3f} ms per forward of {RSS_BLOCKS} "
            f"launches (graph replay)")

        def forward():
            with torch.no_grad():
                model(x)

        order = [(False, False), (True, True), (True, False), (False, True),
                 (False, True), (True, False), (True, True), (False, False)]
        times: dict = {}
        for flags in order:
            set_rss_flags(model, *flags)
            times.setdefault(flags, []).append(self.time_ms(forward, iters=6))
        set_rss_flags(model, True, True)
        for flags, ts in times.items():
            log(f"  predict, fused_mlp={flags[0]}, fused_attn={flags[1]}: "
                f"{', '.join(f'{t:.2f}' for t in ts)} ms per batch of {RSS_BATCH} -> "
                f"{RSS_BATCH * 1000.0 / min(ts):.1f} tiles/s (best run)")
        torch.cuda.reset_peak_memory_stats()
        forward()
        torch.cuda.synchronize()
        log(f"  peak device memory, both flags on: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


    # ------------------------------------------------------------- phase 7l (f32, K5 widths)
    def run_f32(self, mods, card: str) -> None:
        """K1's f32 operand path and K5 in f32 and at every HRNetV2 width: each new kernel
        geometry against its plain version at the same dtype (TF32 off), then the models
        that run them, TSCD(dtype=f32, fused_blocks=True) at the headline's 8 x 512² and
        HRNetFusion(w18 / w40 / w48, fused_mlp, fused_attn) in f32 at 8 x 512²."""
        torch = self.torch
        tmb, tm, ti = mods[0], mods[4], mods[5]
        t_phase = time.perf_counter()
        log(f"== f32 and K5 widths (phase 7l): K1 linear / sr_conv / attention with f32 operands "
            f"(3xTF32 on wgmma; sr_conv's K slices summed in a thread-block cluster), K5 at hid "
            f"72 / 128 / 160 / 192 in f32 and bf16 (taps on 3xTF32 wgmma); {card}")
        gen = torch.Generator().manual_seed(self.seed + 31)
        self.f32 = {k: {"ms": 0.0, "bound": [0.0, 0.0], "lib": 0.0, "err": 0.0}
                    for k in (*PIECE_TOL, "mlp_fc1", "mlp_taps")}
        self.f32_same = True
        log(f"  K1 at the headline's four stage geometries (B = {BATCH}, {IMAGE}², f32 tokens "
            f"and operands), each piece against its plain version, a rerun and every plan of "
            f"`linear` and `attention` for equal bits, every plan of `sr_conv` against the plain "
            f"version and its rerun, timed by graph replay with its f32 library call")
        for stage in STAGES:
            self._k1_f32_block(tmb, gen, BATCH, *stage)
        self._k1_f32_edges(tmb, gen)
        self.check(self.f32_same, "K1 with f32 operands: a rerun, and every `linear` and `attention` "
                                  "plan, give equal bits at every geometry of the phase")
        for k in PIECE_TOL:
            e = self.f32[k]
            ratio = e["ms"] / self.piece_ms[k] if self.piece_ms.get(k) else float("nan")
            log(f"  {k} a headline forward in f32: kernel {e['ms']:.4f} ms, bound "
                f"{sum(e['bound']):.4f} ms ({'bytes' if e['bound'][0] >= e['bound'][1] else 'operations'}"
                f", {sum(e['bound']) / e['ms']:.0%} of it), library call {e['lib']:.4f} ms, largest "
                f"error {e['err']:.3e}; f32 / bf16 kernel time {ratio:.2f}")
        self._wgmma_sass()
        self._sr_conv_bf16_digest(tmb)
        self._tscd_f32(tmb)
        self._k5_widths(tm, gen)
        self._fc1_bf16_digests(tm)
        self._k6_f32_widths(ti, gen)
        self._hrnet_widths(tm, ti)
        log(f"  phase 7l: {time.perf_counter() - t_phase:.1f} s")

    def _k1_f32_block(self, tmb, gen, B, hw, C, nh, sr, export) -> None:
        """One block geometry with f32 operands: each kernel call of the block against its
        plain version in f32 at F32_PIECE_TOL, a rerun (and for `linear` every plan) for
        equal bits; each call's kernel time, its f32 library call and its f32 bound (3xTF32
        products at PEAK_TF32, or bytes), DEPTH blocks a stage."""
        torch = self.torch
        f32 = torch.float32
        N = hw * hw
        x = torch.randn(B, N, C, generator=gen).to(self.dev)
        p = self._block_params(C, nh, sr, export, gen)
        calls = []

        def recording(name):
            def run(*a, **kw):
                fn = getattr(tmb, name)
                got = fn(*a, **kw)
                runs = [fn(*a, **kw)]
                if name == "linear":
                    M, (Nout, K) = a[0].numel() // a[0].shape[-1], a[1].shape
                    runs += [fn(*a, plan=pl, **kw) for pl in linear_plans(tmb, M, Nout, K, f32)]
                if name == "attention":
                    (B_, N_, C_), Nk_ = a[0].shape, a[1].shape[1]
                    runs += [fn(*a, plan=pl, **kw)
                             for pl in attention_plans(tmb, B_, N_, Nk_, C_, kw["nh"])]
                want = getattr(tmb, name + "_reference")(*a, **kw)
                if name == "sr_conv":   # each plan cuts K its own way: held to the plain version
                    B_, _, C_ = a[0].shape
                    sr_ = kw["sr"]
                    M_ = B_ * (kw["H"] // sr_) * (kw["W"] // sr_)
                    for pl in sr_conv_plans(tmb, M_, C_, sr_ * sr_ * C_):
                        got_p, again = fn(*a, plan=pl, **kw), fn(*a, plan=pl, **kw)
                        torch.cuda.synchronize()
                        err, mag = max_err(got_p, want)
                        self.check(err <= F32_PIECE_TOL[name] * max(1.0, mag),
                                   f"sr_conv f32 @ B={B} N={N} C={C} plan {pl}: max abs err "
                                   f"{err:.3e} (max |plain| {mag:.3e})")
                        self.f32[name]["err"] = max(self.f32[name]["err"], err)
                        self.f32_same &= torch.equal(got_p, again)
                torch.cuda.synchronize()
                got_t = got if isinstance(got, tuple) else (got,)
                want_t = want if isinstance(want, tuple) else (want,)
                for i, (g, w) in enumerate(zip(got_t, want_t)):
                    if g is None:
                        continue
                    err, mag = max_err(g, w)
                    tol = F32_PIECE_TOL[name if i == 0 else "logits"] * max(1.0, mag)
                    self.check(bool(torch.isfinite(g).all()) and err <= tol,
                               f"{name}{' logits' if i else ''} f32 @ B={B} N={N} C={C}: max abs "
                               f"err {err:.3e} (max |plain| {mag:.3e}, tol {tol:.3e})")
                    self.f32[name]["err"] = max(self.f32[name]["err"], err if i == 0 else 0.0)
                    for r in runs:
                        self.f32_same &= torch.equal(g, (r if isinstance(r, tuple) else (r,))[i])
                calls.append((name, a, kw, got))
                return got
            return run

        def sr_plan(a, kw):
            B_, _, C_ = a[0].shape
            sr_ = kw["sr"]
            return tmb.sr_conv_plan(B_ * (kw["H"] // sr_) * (kw["W"] // sr_), C_, sr_ * sr_ * C_, f32)

        ops = SimpleNamespace(**{n: recording(n) for n in PIECE_TOL})
        with torch.no_grad():
            tmb._block(x, p, ops=ops, H=hw, W=hw, sr=sr, nh=nh, dtype=f32, export=export)
            for name, a, kw, got in calls:
                k_ms = self.graph_ms(lambda: getattr(tmb, name)(*a, **kw))
                lib_fn = self._library_call(name, a, kw, f32)
                lib_ms = None if lib_fn is None else self.graph_ms(lib_fn)
                flops, peak = k1_flops(name, a, kw)
                if peak == PEAK_BF16:   # the products: three TF32 products each
                    flops, peak = 3.0 * flops, PEAK_TF32
                t_bytes, t_ops = 1e3 * nbytes(a, kw, got) / PEAK_BYTES, 1e3 * flops / peak
                e = self.f32[name]
                e["ms"] += DEPTH * k_ms
                e["bound"][0 if t_bytes >= t_ops else 1] += DEPTH * max(t_bytes, t_ops)
                e["lib"] += DEPTH * (lib_ms or 0.0)
                if name in ("linear", "sr_conv", "attention"):
                    log(f"  {name} f32 @ N={N} C={C}{', exporting' if export and name == 'attention' else ''}"
                        f"{f' {shape_of(a)}' if name == 'linear' else ''}"
                        f"{f' plan {sr_plan(a, kw)}' if name == 'sr_conv' else ''}, a launch: kernel "
                        f"{k_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
                        f"({max(t_bytes, t_ops) / k_ms:.0%} of it), library call "
                        f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}")

    def _wgmma_sass(self) -> None:
        """The SASS of the f32 `linear`, `sr_conv`, `attention`, `taps` and `fc1` instantiations
        (`cuobjdump -sass` on the built libraries): their main products are TF32 `HGMMA`s, and
        all but `taps` hold no `HMMA` (the taps' `HMMA` are fc2's 3xTF32 `mma.sync`, 1 / 20 of
        its products)."""
        from representationlearning_tpu_torch.ops import _build

        tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
        counts = {}
        for lib, kernel in (("mit_block", "linear_wg_kernel"), ("mit_block", "sr_conv_wg_kernel"),
                            ("mit_block", "attention_wg_kernel"), ("rssformer", "taps_wg_kernel"),
                            ("rssformer", "fc1_wg_kernel")):
            sass = run_cmd([tool, "-sass", _build.build_log[lib]["path"]])
            name = None
            for line in sass.splitlines():
                m = re.search(r"Function : (\S+)", line)
                if m:
                    name = m.group(1) if kernel in m.group(1) else None
                elif name is not None:
                    c = counts.setdefault((kernel, name), [0, 0])
                    c[0] += bool(re.search(r"HGMMA\.\S*TF32", line))
                    c[1] += bool(re.search(r"\bHMMA\b", line))
        from representationlearning_tpu_torch.ops import mit_block as tmb

        # (instantiations, least TF32 HGMMA each): linear with and without LN, 12 a K step
        # (3 products x 4 k slices); sr_conv at every tile, 12 a K step; attention at head
        # width 32 and 64 with one and two consumer warpgroups, 36 a key tile at least (q k^T:
        # 3 x hd / 8, p v: 3 x 8); taps at hid 96 to 192; fc1 at tiles of 32 and 96 to 192
        # hidden features, 6 a pair of k slices
        for kernel, n, least in (("linear_wg_kernel", 2 * len(tmb.LINEAR_TILES_F32), 12),
                                 ("sr_conv_wg_kernel", len(tmb.SR_WG_ROWS) * len(tmb.SR_WG_COLUMNS), 12),
                                 ("attention_wg_kernel", 2 * len(tmb.ATTN_WG_QUERIES), 36),
                                 ("taps_wg_kernel", 4, 12), ("fc1_wg_kernel", 5, 6)):
            got = [v for (k, _), v in counts.items() if k == kernel]
            no_hmma = kernel != "taps_wg_kernel"
            log(f"  SASS of {kernel}'s {len(got)} instantiations: TF32 HGMMA "
                f"{[h for h, _ in got]}, HMMA {[m for _, m in got]}")
            self.check(len(got) == n and all(h >= least for h, _ in got)
                       and (not no_hmma or all(m == 0 for _, m in got)),
                       f"{kernel}: the f32 products run on TF32 HGMMA (at least {least} an "
                       f"instantiation){', no HMMA' if no_hmma else ''}")

    def _k1_f32_edges(self, tmb, gen) -> None:
        """K1's three product kernels with f32 operands at PR 7's edges of `linear` (M of
        one row and of a tile less or more one, Nout 96 / 640 / 1280, K 32 / 64 / 2048,
        LayerNorm and residual on and off, every plan), `sr_conv` at K1_F32_SR_EDGES (grids
        cropped to full windows, patch rows that cross images, tiles of a row more or less,
        every tile width) at every plan, `attention` (its `wgmma` kernel) at K1_F32_ATTN_KEYS
        x K1_F32_ATTN_QUERIES, head widths 32 and 64, with and without export, every plan;
        the shared memory of `sr_conv` and `attention` as the kernel and the plan count it,
        and the clusters of `sr_conv` the card holds as its plan counts them."""
        torch = self.torch
        f32 = torch.float32

        def rand(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=gen)).to(self.dev)

        def held(name, got, want, i=0):
            err, mag = max_err(got, want)
            self.f32[name]["err"] = max(self.f32[name]["err"], err if i == 0 else 0.0)
            return err / (F32_PIECE_TOL[name if i == 0 else "logits"] * max(1.0, mag))

        worst, n = 0.0, 0
        rows = sorted({r for r, _ in tmb.LINEAR_TILES})
        ms = sorted({1} | {r + d for r in rows for d in (-1, 1)})
        with torch.no_grad():
            for M in ms:
                for Nout in (96, 640, 1280):
                    for K in (32, 64, 2048):
                        a, w = rand(M, K), rand(Nout, K, scale=0.05)
                        for ln in (False, True):
                            for res in (False, True):
                                kw = dict(bias=rand(Nout), dtype=f32)
                                if ln:
                                    kw.update(stats=tmb.ln_stats_reference(a), ln_w=rand(K) + 1.0,
                                              ln_b=rand(K, scale=0.1))
                                if res:
                                    kw["residual"] = rand(M, Nout)
                                got = tmb.linear(a, w, **kw)
                                runs = [tmb.linear(a, w, **kw)]
                                runs += [tmb.linear(a, w, plan=pl, **kw)
                                         for pl in linear_plans(tmb, M, Nout, K, f32)]
                                torch.cuda.synchronize()
                                worst = max(worst, held("linear", got, tmb.linear_reference(a, w, **kw)))
                                self.f32_same &= all(torch.equal(got, r) for r in runs)
                                n += 1
            self.check(worst <= 1.0, f"linear f32 at M = {ms}, Nout = 96, 640, 1280, K = 32, 64, "
                                     f"2048, LayerNorm and residual on and off ({n} cases, every "
                                     f"plan): largest error {worst:.3f} of its tolerance")
            worst, n = 0.0, 0
            for B, H, W, C, sr in K1_F32_SR_EDGES:
                x = rand(B, H * W, C)
                args = (x, tmb.ln_stats_reference(x), rand(C) + 1.0, rand(C, scale=0.1),
                        rand(C, sr * sr * C, scale=0.05), rand(C))
                want = tmb.sr_conv_reference(*args, H=H, W=W, sr=sr, dtype=f32)
                M = B * (H // sr) * (W // sr)
                for plan in sr_conv_plans(tmb, M, C, sr * sr * C):
                    got = tmb.sr_conv(*args, H=H, W=W, sr=sr, dtype=f32, plan=plan)
                    again = tmb.sr_conv(*args, H=H, W=W, sr=sr, dtype=f32, plan=plan)
                    torch.cuda.synchronize()
                    worst = max(worst, held("sr_conv", got, want))
                    self.f32_same &= torch.equal(got, again)
                    n += 1
            self.check(worst <= 1.0, f"sr_conv f32 at {len(K1_F32_SR_EDGES)} edge geometries "
                                     f"({n} cases, every plan: 64 and 128 rows, 1 to "
                                     f"{tmb.SR_WG_MAX_SLICES} K slices a cluster): largest error "
                                     f"{worst:.3f} of its tolerance")
            from representationlearning_tpu_torch.ops import _build

            lib = _build.load_library("mit_block")
            tiles = [(r, c) for r in tmb.SR_WG_ROWS for c in tmb.SR_WG_COLUMNS]
            smem = {t: (lib.k1_sr_conv_wg_smem(*t), tmb.sr_conv_smem_bytes(t, f32)) for t in tiles}
            clusters = {t: [lib.k1_sr_conv_wg_clusters(*t, s)
                            for s in range(1, tmb.SR_WG_MAX_SLICES + 1)] for t in tiles}
            self.check(all(a == b <= tmb.SMEM_LIMIT for a, b in smem.values())
                       and all(c == list(tmb.SR_WG_CLUSTERS) for c in clusters.values()),
                       f"sr_conv f32: the kernel's shared memory at every tile equals the plan's "
                       f"(within {tmb.SMEM_LIMIT}), and the card holds {list(tmb.SR_WG_CLUSTERS)} "
                       f"clusters of 1 to {tmb.SR_WG_MAX_SLICES} blocks at every tile (the card: "
                       f"{clusters[(128, 64)]} at 128 x 64)")
            smem = {(hd, q): (lib.k1_attention_wg_smem(hd, q),
                              tmb.attention_smem_bytes((q, 1), hd, f32))
                    for hd in (32, 64) for q in tmb.ATTN_WG_QUERIES}
            self.check(all(a == b <= tmb.SMEM_LIMIT for a, b in smem.values()),
                       f"attention f32: the kernel's shared memory at head widths 32 and 64, "
                       f"64 and 128 queries a block {smem} (bytes: kernel, plan), within "
                       f"{tmb.SMEM_LIMIT}")
            worst, n = 0.0, 0
            for Nk in K1_F32_ATTN_KEYS:
                for N in K1_F32_ATTN_QUERIES:
                    for C, nh in ((64, 1), (64, 2), (128, 2)):   # head widths 64, 32, 64
                        q, kv = rand(2, N, C), rand(2, Nk, 2 * C)
                        for export in (False, True):
                            got = tmb.attention(q, kv, nh=nh, dtype=f32, export=export)
                            runs = [tmb.attention(q, kv, nh=nh, dtype=f32, export=export)]
                            runs += [tmb.attention(q, kv, nh=nh, dtype=f32, export=export, plan=pl)
                                     for pl in attention_plans(tmb, 2, N, Nk, C, nh)]
                            torch.cuda.synchronize()
                            want = tmb.attention_reference(q, kv, nh=nh, dtype=f32, export=export)
                            for i in (0, 1):
                                if got[i] is not None:
                                    worst = max(worst, held("attention", got[i], want[i], i))
                                    self.f32_same &= all(torch.equal(got[i], r[i]) for r in runs)
                            n += 1
            self.check(worst <= 1.0, f"attention f32 (wgmma) at Nk = {K1_F32_ATTN_KEYS}, N = "
                                     f"{K1_F32_ATTN_QUERIES}, head widths 32 and 64, with and "
                                     f"without export ({n} cases, every plan): largest error "
                                     f"{worst:.3f} of its tolerance")

    def _sr_conv_bf16_digest(self, tmb) -> None:
        """The bf16 `sr_conv` (its `mma.sync` kernel) at the headline's three stage geometries
        on inputs from a fixed seed: a SHA-256 of each output, to be compared with another
        tree's line (`tools/time_port_sr_conv.py --dtype bf16` prints the same digests)."""
        torch = self.torch
        gen = torch.Generator().manual_seed(0)
        digests = []
        for hw, C, _, sr, _ in STAGES[:3]:
            K = sr * sr * C
            x = (2.0 * torch.randn(BATCH, hw * hw, C, generator=gen) + 0.5).to(self.dev)
            a = (x, tmb.ln_stats_reference(x), (torch.randn(C, generator=gen) + 1.0).to(self.dev),
                 (0.1 * torch.randn(C, generator=gen)).to(self.dev),
                 (K ** -0.5 * torch.randn(C, K, generator=gen)).to(self.dev).to(torch.bfloat16),
                 torch.randn(C, generator=gen).to(self.dev))
            out = tmb.sr_conv(*a, H=hw, W=hw, sr=sr, dtype=torch.bfloat16)
            digests.append(hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16])
        log(f"  sr_conv bf16 at the headline's stages 1-3, SHA-256: {' '.join(digests)}")

    def _tscd_f32(self, tmb) -> None:
        """TSCD(dtype=f32, fused_blocks=True) at the headline's 8 x 512² against its plain
        path (the same model, K1 swapped for its plain version) at TSCD_F32_TOL; K1 84."""
        torch = self.torch
        from representationlearning_tpu_torch.models.mit import FusedBlock
        from representationlearning_tpu_torch.models.tscd import TSCD

        gen = torch.Generator().manual_seed(self.seed + 32)
        model = TSCD("mit_b1", NUM_CLASSES, fused_blocks=True, collect_attns="last2",
                     generator=gen).eval()   # f32, the default
        blocks = [m for m in model.encoder.modules() if isinstance(m, FusedBlock)]
        x = torch.randn(BATCH, 3, IMAGE, IMAGE, generator=gen).to(self.dev)
        tmb.reset_launches()
        with torch.no_grad():
            out = model(x)
        torch.cuda.synchronize()
        counts = dict(tmb.LAUNCHES)
        n_sr = sum(DEPTH for _, _, _, sr, _ in STAGES if sr > 1)
        want = {"ln_stats": 2 * 8 + n_sr, "linear": 5 * 8, "sr_conv": n_sr,
                "attention": 8, "dwconv_gelu": 8}
        self.check(counts == want and all(b.dtype == torch.float32 for b in blocks),
                   f"TSCD(dtype=f32, fused_blocks=True) at {BATCH} x {IMAGE}²: K1 launches {counts} "
                   f"({sum(counts.values())}), as the bf16 headline's")
        self.launches_f32 = counts
        with plain_kernels(*blocks), torch.no_grad():
            plain = model(x)
        torch.cuda.synchronize()
        cls, seg, attns, pred = out
        p_cls, p_seg, p_attns, p_pred = plain
        for k, g, w in (("cls", cls, p_cls), ("seg", seg, p_seg), ("attn_pred", pred, p_pred),
                        ("attns[0]", attns[0], p_attns[0]), ("attns[1]", attns[1], p_attns[1])):
            err, mag = max_err(g, w)
            self.check(bool(torch.isfinite(g).all()) and err <= TSCD_F32_TOL * mag,
                       f"f32 TSCD {k}: kernel path against plain path max abs err {err:.3e} "
                       f"(max |plain| {mag:.3e}, tol {TSCD_F32_TOL * mag:.3e})")
        del out, plain, cls, seg, attns, pred, p_cls, p_seg, p_attns, p_pred

        def forward(plain_path):
            with (plain_kernels(*blocks) if plain_path else contextlib.nullcontext()), \
                    torch.no_grad():
                model(x)

        ms = [self.time_ms(lambda: forward(False), iters=5),
              self.time_ms(lambda: forward(True), iters=3), self.time_ms(lambda: forward(False), iters=5)]
        self.tscd_f32_ms = min(ms[0], ms[2])
        log(f"  f32 TSCD forward, {BATCH} x {IMAGE}²: kernel path {ms[0]:.2f} / {ms[2]:.2f} ms, "
            f"plain path {ms[1]:.2f} ms (CUDA events)")

    def _k5_widths(self, tm, gen) -> None:
        """K5 at HRNetV2's four widths (dim 18 / 32 / 40 / 48, hid = 4 dim) in f32 and bf16:
        fc1, taps and the whole block against their plain versions at the same dtype, at the
        branch-0 plane of a 512² input ({BATCH} x 128²), a TTA plane and PR 11's edge planes;
        a rerun and every plan for equal bits; the blocks an SM holds against the plans'
        estimates; a launch of each at {BATCH} x 128², timed by graph replay."""
        torch = self.torch
        import torch.nn.functional as F
        from representationlearning_tpu_torch.models.layers import init_weights
        from representationlearning_tpu_torch.models.rssformer_modules import MlpDWBN
        from representationlearning_tpu_torch.ops import _build

        f32, bf16 = torch.float32, torch.bfloat16
        lib = _build.load_library("rssformer")
        side = IMAGE // 4
        planes = ((BATCH, side, side), (2, 96, 96), (2, 7, 9), (1, 20, 45), (3, 13, 29),
                  (1, 1, 1))
        self.k5_widths = {}
        for dim in (18, 32, 40, 48):
            hid, cout = 4 * dim, dim
            hp = tm.padded_hid(hid)
            mod = MlpDWBN(dim, hid, cout, fused=True).eval()
            init_weights(mod, gen)
            calm(torch, mod, gen)
            mod.to(self.dev)
            with torch.no_grad():
                p = {k: v.detach() for k, v in mod.kernel_params().items()}
            fig = self.k5_widths[f"w{dim}"] = {}
            for dtype in (f32, bf16):
                d = "f32" if dtype == f32 else "bf16"
                tol = {k: K5_F32_TOL for k in K5_TOL} if dtype == f32 else K5_TOL
                far = None if dtype == f32 else K5_FAR_SHARE
                f1 = (p["fc1_weight"].reshape(hid, dim).to(dtype), p["fc1_bias"], p["bn1_scale"],
                      p["bn1_shift"])
                rest = (tm.tap_weights(p).to(dtype).contiguous(), p["dw_bias"], p["bn2_scale"],
                        p["bn2_shift"], p["fc2_weight"].reshape(cout, hid).to(dtype), p["fc2_bias"],
                        p["bn3_scale"], p["bn3_shift"])
                f32_flag = int(dtype == f32)
                first = tm.fc1_plan(BATCH * side * side, dim, hid, dtype)[0]   # warps, or tile (f32)
                tiles = tm.taps_tiles(hid, dtype)
                held = ([lib.k5_fc1_blocks_per_sm(dim, -(-dim // 16) * 16, hp, f32_flag, first)]
                        + [lib.k5_taps_blocks_per_sm(hp, f32_flag, t) for t in tiles])
                want_held = ([tm.fc1_blocks_per_sm(dim, first, hid, dtype)]
                             + [tm.taps_blocks_per_sm(t, hid, dtype) for t in tiles])
                self.check(held == want_held, f"K5 {d} dim {dim}: blocks an SM holds of fc1 "
                                              f"({first} {'features a tile' if f32_flag else 'warps'})"
                                              f" and of the taps tiles {tiles}: {held}, the plans' "
                                              f"estimates {want_held}")
                same, worst = True, {"mlp_fc1": 0.0, "mlp_taps": 0.0, "whole": 0.0}
                fc1_seen = set()
                for B, H, W in planes:
                    M = B * H * W
                    fc1_pl = (fc1_f32_plans(tm, M, dim, hid) if dtype == f32 else
                              [(w, per) for w in (1, 2, 4, 8) for per in (1, 2, 3)
                               if tm.fc1_fits(dim, w, hid, dtype)])
                    fc1_seen.update(fc1_pl)
                    x = torch.randn(B, H * W, dim, generator=gen).to(self.dev)
                    taps_pl = [(t, n) for t in tiles for n in sorted(
                        {1, 3, max(1, min(-(-M // t), tm.taps_blocks_per_sm(t, hid, dtype) * tm.TAPS_SMS))})]
                    with torch.no_grad():
                        h = tm.mlp_fc1(x, *f1, dtype=dtype)
                        runs = [tm.mlp_fc1(x, *f1, dtype=dtype)]
                        runs += [tm.mlp_fc1(x, *f1, dtype=dtype, plan=pl) for pl in fc1_pl]
                        out = tm.mlp_taps(h, *rest, H=H, W=W, dtype=dtype)
                        truns = [tm.mlp_taps(h, *rest, H=H, W=W, dtype=dtype)]
                        truns += [tm.mlp_taps(h, *rest, H=H, W=W, dtype=dtype, plan=pl)
                                  for pl in taps_pl]
                        whole = tm.fused_mlp_dwbn(x, p, H=H, W=W, dtype=dtype)
                        torch.cuda.synchronize()
                        want_h = tm.mlp_fc1_reference(x, *f1, dtype=dtype)
                        want = tm.mlp_taps_reference(h[..., :hid], *rest, H=H, W=W, dtype=dtype)
                        want_whole = tm.fused_mlp_dwbn_reference(x, p, H=H, W=W, dtype=dtype)
                    same &= all(torch.equal(h, r) for r in runs) and all(
                        torch.equal(out, r) for r in truns) and not h[..., hid:].any()
                    for name, g, w in (("mlp_fc1", h[..., :hid], want_h), ("mlp_taps", out, want),
                                       ("whole", whole, want_whole)):
                        err, mag = max_err(g, w)
                        scale = max(1.0, mag)
                        ok = bool(torch.isfinite(g.float()).all())
                        worst[name] = max(worst[name], err / (tol[name] * scale) if ok else float("inf"))
                        if far is not None and name != "mlp_fc1":
                            share = ((g.float() - w.float()).abs() > K5_NEAR * scale).float().mean().item()
                            worst[name] = max(worst[name], share / far)
                        if dtype == f32 and dim == RSS_DIM and name in self.f32:
                            self.f32[name]["err"] = max(self.f32[name]["err"], err)
                self.check(all(v <= 1.0 for v in worst.values()),
                           f"K5 {d} dim {dim} (hid {hid}, run at {hp}) at planes {list(planes)}: "
                           f"largest error of fc1 / taps / the whole block "
                           f"{' / '.join(f'{v:.3f}' for v in worst.values())} of its tolerance"
                           + ("" if far is None else f" (and of the share beyond {K5_NEAR:.0e})"))
                self.check(same, f"K5 {d} dim {dim}: a rerun and every plan of fc1 {sorted(fc1_seen)} "
                                 f"and of the taps (tiles {tiles}) give equal bits; the padded "
                                 f"hidden features are 0")
                # a launch of each at BATCH x 128², the kernel and fc1's library call by replay
                x = torch.randn(BATCH, side * side, dim, generator=gen).to(self.dev)
                with torch.no_grad():
                    h = tm.mlp_fc1(x, *f1, dtype=dtype)
                    out = tm.mlp_taps(h, *rest, H=side, W=side, dtype=dtype)
                    fc1_ms = self.graph_ms(lambda: tm.mlp_fc1(x, *f1, dtype=dtype))
                    taps_ms = self.graph_ms(lambda: tm.mlp_taps(h, *rest, H=side, W=side, dtype=dtype))
                    xl, bl = x.to(dtype), f1[1].to(dtype)
                    lib_ms = self.graph_ms(lambda: F.linear(xl, f1[0], bl))
                M = x.shape[0] * x.shape[1]
                tap_tokens = BATCH * sum(max(0, side - abs(dy)) * max(0, side - abs(dx))
                                         for dy, dx in tm.tap_offsets())
                ops_fc1 = 2.0 * M * dim * hid
                ops_taps = 2.0 * hid * (hid * tap_tokens + M * cout)
                rate = PEAK_TF32 / 3.0 if dtype == f32 else PEAK_BF16
                # x, the weights and vectors read and the hidden plane written at its own
                # width (fc1); that plane, 19 + 1 weights and six vectors read, the tokens
                # written (taps); a tap counts only where its source lies in the plane
                plane = M * hid * (4 if dtype == f32 else 2)
                b_fc1 = 1e3 * (nbytes(x, f1) + plane) / PEAK_BYTES, 1e3 * ops_fc1 / rate
                b_taps = 1e3 * (plane + nbytes(rest, out)) / PEAK_BYTES, 1e3 * ops_taps / rate
                fig.update({f"fc1_ms_{d}": fc1_ms, f"taps_ms_{d}": taps_ms,
                            f"fc1_bound_ms_{d}": max(b_fc1), f"taps_bound_ms_{d}": max(b_taps),
                            f"fc1_library_ms_{d}": lib_ms})
                log(f"  K5 {d} dim {dim} a launch at {BATCH} x {side}²: fc1 {fc1_ms:.4f} ms (bound "
                    f"{max(b_fc1):.4f}, by {'bytes' if b_fc1[0] >= b_fc1[1] else 'operations'}, "
                    f"{max(b_fc1) / fc1_ms:.0%} of it; F.linear {lib_ms:.4f}), taps {taps_ms:.4f} ms (bound "
                    f"{max(b_taps):.4f}, by {'bytes' if b_taps[0] >= b_taps[1] else 'operations'}, "
                    f"{max(b_taps) / taps_ms:.0%} of it; library call none)")
                if dtype == f32 and dim == RSS_DIM:   # the kernels line's f32 fields, a predict forward
                    xs = x[:RSS_BATCH].contiguous()
                    with torch.no_grad():
                        hs = tm.mlp_fc1(xs, *f1, dtype=dtype)
                        outs = tm.mlp_taps(hs, *rest, H=side, W=side, dtype=dtype)
                        ms_ = (self.graph_ms(lambda: tm.mlp_fc1(xs, *f1, dtype=dtype)),
                               self.graph_ms(lambda: tm.mlp_taps(hs, *rest, H=side, W=side, dtype=dtype)))
                        xsl = xs.to(dtype)
                        lib_s = self.graph_ms(lambda: F.linear(xsl, f1[0], bl))
                    Ms = xs.shape[0] * xs.shape[1]
                    sides = {"mlp_fc1": (1e3 * nbytes(xs, f1, hs) / PEAK_BYTES,
                                         1e3 * 2.0 * Ms * dim * hid / rate),
                             "mlp_taps": (1e3 * nbytes(hs, rest, outs) / PEAK_BYTES,
                                          1e3 * ops_taps * RSS_BATCH / BATCH / rate)}
                    for (name, (tb, to)), k_ms in zip(sides.items(), ms_):
                        e = self.f32[name]
                        e["ms"] = RSS_BLOCKS * k_ms
                        e["bound"][0 if tb >= to else 1] = RSS_BLOCKS * max(tb, to)
                        e["lib"] = RSS_BLOCKS * lib_s if name == "mlp_fc1" else None

    def _fc1_bf16_digests(self, tm) -> None:
        """The bf16 `mlp_fc1` at HRNetV2's widths and phase 7l's planes, on inputs drawn by
        numpy from a fixed seed: a SHA-256 of each output against FC1_BF16_SHA256, the
        digests of the tree before the f32 fc1 became `fc1_wg_kernel` (the same bf16 kernel)."""
        from tools.time_port_dwconv_fc1 import fc1_bf16_digests

        got = fc1_bf16_digests(self.torch, tm, self.dev)
        same = [k for k, v in got.items() if FC1_BF16_SHA256.get(k) == v]
        log(f"  fc1 bf16 at the four widths and {len(got) // 4} planes, SHA-256: "
            + ", ".join(f"{k} {v}" for k, v in got.items()))
        self.check(len(same) == len(FC1_BF16_SHA256) == len(got),
                   f"fc1 bf16: {len(same)} of {len(FC1_BF16_SHA256)} outputs equal the recorded "
                   f"SHA-256 (the same bits as before the f32 redesign)")

    def _k6_f32_widths(self, ti, gen) -> None:
        """K6 with f32 operands (plain f32 multiply-adds) at the head widths of phase 7l's
        f32 HRNetFusion (dim 18 / 40 / 48, two heads: 9 / 20 / 24), on the windows of its
        branch-0 plane ({BATCH} x 128², 7 x 7 windows): a launch by graph replay beside its
        byte bound and `F.scaled_dot_product_attention` f32 without the DAL gate."""
        torch = self.torch
        import torch.nn.functional as F

        f32, side = torch.float32, IMAGE // 4
        NW, T = BATCH * (-(-side // RSS_WINDOW)) ** 2, RSS_WINDOW * RSS_WINDOW
        self.k6_f32 = {}
        for dim in (18, 40, 48):
            nh, hd = RSS_HEADS, dim // RSS_HEADS
            q, k, v = (torch.randn(NW, T, dim, generator=gen).to(self.dev) for _ in range(3))
            q = q * hd ** -0.5
            with torch.no_grad():
                got = ti.isa_core(q, k, v, nh=nh, dtype=f32)
                torch.cuda.synchronize()
                err, mag = max_err(got, ti.isa_core_reference(q, k, v, nh=nh, dtype=f32))
                ms = self.graph_ms(lambda: ti.isa_core(q, k, v, nh=nh, dtype=f32))

                def heads(t):
                    return t.reshape(NW, T, nh, hd).transpose(1, 2).contiguous()

                qh, kh, vh = heads(q), heads(k), heads(v)
                lib_ms = self.graph_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0))
            t_bytes = 1e3 * nbytes(q, k, v, got) / PEAK_BYTES
            t_ops = 1e3 * NW * (4.0 * T * T * dim + 2.0 * T * dim * hd) / PEAK_F32
            self.check(err <= K6_TOL["float32"] * max(1.0, mag),
                       f"isa_core f32 at head width {hd}: max abs err {err:.3e}")
            self.k6_f32[f"w{dim}"] = {"head_width": hd, "ms": ms, "bound_ms": max(t_bytes, t_ops),
                                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                                      "library_ms": lib_ms, "max_abs_err": err}
            log(f"  isa_core f32, {NW} windows of {T} x {dim}, head width {hd}, a launch: kernel "
                f"{ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
                f"({'bytes' if t_bytes >= t_ops else 'f32 operations'}, {max(t_bytes, t_ops) / ms:.0%} "
                f"of it; operations {t_ops:.4f}), SDPA f32 without the DAL gate {lib_ms:.4f} ms, max "
                f"abs err {err:.2e}")

    def _hrnet_widths(self, tm, ti) -> None:
        """HRNetFusion at hrnetv2_w18, w40 and w48 with fused_mlp and fused_attn (K5 at hid
        72 / 160 / 192, K6 at head widths 9 / 20 / 24), f32 as JAX builds it, 8 x 512²,
        calmed as phase 8 calms its model: probabilities against both flags off (cuDNN
        f32 convolutions, the plain attention core) at HRNET_F32_TOL; K5 8 + 8 and K6 8
        launches a forward."""
        torch = self.torch
        from representationlearning_tpu_torch.models.rssformer import HRNetFusion

        self.hrnet_f32 = {}
        for w in (18, 40, 48):
            gen = torch.Generator().manual_seed(self.seed + 40 + w)
            model = HRNetFusion(f"hrnetv2_w{w}", RSS_CLASSES, fused_mlp=True, fused_attn=True,
                                generator=gen).eval()
            calm(torch, model, gen)
            x = torch.randn(BATCH, 3, IMAGE, IMAGE, generator=gen).to(self.dev)

            def forward(flags):
                set_rss_flags(model, *flags)
                tm.reset_launches()
                ti.reset_launches()
                with torch.no_grad():
                    out = model(x)
                torch.cuda.synchronize()
                return out, {**tm.LAUNCHES, **ti.LAUNCHES}

            prob, counts = forward((True, True))
            want = {"mlp_fc1": RSS_BLOCKS, "mlp_taps": RSS_BLOCKS, "isa_core": RSS_BLOCKS}
            plain, none = forward((False, False))
            err = (prob - plain).abs().max().item()
            self.check(counts == want and not any(none.values())
                       and bool(torch.isfinite(prob).all()) and prob.std().item() > 0.01
                       and err <= HRNET_F32_TOL,
                       f"HRNetFusion(hrnetv2_w{w}, f32) at {BATCH} x {IMAGE}², K5 + K6 against "
                       f"both flags off: launches {counts}, max abs err of the probabilities "
                       f"{err:.3e} (tol {HRNET_F32_TOL:.0e}), spread {prob.std().item():.3f}")
            self.launches_hrnet_f32 = counts
            del prob, plain
            ms = [self.time_ms(lambda: forward((True, True)), iters=3),
                  self.time_ms(lambda: forward((False, False)), iters=3)]
            self.hrnet_f32[f"w{w}"] = {"kernels_ms": ms[0], "plain_ms": ms[1], "max_abs_err": err}
            log(f"  HRNetFusion(hrnetv2_w{w}, f32) forward of {BATCH} x {IMAGE}²: K5 + K6 "
                f"{ms[0]:.2f} ms, both flags off {ms[1]:.2f} ms (CUDA events, the launch counts "
                f"reset inside)")
            del model, x

    # ------------------------------------------------------------- phase 9 (bench)
    def run_bench(self) -> None:
        """The port's bench entry point (``representationlearning_tpu_torch/bench.py``):
        its seven workloads measured in this process at a short loop, each line
        checked and its kernels' launches held to the counts of phases 4, 7a, 7b and 7c;
        then the headline through the module's own command line, in a process of its
        own."""
        torch = self.torch
        from representationlearning_tpu_torch import bench as tb

        log(f"== bench: {PKG}.bench, the {len(tb.PORTED)} ported workloads in this process "
            "(iters 2, reps 1)")
        t0 = time.perf_counter()
        n_sr = sum(DEPTH for _, _, _, sr, _ in STAGES if sr > 1)
        k1 = {"ln_stats": 2 * 8 + n_sr, "linear": 5 * 8, "sr_conv": n_sr, "attention": 8,
              "dwconv_gelu": 8}   # a headline forward, as phase 4 counts it
        n_fwd = 2 * len(RML_SCALES)   # the RML step's CAM forwards, as phase 7a counts them
        zero = {g: dict.fromkeys(mod.LAUNCHES, 0) for g, mod in tb.KERNEL_GROUPS.items()}

        def want(**groups):
            return {g: {**zero[g], **groups.get(g, {})} for g in zero}

        expect = {
            "segformer_b1": want(K1=k1),
            "rml_train": want(K1={k: n_fwd * v for k, v in k1.items()}, K2={"affinity": 1},
                              K3={"varm_propagate": VARM_ITERS}),
            "rssformer_predict": want(K5={"mlp_fc1": RSS_BLOCKS, "mlp_taps": RSS_BLOCKS}),
            "scd_pseudo_labels": want(), "rssformer_tta_eval": want(), "rssformer_train": want(),
            "wavecam_cams": want()}
        held = {"segformer_b1": {k: self.launches.get(k) for k in k1},   # phase 4
                "rml_train": self.launches_rml,                            # phase 7a
                "rssformer_predict": {k: self.launches.get(k) for k in ("mlp_fc1", "mlp_taps")},
                "rssformer_train": self.launches_rss_step}                 # phase 7c

        def launched(groups):
            return {g: nz for g, c in groups.items()
                    if (nz := {k: v for k, v in c.items() if v})} or "none"

        for name in tb.PORTED:
            rec = tb.measure(name, iters=2, reps=1)
            log(json.dumps(rec))
            value = rec["value"]
            self.check(value == value and 0 < value < float("inf") and rec["unit"] != "error",
                       f"{name}: {value:.2f} {rec['unit']}, finite and positive")
            self.check(0.0 <= rec["idle_share"] < 1.0 and rec["launches_per_call"] > 0
                       and rec["peak_mem_gib"] > 0 and rec["flops_per_example_g"] > 0,
                       f"{name}: idle share {rec['idle_share']:.4f} in [0, 1), "
                       f"{rec['launches_per_call']:.0f} launches a call, peak "
                       f"{rec['peak_mem_gib']:.2f} GiB, {rec['flops_per_example_g']:.2f} GFLOP an "
                       "example")
            self.check(rec["kernels"] == expect[name],
                       f"{name}: hand-written kernels a call {launched(rec['kernels'])} "
                       f"(expected {launched(expect[name])})")
            if name in held:
                phase = {k: v for k, v in held[name].items() if v is not None}
                flat = {k: v for c in rec["kernels"].values() for k, v in c.items()}
                self.check(bool(phase) and all(flat[k] == v for k, v in phase.items()),
                           f"{name}: the same counts as the earlier phase's path "
                           f"({phase or 'that phase counted nothing'})")
            torch.cuda.empty_cache()
        log(f"  in-process measurements: {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", f"{PKG}.bench", "--one", "segformer_b1"]
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        lines = r.stdout.strip().splitlines()
        try:
            last = json.loads(lines[-1])
        except (IndexError, ValueError):
            last = {}
        head = tb.BENCHES["segformer_b1"]
        self.check(r.returncode == 0 and last.get("metric") == head.metric
                   and last.get("unit") == head.unit and last.get("value", 0) > 0
                   and last.get("kernels") == expect["segformer_b1"],
                   f"`{' '.join(cmd[1:])}`: exit {r.returncode}, its last line the headline's "
                   f"record ({last.get('value', 0):.2f} {last.get('unit')}), "
                   f"{time.perf_counter() - t0:.1f} s")
        if r.returncode != 0:
            log(r.stderr[-3000:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only",
              file=sys.stderr)
        return 1
    if not (ROOT / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/ not found beside {Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from representationlearning_tpu_torch.ops import _build
    from representationlearning_tpu_torch.ops import affinity as ta
    from representationlearning_tpu_torch.ops import attention as tf
    from representationlearning_tpu_torch.ops import isa_attention as ti
    from representationlearning_tpu_torch.ops import mit_block as tmb
    from representationlearning_tpu_torch.ops import mlp_dwbn as tm
    from representationlearning_tpu_torch.ops import varm as tv

    ph = Phases(torch, args.seed)
    torch.manual_seed(args.seed)
    try:
        card = ph.environment(_build.find_nvcc())
        ph.build(_build)
    except Exception:  # noqa: BLE001 -- nothing else can run without the kernels
        traceback.print_exc()
        return 1
    state = {}  # what a phase hands to the later ones

    def slice_():
        state["model"], state["blocks"], state["x"] = ph.run_slice(tmb)

    def pseudo():
        state["twin"], state["twin_blocks"], state["args"] = ph.run_pseudo_labels(
            tmb, ta, tv, state["model"], state["blocks"])

    def train():
        state["trainer"], state["plain_trainer"], state["batch"] = ph.run_train_steps(
            tmb, ta, tv, tf)

    def rml():
        state["rml"], state["rml_plain"], state["rml_batch"] = ph.run_rml_steps(
            (tmb, ta, tv, tf, tm, ti))

    def rss():
        state["rss_model"], state["rss_x"] = ph.run_rssformer(tm, ti)

    def rss_train():
        ph.run_rss_train((tmb, ta, tv, tf, tm, ti))

    def timing():
        log(f"== timing of K2 / K3 (CUDA graph replay, {card})")
        ph.time_refine_kernels(ta, tv)
        ph.timing(state["model"], state["blocks"], state["x"], card)
        ph.timing_pseudo(state["twin"], state["twin_blocks"], state["args"], card)
        ph.timing_train(state["trainer"], state["plain_trainer"], state["batch"], card)
        ph.timing_rml(state["rml"], state["rml_plain"], state["rml_batch"], card)
        ph.timing_presr(state["model"], state["blocks"], state["x"], card)
        ph.timing_rss(tm, ti, state["rss_model"], state["rss_x"], card)

    for name, fn in (("kernel vs plain", lambda: ph.kernels_vs_plain(tmb)),
                     ("K2 / K3 vs plain", lambda: ph.refine_kernels_vs_plain(ta, tv)),
                     ("slice", slice_), ("pseudo labels", pseudo),
                     ("K4 vs plain", lambda: ph.flash_vs_plain(tf)),
                     ("K4 in the model", lambda: ph.flash_model(tf)),
                     ("train step", train),
                     ("RML train step", rml),
                     ("K5 vs plain", lambda: ph.mlp_vs_plain(tm)),
                     ("K6 vs plain", lambda: ph.isa_vs_plain(ti)),
                     ("K1' vs plain", lambda: ph.presr_vs_plain(tmb)),
                     ("f32 and K5 widths (7l)",
                      lambda: ph.run_f32((tmb, ta, tv, tf, tm, ti), card)),
                     ("RSSFormer predict", rss),
                     ("RSSFormer train step", rss_train),
                     ("WaveCAM", ph.run_wavecam),
                     ("DRFL", lambda: ph.run_drfl(card)),
                     ("WSSS command lines",
                      lambda: ph.run_wsss_cli((tmb, ta, tv, tf, tm, ti), card)),
                     ("RSSFormer command line",
                      lambda: ph.run_rss_cli((tmb, ta, tv, tf, tm, ti), card)),
                     ("WaveCAM command line", lambda: ph.run_wavecam_train(card)),
                     ("HRFormer, ASFF, converter",
                      lambda: ph.run_hrt((tmb, ta, tv, tf, tm, ti), card)),
                     ("baseline zoo", lambda: ph.run_zoo((tmb, ta, tv, tf, tm, ti), card)),
                     ("multi-device", lambda: ph.run_dp((tmb, ta, tv, tf, tm, ti), card)),
                     ("K1' in the model", lambda: ph.run_presr(tmb, state["model"],
                                                              state["blocks"], state["x"])),
                     ("timing", timing),
                     ("bench", ph.run_bench)):
        try:
            fn()
        except Exception:  # noqa: BLE001 -- report the phase, go on with the next
            traceback.print_exc()
            ph.failures.append(f"phase {name} raised")
        torch.cuda.empty_cache()
    for k in ("flash_fwd", "flash_bwd"):  # K4's own path is the train step
        ph.launches[k] = ph.launches_train.get(k, 0)
    missing = [k for k in KERNELS if ph.launches.get(k, 0) == 0]
    missing += [f"{k} (pseudo-label call)" for k in PIECE_TOL
                if ph.launches_pseudo.get(k, 0) == 0]
    missing += [f"{k} (train step)" for k in TRAIN_KERNELS
                if ph.launches_train.get(k, 0) == 0]
    missing += [f"{k} (RML train step)" for k in RML_KERNELS
                if ph.launches_rml.get(k, 0) == 0]
    missing += [f"{k} (RSSFormer train step, fused_attn)" for k in ("isa_core",)
                if ph.launches_rss_train.get(k, 0) == 0]
    missing += [f"{k} (RSSFormer evaluate)" for k in ("mlp_fc1", "mlp_taps")
                if ph.launches_rss_eval.get(k, 0) == 0]
    missing += [f"{k} (SCD command line)" for k in RML_KERNELS
                if ph.launches_wsss.get(k, 0) == 0]
    missing += [f"{k} (RSSFormer command line, {cmd})" for k in ("mlp_fc1", "mlp_taps")
                for cmd in ("eval_tta", "predict")
                if ph.launches_rss_cli.get(cmd, {}).get(k, 0) == 0]
    missing += [f"{k} (WeTrBaseline forward)" for k in PIECE_TOL
                if ph.launches_wetr.get(k, 0) == 0]
    missing += [f"{k} (f32 TSCD forward)" for k in PIECE_TOL
                if ph.launches_f32.get(k, 0) == 0]
    missing += [f"{k} (f32 HRNetFusion forward, w48)" for k in ("mlp_fc1", "mlp_taps", "isa_core")
                if ph.launches_hrnet_f32.get(k, 0) == 0]
    missing += [f"{k} (data-parallel SCD step, a rank)" for k in RML_KERNELS
                if ph.launches_dp.get("scd_step", {}).get(k, 0) == 0]
    missing += [f"{k} (sharded sliding window, a rank)" for k in ("mlp_fc1", "mlp_taps", "isa_core")
                if ph.launches_dp.get("sliding", {}).get(k, 0) == 0]
    if missing:
        ph.failures.append(f"kernels never launched on their path: {missing}")
    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    if leaked:
        ph.failures.append(f"jax was imported: {leaked[:5]}")
    if ph.failures:
        log(f"FAILED: {len(ph.failures)} check(s)")
        for f in ph.failures:
            log(f"  - {f}")
        return 1
    kernels = []
    for k, (source, replaces) in KERNELS.items():
        by_bytes, by_ops = ph.piece_bound[k]
        entry = {"name": k, "route": "cuda", "source": f"{PKG}/csrc/{source}",
                 "replaces": replaces, "launches": ph.launches[k],
                 "max_abs_err": ph.piece_err[k], "ms": ph.piece_ms[k],
                 "plain_ms": ph.piece_plain_ms[k], "bound_ms": by_bytes + by_ops,
                 "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                 "library_ms": ph.piece_library_ms[k]}
        if k in ph.launches_pseudo:
            entry["launches_pseudo_label"] = ph.launches_pseudo[k]
        if k in ph.launches_train:
            entry["launches_train_step"] = ph.launches_train[k]
        if k in RML_KERNELS:
            entry["launches_rml_train_step"] = ph.launches_rml[k]
        if k in PIECE_TOL:
            entry["launches_wetr_baseline_forward"] = ph.launches_wetr[k]
        if k in RML_KERNELS:
            entry["launches_dp_scd_step_a_rank"] = ph.launches_dp["scd_step"][k]
        if k in ("mlp_fc1", "mlp_taps", "isa_core"):
            entry["launches_dp_sliding_window_a_rank"] = ph.launches_dp["sliding"][k]
        if k == "isa_core":
            entry["launches_rssformer_train_step"] = ph.launches_rss_train[k]
        if k in ("mlp_fc1", "mlp_taps"):
            entry["launches_rssformer_evaluate"] = ph.launches_rss_eval[k]
            entry["launches_rssformer_cli_eval_tta"] = ph.launches_rss_cli["eval_tta"][k]
            entry["launches_rssformer_cli_predict"] = ph.launches_rss_cli["predict"][k]
        if k == "dwconv_gelu":   # the library call on bf16, beside the f32 one
            entry["library_ms_bf16"] = ph.dwconv_library_bf16_ms
        if k == "mlp_taps":  # the block as one function, and the module K5 stands in for
            entry["max_abs_err_whole_block"] = ph.piece_err["mlp_whole"]
            entry["unfused_module_ms"] = ph.unfused_mlp_ms
        if k == "isa_core":
            entry["max_abs_err_f32"] = ph.piece_err["isa_core_f32"]
            entry["ms_f32"] = ph.isa_f32_ms
            entry["f32_hrnet_widths"] = ph.k6_f32
        if k == "mit_block_presr":
            entry["library_front_ms"] = ph.presr_front_ms
            entry["library_front_graph_ms"] = ph.front_graph_ms["library"]
            entry["k1_front_graph_ms"] = ph.front_graph_ms["k1"]
        if k == "flash_bwd":  # the bound as f32 multiply-adds beside the 3xTF32 one
            entry["bound_ms_f32_fma"] = ph.flash_bwd_fma_bound
            entry["workspace_bytes_a_launch"] = ph.flash_bwd_workspace
        if k == "flash_fwd":  # both directions, at its looser tolerance
            entry["max_abs_err_bf16"] = ph.piece_err["flash_bf16"]
            entry["bound_ms_f32_fma"] = ph.flash_fwd_fma_bound
            entry["ms_512_forward"] = ph.flash_eval_ms[""]
            entry["library_ms_512_forward"] = ph.flash_eval_ms["library"]
        entry["timed_by"] = ("CUDA events around a loop" if k == "mit_block_presr"
                             else "CUDA graph replay (kernel and library call)")
        if k == "attention":  # the library call covers the launches that export nothing
            for which, part in ph.attn_split.items():
                entry.update({f"{key}_{which}": part[key] or None
                              for key in ("launches", "ms", "bound_ms", "library_ms")})
        if k in ph.library_covers:
            entry["library_covers"] = ph.library_covers[k]
        if k in ph.f32:   # phase 7l: the same work with f32 operands (3xTF32 products)
            e = ph.f32[k]
            entry.update({"ms_f32": e["ms"], "bound_ms_f32": sum(e["bound"]),
                          "bound_by_f32": "bytes" if e["bound"][0] >= e["bound"][1] else "operations",
                          "library_ms_f32": e["lib"], "max_abs_err_f32": e["err"]})
            if k in PIECE_TOL:
                entry["launches_f32_tscd_forward"] = ph.launches_f32[k]
        if k in ("mlp_fc1", "mlp_taps"):   # a launch at 8 x 128², each HRNetV2 width
            piece = k.removeprefix("mlp_")
            entry["widths"] = {w: {key.removeprefix(piece + "_"): v for key, v in fig.items()
                                   if key.startswith(piece + "_")}
                               for w, fig in ph.k5_widths.items()}
            entry["launches_f32_hrnet_forward"] = ph.launches_hrnet_f32[k]
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
