#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's main path, TSCD / MiT-B1 segmentation inference at 512 x 512,
batch 8, bf16 compute and a bf16 residual stream, with every encoder block on
kernel K1 (``representationlearning_tpu_torch/ops/mit_block.py``), and checks it:

1. environment: torch, CUDA, nvcc, the card and its power limit;
2. build: compiles the CUDA sources under ``representationlearning_tpu_torch/csrc``;
3. kernel vs plain: each K1 kernel, and the whole block, against its plain
   PyTorch version on the same inputs, at the four MiT-B1 stage geometries;
4. slice: the model's forward through the kernels, its output shapes, the
   launch counts of every kernel, and seg / attn_pred against the same model run
   with the plain block; one ``cam_only`` forward;
5. timing: CUDA-event times of each kernel and of the whole forward, kernel
   path against plain path.

Run from the root of the repository: ``python3 chip_smoke.py [--seed N]``. Every
phase prints its results; the line before the last is a JSON object with one
entry per kernel, and the last line is ``{"ok": true, ...}``. Without a CUDA
card, or without the package beside the script, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
PKG = "representationlearning_tpu_torch"
BATCH, IMAGE, NUM_CLASSES = 8, 512, 21
# (tokens per side, C, heads, sr, export) of the MiT-B1 blocks at 512 x 512
STAGES = [(128, 64, 1, 8, False), (64, 128, 2, 4, False), (32, 320, 5, 2, False),
          (32, 512, 8, 1, True)]
DEPTH = 2  # MiT-B1 blocks per stage
REPLACES = "representationlearning_tpu/ops/pallas/mit_block.py:259"
SOURCES = {"ln_stats": "ln_stats.cu", "linear": "gemm.cu", "sr_conv": "gemm.cu",
           "attention": "attention.cu", "dwconv_gelu": "dwconv_gelu.cu"}

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
# The raw logits: f32 sums of hd = 64 exact bf16 products in another order.
LOGIT_TOL = 1e-4
# Whole block and whole model, kernel path against plain path: each side rounds
# its own f32 intermediates to bf16 operands, so where the two f32 sums fall on
# either side of a bf16 rounding boundary the results move by one bf16 spacing
# (2^-8 relative) and that propagates; the block output is stored in bf16.
# 2e-2 of the largest magnitude is about five bf16 spacings (the bound of the
# port's bf16 CPU parity test against the JAX package).
PATH_TOL = 2e-2


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


def use_plain(blocks, tmb, plain: bool) -> None:
    """Swap the FusedBlocks' K1 for its plain version, or back to the kernels."""
    for b in blocks:
        if plain:
            b.block_fn = tmb.fused_block_reference
        else:
            vars(b).pop("block_fn", None)  # back to the class attribute


class Phases:
    def __init__(self, torch, seed: int):
        self.torch = torch
        self.seed = seed
        self.dev = torch.device("cuda", 0)
        self.failures: list[str] = []
        self.piece_err: dict[str, float] = {}
        self.piece_ms: dict[str, float] = {}
        self.piece_plain_ms: dict[str, float] = {}
        self.launches: dict[str, int] = {}

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
        _build.load_library("mit_block")
        info = _build.build_log["mit_block"]
        log(f"  mit_block: {time.perf_counter() - t0:.1f} s -> {info['path']}")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
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

    def kernels_vs_plain(self, tmb) -> None:
        """Each piece of K1 against its plain version on the inputs the kernel
        path gives it, then the whole block, at every stage geometry."""
        torch = self.torch
        log("== kernel vs plain (same inputs), B = 8, bf16 compute")
        gen = torch.Generator().manual_seed(self.seed)
        names = list(PIECE_TOL)
        for k in names:
            self.piece_err[k] = 0.0
            self.piece_ms[k] = self.piece_plain_ms[k] = 0.0
        for hw, C, nh, sr, export in STAGES:
            N = hw * hw
            x = torch.randn(BATCH, N, C, generator=gen).to(self.dev, torch.bfloat16)
            p = self._block_params(C, nh, sr, export, gen)
            calls: list[tuple[str, tuple, dict]] = []

            def recording(name):
                def run(*a, **kw):
                    got = getattr(tmb, name)(*a, **kw)
                    want = getattr(tmb, name + "_reference")(*a, **kw)
                    got_t = got if isinstance(got, tuple) else (got,)
                    want_t = want if isinstance(want, tuple) else (want,)
                    for i, (g, w) in enumerate(zip(got_t, want_t)):
                        if g is None and w is None:
                            continue
                        err, mag = max_err(g, w)
                        tol = (LOGIT_TOL if i == 1 else PIECE_TOL[name]) * max(1.0, mag)
                        what = f"{name}{' logits' if i == 1 else ''} @ N={N} C={C} " \
                               f"shape {tuple(g.shape)}"
                        self.check(err <= tol, f"{what}: max abs err {err:.3e} "
                                               f"(max |plain| {mag:.3e}, tol {tol:.3e})")
                        self.piece_err[name] = max(self.piece_err[name], err)
                    calls.append((name, a, kw))
                    return got
                return run

            ops = SimpleNamespace(**{n: recording(n) for n in names})
            with torch.no_grad():
                res = tmb._block(x, p, H=hw, W=hw, sr=sr, nh=nh, dtype=torch.bfloat16,
                                 export=export, ops=ops)
                torch.cuda.synchronize()
                got = tmb.fused_block(x, p, H=hw, W=hw, sr=sr, nh=nh, dtype=torch.bfloat16,
                                      export=export)
                want = tmb.fused_block_reference(x, p, H=hw, W=hw, sr=sr, nh=nh,
                                                 dtype=torch.bfloat16, export=export)
                torch.cuda.synchronize()
            got_t = got if export else (got,)
            want_t = want if export else (want,)
            same = all(torch.equal(a, b) for a, b in zip(res if export else (res,), got_t))
            self.check(same, f"block @ N={N} C={C}: fused_block = the recorded kernel sequence")
            for i, (g, w) in enumerate(zip(got_t, want_t)):
                err, mag = max_err(g, w)
                rel = ((g.float() - w.float()).norm() / w.float().norm()).item()
                tol = PATH_TOL * mag
                self.check(bool(torch.isfinite(g.float()).all()) and err <= tol,
                           f"whole block{' logits' if i else ''} @ N={N} C={C} nh={nh} "
                           f"sr={sr}: max abs err {err:.3e} (max |plain| {mag:.3e}, "
                           f"tol {tol:.3e}), rel L2 {rel:.2e}")
            # device time of every piece over its calls in one block, x DEPTH blocks
            for name, a, kw in calls:
                k_ms = self.time_ms(lambda: getattr(tmb, name)(*a, **kw), iters=10)
                p_ms = self.time_ms(lambda: getattr(tmb, name + "_reference")(*a, **kw),
                                    iters=10)
                self.piece_ms[name] += DEPTH * k_ms
                self.piece_plain_ms[name] += DEPTH * p_ms
            with torch.no_grad():
                blk_ms = self.time_ms(lambda: tmb.fused_block(
                    x, p, H=hw, W=hw, sr=sr, nh=nh, dtype=torch.bfloat16, export=export),
                    iters=10)
                plain_ms = self.time_ms(lambda: tmb.fused_block_reference(
                    x, p, H=hw, W=hw, sr=sr, nh=nh, dtype=torch.bfloat16, export=export),
                    iters=10)
            log(f"  K1 block @ stage N={N} C={C}: kernels {blk_ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms per block")
            del calls, res, got, want

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
                     generator=gen).eval().to(self.dev)
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

        use_plain(blocks, tmb, True)
        tmb.reset_launches()
        with torch.no_grad():
            p_cls, p_seg, _, p_pred = model(x)
        torch.cuda.synchronize()
        self.check(sum(tmb.LAUNCHES.values()) == 0, "plain path launched no kernel")
        for k, g, w in (("cls", cls, p_cls), ("seg", seg, p_seg), ("attn_pred", pred, p_pred)):
            err, mag = max_err(g, w)
            rel = ((g.float() - w.float()).norm() / w.float().norm()).item()
            self.check(err <= PATH_TOL * mag,
                       f"{k}: kernel path vs plain path max abs err {err:.3e} "
                       f"(max |plain| {mag:.3e}, tol {PATH_TOL * mag:.3e}), rel L2 {rel:.2e}")
        use_plain(blocks, tmb, False)
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
    def timing(self, tmb, model, blocks, x, card: str) -> None:
        torch = self.torch
        log(f"== timing (CUDA events, {card})")

        def forward():
            with torch.no_grad():
                model(x)

        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            use_plain(blocks, tmb, which == "plain")
            times[which].append(self.time_ms(forward, iters=5))
        use_plain(blocks, tmb, False)
        for which, ts in times.items():
            ms = min(ts)
            log(f"  forward, {which} path: {', '.join(f'{t:.2f}' for t in ts)} ms per batch "
                f"of {BATCH} -> {BATCH * 1000.0 / ms:.1f} tiles/s (best run)")
        torch.cuda.reset_peak_memory_stats()
        forward()
        log(f"  peak device memory, kernel path: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for k in PIECE_TOL:
            log(f"  {k}: {self.piece_ms[k]:.3f} ms per forward (plain "
                f"{self.piece_plain_ms[k]:.3f} ms)")


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
    from representationlearning_tpu_torch.ops import mit_block as tmb

    ph = Phases(torch, args.seed)
    torch.manual_seed(args.seed)
    try:
        card = ph.environment(_build.find_nvcc())
        ph.build(_build)
    except Exception:  # noqa: BLE001 -- nothing else can run without the kernels
        traceback.print_exc()
        return 1
    state = None  # (model, its FusedBlocks, input) once the slice ran
    for name, fn in (("kernel vs plain", lambda: ph.kernels_vs_plain(tmb)),
                     ("slice", lambda: ph.run_slice(tmb))):
        try:
            state = fn() or state
        except Exception:  # noqa: BLE001 -- report the phase, go on with the next
            traceback.print_exc()
            ph.failures.append(f"phase {name} raised")
        torch.cuda.empty_cache()
    if state is not None:
        try:
            ph.timing(tmb, *state, card)
        except Exception:  # noqa: BLE001
            traceback.print_exc()
            ph.failures.append("phase timing raised")
    missing = [k for k in PIECE_TOL if ph.launches.get(k, 0) == 0]
    if missing:
        ph.failures.append(f"kernels never launched on the main path: {missing}")
    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    if leaked:
        ph.failures.append(f"jax was imported: {leaked[:5]}")
    if ph.failures:
        log(f"FAILED: {len(ph.failures)} check(s)")
        for f in ph.failures:
            log(f"  - {f}")
        return 1
    kernels = [{"name": k, "route": "cuda",
                "source": f"{PKG}/csrc/mit_block/{SOURCES[k]}", "replaces": REPLACES,
                "launches": ph.launches[k], "max_abs_err": ph.piece_err[k],
                "ms": ph.piece_ms[k], "plain_ms": ph.piece_plain_ms[k]} for k in PIECE_TOL]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
