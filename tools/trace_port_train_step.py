"""Device trace of the PyTorch port's SCD train step, or of its RML, RSSFormer or
DRFL train step, on one CUDA card.

Builds the same trainer and batch as ``chip_smoke.py`` (``make_scd_train_step`` at
8 x 320 x 320, ``configs/scd_voc.yaml`` with flash attention on: the f32
``TSCD("mit_b1", use_flash=True)``, its bf16 fused CAM twin, AdamW; with ``--rml``
``make_rml_train_step`` at ``bench.py::bench_rml_train``'s configuration: 16 raw
512 x 512 canvases augmented on the card to 320 x 320, ``RMLModel("mit_b1",
dtype=bf16)`` and its bf16 fused twin, PAR; with ``--rssformer``
``make_rssformer_train_step`` at ``bench.py::bench_rssformer_train``'s configuration:
``HRNetFusion("hrnetv2_w32", 7, dtype=bf16)``, 8 x 512 x 512, SGD; with ``--drfl B``
``make_drfl_train_step`` at ``chip_smoke.py`` phase 7e's configuration: the f32
``Softnet(3, 12)`` at 256², batch B of the synthetic source, Adam; with ``--cli scd``
or ``--cli rml`` the step that ``cli/train_scd.py`` or ``cli/train_rml.py`` builds from
``configs/scd_voc.yaml`` or ``configs/rml_voc.yaml`` with ``dataset.device_augment=true``
and no warm-up, taken on its last batch after two steps of the command line, as
``chip_smoke.py`` phase 7f takes it: batch 2, the f32 model, its bf16 twins) and prints:

- the card and its power limit;
- the step's time by CUDA events, mean over a few steps without the profiler;
- from a ``torch.profiler`` trace of a few back-to-back steps: the window's
  length per step, the share of it in which no kernel ran (the device's idle
  share, under the profiler and against the step timed without it), the kernel
  launches per step, the kernels that take most of the device time, and every
  hand-written kernel;
- the device time and the launches of each stage that ``scd_losses`` and the
  step function name as profiler ranges (augment, main_forward, pseudo_labels,
  small_forward, small_cams, losses, energy_loss, forward, backward, optimizer): every
  kernel counts for the range in which the host launched it, so the slower
  host under the profiler does not stretch a stage.

With ``--out DIR`` the Chrome trace is kept there. Usage, from the root of
the repository: ``python tools/trace_port_train_step.py [--rml | --rssformer | --drfl B |
--cli scd|rml] [--seed N] [--steps N] [--out DIR]``. It needs a CUDA card and imports no JAX.
"""
import argparse
import json
import os
import sys
import tempfile
from collections import defaultdict
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


STAGES = ("augment", "main_forward", "pseudo_labels", "small_forward", "small_cams", "losses",
          "energy_loss", "forward", "backward", "optimizer")


def stage_report(trace: list[dict], n: int, total: float) -> None:
    """Device time and launches by stage from a Chrome trace of ``n`` steps: a
    kernel, copy or fill counts for the stage range that holds the host's launch
    call of the same correlation id."""
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in trace
                    if e.get("cat") == "user_annotation" and e.get("name") in STAGES)
    launched = {e["args"]["correlation"]: e["ts"] for e in trace
                if e.get("cat", "").startswith("cuda_")  # the host's launch calls
                and "correlation" in e.get("args", {})}
    by_stage = {name: [0.0, 0] for name in STAGES}
    between = [0.0, 0]
    for e in trace:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        at = launched.get(e["args"].get("correlation"))
        slot = between
        if at is not None:
            slot = next((by_stage[name] for lo, hi, name in ranges if lo <= at <= hi), between)
        slot[0] += e["dur"]
        slot[1] += 1
    busy = sum(us for us, _ in by_stage.values()) + between[0]
    print(f"device time by stage (trace, per step; {busy / n / 1e3:.3f} ms of kernels, copies "
          f"and fills in the {total:.3f} ms step):")
    for name, (us, count) in list(by_stage.items()) + [("between the stages", between)]:
        print(f"  {us / n / 1e3:8.3f} ms  {100.0 * us / busy:5.1f}%  {count / n:6.0f} launches  "
              f"{name}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rml", action="store_true", help="the RML train step")
    ap.add_argument("--rssformer", action="store_true", help="the RSSFormer train step")
    ap.add_argument("--drfl", type=int, default=None, metavar="B",
                    help="the DRFL train step at batch B")
    ap.add_argument("--cli", choices=("scd", "rml"), default=None,
                    help="the step of cli/train_scd.py or cli/train_rml.py (phase 7f)")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device: this script traces the card only", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from representationlearning_tpu_torch.train import scd as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    ph = cs.Phases(torch, args.seed)
    if args.rml:
        gen = torch.Generator().manual_seed(args.seed + 7)
        batch, size = cs.rml_batch(torch, gen, ph.dev), cs.RML_BATCH
        t, what = ph._rml_trainer(gen), "RML train step"
    elif args.rssformer:
        batch, size = cs.rss_batch(torch, ph.dev), cs.BATCH
        t, what = ph._rss_trainer(), "RSSFormer train step"
    elif args.drfl:
        from representationlearning_tpu_torch.data.medical import DRFLPairedDataset, collate_drfl
        from representationlearning_tpu_torch.models.dcl import Softnet
        from representationlearning_tpu_torch.train import drfl as td

        model = Softnet(3, cs.DRFL_LAYERS, cs.DRFL_SIDE,
                        generator=torch.Generator().manual_seed(args.seed + 9), device=ph.dev)
        ds = DRFLPairedDataset(crop_size=cs.DRFL_SIDE, synthetic_size=cs.DRFL_SIDE,
                               synthetic_n=args.drfl)
        batch, size = collate_drfl([ds[i] for i in range(args.drfl)]), args.drfl
        t = SimpleNamespace(step=td.make_drfl_train_step(model),
                            state=td.create_drfl_state(model, td.DRFLConfig(), 1))
        what = f"DRFL train step, batch {args.drfl}"
    elif args.cli:
        from representationlearning_tpu_torch.cli import train_rml, train_scd
        from representationlearning_tpu_torch.ops import (affinity, attention, isa_attention,
                                                          mit_block, mlp_dwbn, varm)

        mods = (mit_block, affinity, varm, attention, mlp_dwbn, isa_attention)
        with tempfile.TemporaryDirectory() as tmp:
            rec = ph._cli_run(train_scd if args.cli == "scd" else train_rml, [
                "--config", f"configs/{args.cli}_voc.yaml", "dataset.device_augment=true",
                "train.max_iters=2", "train.cam_iters=-1", "train.eval_iters=1000",
                f"work_dir.dir={tmp}" if args.cli == "scd" else f"work_dir={tmp}"],
                mods, f"make_{args.cli}_train_step")
        step, state, batch = rec.last
        t, size = SimpleNamespace(step=step, state=state), len(batch["cls_label"])
        what = f"cli/train_{args.cli}.py's train step, batch {size}"
    else:
        gen = torch.Generator().manual_seed(args.seed + 5)
        x, cls, box = cs.pseudo_batch(torch, gen, ph.dev)
        batch, size = {"image": x, "cls_label": cls, "img_box": box}, cs.BATCH
        t, what = ph._trainer(gen, use_flash=True), "train step"

    def run(i):
        t.step(t.state, batch, torch.Generator().manual_seed(args.seed + i))

    for i in range(2):  # builds the kernels, warms the allocator and cuDNN
        run(i)
    torch.cuda.synchronize()
    whole = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    whole[0].record()
    for i in range(args.steps):
        run(i)
    whole[1].record()
    torch.cuda.synchronize()
    total = whole[0].elapsed_time(whole[1]) / args.steps
    print(f"{what} without the profiler (CUDA events, mean of {args.steps}): "
          f"{total:.3f} ms, {size * 1000.0 / total:.1f} images/s")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(args.steps):
            run(i)
        torch.cuda.synchronize()

    # device events without the ranges PyTorch marks itself (`Optimizer.step#AdamW.step`)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
    if not kernels:
        print("the trace holds no device event", file=sys.stderr)
        return 1
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:  # union of the kernel intervals
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    window = max(b for _, b in spans) - spans[0][0]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    n = args.steps
    print(f"window {window / n / 1e3:.3f} ms per step over {n} steps; device busy "
          f"{busy / n / 1e3:.3f} ms per step; idle share {100.0 * (1.0 - busy / window):.2f}%; "
          f"{len(kernels) / n:.0f} kernel launches per step")
    # tracing some thousands of launches slows the host: against the step as timed
    # above, without the profiler, the same kernels leave this share idle
    print(f"device busy {busy / n / 1e3:.3f} ms of the {total:.3f} ms step timed without the "
          f"profiler: idle share {100.0 * (1.0 - busy / n / 1e3 / total):.2f}%")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    own = ("k1::", "k4::", "refine::")  # the hand-written kernels, wherever they rank
    for i, (name, (us, count)) in enumerate(ranked):
        if i < 24 or any(tag in name for tag in own):
            print(f"  {us / n / 1e3:8.3f} ms  {count / n:6.0f} launches  {name[:100]}")
    with tempfile.TemporaryDirectory() as tmp:
        if args.out:
            os.makedirs(args.out, exist_ok=True)
        prefix = "rml_" if args.rml else "rssformer_" if args.rssformer else \
            f"drfl{args.drfl}_" if args.drfl else f"cli_{args.cli}_" if args.cli else ""
        path = os.path.join(args.out or tmp, prefix + "train_step_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
    if args.out:
        print(f"chrome trace: {path}")
    stage_report(trace, n, total)
    return 0


if __name__ == "__main__":
    sys.exit(main())
