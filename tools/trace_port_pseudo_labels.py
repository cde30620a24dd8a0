"""Device trace of the PyTorch port's pseudo-label call on one CUDA card.

Builds the same model and batch as ``chip_smoke.py`` (``scd_pseudo_labels`` at
8 x 320 x 320, ``configs/scd_voc.yaml``), traces a few back-to-back calls with
``torch.profiler`` and prints: the card and its power limit, the window's
length per call, the share of it in which no kernel ran (the device's idle
share), the kernel launches per call, and the kernels that take most of the
device time. With ``--out DIR`` it also writes a Chrome trace there.

Usage, from the root of the repository: ``python tools/trace_port_pseudo_labels.py
[--seed N] [--calls N] [--out DIR]``. It needs a CUDA card and imports no JAX.
"""
import argparse
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device: this script traces the card only", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from representationlearning_tpu_torch.models.tscd import TSCD
    from representationlearning_tpu_torch.train import scd as ts

    print(cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    gen = torch.Generator().manual_seed(args.seed + 2)
    twin = TSCD("mit_b1", cs.NUM_CLASSES, dtype=torch.bfloat16, fused_blocks=True,
                act_dtype=torch.bfloat16, collect_attns="none", generator=gen).eval()
    x, cls, box = cs.pseudo_batch(torch, gen, torch.device("cuda", 0))
    cfg = ts.SCDConfig(num_classes=cs.NUM_CLASSES, crop_size=cs.CROP,
                       cam_scales=cs.CAM_SCALES, varm_dilations=cs.DILATIONS,
                       varm_iters=cs.VARM_ITERS, max_present=cs.MAX_PRESENT)
    attn_mask = ts._attn_mask(cfg)

    def call():
        return ts.scd_pseudo_labels(twin, x, cls, box, cfg, attn_mask=attn_mask)

    for _ in range(2):  # builds the kernels, warms the allocator
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.calls):
            call()
        torch.cuda.synchronize()

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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
    n = args.calls
    print(f"window {window / n / 1e3:.3f} ms per call over {n} calls; device busy "
          f"{busy / n / 1e3:.3f} ms per call; idle share {100.0 * (1.0 - busy / window):.2f}%; "
          f"{len(kernels) / n:.0f} kernel launches per call")
    own = ("k1::", "refine::")  # the hand-written kernels, wherever they rank
    for i, (name, (us, count)) in enumerate(sorted(by_name.items(), key=lambda kv: -kv[1][0])):
        if i < 14 or any(tag in name for tag in own):
            print(f"  {us / n / 1e3:8.3f} ms  {count / n:6.0f} launches  {name[:100]}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, "pseudo_labels_trace.json")
        prof.export_chrome_trace(path)
        print(f"chrome trace: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
