"""Device trace of the PyTorch port's RSSFormer predict forward on one CUDA card.

Builds the same model and batch as ``chip_smoke.py`` (``HRNetFusion("hrnetv2_w32",
7, dtype=bf16)`` at 4 x 3 x 512 x 512, weights from the seed), times the forward
without the profiler (CUDA events), traces a few back-to-back forwards with
``torch.profiler`` and prints: the card and its power limit, the window's length
per forward, the share of it in which no kernel ran (the device's idle share,
also against the untraced time, since the profiler slows the host), the kernel
launches per forward, and the kernels that take most of the device time (and K5's
and K6's, wherever they rank). By
default both ``fused_mlp`` (K5) and ``fused_attn`` (K6) are on; ``--unfused``
traces the cuDNN path. With ``--out DIR`` it also writes a Chrome trace there.

Usage, from the root of the repository: ``python tools/trace_port_rssformer_predict.py
[--seed N] [--calls N] [--unfused] [--out DIR]``. It needs a CUDA card and imports
no JAX.
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
    ap.add_argument("--unfused", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device: this script traces the card only", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from representationlearning_tpu_torch.models.rssformer import HRNetFusion

    print(cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    fused = not args.unfused
    gen = torch.Generator().manual_seed(args.seed + 9)
    model = HRNetFusion("hrnetv2_w32", cs.RSS_CLASSES, dtype=torch.bfloat16, fused_mlp=fused,
                        fused_attn=fused, generator=gen).eval()
    cs.calm(torch, model, gen)
    x = torch.randn(cs.RSS_BATCH, 3, cs.IMAGE, cs.IMAGE, generator=gen).to("cuda")

    def call():
        with torch.no_grad():
            return model(x)

    for _ in range(2):  # builds the kernels, warms the allocator and cuDNN
        call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.calls):
        call()
    end.record()
    end.synchronize()
    untraced = start.elapsed_time(end) / args.calls
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
    busy_ms = busy / n / 1e3
    print(f"fused_mlp = fused_attn = {fused}: forward {untraced:.3f} ms without the profiler "
          f"({cs.RSS_BATCH * 1e3 / untraced:.1f} tiles/s); traced window {window / n / 1e3:.3f} ms "
          f"per forward over {n}; device busy {busy_ms:.3f} ms per forward; idle share "
          f"{100.0 * (1.0 - busy / window):.2f}% of the traced window, "
          f"{100.0 * max(0.0, 1.0 - busy_ms / untraced):.2f}% of the untraced forward; "
          f"{len(kernels) / n:.0f} kernel launches per forward")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the sixteen largest, then the port's own kernels (K5, K6) further down
    for i, (name, (us, count)) in enumerate(ranked):
        if i < 16 or "rss::" in name:
            print(f"  {us / n / 1e3:8.3f} ms  {count / n:6.0f} launches  {name[:100]}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, "rssformer_predict_trace.json")
        prof.export_chrome_trace(path)
        print(f"chrome trace: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
