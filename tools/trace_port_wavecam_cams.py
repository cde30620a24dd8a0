"""Device trace of the PyTorch port's WaveCAM CAM pair on one CUDA card.

Builds the bench's ``wavecam_cams`` workload (``bench.py::build_wavecam_cams``:
``Net(n_classes=20, dtype=bf16)`` from seed 0, one ``cam`` over 8 x 512 x 512
images and their flips, ReLU, the flip sum), times the call without the profiler
(CUDA events), traces a few back-to-back calls with ``torch.profiler`` and prints:
the card and its power limit, the call's time, the device's busy time and idle
share, the kernel launches a call, the kernels that take most of the device time,
and the device time split between the convolutions (their kernels, by name) and
everything else (FrozenBatchNorm's f32 passes, ReLU, the residual adds, the casts
to bf16, cuDNN's layout transposes). TF32 is off, as in the bench. With ``--out
DIR`` it also writes a Chrome trace there.

Usage, from the root of the repository: ``python tools/trace_port_wavecam_cams.py
[--calls N] [--out DIR]``. It needs a CUDA card and imports no JAX.
"""
import argparse
import os
import re
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the convolutions' kernels, by the names the profiler gives them: cuDNN's implicit
# GEMMs (sm90_xmma_*, cutlass_*) and the cuBLAS GEMMs (nvjet_*) it picks for 1x1 convs
CONV = re.compile(r"conv|xmma|gemm|cutlass|nvjet|sm90_|sm80_", re.IGNORECASE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    from representationlearning_tpu_torch import bench as tb

    print(cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    with tb.no_tf32():
        w = tb.build_wavecam_cams()
        for _ in range(3):   # cuDNN's choices, the allocator
            w.call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.calls):
            w.call()
        end.record()
        end.synchronize()
        untraced = start.elapsed_time(end) / args.calls
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                w.call()
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
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    n = args.calls
    busy_ms = busy / n / 1e3
    print(f"wavecam_cams (batch {w.batch}, pair {2 * w.batch}): {untraced:.3f} ms a call without "
          f"the profiler ({w.batch * 1e3 / untraced:.2f} CAMs/s); device busy {busy_ms:.3f} ms a "
          f"call, idle share {100.0 * max(0.0, 1.0 - busy_ms / untraced):.2f}% of the untraced "
          f"call; {len(kernels) / n:.0f} kernel launches a call")
    groups = {"convolutions": [0.0, 0], "everything else": [0.0, 0]}
    for name, (us, count) in by_name.items():
        g = groups["convolutions" if CONV.search(name) else "everything else"]
        g[0] += us
        g[1] += count
    for g, (us, count) in groups.items():
        print(f"  {g}: {us / n / 1e3:.3f} ms in {count / n:.0f} launches a call")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"  {us / n / 1e3:8.3f} ms  {count / n:6.0f} launches  {name[:100]}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, "wavecam_cams_trace.json")
        prof.export_chrome_trace(path)
        print(f"chrome trace: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
