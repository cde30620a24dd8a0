"""Where a baseline-zoo model's f32 training gradient parts from its f64 one, on the CPU.

The model is built, calmed and fed as `chip_smoke.py` phase 7j (b) does (seed 0, 2 x 128²,
dropout off), then trained for one forward and backward in f32 and in f64. Printed:
- each training-mode BatchNorm: the relative error of its f32 input and output against
  f64, the largest |mean| / std of its input channels, and the number of values a
  channel; then the relative error of the gradient reaching its output;
- each top-level module: its f64 gradient norm, the f32 norm's relative error, and the
  f32 gradient's error as a vector, |g32 - g64| / |g64|.

Usage: python tools/zoo_f32_conditioning.py LinkNet [PSPNet ...]
"""
import copy
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from representationlearning_tpu_torch.models import baselines  # noqa: E402
from representationlearning_tpu_torch.models.layers import BatchNorm2d  # noqa: E402
from representationlearning_tpu_torch.models.smp_zoo import ZOO_MODELS  # noqa: E402


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm()) if b.norm() else float((a - b).norm())


def run(name: str, seed: int = 0) -> None:
    ph = cs.Phases.__new__(cs.Phases)
    ph.torch = torch
    base = ph._zoo_build(name, torch.device("cpu"), seed + 43)
    cs.calm(torch, base, torch.Generator().manual_seed(seed + 44))
    gen = torch.Generator().manual_seed(seed + 45)
    x = torch.randn(cs.ZOO_SMALL_BATCH, 3, cs.ZOO_SMALL, cs.ZOO_SMALL, generator=gen)
    y = torch.randint(-1, cs.RSS_CLASSES, (cs.ZOO_SMALL_BATCH, cs.ZOO_SMALL, cs.ZOO_SMALL),
                      generator=gen)
    seen, grads = {}, {}
    for dtype in (torch.float32, torch.float64):
        m = copy.deepcopy(base).to(dtype=dtype)
        fwd, bwd = {}, {}
        for n, mod in m.named_modules():
            if isinstance(mod, BatchNorm2d):   # the trained ones, not the frozen encoder's
                mod.register_forward_hook(lambda _, i, o, n=n: fwd.__setitem__(
                    n, (i[0].detach().double(), o.detach().double())))
                mod.register_full_backward_hook(lambda _, gi, go, n=n: bwd.__setitem__(
                    n, go[0].double()))
        losses = m.train()(x.to(dtype), y)
        sum(losses.values()).backward()
        seen[dtype] = (fwd, bwd)
        grads[dtype] = {}
        for k, p in m.named_parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            grads[dtype].setdefault(k.split(".")[0], []).append(g.detach().double().flatten())
    print(f"== {name}")
    (f32, b32), (f64, b64) = seen[torch.float32], seen[torch.float64]
    for n, (i64, o64) in f64.items():
        i32, o32 = f32[n]
        ch = i64.transpose(0, 1).reshape(i64.shape[1], -1)
        kappa = float((ch.mean(1).abs() / ch.std(1, unbiased=False).clamp_min(1e-12)).max())
        print(f"  {n:40s} in {rel(i32, i64):.1e} out {rel(o32, o64):.1e} |mean|/std {kappa:8.1f} "
              f"values {ch.shape[1]:7d} grad {rel(b32[n], b64[n]) if n in b64 else float('nan'):.1e}")
    for k, g64 in grads[torch.float64].items():
        g64, g32 = torch.cat(g64), torch.cat(grads[torch.float32][k])
        n64 = float(g64.norm())
        print(f"  module {k:20s} norm {n64:.4e} norm error {abs(float(g32.norm()) - n64) / n64:.2e} "
              f"vector error {rel(g32, g64):.2e}")


if __name__ == "__main__":
    torch.set_num_threads(4)
    baselines.dropout = lambda t, *a, **k: t   # the same function in f32 and f64
    for name in sys.argv[1:] or ZOO_MODELS:
        run(name)
