"""Profiling and throughput instrumentation, the port of
``representationlearning_tpu/utils/profiling.py`` (the systematic replacement for
the reference's ad-hoc ETA timers and commented-out FLOPs probes): a
``torch.profiler`` trace written for TensorBoard, a step-rate meter printing
images a second like WaveCAM's ``imps`` (`step/train_cam.py:96-100`), and the
cards' memory statistics."""
from __future__ import annotations

import contextlib
import time
from typing import Sequence

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

ACTIVITIES = {"cpu": ProfilerActivity.CPU, "cuda": ProfilerActivity.CUDA}


@contextlib.contextmanager
def trace(log_dir: str, activities: Sequence[str] = ("cpu", "cuda")):
    """Record the host's and the card's activity inside the block and write the
    trace (``<worker>.<time>.pt.trace.json``, which TensorBoard's profiler
    plugin and chrome://tracing read) into ``log_dir`` when it ends. Yields the
    ``torch.profiler.profile``. ``activities`` names what is recorded: "cpu",
    "cuda"."""
    with profile(activities=[ACTIVITIES[a] for a in activities],
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class StepRate:
    """images/sec + step-time meter with warmup skip."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.n_steps = 0
        self.n_items = 0
        self.t0 = None

    def update(self, n_items: int):
        self.n_steps += 1
        if self.n_steps == self.warmup:
            self.t0 = time.perf_counter()
            self.n_items = 0
        elif self.n_steps > self.warmup:
            self.n_items += n_items

    @property
    def imps(self) -> float:
        if self.t0 is None or self.n_items == 0:
            return 0.0
        return self.n_items / (time.perf_counter() - self.t0)

    @property
    def step_ms(self) -> float:
        steps = self.n_steps - self.warmup
        if self.t0 is None or steps <= 0:
            return 0.0
        return (time.perf_counter() - self.t0) / steps * 1000.0


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` of each visible card, keyed "cuda:<index>"
    (replaces the reference's commented CUDA max-memory probes); empty where
    there is no card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
