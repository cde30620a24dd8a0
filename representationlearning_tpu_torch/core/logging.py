"""Logging / meters / timers, the port's copy of
``representationlearning_tpu/core/logging.py``.

Reference equivalents: keyed AverageMeter (`SCD-AAAI2023/utils/AverageMeter.py`),
WaveCAM Timer with ETA + images/sec (`misc/pyutils.py:50-83`), rank-0 python logging
(`scripts/dist_train_voc.py:60-73`).
"""
from __future__ import annotations

import logging
import sys
import time


def setup_logger(name: str = "tpurep", log_file: str | None = None, is_main: bool = True):
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO if is_main else logging.WARNING)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file and is_main:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class AverageMeter:
    """Keyed running means: `add_value(k, v)` accumulates, `pop(k)` returns mean and
    resets (semantics of `SCD-AAAI2023/utils/AverageMeter.py`)."""

    def __init__(self, *keys):
        self._data = {}
        for k in keys:
            self._data[k] = [0.0, 0]

    def add(self, **kwargs):
        for k, v in kwargs.items():
            s, n = self._data.get(k, (0.0, 0))
            self._data[k] = [s + float(v), n + 1]

    def get(self, key):
        s, n = self._data.get(key, (0.0, 0))
        return s / n if n else 0.0

    def pop(self, key=None):
        if key is None:
            out = {k: self.get(k) for k in self._data}
            self._data = {k: [0.0, 0] for k in self._data}
            return out
        v = self.get(key)
        self._data[key] = [0.0, 0]
        return v


class Timer:
    """ETA + throughput (WaveCAM `misc/pyutils.py:50-83` `Timer`/`imps`)."""

    def __init__(self, total_steps: int | None = None):
        self.start = time.time()
        self.last = self.start
        self.total_steps = total_steps

    def tick(self) -> float:
        now = time.time()
        dt = now - self.last
        self.last = now
        return dt

    def elapsed(self) -> float:
        return time.time() - self.start

    def eta(self, step: int) -> float:
        if not self.total_steps or step == 0:
            return float("nan")
        return self.elapsed() / step * (self.total_steps - step)

    def throughput(self, units: int) -> float:
        dt = self.elapsed()
        return units / dt if dt > 0 else 0.0
