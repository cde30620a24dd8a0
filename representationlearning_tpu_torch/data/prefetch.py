"""Input-pipeline overlap, the port of ``representationlearning_tpu/data/prefetch.py``:
background batch preparation and device prefetch.

The reference hides host-side augmentation latency behind
`DataLoader(num_workers=10)` worker processes
(`SCD-AAAI2023/scripts/dist_train_voc.py:214-229`). Here:

- `ThreadedLoader`: wraps any batch iterator (e.g. `data.voc.BatchLoader`) and
  prepares up to `depth` batches ahead on a worker thread. Threads (not
  processes) suffice because PIL decode / numpy augmentation release the GIL for
  the heavy parts, and the arrays land in the consumer process with no pickling
  round-trip. The thread handles numpy arrays only and never touches CUDA: the
  consumer turns batches into tensors on its own thread.
- `device_prefetch`: keeps `n` batches on the device ahead of consumption, each
  tensor copied from pinned host memory with `non_blocking=True`, so that the copy
  overlaps the running step.

Both preserve batch order exactly, so runs are deterministic whatever the depth.
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from .._device import resolve_device


class ThreadedLoader:
    """Iterate `loader` on a background thread, buffering up to `depth` batches."""

    def __init__(self, loader: Iterable, depth: int = 4):
        self.loader = loader
        self.depth = max(1, int(depth))

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        _END = object()

        def feed():
            try:
                for item in self.loader:
                    q.put(item)
                q.put(_END)
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


def _to_device(item: Any, device: torch.device) -> Any:
    """Every numpy array or tensor of a nested dict / list / tuple on `device`;
    other leaves (names) as they are."""
    if isinstance(item, dict):
        return {k: _to_device(v, device) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_to_device(v, device) for v in item)
    if isinstance(item, np.ndarray):
        item = torch.from_numpy(np.ascontiguousarray(item))
    if not isinstance(item, torch.Tensor):
        return item
    if device.type == "cuda" and item.device.type == "cpu":
        item = item.pin_memory()
    return item.to(device, non_blocking=True)


def device_prefetch(iterator: Iterable, n: int = 2,
                    device: torch.device | str | None = None) -> Iterator:
    """Yield items from `iterator` with `n` of them already on `device`, the card
    unless the caller names another (it raises where there is none).

    Items are nested dicts / lists / tuples of numpy arrays and tensors; arrays
    become tensors. Order is kept."""
    device = resolve_device(device)
    buf: collections.deque = collections.deque()
    it = iter(iterator)
    try:
        for _ in range(max(1, n)):
            buf.append(_to_device(next(it), device))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(_to_device(next(it), device))
        except StopIteration:
            pass
        yield out
