"""The device rule of the port's entry points: they run on the card unless the
caller asks for something else, and they do not fall back to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``, raising where no CUDA device exists;
    anything else is taken as the caller's explicit choice (``"cpu"`` in tests)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default and does not fall "
            "back to the CPU; pass device='cpu' to run there on purpose")
    return torch.device("cuda")
