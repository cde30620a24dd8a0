"""Component registry, the port's copy of ``representationlearning_tpu/core/registry.py``
(it replaces the external `ever` package registry the reference leans on for
RSSFormer: registry use at `RSSFormer-TIP2023/data/loveda.py:97`,
`module/baseline/hrnet_aux.py:70`). Components register under the JAX package's
names."""
from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Any] = {}

    def register(self, name: str | None = None) -> Callable:
        def deco(obj):
            key = name or obj.__name__
            if key in self._entries:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._entries[key] = obj
            return obj

        return deco

    def get(self, name: str) -> Any:
        if name not in self._entries:
            raise KeyError(
                f"{name!r} not found in registry {self.name!r}; "
                f"available: {sorted(self._entries)}"
            )
        return self._entries[name]

    def build(self, name: str, *args, **kwargs) -> Any:
        return self.get(name)(*args, **kwargs)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def keys(self):
        return self._entries.keys()


MODELS = Registry("models")
DATASETS = Registry("datasets")
LOSSES = Registry("losses")
