"""Unified config tree, the port's copy of ``representationlearning_tpu/core/config.py``.

The reference uses four distinct config idioms (SURVEY.md §5): OmegaConf YAML + argparse
overrides (SCD/RML `scripts/dist_train_voc.py:437-445`), pure argparse with stage gates
(WaveCAM `run_wavecam_voc.py:19-92`), python-module configs + registry + dotted CLI
overrides (RSSFormer `ever.core.config`), and YAML->EasyDict merge (DRFL `util/util.py`).

This module unifies all four: an attribute-access config tree that loads from YAML or a
python dict, supports deep merge, and applies ``key.sub.key=value`` dotted overrides from
the command line.
"""
from __future__ import annotations

import ast
import copy
import importlib
from typing import Any, Iterable, Mapping


class Config(dict):
    """Attribute-accessible nested dict. ``cfg.train.max_iters`` == ``cfg['train']['max_iters']``."""

    def __init__(self, data: Mapping | None = None, **kwargs):
        super().__init__()
        data = dict(data or {})
        data.update(kwargs)
        for k, v in data.items():
            self[k] = self._wrap(v)

    @staticmethod
    def _wrap(v):
        if isinstance(v, Mapping) and not isinstance(v, Config):
            return Config(v)
        if isinstance(v, (list, tuple)):
            return type(v)(Config._wrap(x) for x in v)
        return v

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any):
        self[name] = self._wrap(value)

    def __delattr__(self, name: str):
        del self[name]

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    # ------------------------------------------------------------------ merge
    def merge(self, other: Mapping) -> "Config":
        """Deep-merge ``other`` into self (other wins). Returns self."""
        for k, v in other.items():
            if k in self and isinstance(self[k], Config) and isinstance(v, Mapping):
                self[k].merge(v)
            else:
                self[k] = self._wrap(v)
        return self

    # -------------------------------------------------------------- overrides
    def set_dotted(self, key: str, value: Any) -> None:
        """Set ``a.b.c`` = value, creating intermediate nodes."""
        parts = key.split(".")
        node = self
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], Config):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = self._wrap(value)

    def get_dotted(self, key: str, default: Any = None) -> Any:
        node: Any = self
        for p in key.split("."):
            if not isinstance(node, Mapping) or p not in node:
                return default
            node = node[p]
        return node

    def apply_overrides(self, overrides: Iterable[str]) -> "Config":
        """Apply CLI-style overrides: ``["train.max_iters=100", "cam.scales=[1,0.5]"]``.

        Also accepts the RSSFormer space-separated pair style used in
        ``scripts/train.sh:14`` (``train.eval_interval_epoch 20``) when given as
        alternating key/value tokens without '='.
        """
        toks = list(overrides)
        i = 0
        while i < len(toks):
            t = toks[i]
            if "=" in t:
                key, val = t.split("=", 1)
                i += 1
            else:
                if i + 1 >= len(toks):
                    raise ValueError(
                        f"override {t!r} has no value: use 'key=value' or 'key value' pairs"
                    )
                key, val = t, toks[i + 1]
                i += 2
            self.set_dotted(key, _parse_literal(val))
        return self

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            if isinstance(v, Config):
                out[k] = v.to_dict()
            elif isinstance(v, (list, tuple)):
                out[k] = type(v)(x.to_dict() if isinstance(x, Config) else x for x in v)
            else:
                out[k] = v
        return out


def _parse_literal(s: str) -> Any:
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def load_yaml(path: str) -> Config:
    import yaml

    with open(path) as f:
        return Config(yaml.safe_load(f) or {})


def import_config(dotted_path: str, package: str | None = None) -> Config:
    """RSSFormer-style python-module config import (``ever.core.config.import_config``):
    the module must expose a dict (or Config) named ``config``."""
    mod = importlib.import_module(dotted_path, package=package)
    cfg = getattr(mod, "config")
    return Config(cfg) if not isinstance(cfg, Config) else cfg
