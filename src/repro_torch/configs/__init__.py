"""Registry of the architectures the port runs (public ``--arch`` ids)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, LayerSpec, validate  # noqa: F401

# public id -> module name; the JAX package's other archs wait for
# ROADMAP port queue item 6 (other model families)
_ARCH_MODULES = {
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen2.5-14b": "qwen2_5_14b",
}

ARCH_IDS = list(_ARCH_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(_ARCH_MODULES)}")
    cfg = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}").CONFIG
    validate(cfg)
    return cfg
