"""Registry of the architectures the port runs (public ``--arch`` ids)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    LayerSpec,
    MambaCfg,
    MoECfg,
    validate,
)

# public id -> module name; the JAX package's other archs (xlstm-125m,
# bert-large, hubert-xlarge, internvl2-26b) wait for ROADMAP port queue
# item 6b
_ARCH_MODULES = {
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen2.5-14b": "qwen2_5_14b",
    "gemma3-4b": "gemma3_4b",
    "internlm2-20b": "internlm2_20b",
    "dbrx-132b": "dbrx_132b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}

ARCH_IDS = list(_ARCH_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(_ARCH_MODULES)}")
    cfg = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}").CONFIG
    validate(cfg)
    return cfg
