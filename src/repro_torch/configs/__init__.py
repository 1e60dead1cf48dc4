"""Registry of the architectures the port runs (public ``--arch`` ids)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    ArchConfig,
    InputShape,
    LayerSpec,
    MambaCfg,
    MoECfg,
    XLSTMCfg,
    validate,
)

# public id -> module name, in the JAX package's order
_ARCH_MODULES = {
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "hubert-xlarge": "hubert_xlarge",
    "qwen2.5-14b": "qwen2_5_14b",
    "dbrx-132b": "dbrx_132b",
    "xlstm-125m": "xlstm_125m",
    "internlm2-20b": "internlm2_20b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "internvl2-26b": "internvl2_26b",
    "gemma3-4b": "gemma3_4b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    # the paper's own evaluation model (serverless benchmarks)
    "bert-large": "bert_large",
}

# bert-large is also the paper's Table 1 model: as an arch id it would
# shadow that profile, so it is reachable through get_config only
ARCH_IDS = [k for k in _ARCH_MODULES if k != "bert-large"]


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(_ARCH_MODULES)}")
    cfg = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}").CONFIG
    validate(cfg)
    return cfg
