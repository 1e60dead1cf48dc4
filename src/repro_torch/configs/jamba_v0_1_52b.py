"""jamba-v0.1-52b  [hybrid]  — Mamba+attn 1:7 interleave, MoE 16e top-2  [arXiv:2403.19887]

Period of 8 layers: attention at index 4 (1:7 attn:mamba), MoE FFN on every
other layer (odd indices), dense FFN elsewhere — the Jamba block layout.
"""
from repro_torch.configs.base import (
    ATTN,
    DENSE_FF,
    MAMBA,
    MOE_FF,
    ArchConfig,
    LayerSpec,
    MambaCfg,
    MoECfg,
)


def _layer(i: int) -> LayerSpec:
    return LayerSpec(mixer=ATTN if i == 4 else MAMBA, ff=MOE_FF if i % 2 == 1 else DENSE_FF)


CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    citation="arXiv:2403.19887",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    period=tuple(_layer(i) for i in range(8)),
    moe=MoECfg(n_experts=16, top_k=2, d_ff_expert=14336),
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2),
    stages=4,  # 4 periods of 8 -> 1 period per stage; tensor=4
    tensor=4,
)
