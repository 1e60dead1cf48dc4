"""phi3-mini-3.8b  [dense]  — RoPE SwiGLU GQA  [arXiv:2404.14219]"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    citation="arXiv:2404.14219",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    period=(LayerSpec(),),
    rope_theta=10_000.0,
)
