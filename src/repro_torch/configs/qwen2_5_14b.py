"""qwen2.5-14b  [dense]  — GQA with QKV bias  [hf:Qwen/Qwen2.5-0.5B]"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    citation="hf:Qwen/Qwen2.5-0.5B",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    period=(LayerSpec(),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    stages=16,  # 48 layers -> 3 per stage
    tensor=1,
)
