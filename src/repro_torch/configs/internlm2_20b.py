"""internlm2-20b  [dense]  — GQA  [arXiv:2403.17297]"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    citation="arXiv:2403.17297",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    period=(LayerSpec(),),
    rope_theta=1_000_000.0,
    stages=16,  # 48 layers -> 3 per stage
    tensor=1,
)
