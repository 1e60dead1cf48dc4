"""bert-large — the paper's own evaluation model (Table 1: 1153 MB params).

Used by the serverless substrate benchmarks (Fig 5/6/11) and as an encoder
smoke model.  [arXiv:1810.04805]
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="bert-large",
    family="audio",  # encoder-only pathway (masked prediction)
    citation="arXiv:1810.04805",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=30522,
    period=(LayerSpec(),),
    causal=False,
    is_encoder=True,
    frontend="none",
    stages=8,
    tensor=2,
)
