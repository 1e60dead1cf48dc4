"""internvl2-26b  [vlm]  — InternViT + InternLM2 backbone  [arXiv:2404.16821]

The InternViT vision encoder + MLP projector are a stub, as in the JAX
package: a batch carries precomputed patch embeddings (batch, n_patches,
d_model) (``data.synthetic.make_batch``) which the language model consumes in
its first ``n_frontend_tokens`` positions.  This module is the InternLM2-20B language backbone (+9 vocab for
the VLM special tokens).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    citation="arXiv:2404.16821",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    period=(LayerSpec(),),
    rope_theta=1_000_000.0,
    frontend="vision",
    n_frontend_tokens=256,
    stages=16,
    tensor=1,
)
