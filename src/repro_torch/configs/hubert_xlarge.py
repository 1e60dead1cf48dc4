"""hubert-xlarge  [audio]  — encoder-only transformer backbone [arXiv:2106.07447]

The conv/mel frontend is a stub, as in the JAX package: a batch carries
precomputed frame embeddings of shape (batch, seq, d_model)
(``data.synthetic.make_batch``); the model here is the transformer encoder
trained with masked-prediction CE over the 504-unit codebook.  Encoder-only
=> no decode shapes.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    citation="arXiv:2106.07447",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    period=(LayerSpec(),),
    causal=False,
    is_encoder=True,
    frontend="audio",
    stages=16,  # 48 layers -> 3 per stage
    tensor=1,
)
