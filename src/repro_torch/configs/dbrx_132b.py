"""dbrx-132b  [moe]  — 16 experts top-4, fine-grained  [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import MOE_FF, ArchConfig, LayerSpec, MoECfg

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    citation="hf:databricks/dbrx-base",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    period=(LayerSpec(ff=MOE_FF),),
    moe=MoECfg(n_experts=16, top_k=4, d_ff_expert=10752),
    rope_theta=500_000.0,
    stages=8,  # 40 layers -> 5 per stage; tensor=2 within stage
    tensor=2,
)
