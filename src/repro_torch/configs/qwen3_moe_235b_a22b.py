"""qwen3-moe-235b-a22b  [moe]  — 128 experts top-8  [hf:Qwen/Qwen3-30B-A3B]

94 layers of one MoE layer each; GQA 64:4 at heads of 128 with RMS norms of
q and k over the head dim.
"""
from repro_torch.configs.base import MOE_FF, ArchConfig, LayerSpec, MoECfg

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    citation="hf:Qwen/Qwen3-30B-A3B",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,  # expert FFN width (fine-grained experts)
    vocab_size=151936,
    period=(LayerSpec(ff=MOE_FF),),
    moe=MoECfg(n_experts=128, top_k=8, d_ff_expert=1536),
    qk_norm=True,
    rope_theta=1_000_000.0,
    stages=16,  # ceil(94/16)=6 per stage (2 masked padding layers)
    tensor=1,
)
