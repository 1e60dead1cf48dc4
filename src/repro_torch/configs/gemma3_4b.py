"""gemma3-4b  [dense]  — 5:1 local:global attention  [hf:google/gemma-3-1b-pt]

Period of 6: five sliding-window (1024) layers then one global layer, RMS
norms of q and k over the head dim, head dim 256.  34 layers are 5 full
periods and 4 layers of a sixth, masked to identity past ``n_layers``.
"""
from repro_torch.configs.base import GLOBAL_WINDOW, ArchConfig, LayerSpec

LOCAL = LayerSpec(window=1024)
GLOBAL = LayerSpec(window=GLOBAL_WINDOW)

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    citation="hf:google/gemma-3-1b-pt",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    period=(LOCAL, LOCAL, LOCAL, LOCAL, LOCAL, GLOBAL),
    qk_norm=True,
    rope_theta=1_000_000.0,
    stages=2,  # 6 periods -> 3 periods/stage; tensor=8
    tensor=8,
)
