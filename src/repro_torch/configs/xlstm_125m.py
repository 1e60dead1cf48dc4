"""xlstm-125m  [ssm]  — alternating sLSTM + mLSTM blocks  [arXiv:2405.04517]

d_ff=0: xLSTM blocks carry their own up-projections (mLSTM pre-up-projection
x2, sLSTM post-up-projection 4/3), so there is no separate FFN.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, XLSTMCfg, MLSTM, SLSTM, NO_FF

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    citation="arXiv:2405.04517",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    period=(LayerSpec(mixer=MLSTM, ff=NO_FF), LayerSpec(mixer=SLSTM, ff=NO_FF)),
    xlstm=XLSTMCfg(),
    stages=2,  # 12 layers = 6 periods -> 3 periods per stage; tensor=8
    tensor=8,
)
