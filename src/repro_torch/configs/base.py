"""Architecture configuration (``repro.configs.base`` for the port).

The port covers every mixer (ATTN, MAMBA, SLSTM, MLSTM) and feed-forward
(DENSE_FF, MOE_FF, NO_FF) kind of the JAX package, decoders and encoders,
with the audio and vision frontends as precomputed embeddings.  A model is
a sequence of *period instances*, each a static list of :class:`LayerSpec`,
exactly as in the JAX package, so stage cuts and parameter stacking carry
over.  ``stages``/``tensor`` give the default factorization of the mesh's
``model`` axis into (pipeline stages x tensor parallel) that the mesh path
(``core.plan.make_plan``) starts from; ``INPUT_SHAPES`` are the JAX
package's named input shapes.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence

# Mixer kinds.
ATTN = "attn"
MAMBA = "mamba"
SLSTM = "slstm"
MLSTM = "mlstm"

# FF kinds.
DENSE_FF = "dense"
MOE_FF = "moe"
NO_FF = "none"

GLOBAL_WINDOW = 0  # sentinel: full (global) attention

@dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating period."""

    mixer: str = ATTN
    ff: str = DENSE_FF
    window: int = GLOBAL_WINDOW  # sliding-window size; 0 = full attention

    def __post_init__(self):
        assert self.mixer in (ATTN, MAMBA, SLSTM, MLSTM), self.mixer
        assert self.ff in (DENSE_FF, MOE_FF, NO_FF), self.ff


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclass(frozen=True)
class XLSTMCfg:
    # Projection factor of the mLSTM up-projection and sLSTM ffn.
    m_proj_factor: float = 2.0
    s_proj_factor: float = 4.0 / 3.0
    conv_kernel: int = 4


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    citation: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    period: Sequence[LayerSpec] = (LayerSpec(),)
    moe: Optional[MoECfg] = None
    mamba: Optional[MambaCfg] = None
    xlstm: Optional[XLSTMCfg] = None
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    causal: bool = True
    is_encoder: bool = False          # encoder-only (no decode shapes)
    frontend: str = "none"            # none | audio | vision
    n_frontend_tokens: int = 256      # vision: #patch embeddings prepended
    tie_embeddings: bool = False
    # dtype of params/activations on the target hardware
    param_dtype: str = "bfloat16"
    qk_norm: bool = False             # RMS norm of q and k over the head dim (gemma3)
    # default factorization of the 16-wide model axis: stages * tensor
    stages: int = 16
    tensor: int = 1

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def period_len(self) -> int:
        return len(self.period)

    @property
    def n_periods(self) -> int:
        """Number of period instances, rounded up; layers past ``n_layers``
        in the last instance are masked to identity."""
        return -(-self.n_layers // self.period_len)

    def layer_spec(self, i: int) -> LayerSpec:
        return self.period[i % self.period_len]

    @property
    def uses_attention(self) -> bool:
        return any(s.mixer == ATTN for s in self.period)

    @property
    def subquadratic(self) -> bool:
        """True if a 500k-token decode context is feasible (no full O(L^2)
        attention with an unbounded KV cache on every layer)."""
        if all(s.mixer != ATTN for s in self.period):
            return True
        n_attn = sum(1 for s in self.period if s.mixer == ATTN)
        n_global = sum(1 for s in self.period if s.mixer == ATTN and s.window == GLOBAL_WINDOW)
        return n_global < n_attn or n_attn * 4 <= len(self.period)

    def supports_shape(self, shape_name: str) -> bool:
        if self.is_encoder and shape_name in ("decode_32k", "long_500k"):
            return False
        if shape_name == "long_500k" and not self.subquadratic:
            return False
        return True

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + per-layer, excl. norms)."""
        d, hd = self.d_model, self.hd
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            spec = self.layer_spec(i)
            if spec.mixer == ATTN:
                total += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                    + self.n_heads * hd * d
            elif spec.mixer == MAMBA:
                mc = self.mamba or MambaCfg()
                di = mc.d_inner(d)
                total += d * 2 * di + di * mc.d_conv + di * (2 * mc.d_state + 2) + di * d
            else:  # SLSTM / MLSTM: JAX's approximation, which the profiles read
                xc = self.xlstm or XLSTMCfg()
                f = xc.m_proj_factor if spec.mixer == MLSTM else xc.s_proj_factor
                di = int(d * f)
                total += 2 * d * di + di * d + 4 * d * di  # up/gate/down + gates
            if spec.ff == DENSE_FF:
                total += 3 * d * self.d_ff
            elif spec.ff == MOE_FF:
                if self.moe is None:
                    raise ValueError(f"{self.name}: MoE layers without a MoECfg")
                total += self.moe.n_experts * 3 * d * self.moe.d_ff_expert \
                    + d * self.moe.n_experts
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if self.moe is None:
            return self.param_count()
        n_moe_layers = sum(1 for i in range(self.n_layers) if self.layer_spec(i).ff == MOE_FF)
        inactive = n_moe_layers * (self.moe.n_experts - self.moe.top_k) * 3 \
            * self.d_model * self.moe.d_ff_expert
        return self.param_count() - inactive

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 periods, d_model<=256, <=4 experts, fp32."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, max(1, n_heads // 2))
        moe = None
        if self.moe is not None:
            moe = replace(self.moe, n_experts=min(4, self.moe.n_experts),
                          top_k=min(2, self.moe.top_k),
                          d_ff_expert=min(self.moe.d_ff_expert, 2 * d_model))
        n_layers = self.period_len * (2 if self.period_len == 1 else 1)
        period = tuple(
            replace(s, window=min(s.window, 64) if s.window else 0) for s in self.period
        )
        return replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d_model // n_heads,
            d_ff=min(self.d_ff, 4 * d_model) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
            moe=moe,
            period=period,
            stages=1,
            tensor=1,
            n_frontend_tokens=min(self.n_frontend_tokens, 16),
            param_dtype="float32",
        )


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def validate(cfg: ArchConfig) -> None:
    if cfg.n_periods < 1:
        raise ValueError(f"{cfg.name}: no layers")
    if cfg.n_heads % cfg.n_kv_heads and cfg.n_kv_heads % cfg.n_heads:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} heads vs {cfg.n_kv_heads} kv heads")
    if any(s.ff == MOE_FF for s in cfg.period) and cfg.moe is None:
        raise ValueError(f"{cfg.name}: MoE layers without a MoECfg")
    if any(s.mixer == MAMBA for s in cfg.period) and cfg.mamba is None:
        raise ValueError(f"{cfg.name}: Mamba layers without a MambaCfg")
    if any(s.mixer in (SLSTM, MLSTM) for s in cfg.period) and cfg.xlstm is None:
        raise ValueError(f"{cfg.name}: xLSTM layers without an XLSTMCfg")
    if 16 % cfg.stages:
        raise ValueError(f"{cfg.name}: {cfg.stages} stages do not divide the model axis of 16")
