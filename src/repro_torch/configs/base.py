"""Architecture configuration (``repro.configs.base`` for the port).

The port covers decoder LMs of ATTN mixers and DENSE_FF feed-forwards (the
serving slice); the other mixer and FF kinds are named so configs stay
comparable, and anything that would need them raises.  A model is a
sequence of *period instances*, each a static list of :class:`LayerSpec`,
exactly as in the JAX package, so stage cuts and parameter stacking carry
over.
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

OTHER_FAMILIES = "not ported yet: ROADMAP port queue item 6 (other model families)"


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
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    causal: bool = True
    frontend: str = "none"            # none | audio | vision
    tie_embeddings: bool = False
    # dtype of params/activations on the target hardware
    param_dtype: str = "bfloat16"

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

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + per-layer, excl. norms)."""
        d, hd = self.d_model, self.hd
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            spec = self.layer_spec(i)
            if spec.mixer != ATTN or spec.ff not in (DENSE_FF, NO_FF):
                raise NotImplementedError(
                    f"{spec.mixer}/{spec.ff} layers: {OTHER_FAMILIES}")
            total += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
            if spec.ff == DENSE_FF:
                total += 3 * d * self.d_ff
        return total

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 periods, d_model<=256, fp32."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, max(1, n_heads // 2))
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
            period=period,
            param_dtype="float32",
        )


def validate(cfg: ArchConfig) -> None:
    if cfg.n_periods < 1:
        raise ValueError(f"{cfg.name}: no layers")
    if cfg.n_heads % cfg.n_kv_heads and cfg.n_kv_heads % cfg.n_heads:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} heads vs {cfg.n_kv_heads} kv heads")
