"""Stage spans: which period instances (plus embedding / head) each pipeline
stage owns (``StageSpan`` and ``stage_instance_ranges`` of
``repro.serverless.runtime.worker``).  The training ``StageWorker`` comes
with the training slice (ROADMAP port queue item 1)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from repro_torch.configs.base import ArchConfig
from repro_torch.core.partition import stages_of


@dataclass(frozen=True)
class StageSpan:
    """What pipeline stage ``index`` of ``n_stages`` owns."""

    index: int
    n_stages: int
    inst_lo: int          # first owned period instance
    inst_hi: int          # one past the last owned instance (may equal lo)
    owns_embed: bool
    owns_head: bool


def stage_instance_ranges(cfg: ArchConfig, x) -> List[StageSpan]:
    """Map profile-layer cuts ``x`` (over ``arch_model_profile``'s
    ``[embed, layers..., head]`` table) to period-instance spans."""
    L = len(x) + 1
    expect = cfg.n_layers + 2
    if L != expect:
        raise ValueError(
            f"partition is over {L} profile layers but arch {cfg.name!r} "
            f"profiles to {expect} ([embed] + {cfg.n_layers} layers + [head])")
    plen = cfg.period_len
    spans = []
    stages = stages_of(tuple(x))
    for s, (lo, hi) in enumerate(stages):
        lo_l = max(lo, 1) - 1          # first model layer in the stage
        hi_l = min(hi, cfg.n_layers) - 1   # last model layer (inclusive)
        if lo_l > hi_l:                # embed-only or head-only stage
            inst_lo = inst_hi = 0 if lo == 0 else cfg.n_periods
        else:
            if lo_l % plen != 0:
                raise ValueError(
                    f"stage {s} starts mid-period (layer {lo_l}, period_len={plen}); "
                    "numeric execution needs period-aligned cuts")
            if hi_l != cfg.n_layers - 1 and (hi_l + 1) % plen != 0:
                raise ValueError(
                    f"stage {s} ends mid-period (layer {hi_l}, period_len={plen}); "
                    "numeric execution needs period-aligned cuts")
            inst_lo = lo_l // plen
            inst_hi = -(-(hi_l + 1) // plen)
        spans.append(StageSpan(
            index=s, n_stages=len(stages), inst_lo=inst_lo, inst_hi=inst_hi,
            owns_embed=(lo == 0), owns_head=(hi == L - 1),
        ))
    return spans
