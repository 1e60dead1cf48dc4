"""Serving cost model (``repro.serving.cost`` for the port, copied exactly):
per-request prefill + decode latency and $/1k requests for a partitioned
pipeline on a serverless platform.

A serving request is one prefill pass (seq = prompt length) followed by
``new_tokens - 1`` single-token pipeline rounds, each of which round-trips
every stage's KV cache through the object store (serverless functions are
stateless between invocations).  All per-stage terms come from
``stage_aggregates`` over a profile built at ``seq = prefill_tokens`` and
``micro_batch = batch``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from repro_torch.core.perfmodel import Config
from repro_torch.core.profiler import arch_config as arch_config_for_model  # noqa: F401
from repro_torch.serverless.platform import GB, Platform
from repro_torch.serverless.simulator import stage_aggregates

#: greedy-token feedback object: int32 [B, 1]
TOKEN_BYTES = 4


@dataclass(frozen=True)
class ServingSpec:
    """One serving workload: SLO + request shape."""

    slo_s: float            # per-request latency objective
    batch: int              # requests decoded together
    prefill_tokens: int     # prompt length
    new_tokens: int         # tokens generated per request (incl. the
                            # prefill's first token)

    def __post_init__(self):
        if self.slo_s <= 0:
            raise ValueError(f"slo_s must be positive, got {self.slo_s}")
        if self.batch < 1 or self.prefill_tokens < 1 or self.new_tokens < 1:
            raise ValueError(
                "batch, prefill_tokens and new_tokens must all be >= 1 "
                f"(got {self.batch}, {self.prefill_tokens}, "
                f"{self.new_tokens})")

    @property
    def s_ctx(self) -> int:
        """KV-cache capacity: prompt + every generated token."""
        return self.prefill_tokens + self.new_tokens

    def as_dict(self) -> dict:
        return {"slo_s": self.slo_s, "batch": self.batch,
                "prefill_tokens": self.prefill_tokens,
                "new_tokens": self.new_tokens, "context": self.s_ctx}


def kv_bytes_per_instance(cfg, batch: int, s_ctx: int) -> float:
    """Decode-cache bytes of ONE period instance, from shapes on the meta
    device (nothing is allocated)."""
    from repro_torch.models import registry
    from repro_torch.models.common import tree_leaves

    caches = registry.init_decode_caches(cfg, batch, s_ctx, device="meta")
    total = 0.0
    for leaf in tree_leaves(caches):
        # leaves are stacked [n_periods, ...]; charge one instance
        total += float(np.prod(leaf.shape[1:]) * leaf.element_size())
    return total


@dataclass(frozen=True)
class ServingEstimate:
    """Closed-form per-request latency/cost of one partition + memory
    assignment."""

    t_prefill: float                 # prompt pass through the pipeline
    t_token: float                   # one decode pipeline round
    t_request: float                 # t_prefill + (new_tokens-1) * t_token
    cost_per_request: float          # $ (all stages occupied for t_request)
    cost_per_1k: float
    kv_bytes: Tuple[float, ...]      # [S] per-stage decode-cache bytes
    mem: Tuple[float, ...]           # [S] allocated function memory (bytes)
    t_prefill_stage: Tuple[float, ...]   # [S] per-stage prefill compute
    t_decode_stage: Tuple[float, ...]    # [S] per-stage decode compute


def estimate_serving(profile, platform: Platform, config: Config, cfg,
                     spec: ServingSpec) -> ServingEstimate:
    """Per-request latency and cost of serving ``spec`` on ``config``;
    ``profile`` must be built at ``seq = spec.prefill_tokens`` and
    ``micro_batch = spec.batch``."""
    from repro_torch.serverless.runtime.worker import stage_instance_ranges

    agg = stage_aggregates(profile, platform, config, 1)
    S = agg.S
    S_pre = spec.prefill_tokens
    t_lat = agg.t_lat
    w = agg.w

    # ---- prefill: one prompt flows through the pipeline depth-first
    t_prefill = float(np.sum(agg.t_fc))
    for s in range(S - 1):
        t_prefill += agg.out_b[s] / w[s] + t_lat          # producer uplink
        t_prefill += agg.out_b[s] / w[s + 1] + t_lat      # consumer downlink

    # ---- decode: compute and boundary scale to a single token
    t_dec = agg.t_fc / S_pre
    tok_b = agg.out_b / S_pre                             # [B, 1, d] hidden
    per_inst = kv_bytes_per_instance(cfg, spec.batch, spec.s_ctx)
    spans = stage_instance_ranges(cfg, config.x)
    kv_b = tuple(float((sp.inst_hi - sp.inst_lo) * per_inst) for sp in spans)

    t_token = 0.0
    for s in range(S):
        t_token += float(t_dec[s])
        if kv_b[s]:
            # stateless functions: the KV cache round-trips the store
            t_token += 2.0 * (kv_b[s] / w[s] + t_lat)
        if s < S - 1:
            t_token += tok_b[s] / w[s] + t_lat
            t_token += tok_b[s] / w[s + 1] + t_lat
    # greedy-token feedback: last stage -> store -> stage 0
    fb = float(spec.batch * TOKEN_BYTES)
    t_token += fb / w[S - 1] + t_lat + fb / w[0] + t_lat

    t_request = t_prefill + (spec.new_tokens - 1) * t_token
    cost = float(platform.price_per_gb_s
                 * (np.sum(agg.mem) / GB) * t_request)
    return ServingEstimate(
        t_prefill=float(t_prefill), t_token=float(t_token),
        t_request=float(t_request), cost_per_request=cost,
        cost_per_1k=1000.0 * cost, kv_bytes=kv_b,
        mem=tuple(float(m) for m in agg.mem),
        t_prefill_stage=tuple(float(t) for t in agg.t_fc),
        t_decode_stage=tuple(float(t) for t in t_dec),
    )
