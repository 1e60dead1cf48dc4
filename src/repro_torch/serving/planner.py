"""SLO-aware serving planner (``repro.serving.planner`` for the port, copied
exactly): choose partition + memory sizes minimizing $/1k-requests subject
to a per-request latency SLO.

The search mirrors the training planner's grid engine — enumerate layer
partitions, derive a per-stage memory floor, then refine with one
first-improvement coordinate-descent sweep — but the objective and the
constraints are serving's:

* latency = prefill pass + ``(new_tokens - 1)`` decode pipeline rounds, each
  round-tripping stage KV caches through the store (``serving.cost``);
* the per-stage memory constraint gains the stage's KV-cache bytes;
* partitions must cut on period boundaries (``stage_instance_ranges``) —
  serving stages run real prefill/decode math, not analytic tables.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.api.session import InfeasiblePlanError
from repro_torch.core.partition import stages_of
from repro_torch.core.perfmodel import Config, perf_tables
from repro_torch.core.planner import _expand_z, _partitions
from repro_torch.core.profiler import resolve_profile
from repro_torch.serverless.platform import Platform, get_platform
from repro_torch.serving.cost import (
    ServingEstimate,
    ServingSpec,
    arch_config_for_model,
    estimate_serving,
    kv_bytes_per_instance,
)


class InfeasibleSLOError(InfeasiblePlanError):
    """No partition/memory assignment meets the serving SLO (or fits in
    the platform's memory options at all)."""


@dataclass(frozen=True)
class ServingSolution:
    model: str
    config: Config
    estimate: ServingEstimate
    spec: ServingSpec
    profile: object                 # ModelProfile the config indexes into
    platform: Platform
    n_candidates: int               # period-aligned partitions examined
    n_feasible: int                 # configs meeting memory + SLO
    solve_seconds: float


def solve_serving(model: str, platform, spec: ServingSpec, *,
                  max_stages: Optional[int] = None) -> ServingSolution:
    """Grid + coordinate-descent search over (partition, stage memory)."""
    t_start = time.monotonic()
    if isinstance(platform, str):
        platform = get_platform(platform)
    cfg = arch_config_for_model(model)
    profile = resolve_profile(model, platform, seq=spec.prefill_tokens,
                              micro_batch=spec.batch)
    from repro_torch.serverless.runtime.worker import stage_instance_ranges

    T = perf_tables(profile, platform)
    L, J = T.L, T.J
    per_inst = kv_bytes_per_instance(cfg, spec.batch, spec.s_ctx)

    best: Optional[Tuple[Config, ServingEstimate]] = None
    fastest: Optional[Tuple[Config, ServingEstimate]] = None
    n_cand = 0
    n_feas = 0

    def consider(x, stage_mem):
        nonlocal best, fastest, n_feas
        config = Config(x=tuple(x), d=1, z=_expand_z(stage_mem, x, L))
        est = estimate_serving(profile, platform, config, cfg, spec)
        if fastest is None or est.t_request < fastest[1].t_request:
            fastest = (config, est)
        if est.t_request <= spec.slo_s:
            n_feas += 1
            if best is None or (est.cost_per_1k, est.t_request) < (
                    best[1].cost_per_1k, best[1].t_request):
                best = (config, est)
        return est

    for bits in _partitions(L, max_stages):
        try:
            spans = stage_instance_ranges(cfg, bits)
        except ValueError:
            continue                # mid-period cut: not executable
        n_cand += 1
        stages = stages_of(bits)
        los = np.array([lo for lo, _ in stages])
        a_stage = np.add.reduceat(T.a, los)
        s_stage = np.add.reduceat(T.s, los)
        kv = np.array([(sp.inst_hi - sp.inst_lo) * per_inst for sp in spans])
        need = a_stage + s_stage + kv + T.base_memory
        floors = np.searchsorted(T.mem_opts, need)
        if np.any(floors >= J):
            continue                # some stage fits in no memory option
        # candidate stage-memory assignments: the floor, then every uniform
        # level clamped up to it (more memory = more vCPU = lower latency)
        seen = set()
        floor_t = tuple(int(f) for f in floors)
        for lvl in range(int(floors.max()), J):
            cand = tuple(max(lvl, f) for f in floor_t)
            if cand not in seen:
                seen.add(cand)
                consider(bits, cand)
        if floor_t not in seen:
            consider(bits, floor_t)

    # one first-improvement coordinate-descent sweep from the winner
    if best is not None:
        config, est = best
        stage_mem = [config.z[lo] for lo, _ in stages_of(config.x)]
        stages = stages_of(config.x)
        for si in range(len(stage_mem)):
            for j in range(J):
                if j == stage_mem[si]:
                    continue
                trial = list(stage_mem)
                trial[si] = j
                e = consider(config.x, tuple(trial))
                if best[1] is e:
                    stage_mem = trial
                    est = e
                    break

    if best is None:
        if fastest is None:
            raise InfeasibleSLOError(
                f"no period-aligned partition of {model!r} fits the memory "
                f"options of {platform.name} (largest option "
                f"{T.mem_opts[-1] / 2**20:.0f} MB) at batch={spec.batch}, "
                f"context={spec.s_ctx}")
        raise InfeasibleSLOError(
            f"no partition of {model!r} on {platform.name} meets the "
            f"{spec.slo_s:.3f}s SLO: best achievable request latency is "
            f"{fastest[1].t_request:.3f}s "
            f"({len(stages_of(fastest[0].x))} stages, "
            f"{spec.new_tokens} tokens); relax the SLO, shrink the token "
            "budget, or pick a smaller model")

    return ServingSolution(
        model=model, config=best[0], estimate=best[1], spec=spec,
        profile=profile, platform=platform, n_candidates=n_cand,
        n_feasible=n_feas, solve_seconds=time.monotonic() - t_start)


def plan_serving(model: str, platform, *, slo: float, batch: int = 1,
                 prefill_tokens: int = 64, new_tokens: int = 8,
                 max_stages: Optional[int] = None):
    """Solve the serving problem and record it as a ``workload="serve"``
    :class:`repro_torch.api.plan.DeploymentPlan`."""
    from repro_torch.api.plan import DeploymentPlan, profile_fingerprint

    spec = ServingSpec(slo_s=float(slo), batch=int(batch),
                       prefill_tokens=int(prefill_tokens),
                       new_tokens=int(new_tokens))
    sol = solve_serving(model, platform, spec, max_stages=max_stages)
    est = sol.estimate
    return DeploymentPlan(
        model=model,
        platform=sol.platform.name,
        x=tuple(sol.config.x),
        d=1,
        z=tuple(sol.config.z),
        total_micro_batches=1,
        pipelined_sync=False,
        alpha=(1.0, 0.0),
        profile_fingerprint=profile_fingerprint(sol.profile, sol.platform),
        t_iter=est.t_request,
        c_iter=est.cost_per_request,
        objective=est.cost_per_request,
        solver="serve-grid",
        engine="serve",
        solve_seconds=sol.solve_seconds,
        merge_to=None,
        seq=spec.prefill_tokens,
        micro_batch=spec.batch,
        profile_source=getattr(sol.profile, "source", "analytic"),
        workload="serve",
        serving={
            **spec.as_dict(),
            "t_prefill": est.t_prefill,
            "t_token": est.t_token,
            "t_request": est.t_request,
            "cost_per_request": est.cost_per_request,
            "cost_per_1k": est.cost_per_1k,
            "kv_bytes": list(est.kv_bytes),
            "n_candidates": sol.n_candidates,
            "n_feasible": sol.n_feasible,
        },
    )
