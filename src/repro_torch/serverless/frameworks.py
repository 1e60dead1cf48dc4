"""The evaluated training designs (§5.1 baselines + FuncPipe itself), each a
resource-allocation policy over the simulator (``repro.serverless.frameworks``
for the port, copied exactly).

  LambdaML     — pure DP; max memory per worker, max local batch in memory.
  HybridPS     — DP with a parameter-server VM for synchronization.
  LambdaML-GA / HybridPS-GA — gradient accumulation (micro-batch 1) with the
                 minimum feasible memory per worker.
  FuncPipe     — pipeline plan from the MIQP co-optimizer (core.planner).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.partition import ModelProfile
from repro_torch.core import planner
from repro_torch.serverless.platform import Platform
from repro_torch.serverless.simulator import SimResult, simulate_data_parallel, simulate_funcpipe


def _max_local_batch(profile, platform, mem, micro_batch, n_workers) -> int:
    arr = profile.arrays()
    per_mb_act = arr["a"].sum()  # bytes per micro-batch
    sync_f = 4 if n_workers > 1 else 2
    budget = mem - arr["s"].sum() * sync_f - platform.base_memory
    if budget <= 0:
        return 0
    n_mb = int(budget // per_mb_act)
    return n_mb * micro_batch


def lambda_ml(
    profile: ModelProfile,
    platform: Platform,
    global_batch: int,
    *,
    micro_batch: int = 4,
    sync: str = "scatter_reduce",
    grad_accum: bool = False,
    contention: bool = False,
    ps: bool = False,
) -> Optional[SimResult]:
    """LambdaML policy: max memory, max local batch -> fewest workers."""
    J = len(platform.memory_options)
    if grad_accum:
        # min memory that fits ONE micro-batch of size 1
        arr = profile.arrays()
        per_sample_act = arr["a"].sum() / micro_batch
        for j in range(J):
            mem = platform.memory_options[j]
            if per_sample_act + arr["s"].sum() * 4 + platform.base_memory <= mem:
                break
        else:
            return None
        # same worker count as non-GA LambdaML for comparability (paper §5.1)
        base = lambda_ml(profile, platform, global_batch, micro_batch=micro_batch,
                         sync=sync, contention=contention, ps=ps)
        if base is None:
            return None
        n_workers = base.n_workers
        return simulate_data_parallel(
            profile, platform, n_workers=n_workers, mem_index=j,
            samples_per_worker=global_batch // n_workers, micro_batch=1,
            sync="ps" if ps else sync, grad_accum=True, contention=contention,
        )
    j = J - 1
    mem = platform.memory_options[j]
    local = _max_local_batch(profile, platform, mem, micro_batch, n_workers=2)
    if local <= 0:
        return None
    local = min(local, global_batch)
    n_workers = max(1, -(-global_batch // local))
    local = global_batch // n_workers
    return simulate_data_parallel(
        profile, platform, n_workers=n_workers, mem_index=j,
        samples_per_worker=local, micro_batch=micro_batch,
        sync="ps" if ps else sync, contention=contention,
    )


def hybrid_ps(profile, platform, global_batch, *, micro_batch: int = 4,
              grad_accum: bool = False, contention: bool = False):
    return lambda_ml(profile, platform, global_batch, micro_batch=micro_batch,
                     grad_accum=grad_accum, contention=contention, ps=True)


@dataclass(frozen=True)
class FuncPipeResult:
    plans: List[planner.PlanResult]
    sims: List[SimResult]
    recommended: int  # index into plans/sims
    deployment_plans: Optional[List] = None  # DeploymentPlans when replayed
    engine_results: Optional[List] = None    # EngineResults when executed

    @property
    def recommended_sim(self) -> SimResult:
        return self.sims[self.recommended]


# the paper's four weight pairs (§5.1); scaled: cost in $, time in s
ALPHA_PAIRS: Tuple[Tuple[float, float], ...] = (
    (1.0, 0.0),
    (1.0, 2**16 * 1e-9),
    (1.0, 2**19 * 1e-9),
    (1.0, 2**22 * 1e-9),
)


def funcpipe_replay(
    deployment_plans: Sequence,
    *,
    contention: bool = False,
    backend: Optional[str] = None,
    engine_steps: int = 1,
) -> Optional[FuncPipeResult]:
    """The FuncPipe policy over saved :class:`repro_torch.api.plan.DeploymentPlan`
    artifacts — no solver run.  Each plan is resolved (fingerprint-checked
    against its recorded model/platform), identical configs are deduped,
    then simulated under this call's ``contention`` setting and fed through
    the same §5.1 recommendation as :func:`funcpipe`.

    With ``backend`` set (``"emulated"``, ``"local"``, or any registered
    execution backend), every kept plan is additionally *executed* through
    the storage-backed engine on that backend for ``engine_steps`` steps
    (timing axis), and the per-plan ``EngineResult``s ride along on
    ``FuncPipeResult.engine_results``."""
    from repro_torch.core.perfmodel import evaluate

    uniq, sims, kept = [], [], []
    engine_results: Optional[List] = [] if backend is not None else None
    seen = set()
    for p in deployment_plans:
        key = (p.x, p.d, p.z)       # dedupe before the profile rebuild
        if key in seen:
            continue
        seen.add(key)
        rp = p.resolve()
        ev = evaluate(rp.profile, rp.platform, rp.config,
                      rp.total_micro_batches,
                      pipelined_sync=rp.pipelined_sync)
        uniq.append(planner.PlanResult(
            rp.config, ev, ev.objective(*p.alpha), p.solve_seconds,
            rp.profile))
        sims.append(simulate_funcpipe(
            rp.profile, rp.platform, rp.config, rp.total_micro_batches,
            pipelined_sync=rp.pipelined_sync, contention=contention))
        if engine_results is not None:
            from repro_torch.serverless.runtime import run_plan

            # the legacy keywords carry what ExecutionConfig(steps=,
            # backend=) does in the JAX package (item 5 ports the config)
            engine_results.append(run_plan(
                rp.profile, rp.platform, rp.config, rp.total_micro_batches,
                steps=engine_steps, backend=backend,
                pipelined_sync=rp.pipelined_sync, contention=contention))
        kept.append(p)
    if not uniq:
        return None
    rec = uniq.index(planner.recommend(uniq))
    return FuncPipeResult(plans=uniq, sims=sims, recommended=rec,
                          deployment_plans=kept,
                          engine_results=engine_results)


def funcpipe(
    profile: ModelProfile,
    platform: Platform,
    global_batch: int,
    *,
    micro_batch: int = 4,
    alphas: Sequence[Tuple[float, float]] = ALPHA_PAIRS,
    merge_to: int = 8,
    pipelined_sync: bool = True,
    contention: bool = False,
    d_options: Sequence[int] = planner.DEFAULT_D_OPTIONS,
) -> Optional[FuncPipeResult]:
    """FuncPipe policy: co-optimized plans across the objective weights.

    To replay saved DeploymentPlans instead of solving, use
    :func:`funcpipe_replay`."""
    M = max(1, global_batch // micro_batch)
    plans = []
    for alpha in alphas:
        r = planner.solve(profile, platform, alpha=alpha, total_micro_batches=M,
                          merge_to=merge_to, pipelined_sync=pipelined_sync,
                          d_options=d_options)
        if r is not None:
            plans.append(r)
    if not plans:
        return None
    # dedupe identical configs
    uniq = []
    seen = set()
    for r in plans:
        key = (r.config.x, r.config.d, r.config.z)
        if key not in seen:
            seen.add(key)
            uniq.append(r)
    sims = [
        simulate_funcpipe(r.profile, platform, r.config, M,
                          pipelined_sync=pipelined_sync, contention=contention)
        for r in uniq
    ]
    rec_plan = planner.recommend(uniq)
    rec = uniq.index(rec_plan)
    return FuncPipeResult(plans=uniq, sims=sims, recommended=rec)
