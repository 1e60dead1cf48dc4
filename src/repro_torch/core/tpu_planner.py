"""The paper's co-optimization on a fixed mesh of ranks
(``repro.core.tpu_planner`` in torch).

On serverless, FuncPipe jointly chooses (model partition, #replicas,
per-worker memory).  On a fixed mesh the same *joint* decision becomes
(pipeline stages S, tensor width tp = model/S, micro-batch count mu, remat
policy): S x tp trades pipeline bubble against tp-psum traffic; mu trades
bubble against activation memory; remat trades recompute FLOPs against
device memory.  The objective is the same weighted alpha1*cost + alpha2*time
with cost = ranks * t_step (rank-seconds are the mesh's "GB-seconds").

The evaluator is the analytic roofline (``launch.roofline``) with a per-rank
memory feasibility estimate; enumeration is exact.  The chip is an argument
(``launch.roofline.ChipSpec``): with ``V5E``, the JAX package's constants,
every result equals JAX's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from repro_torch.configs.base import MOE_FF, ArchConfig, InputShape
from repro_torch.core.plan import PipelinePlan, make_plan
from repro_torch.launch.roofline import V5E, ChipSpec, analytic_roofline

CHIP_SECOND_PRICE = 1.0   # relative cost unit


@dataclass(frozen=True)
class TpuPlanResult:
    plan: PipelinePlan
    t_step_est: float
    cost: float           # rank-seconds per step
    hbm_est: float
    objective: float
    note: str = ""


def _hbm_estimate(cfg: ArchConfig, shape: InputShape, plan: PipelinePlan) -> float:
    """Per-rank bytes: params + grads + ZeRO opt shard + pipeline activations."""
    P_BYTES = 2 if cfg.param_dtype == "bfloat16" else 4
    moe_params = 0.0
    if cfg.moe is not None:
        n_moe = sum(1 for i in range(cfg.n_layers) if cfg.layer_spec(i).ff == MOE_FF)
        moe_params = n_moe * cfg.moe.n_experts * 3 * cfg.d_model * cfg.moe.d_ff_expert
    dense = cfg.param_count() - moe_params
    params_chip = (dense / (plan.stages * plan.tensor)
                   + moe_params / (plan.stages * plan.tensor * plan.ep))
    weights = params_chip * P_BYTES
    grads = params_chip * 4.0
    opt = params_chip * 3 * 4.0 / plan.data  # master+m+v fp32, ZeRO-1
    if shape.kind != "train":
        grads = opt = 0.0
    B_local = max(1, shape.global_batch // (plan.pods * plan.data))
    mb = max(1, B_local // plan.microbatches)
    T = plan.microbatches + plan.stages - 1
    act_carry = mb * shape.seq_len * cfg.d_model * P_BYTES
    acts = act_carry * (T if plan.remat in ("tick", "layer") else T * 4)
    return weights + grads + opt + acts + 1e9  # +1GB working set


def solve(
    cfg: ArchConfig,
    shape: InputShape,
    *,
    alpha: Tuple[float, float] = (1.0, 1.0),
    data: int = 16,
    model: int = 16,
    pods: int = 1,
    chip: ChipSpec = V5E,
) -> List[TpuPlanResult]:
    """Enumerate (S, tp, mu, remat); return the plans whose memory estimate
    fits ``chip.hbm_bytes``, sorted by the objective (best first).  Respects
    period-alignment: stages must keep an integer number of period instances
    per stage (padding allowed but counted as wasted compute via the
    analytic flops of padded layers)."""
    a1, a2 = alpha
    out: List[TpuPlanResult] = []
    B_local = max(1, shape.global_batch // (pods * data))
    for stages in (1, 2, 4, 8, 16):
        if stages > model:
            continue
        tensor = model // stages
        # tp feasibility: head/ff divisibility (heads sliced whole)
        if tensor > 1 and cfg.n_heads % tensor and cfg.n_kv_heads % tensor:
            if cfg.n_heads % tensor:
                continue
        mus = sorted({1, min(stages, B_local), min(2 * stages, B_local),
                      min(4 * stages, B_local), B_local})
        for mu in mus:
            if mu < 1 or B_local % mu:
                continue
            for remat in ("tick", "none"):
                try:
                    plan = make_plan(cfg, shape, data=data, model=model,
                                     pods=pods, stages=stages, tensor=tensor,
                                     microbatches=mu, remat=remat)
                except ValueError:   # stages x tensor is not the model axis
                    continue
                hbm = _hbm_estimate(cfg, shape, plan)
                if hbm > chip.hbm_bytes:
                    continue
                r = analytic_roofline(cfg, shape, plan, chip=chip)
                # padded-layer waste: padded instances do real math
                pad_waste = (plan.n_instances * cfg.period_len) / max(1, cfg.n_layers)
                t = r.t_step_est * pad_waste
                chips = pods * data * model
                cost = chips * t * CHIP_SECOND_PRICE
                obj = a1 * cost + a2 * t
                out.append(TpuPlanResult(plan=plan, t_step_est=t, cost=cost,
                                         hbm_est=hbm, objective=obj))
    out.sort(key=lambda x: x.objective)
    return out
