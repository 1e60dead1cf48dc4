"""Unified deployment API (``repro.api`` for the port): one typed front
door over the profile -> co-optimize -> simulate/emulate -> calibrate
pipeline (paper workflow ①-⑤).

    from repro_torch.api import session, DeploymentPlan

    s = session("bert-large", platform="aws").profile().plan(merge_to=14)
    s.save_plan("plan.json").simulate().emulate(steps=2)

    plan = DeploymentPlan.load("plan.json")   # later, or in the JAX package
    plan.simulate(); plan.emulate(steps=2)

The CLI counterpart is ``python -m repro_torch`` (``repro_torch.cli``).
"""
from repro_torch.api.plan import (
    DeploymentPlan,
    PlanCompatibilityError,
    ResolvedPlan,
    profile_fingerprint,
)
from repro_torch.api.plan_cache import PlanCache, resolve_plan_cache
from repro_torch.api.session import (
    DEFAULT_ALPHA,
    InfeasiblePlanError,
    Session,
    session,
)
from repro_torch.serverless.execution import ExecutionConfig

__all__ = [
    "DeploymentPlan",
    "ExecutionConfig",
    "InfeasiblePlanError",
    "PlanCache",
    "PlanCompatibilityError",
    "ResolvedPlan",
    "profile_fingerprint",
    "resolve_plan_cache",
    "Session",
    "session",
    "DEFAULT_ALPHA",
]
