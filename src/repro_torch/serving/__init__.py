"""Serverless inference serving on the port (``repro.serving``): the
SLO-aware planner (``workload="serve"`` deployment plans), pipelined
prefill + token-by-token decode over the emulated or the process backend's
object store, and the seeded autoscaling simulation of a plan across
replica counts."""
from repro_torch.serving.autoscale import (
    AutoscaleRow,
    autoscale_plan,
    bursty_arrivals,
    poisson_arrivals,
    simulate_replicas,
    trace_arrivals,
)
from repro_torch.serving.cost import (
    ServingEstimate,
    ServingSpec,
    arch_config_for_model,
    estimate_serving,
    kv_bytes_per_instance,
)
from repro_torch.serving.engine import (
    SERVE_BACKENDS,
    ServeResult,
    make_prompt,
    reference_decode,
    run_serve_plan,
    serve_worker_program,
)
from repro_torch.serving.planner import (
    InfeasibleSLOError,
    ServingSolution,
    plan_serving,
    solve_serving,
)
from repro_torch.serving.worker import ServeStageWorker, greedy_token

__all__ = [
    "AutoscaleRow",
    "InfeasibleSLOError",
    "SERVE_BACKENDS",
    "ServeResult",
    "ServeStageWorker",
    "ServingEstimate",
    "ServingSolution",
    "ServingSpec",
    "arch_config_for_model",
    "autoscale_plan",
    "bursty_arrivals",
    "estimate_serving",
    "greedy_token",
    "kv_bytes_per_instance",
    "make_prompt",
    "plan_serving",
    "poisson_arrivals",
    "reference_decode",
    "run_serve_plan",
    "serve_worker_program",
    "simulate_replicas",
    "solve_serving",
    "trace_arrivals",
]
