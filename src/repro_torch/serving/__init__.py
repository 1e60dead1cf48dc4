"""Serverless inference serving on the port: pipelined prefill +
token-by-token decode over the emulated or the process backend's object
store (``repro.serving``).
The SLO planner and the autoscaler are not ported yet (ROADMAP port queue
item 4)."""
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
from repro_torch.serving.worker import ServeStageWorker, greedy_token

__all__ = [
    "SERVE_BACKENDS",
    "ServeResult",
    "ServeStageWorker",
    "ServingEstimate",
    "ServingSpec",
    "arch_config_for_model",
    "estimate_serving",
    "greedy_token",
    "kv_bytes_per_instance",
    "make_prompt",
    "reference_decode",
    "run_serve_plan",
    "serve_worker_program",
]
