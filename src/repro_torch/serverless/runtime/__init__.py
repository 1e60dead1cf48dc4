"""The storage-backed serverless runtime (``repro.serverless.runtime``)."""
from repro_torch.serverless.runtime.engine import EngineResult, Execution, run_plan  # noqa: F401
