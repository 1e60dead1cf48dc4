"""Span-level tracing + metrics for the execution stack (``repro.obs`` for
the port).

One schema, two timelines here: the emulated backend's virtual-clock spans
and the ``local``/``process`` backends' wall-clock spans, exported as a
Perfetto-loadable Chrome trace, summarized into pipeline-health metrics and,
against the port's own simulator's predicted spans
(``serverless.simulator.simulate_funcpipe(..., trace=True)``), differenced
into a gap attribution.  Front doors: ``run_plan(..., trace=True)``,
``run_serve_plan(..., trace=True)``, ``Session.emulate(trace=True)`` and
``python -m repro_torch emulate --trace`` / ``inspect``.

``repro_torch.obs.calibrate`` closes the loop: it folds a traced run back
into a measured ``ModelProfile`` and re-plans on it
(``Session.emulate(...).calibrate().plan()``, ``python -m repro_torch
calibrate trace.json``).
"""
from repro_torch.obs.attribution import ELAPSED, GapRow, gap_attribution
from repro_torch.obs.calibrate import (
    Calibration,
    PerfModelWarning,
    ReplanReport,
    StageObservation,
    calibrate_profile,
    calibrate_trace,
    observe_stages,
    replan,
    stage_prediction_errors,
)
from repro_torch.obs.metrics import pipeline_health
from repro_torch.obs.schema import (
    OPS,
    PHASES,
    RESOURCE_OF,
    TRACE_SCHEMA_VERSION,
    Span,
    SpanRecorder,
    Trace,
    TraceValidationError,
    WorkerTracer,
    validate_trace,
)

__all__ = [
    "ELAPSED", "GapRow", "gap_attribution", "pipeline_health",
    "OPS", "PHASES", "RESOURCE_OF", "TRACE_SCHEMA_VERSION", "Span", "SpanRecorder",
    "Trace", "TraceValidationError", "WorkerTracer", "validate_trace",
    "Calibration", "PerfModelWarning", "ReplanReport", "StageObservation",
    "calibrate_profile", "calibrate_trace", "observe_stages", "replan",
    "stage_prediction_errors",
]
