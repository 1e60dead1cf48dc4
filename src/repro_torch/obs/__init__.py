"""Span-level tracing + metrics for the execution stack (``repro.obs`` for
the port).

One schema, two timelines here: the emulated backend's virtual-clock spans
and the ``local``/``process`` backends' wall-clock spans, exported as a
Perfetto-loadable Chrome trace, summarized into pipeline-health metrics and,
against the port's own simulator's predicted spans
(``serverless.simulator.simulate_funcpipe(..., trace=True)``), differenced
into a gap attribution.  Front doors: ``run_plan(..., trace=True)`` and
``run_serve_plan(..., trace=True)``.

Calibration (``repro.obs.calibrate``) is not ported yet: ROADMAP port queue
item 3b, and its names raise here.
"""
from repro_torch.obs.attribution import ELAPSED, GapRow, gap_attribution
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
]

_CALIBRATE = ("Calibration", "PerfModelWarning", "ReplanReport", "StageObservation",
              "calibrate_profile", "calibrate_trace", "observe_stages", "replan",
              "stage_prediction_errors")


def __getattr__(name: str):
    if name in _CALIBRATE:
        raise NotImplementedError(
            f"repro_torch.obs.{name}: calibration is not ported yet: ROADMAP port "
            "queue item 3b (calibration)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
