"""Predicted-vs-observed gap attribution (``repro.obs.attribution`` for the
port).

The ROADMAP's accuracy targets (the ~4% engine-vs-simulator gap, the 31%
``max_model_rel_err``) are single scalars; this module localizes them.  Both
the engine trace (observed) and ``serverless.simulator.simulate_funcpipe(
trace=True)`` (predicted) speak the same span schema, so the per-(stage,
phase, op) busy totals can be differenced directly:

* **op cells** — observed busy seconds summed per (stage, phase, op) and
  normalized per replica-step (the predicted timeline is one step of one
  replica), against the predicted cell sum.  A large ``download`` gap on one
  stage means the cost model's boundary-transfer term is off *there*.
* **elapsed cells** (``op="(elapsed)"``) — the phase's makespan per (stage,
  phase): observed ``max(end) - min(start)`` averaged over (replica, step)
  vs the predicted extent.  Busy sums can match while the *placement* drifts
  (serialization the simulator missed); elapsed catches that.  The sync
  phase is compared on elapsed only: observed sync is per-chunk transfers,
  predicted sync is one closed-form interval.

Rows are ranked by absolute gap — the top row is where the simulator and
the runtime disagree most, i.e. where the roofline/1F1B work should look
first.  On wall-clock traces the comparison crosses clocks (host seconds vs
modeled seconds).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.schema import Span, Trace

ELAPSED = "(elapsed)"


@dataclass(frozen=True)
class GapRow:
    """One (stage, phase, op) attribution cell, per replica-step seconds."""

    stage: int
    phase: str
    op: str                    # an op name, or "(elapsed)" for phase makespan
    observed_s: float
    predicted_s: float

    @property
    def gap_s(self) -> float:
        return self.observed_s - self.predicted_s

    @property
    def rel_err(self) -> float:
        return self.gap_s / max(self.predicted_s, 1e-12)


def _busy_cells(spans: List[Span]) -> Dict[Tuple[int, str, str], float]:
    cells: Dict[Tuple[int, str, str], float] = {}
    for s in spans:
        if s.op == "barrier":
            continue
        k = (s.stage, s.phase, s.op)
        cells[k] = cells.get(k, 0.0) + s.duration
    return cells


def _elapsed_cells(spans: List[Span]) -> Dict[Tuple[int, str], float]:
    """Phase makespan per (stage, phase), averaged over (replica, step)."""
    extent: Dict[tuple, Tuple[float, float]] = {}
    for s in spans:
        if s.op == "barrier":
            continue
        k = (s.stage, s.phase, s.replica, s.step)
        lo, hi = extent.get(k, (s.start, s.end))
        extent[k] = (min(lo, s.start), max(hi, s.end))
    agg: Dict[Tuple[int, str], List[float]] = {}
    for (stage, phase, _r, _k), (lo, hi) in extent.items():
        agg.setdefault((stage, phase), []).append(hi - lo)
    return {k: sum(v) / len(v) for k, v in agg.items()}


def gap_attribution(trace: Trace,
                    predicted: Optional[List[Span]] = None) -> List[GapRow]:
    """Attribution rows, most divergent (by ``|gap_s|``) first.

    ``predicted`` defaults to ``trace.predicted``; raises ``ValueError``
    when the trace carries no predicted timeline to difference against."""
    if predicted is None:
        predicted = trace.predicted
    if not predicted:
        raise ValueError(
            "trace has no predicted spans: load a trace that carries the "
            "simulator's timeline or pass predicted= explicitly")
    meta = trace.meta
    steps = int(meta.get("steps", 1))
    d = int(meta.get("d", 1 + max((s.replica for s in trace.spans),
                                  default=0)))
    norm = max(1, steps) * max(1, d)   # predicted = 1 step of 1 replica

    rows: List[GapRow] = []
    obs = _busy_cells(trace.spans)
    pred = _busy_cells(predicted)
    for (stage, phase, op) in sorted(set(obs) | set(pred)):
        if phase == "sync":
            continue           # per-chunk vs closed-form: elapsed-only below
        rows.append(GapRow(stage=stage, phase=phase, op=op,
                           observed_s=obs.get((stage, phase, op), 0.0) / norm,
                           predicted_s=pred.get((stage, phase, op), 0.0)))

    obs_el = _elapsed_cells(trace.spans)
    pred_el = _elapsed_cells(predicted)
    for (stage, phase) in sorted(set(obs_el) | set(pred_el)):
        rows.append(GapRow(stage=stage, phase=phase, op=ELAPSED,
                           observed_s=obs_el.get((stage, phase), 0.0),
                           predicted_s=pred_el.get((stage, phase), 0.0)))

    rows.sort(key=lambda r: (-abs(r.gap_s), r.stage, r.phase, r.op))
    return rows
