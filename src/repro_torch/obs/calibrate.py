"""Closed-loop trace calibration: measured profiles drive re-planning
(``repro.obs.calibrate`` for the port).

A traced run (``run_plan(..., ExecutionConfig(trace=True))``; on the card a
traced ``process`` run with ``payload_true``, whose compute spans carry the
children's device intervals and whose upload spans carry the real bf16
boundary bytes) is folded back into the per-layer tables:

* **compute**: the observed mean per-micro-batch fwd/bwd compute of each
  stage (a span's device interval where it has one, else its interval)
  over the analytic ``stage_aggregates`` term gives one scale per
  (stage, direction), applied to every memory option of every layer in the
  stage; stages whose phase was never observed keep their analytic values.
* **boundary bytes**: with ``payload_true`` the boundary layers'
  ``out_bytes``/``grad_out_bytes`` are rescaled to the observed means.
* **bandwidth / sync**: the observed store bandwidth and per-step sync are
  compared with the model and reported as named :class:`PerfModelWarning`
  signatures, not folded in (they are platform terms).

The result is a measured :class:`~repro_torch.core.partition.ModelProfile`
(``source="measured"`` with a ``CalibrationMeta``, folded into its
fingerprint), before/after prediction-error tables and :func:`replan`,
which re-solves on the measured tables with the port's planner.  Every
number equals the JAX package's on the same trace.

Front doors: ``Session.emulate(...).calibrate().plan()`` and ``python -m
repro_torch calibrate trace.json`` (the trace file embeds its plan).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.partition import (
    CalibrationMeta,
    LayerProfile,
    ModelProfile,
    stages_of,
)
from repro_torch.core.perfmodel import Config, evaluate
from repro_torch.obs.schema import Span, Trace
from repro_torch.serverless.platform import MB, Platform
from repro_torch.serverless.simulator import stage_aggregates

_EPS = 1e-12


# ---------------------------------------------------------------- observation
@dataclass(frozen=True)
class StageObservation:
    """What one pipeline stage's spans actually measured (trace clock)."""

    stage: int
    n_fwd: int                          # fwd compute spans folded in
    n_bwd: int
    fwd_compute_s: Optional[float]      # mean per-micro-batch fwd compute
    bwd_compute_s: Optional[float]
    fwd_up_bytes: Optional[float]       # mean fwd boundary upload payload
    bwd_up_bytes: Optional[float]       # mean bwd boundary upload payload
    up_bw: Optional[float]              # effective uplink bytes/s (pipeline)
    dn_bw: Optional[float]              # effective downlink bytes/s


def _mean(vals: List[float]) -> Optional[float]:
    return float(np.mean(vals)) if vals else None


def _effective_bw(spans: List[Span], t_lat: float) -> Optional[float]:
    """Total bytes over total (duration - latency) across transfer spans."""
    xs = [(s.nbytes, s.duration) for s in spans if s.nbytes > 0]
    if not xs:
        return None
    nbytes = sum(b for b, _ in xs)
    busy = sum(max(t - t_lat, _EPS) for _, t in xs)
    return float(nbytes / max(busy, _EPS))


def default_warmup(trace: Trace) -> int:
    """Steps to drop before averaging: wall-clock runs pay JIT compilation
    (and OS scheduling cold-start) in step 0, so multi-step wall traces
    skip it; virtual clocks are exact from step 0."""
    meta = trace.meta
    steps = int(meta.get("steps", 1))
    return 1 if meta.get("clock") == "wall" and steps > 1 else 0


def _compute_s(span: Span) -> float:
    """A compute span's seconds: its device interval where it has one (a
    wall-clock span's host interval is only the launch), else its own."""
    dev = span.device_duration
    return span.duration if dev is None else dev


def observe_stages(trace: Trace, *,
                   warmup: Optional[int] = None) -> List[StageObservation]:
    """Reduce a trace's spans to per-stage observed quantities.

    ``warmup`` drops the first N steps from the averages (default:
    :func:`default_warmup`).  Recovery marks (``retry``/``restart``) and
    barriers are never folded in; replayed attempts of a recovered step
    contribute like any other sample."""
    meta = trace.meta
    if warmup is None:
        warmup = default_warmup(trace)
    t_lat = float(meta.get("t_lat", 0.0))
    S = int(meta.get("S", 1 + max((s.stage for s in trace.spans), default=0)))

    by_stage: Dict[int, List[Span]] = {s: [] for s in range(S)}
    for sp in trace.spans:
        if sp.step < warmup or sp.op in ("barrier", "retry", "restart"):
            continue
        by_stage.setdefault(sp.stage, []).append(sp)

    out = []
    for s in range(S):
        spans = by_stage.get(s, [])
        fwd_c = [_compute_s(x) for x in spans
                 if x.op == "compute" and x.phase == "fwd"]
        bwd_c = [_compute_s(x) for x in spans
                 if x.op == "compute" and x.phase == "bwd"]
        fwd_up = [x.nbytes for x in spans
                  if x.op == "upload" and x.phase == "fwd" and x.nbytes > 0]
        bwd_up = [x.nbytes for x in spans
                  if x.op == "upload" and x.phase == "bwd" and x.nbytes > 0]
        pipe = [x for x in spans if x.phase in ("fwd", "bwd")]
        out.append(StageObservation(
            stage=s, n_fwd=len(fwd_c), n_bwd=len(bwd_c),
            fwd_compute_s=_mean(fwd_c), bwd_compute_s=_mean(bwd_c),
            fwd_up_bytes=_mean(fwd_up), bwd_up_bytes=_mean(bwd_up),
            up_bw=_effective_bw([x for x in pipe if x.op == "upload"], t_lat),
            dn_bw=_effective_bw([x for x in pipe if x.op == "download"],
                                t_lat),
        ))
    return out


# ------------------------------------------------------------------- warnings
@dataclass(frozen=True)
class PerfModelWarning:
    """A named systematic gap-attribution signature — a candidate perf-model
    refinement, not a per-run fluke."""

    name: str                   # stable signature id (tests/docs key on it)
    message: str
    stages: Tuple[int, ...] = ()
    magnitude: float = 0.0      # signature-specific ratio (observed/modeled)

    def describe(self) -> str:
        st = f" stages={list(self.stages)}" if self.stages else ""
        return f"[{self.name}] {self.message}{st}"


def _detect_warnings(observations, agg, *, pipelined_sync: bool,
                     observed_sync: Optional[float],
                     predicted_sync: float, d: int,
                     tol: float = 0.25) -> List[PerfModelWarning]:
    warns: List[PerfModelWarning] = []

    unobserved = tuple(o.stage for o in observations
                       if o.fwd_compute_s is None or o.bwd_compute_s is None)
    if unobserved:
        warns.append(PerfModelWarning(
            name="unobserved-stages",
            message="no compute spans for some stages/phases; their "
                    "analytic table values were kept",
            stages=unobserved))

    scales = [(o.stage, o.fwd_compute_s / max(agg.t_fc[o.stage], _EPS))
              for o in observations if o.fwd_compute_s is not None]
    scales += [(o.stage, o.bwd_compute_s / max(agg.t_bc[o.stage], _EPS))
               for o in observations if o.bwd_compute_s is not None]
    if scales:
        vals = np.array([v for _, v in scales])
        med = float(np.median(vals))
        if np.all(vals > 1.0 + tol):
            warns.append(PerfModelWarning(
                name="compute-underestimate",
                message=f"analytic compute tables systematically "
                        f"underestimate observed stage compute "
                        f"(median x{med:.2f})",
                stages=tuple(sorted({s for s, _ in scales})),
                magnitude=med))
        elif np.all(vals < 1.0 - tol):
            warns.append(PerfModelWarning(
                name="compute-overestimate",
                message=f"analytic compute tables systematically "
                        f"overestimate observed stage compute "
                        f"(median x{med:.2f})",
                stages=tuple(sorted({s for s, _ in scales})),
                magnitude=med))

    bw_ratios = [(o.stage, bw / max(agg.w[o.stage], _EPS))
                 for o in observations
                 for bw in (o.up_bw, o.dn_bw) if bw is not None]
    if bw_ratios:
        med = float(np.median([v for _, v in bw_ratios]))
        if med < 1.0 - tol:
            warns.append(PerfModelWarning(
                name="bandwidth-shortfall",
                message=f"observed effective store bandwidth is x{med:.2f} "
                        "of the platform model's per-worker bandwidth "
                        "(store contention / serialization overhead the "
                        "bandwidth curve does not carry)",
                stages=tuple(sorted({s for s, _ in bw_ratios})),
                magnitude=med))

    if observed_sync is not None and d > 1 and predicted_sync > _EPS:
        ratio = observed_sync / predicted_sync
        eq = "eq2" if pipelined_sync else "eq1"
        if ratio > 1.0 + tol:
            warns.append(PerfModelWarning(
                name=f"{eq}-sync-underestimate",
                message=f"the {eq} closed-form sync time underestimates the "
                        f"observed per-chunk scatter-reduce collective "
                        f"(observed x{ratio:.2f} of predicted — per-chunk "
                        "latency and chunk serialization are not in the "
                        "closed form)",
                magnitude=ratio))
        elif ratio < 1.0 - tol:
            warns.append(PerfModelWarning(
                name=f"{eq}-sync-overestimate",
                message=f"the {eq} closed-form sync time overestimates the "
                        f"observed collective (observed x{ratio:.2f})",
                magnitude=ratio))
    return warns


# ------------------------------------------------------------------ residuals
def stage_prediction_errors(profile: ModelProfile, platform: Platform,
                            config: Config, total_micro_batches: int,
                            observations: List[StageObservation],
                            *, contention: bool = False) -> dict:
    """Per-stage relative errors of the model's ``stage_aggregates`` terms
    against observed values — the quantity calibration must shrink.  Rows
    carry one cell per observed quantity (fwd/bwd per-micro-batch compute,
    boundary upload bytes); ``max_rel_err`` is the headline."""
    agg = stage_aggregates(profile, platform, config, total_micro_batches,
                           contention=contention)
    rows = []
    worst = 0.0
    for o in observations:
        s = o.stage
        cells = {}
        pairs = [("t_fc", float(agg.t_fc[s]), o.fwd_compute_s),
                 ("t_bc", float(agg.t_bc[s]), o.bwd_compute_s)]
        if s < agg.S - 1:
            pairs.append(("out_b", float(agg.out_b[s]), o.fwd_up_bytes))
        if s > 0:
            pairs.append(("grad_b", float(agg.grad_b[s]), o.bwd_up_bytes))
        for name, pred, obs in pairs:
            if obs is None:
                continue
            err = abs(pred - obs) / max(abs(obs), _EPS)
            cells[name] = {"predicted": pred, "observed": obs,
                           "rel_err": err}
            worst = max(worst, err)
        rows.append({"stage": s, "cells": cells})
    return {"stages": rows, "max_rel_err": worst}


# ---------------------------------------------------------------- calibration
@dataclass
class Calibration:
    """A measured profile plus everything learned producing it."""

    profile: ModelProfile               # source="measured"
    observations: List[StageObservation]
    scales: List[dict]                  # per-stage applied scale factors
    warnings: List[PerfModelWarning]
    baseline: dict                      # stage_prediction_errors(analytic)
    residual: dict                      # stage_prediction_errors(measured)
    observed_sync: Optional[float]      # mean per-step sync makespan
    predicted_sync: float               # closed-form t_sync_max
    warmup: int
    meta: dict = field(default_factory=dict)   # trace meta echo (subset)

    def describe(self) -> str:
        lines = [
            f"calibration: {self.profile.name} from "
            f"{self.meta.get('backend', '?')} trace "
            f"({self.meta.get('clock', '?')} clock, "
            f"{self.meta.get('steps', '?')} steps, warmup {self.warmup})",
            "stage  fwd-scale  bwd-scale  out-scale  grad-scale",
        ]
        for row in self.scales:
            def cell(k):
                v = row.get(k)
                return "     -" if v is None else f"x{v:5.2f}"
            lines.append(f"{row['stage']:>5d}  {cell('fwd'):>9s}  "
                         f"{cell('bwd'):>9s}  {cell('out'):>9s}  "
                         f"{cell('grad'):>10s}")
        lines.append(
            f"prediction error (max per-stage rel err): analytic "
            f"{self.baseline['max_rel_err']:.1%} -> measured "
            f"{self.residual['max_rel_err']:.1%}")
        for w in self.warnings:
            lines.append(f"warning {w.describe()}")
        return "\n".join(lines)


def calibrate_profile(trace: Trace, profile: ModelProfile,
                      platform: Platform, config: Config,
                      total_micro_batches: int, *,
                      pipelined_sync: bool = True,
                      contention: bool = False,
                      warmup: Optional[int] = None) -> Calibration:
    """Fold a traced run back into a measured :class:`ModelProfile`.

    ``profile`` must be the (merged) profile the traced plan indexes —
    exactly what ``DeploymentPlan.resolve().profile`` returns.  Layers in
    stages whose phase was never observed keep their analytic values."""
    if profile.source != "analytic":
        raise ValueError(
            f"calibrating a {profile.source!r} profile would compound "
            "scale factors; calibrate from the analytic profile")
    if warmup is None:
        warmup = default_warmup(trace)
    observations = observe_stages(trace, warmup=warmup)
    agg = stage_aggregates(profile, platform, config, total_micro_batches,
                           contention=contention)
    if agg.S != len(observations):
        raise ValueError(f"trace has {len(observations)} stages but the "
                         f"plan's partition has {agg.S}")
    stages = stages_of(config.x)

    scale_rows: List[dict] = []
    fwd_scale = np.ones(agg.S)
    bwd_scale = np.ones(agg.S)
    out_scale = np.ones(agg.S)
    grad_scale = np.ones(agg.S)
    for o in observations:
        s = o.stage
        row = {"stage": s, "fwd": None, "bwd": None, "out": None,
               "grad": None}
        if o.fwd_compute_s is not None and agg.t_fc[s] > _EPS:
            fwd_scale[s] = o.fwd_compute_s / agg.t_fc[s]
            row["fwd"] = float(fwd_scale[s])
        if o.bwd_compute_s is not None and agg.t_bc[s] > _EPS:
            bwd_scale[s] = o.bwd_compute_s / agg.t_bc[s]
            row["bwd"] = float(bwd_scale[s])
        if s < agg.S - 1 and o.fwd_up_bytes is not None \
                and agg.out_b[s] > _EPS:
            out_scale[s] = o.fwd_up_bytes / agg.out_b[s]
            row["out"] = float(out_scale[s])
        if s > 0 and o.bwd_up_bytes is not None and agg.grad_b[s] > _EPS:
            grad_scale[s] = o.bwd_up_bytes / agg.grad_b[s]
            row["grad"] = float(grad_scale[s])
        scale_rows.append(row)

    layers: List[LayerProfile] = []
    for s, (lo, hi) in enumerate(stages):
        for i in range(lo, hi + 1):
            l = profile.layers[i]
            layers.append(dataclasses.replace(
                l,
                fwd_time=tuple(t * fwd_scale[s] for t in l.fwd_time),
                bwd_time=tuple(t * bwd_scale[s] for t in l.bwd_time),
                out_bytes=(l.out_bytes * out_scale[s]
                           if i == hi else l.out_bytes),
                grad_out_bytes=(l.grad_out_bytes * grad_scale[s]
                                if i == lo else l.grad_out_bytes),
            ))

    from repro_torch.api.plan import profile_fingerprint

    meta = trace.meta
    cal_meta = CalibrationMeta(
        backend=str(meta.get("backend", "?")),
        clock=str(meta.get("clock", "?")),
        steps=int(meta.get("steps", 1)),
        base_fingerprint=profile_fingerprint(profile, platform),
        t_total=float(meta.get("t_total", 0.0)),
    )
    measured = ModelProfile(name=profile.name, layers=tuple(layers),
                            source="measured", calibration=cal_meta)

    ev = evaluate(profile, platform, config, total_micro_batches,
                  pipelined_sync=pipelined_sync)
    step_syncs = [float(v) for v in meta.get("step_syncs", [])][warmup:]
    observed_sync = _mean(step_syncs)
    warns = _detect_warnings(observations, agg,
                             pipelined_sync=pipelined_sync,
                             observed_sync=observed_sync,
                             predicted_sync=float(ev.t_sync_max),
                             d=agg.d)
    baseline = stage_prediction_errors(profile, platform, config,
                                       total_micro_batches, observations,
                                       contention=contention)
    residual = stage_prediction_errors(measured, platform, config,
                                       total_micro_batches, observations,
                                       contention=contention)
    keep = ("model", "backend", "clock", "steps", "S", "d", "mu",
            "t_total", "t_iter", "payload_true", "throttle")
    return Calibration(
        profile=measured, observations=observations, scales=scale_rows,
        warnings=warns, baseline=baseline, residual=residual,
        observed_sync=observed_sync, predicted_sync=float(ev.t_sync_max),
        warmup=warmup, meta={k: meta[k] for k in keep if k in meta})


def calibrate_trace(trace: Trace, *, plan=None,
                    warmup: Optional[int] = None) -> Tuple["Calibration", object]:
    """Self-contained front door for ``python -m repro_torch calibrate``: a traced run whose
    metadata embeds its plan (every ``--trace`` file written since the
    calibration loop landed does) comes back as (Calibration, plan).  Pass
    ``plan`` explicitly for older traces."""
    from repro_torch.api.plan import DeploymentPlan

    if plan is None:
        doc = trace.meta.get("plan")
        if doc is None:
            raise ValueError(
                "trace metadata carries no plan document (older trace?) — "
                "pass the plan explicitly (python -m repro_torch calibrate --plan plan.json)")
        import json as _json

        plan = DeploymentPlan.from_json(_json.dumps(doc))
    rp = plan.resolve()
    cal = calibrate_profile(trace, rp.profile, rp.platform, rp.config,
                            rp.total_micro_batches,
                            pipelined_sync=rp.pipelined_sync, warmup=warmup)
    return cal, plan


# --------------------------------------------------------------------- replan
@dataclass
class ReplanReport:
    """The plan delta after re-solving on the measured tables."""

    old_plan: object                    # DeploymentPlan (analytic)
    new_plan: object                    # DeploymentPlan (measured)
    old_on_measured: object             # Evaluation of old config, measured
    new_on_measured: object             # Evaluation of new config, measured
    alpha: Tuple[float, float]

    def describe(self) -> str:
        from repro_torch.serverless.platform import get_platform

        old, new = self.old_plan, self.new_plan
        platform = get_platform(new.platform)
        a1, a2 = self.alpha

        def mems(plan):
            return [platform.memory_options[plan.z[lo]] // MB
                    for lo, _ in stages_of(plan.x)]

        obj_old = self.old_on_measured.objective(a1, a2)
        obj_new = self.new_on_measured.objective(a1, a2)
        delta = (obj_new - obj_old) / max(abs(obj_old), _EPS)
        changed = (tuple(old.x), old.d, tuple(old.z)) != \
                  (tuple(new.x), new.d, tuple(new.z))
        lines = [
            f"re-plan on the measured profile "
            f"({'changed' if changed else 'unchanged'} deployment):",
            f"  stages: {old.n_stages} -> {new.n_stages}   "
            f"d: {old.d} -> {new.d}   M: {old.total_micro_batches} -> "
            f"{new.total_micro_batches}",
            f"  mem/stage: {mems(old)}MB -> {mems(new)}MB",
            f"  analytic plan predicted t_iter={old.t_iter:.3f}s "
            f"cost=${old.c_iter:.6f}; the measured tables price that same "
            f"deployment at t_iter={self.old_on_measured.t_iter:.3f}s "
            f"cost=${self.old_on_measured.c_iter:.6f}",
            f"  re-planned deployment (measured): "
            f"t_iter={self.new_on_measured.t_iter:.3f}s "
            f"cost=${self.new_on_measured.c_iter:.6f} "
            f"(objective {obj_old:.6f} -> {obj_new:.6f}, "
            f"{delta:+.1%})",
        ]
        if not self.old_on_measured.mem_ok:
            lines.append("  note: the old deployment is memory-infeasible "
                         "under the measured tables")
        return "\n".join(lines)


def replan(calibration: Calibration, plan, *,
           alpha: Optional[Tuple[float, float]] = None,
           engine: str = "dp",
           d_options: Optional[Tuple[int, ...]] = None) -> ReplanReport:
    """Re-solve the co-optimization on the measured profile and report the
    delta.  The measured profile is already at the traced plan's merged
    depth, so the solve runs at ``merge_to=None``; ``engine='dp'`` (exact at
    any depth) is the default.  ``alpha`` defaults to the plan's recorded
    objective weights (manual/numeric plans record (1, 0) — pass the paper
    default explicitly when cost-only is not what you want)."""
    from repro_torch.api.plan import DeploymentPlan
    from repro_torch.core import planner
    from repro_torch.serverless.platform import get_platform

    measured = calibration.profile
    platform = get_platform(plan.platform)
    if alpha is None:
        alpha = plan.alpha
    kw = dict(alpha=tuple(alpha),
              total_micro_batches=plan.total_micro_batches,
              merge_to=None, pipelined_sync=plan.pipelined_sync)
    if d_options is not None:
        kw["d_options"] = tuple(d_options)
    r = planner.solve(measured, platform, engine=engine, **kw)
    if r is None:
        raise RuntimeError(
            f"no feasible plan for the measured profile of {plan.model!r} "
            f"on {platform.name} at M={plan.total_micro_batches}")
    new_plan = DeploymentPlan.from_result(
        r, model=plan.model, platform=platform, alpha=tuple(alpha),
        total_micro_batches=plan.total_micro_batches,
        pipelined_sync=plan.pipelined_sync, solver="cd", engine=engine,
        merge_to=None, seq=plan.seq, micro_batch=plan.micro_batch)
    old_ev = evaluate(measured, platform, plan.config,
                      plan.total_micro_batches,
                      pipelined_sync=plan.pipelined_sync)
    return ReplanReport(old_plan=plan, new_plan=new_plan,
                        old_on_measured=old_ev,
                        new_on_measured=r.evaluation, alpha=tuple(alpha))
