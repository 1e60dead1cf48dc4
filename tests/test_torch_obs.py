"""The port's span tracing (``repro_torch.obs``) against the live JAX package,
on the CPU.

The schema (``Span``, ``Trace``, ``validate_trace``) round-trips and crosses
packages: a Chrome trace saved by either package loads in the other, byte
for byte the same file.  Traced emulated runs give the JAX engine's spans
exactly (same spans, same order, equal floats) for timing-only plans on
both sync schedules at d 1, 2 and 4 and for a numeric fp32 plan, whose
params stay bit-identical to the untraced run's; ``pipeline_health`` and
``gap_attribution`` give the JAX functions' results exactly on the same
trace.  Tolerance: none (virtual clocks are exact).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.obs as jobs
from repro.configs.base import InputShape as JaxInputShape
from repro.core.perfmodel import Config as JaxConfig
from repro.core.profiler import arch_model_profile as jax_profile
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models import registry as jreg
from repro.optim import AdamW as JaxAdamW
from repro.serverless.execution import ExecutionConfig
from repro.serverless.platform import AWS_LAMBDA
from repro.serverless.runtime import Execution as JaxExecution
from repro.serverless.runtime import run_plan as jax_run_plan
from repro.serverless.simulator import simulate_funcpipe as jax_simulate_funcpipe

import repro_torch.obs as obs
from repro_torch.configs import get_config
from repro_torch.core.perfmodel import Config
from repro_torch.core.profiler import arch_model_profile
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import params_from_jax
from repro_torch.optim import AdamW
from repro_torch.serverless.platform import get_platform
from repro_torch.serverless.runtime import Execution, run_plan
from repro_torch.serverless.simulator import simulate_funcpipe

torch.backends.cuda.matmul.allow_tf32 = False
AWS = get_platform("aws")
PHI3 = "phi3-mini-3.8b"


def _cfgs(n_layers=4):
    return (dataclasses.replace(jconfigs.get_config(PHI3).reduced(), n_layers=n_layers),
            dataclasses.replace(get_config(PHI3).reduced(), n_layers=n_layers))


def _rows(spans):
    return [(s.stage, s.replica, s.step, s.phase, s.op, s.start, s.end, s.nbytes, s.key)
            for s in spans]


def _meta_but_names(meta):
    return {k: v for k, v in meta.items() if k not in ("model", "backend")}


def _to_port(jtrace):
    """A JAX ``Trace`` as the port's, through the shared payload."""
    return obs.Trace.from_payload(json.loads(json.dumps(jtrace.to_payload())))


# timing-only: 3 stages of phi3-mini-3.8b@reduced4 (test_timing_only_run_equals_jax_engine)
_X, _Z = (1, 0, 1, 0, 0), (0, 0, 1, 1, 2, 2)


def _timing_runs(d, pipelined, steps=3):
    jcfg, cfg = _cfgs()
    kw = dict(total_micro_batches=4 * d, pipelined_sync=pipelined)
    jres = jax_run_plan(jax_profile(jcfg, AWS_LAMBDA, seq=64, micro_batch=4), AWS_LAMBDA,
                        JaxConfig(x=_X, d=d, z=_Z),
                        exec_config=ExecutionConfig(steps=steps, trace=True), **kw)
    res = run_plan(arch_model_profile(cfg, AWS, seq=64, micro_batch=4), AWS,
                   Config(x=_X, d=d, z=_Z), steps=steps, trace=True, **kw)
    return res, jres


@pytest.fixture(scope="module")
def timing_d2():
    """The d 2, eq (2) timing-only run in both packages, with each package's
    simulator's predicted spans of the same plan (JAX's, then the port's)."""
    res, jres = _timing_runs(2, True)
    jcfg, cfg = _cfgs()
    jsim = jax_simulate_funcpipe(jax_profile(jcfg, AWS_LAMBDA, seq=64, micro_batch=4),
                                 AWS_LAMBDA, JaxConfig(x=_X, d=2, z=_Z), 8, trace=True)
    sim = simulate_funcpipe(arch_model_profile(cfg, AWS, seq=64, micro_batch=4), AWS,
                            Config(x=_X, d=2, z=_Z), 8, trace=True)
    return res, jres, jsim.trace.spans, sim.trace.spans


# ------------------------------------------------------------------ schema
def test_schema_constants_equal_jax():
    assert obs.PHASES == jobs.PHASES and obs.OPS == jobs.OPS
    assert obs.RESOURCE_OF == jobs.RESOURCE_OF
    assert obs.TRACE_SCHEMA_VERSION == jobs.schema.TRACE_SCHEMA_VERSION
    assert obs.ELAPSED == jobs.ELAPSED


@pytest.mark.parametrize("fields", [
    dict(stage=1, replica=2, step=0, phase="fwd", op="upload", start=1.0, end=2.5,
         nbytes=100.0, key="k0/r2/m0/act1"),
    dict(stage=0, replica=0, step=3, phase="bwd", op="compute", start=0.0, end=1.0),
    dict(stage=2, replica=1, step=1, phase="sync", op="barrier", start=0.25, end=0.5),
], ids=["upload", "compute", "barrier"])
def test_span_round_trips_and_matches_jax(fields):
    sp, jsp = obs.Span(**fields), jobs.Span(**fields)
    assert obs.Span.from_dict(sp.to_dict()) == sp
    assert sp.to_dict() == jsp.to_dict()
    assert (sp.worker, sp.duration, sp.resource) == (jsp.worker, jsp.duration, jsp.resource)


def test_recorder_stamps_step_and_phase():
    rec = obs.SpanRecorder()
    a, b = rec.tracer(0, 1), rec.tracer(1, 0)
    rec.set_step(2)
    rec.set_phase("bwd")
    a.emit("compute", 0.0, 1.0)
    b.emit("download", 1.0, 2.0, nbytes=8.0, key="k2/r0/m0/grad0")
    assert _rows(rec.spans) == [(0, 1, 2, "bwd", "compute", 0.0, 1.0, 0.0, None),
                                (1, 0, 2, "bwd", "download", 1.0, 2.0, 8.0, "k2/r0/m0/grad0")]


def test_trace_payload_round_trips(timing_d2):
    res, _, _, predicted = timing_d2
    tr = obs.Trace(spans=res.trace.spans, meta=res.trace.meta, predicted=predicted)
    back = obs.Trace.from_payload(json.loads(json.dumps(tr.to_payload())))
    assert back.spans == tr.spans and back.predicted == tr.predicted and back.meta == tr.meta
    with pytest.raises(obs.TraceValidationError, match="schema version"):
        obs.Trace.from_payload({"version": 99})


def test_chrome_trace_crosses_packages(timing_d2, tmp_path):
    """A JAX-saved Chrome trace (with predicted spans) loads in the port with
    equal spans, predicted spans and meta, and the port writes the same
    file; a port-saved trace loads and validates in JAX."""
    res, jres, predicted, _ = timing_d2
    jtr = jobs.Trace(spans=jres.trace.spans, meta=jres.trace.meta, predicted=predicted)
    jtr.save(tmp_path / "jax.json")
    tr = obs.Trace.load(tmp_path / "jax.json")
    assert _rows(tr.spans) == _rows(jtr.spans)
    assert _rows(tr.predicted) == _rows(jtr.predicted)
    assert tr.meta == json.loads(json.dumps(jtr.meta))
    tr.save(tmp_path / "port.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    doc = json.loads((tmp_path / "port.json").read_text())
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert len(xs) == len(tr.spans) + len(tr.predicted) and all(e["dur"] >= 0 for e in xs)

    res.trace.save(tmp_path / "port_run.json")
    back = jobs.Trace.load(tmp_path / "port_run.json")
    jobs.validate_trace(back)
    assert _rows(back.spans) == _rows(res.trace.spans)
    assert back.meta == json.loads(json.dumps(res.trace.meta))


def test_port_trace_with_device_intervals_loads_in_jax(timing_d2, tmp_path):
    """A wall-clock compute span's device interval rides in the port's file
    as two more span keys, which JAX's ``Trace.load`` passes over: its spans
    are the port's without them."""
    res = timing_d2[0]
    spans = [dataclasses.replace(sp, device_start=sp.start + 0.5, device_end=sp.end + 0.5)
             if sp.op == "compute" else sp for sp in res.trace.spans]
    obs.Trace(spans=spans, meta=res.trace.meta).save(tmp_path / "port.json")
    assert obs.Trace.load(tmp_path / "port.json").spans == spans
    back = jobs.Trace.load(tmp_path / "port.json")
    jobs.validate_trace(back)
    assert _rows(back.spans) == _rows(res.trace.spans)


def _outcome(mod, spans, meta=None):
    tr = mod.Trace(spans=[mod.Span(**d) for d in spans], meta=meta or {})
    try:
        mod.validate_trace(tr)
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return type(e).__name__, str(e)
    return None


def _sp(phase, op, start, end, step=0, **kw):
    return dict(stage=0, replica=0, step=step, phase=phase, op=op, start=start, end=end, **kw)


_VALIDATION_CASES = {
    # tests/test_obs.py:108-122
    "overlap": [_sp("fwd", "compute", 0.0, 2.0), _sp("fwd", "compute", 1.0, 3.0)],
    "bwd_before_fwd_ends": [_sp("bwd", "compute", 0.0, 1.0), _sp("fwd", "compute", 2.0, 3.0)],
    "sync_upload_before_bwd_ends": [_sp("bwd", "compute", 0.0, 2.0),
                                    _sp("sync", "upload", 1.0, 3.0, nbytes=4.0)],
    "sync_download_may_prefetch": [_sp("bwd", "compute", 0.0, 2.0),
                                   _sp("sync", "download", 1.0, 3.0, nbytes=4.0)],
    "unknown_phase": [_sp("warmup", "barrier", 0.0, 1.0)],
    "unknown_op": [_sp("fwd", "teleport", 0.0, 1.0)],
    "negative_nbytes": [_sp("fwd", "upload", 0.0, 1.0, nbytes=-1.0)],
    "end_before_start": [_sp("fwd", "compute", 2.0, 1.0)],
    "nan": [_sp("fwd", "compute", float("nan"), 1.0)],
    "barriers_are_exempt": [_sp("fwd", "compute", 0.0, 2.0), _sp("bwd", "barrier", 1.0, 2.5),
                            _sp("bwd", "compute", 2.0, 3.0)],
    "replay_after_restart": [_sp("fwd", "compute", 0.0, 1.0), _sp("bwd", "compute", 1.0, 2.0),
                             _sp("fwd", "restart", 2.0, 3.0), _sp("fwd", "compute", 3.0, 4.0)],
    "valid": [_sp("fwd", "download", 0.0, 1.0, nbytes=8.0, key="k"),
              _sp("fwd", "compute", 1.0, 2.0), _sp("bwd", "compute", 2.0, 3.0),
              _sp("sync", "upload", 3.0, 4.0, nbytes=2.0)],
}


@pytest.mark.parametrize("case", sorted(_VALIDATION_CASES))
def test_validate_trace_rules_equal_jax(case):
    """Each case is accepted or rejected as JAX's validate_trace does it,
    with the same error type and message."""
    spans = _VALIDATION_CASES[case]
    got, want = _outcome(obs, spans), _outcome(jobs, spans)
    assert got == want
    if case in ("overlap", "bwd_before_fwd_ends", "sync_upload_before_bwd_ends"):
        assert got is not None and got[0] == "TraceValidationError"
    if case in ("valid", "sync_download_may_prefetch", "barriers_are_exempt",
                "replay_after_restart"):
        assert got is None


def test_calibration_names_raise_naming_item_3b():
    """Calibration is ported (item 3b): ``repro_torch.obs`` exports the same
    names as ``repro.obs``, from ``repro_torch.obs.calibrate``; an unknown
    name is still an AttributeError."""
    from repro_torch.obs import calibrate

    names = ("Calibration", "PerfModelWarning", "ReplanReport", "StageObservation",
             "calibrate_profile", "calibrate_trace", "observe_stages", "replan",
             "stage_prediction_errors")
    assert set(names) <= set(obs.__all__) and set(names) <= set(jobs.__all__)
    assert all(getattr(obs, n) is getattr(calibrate, n) for n in names)
    with pytest.raises(AttributeError):
        obs.no_such_name


# ----------------------------------------------------- emulated training
@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("pipelined", [True, False], ids=["eq2", "eq1"])
def test_emulated_timing_trace_equals_jax(d, pipelined):
    """Spans (all fields, in order) and meta exactly equal to the JAX
    engine's, the model's and backend's names aside; each step's last span
    ends at its ``step_ends`` entry."""
    res, jres = _timing_runs(d, pipelined)
    tr, jtr = res.trace, jres.trace
    assert len(tr.spans) > 0 and _rows(tr.spans) == _rows(jtr.spans)
    assert _meta_but_names(tr.meta) == _meta_but_names(jtr.meta)
    assert tr.meta["backend"] == "emulated" and tr.meta["clock"] == "virtual"
    obs.validate_trace(tr)
    for k, end in enumerate(tr.meta["step_ends"]):
        assert max(s.end for s in tr.spans if s.step == k) == end
    assert {s.worker for s in tr.spans} == {f"s{s}r{r}" for s in range(3) for r in range(d)}


@pytest.fixture(scope="module")
def numeric_runs():
    """tests/test_torch_training.py's two-step fp32 plan (phi3@reduced, 4
    layers, 2 stages x 2 replicas, mu 2, AdamW(1e-2)) traced on the JAX
    engine and on the port, and untraced on the port."""
    jcfg, cfg = _cfgs()
    B, S, d, mu, steps = 8, 16, 2, 2, 2
    L = cfg.n_layers + 2
    x = tuple(1 if i == 2 else 0 for i in range(L - 1))
    params0 = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    batches = [jax_make_batch(jcfg, JaxInputShape("emu", S, B, "train"), step=k)
               for k in range(steps)]
    jres = jax_run_plan(
        jax_profile(jcfg, AWS_LAMBDA, seq=S, micro_batch=B // (d * mu)), AWS_LAMBDA,
        JaxConfig(x=x, d=d, z=(0,) * L), total_micro_batches=d * mu,
        exec_config=ExecutionConfig(steps=steps, trace=True),
        execution=JaxExecution(cfg=jcfg, optimizer=JaxAdamW(lr=1e-2), init_params=params0,
                               batch_fn=lambda k: batches[k]))
    tb = [{k: torch.from_numpy(np.array(v)) for k, v in b.items()} for b in batches]
    params = params_from_jax(jax.tree.map(np.asarray, params0), device="cpu")

    def port(trace):
        return run_plan(arch_model_profile(cfg, AWS, seq=S, micro_batch=B // (d * mu)), AWS,
                        Config(x=x, d=d, z=(0,) * L), total_micro_batches=d * mu, steps=steps,
                        trace=trace,
                        execution=Execution(cfg=cfg, optimizer=AdamW(lr=1e-2),
                                            init_params=params, batch_fn=lambda k: tb[k],
                                            device="cpu"))
    return port(True), port(False), jres


def test_emulated_numeric_trace_equals_jax(numeric_runs):
    traced, untraced, jres = numeric_runs
    assert _rows(traced.trace.spans) == _rows(jres.trace.spans)
    assert _meta_but_names(traced.trace.meta) == _meta_but_names(jres.trace.meta)
    assert untraced.trace is None


def test_tracing_changes_no_numerics(numeric_runs):
    """Traced and untraced runs: equal losses, bit-identical params."""
    traced, untraced, _ = numeric_runs
    assert traced.losses == untraced.losses
    for a, b in zip(tree_leaves(traced.params), tree_leaves(untraced.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------- metrics
def test_pipeline_health_equals_jax(timing_d2):
    res, jres, _, _ = timing_d2
    assert obs.pipeline_health(res.trace) == jobs.pipeline_health(jres.trace)
    h = obs.pipeline_health(_to_port(jres.trace))
    assert h == jobs.pipeline_health(jres.trace)
    assert h["reconciliation"]["ok"] and all("up_bw_util" in row for row in h["stages"])


def test_gap_attribution_equals_jax(timing_d2):
    """The port's trace against the port's own simulator's predicted spans,
    JAX's against JAX's: equal predicted spans, and the same rows in the
    same order, exactly."""
    res, jres, jpredicted, predicted = timing_d2
    assert [s.to_dict() for s in predicted] == [s.to_dict() for s in jpredicted]
    rows = obs.gap_attribution(res.trace, predicted=predicted)
    jrows = jobs.gap_attribution(jres.trace, predicted=jpredicted)
    assert [dataclasses.astuple(r) for r in rows] == [dataclasses.astuple(r) for r in jrows]
    assert [(r.gap_s, r.rel_err) for r in rows] == [(r.gap_s, r.rel_err) for r in jrows]
    assert any(r.op == obs.ELAPSED for r in rows)
    with pytest.raises(ValueError, match="no predicted"):
        obs.gap_attribution(res.trace)
