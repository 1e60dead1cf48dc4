"""The port's front door (``repro_torch.api``: ``Session``, ``PlanCache``,
``DeploymentPlan.emulate``; ``python -m repro_torch``) and calibration
(``repro_torch.obs.calibrate``) against the live JAX package, on the CPU.

Calibration reads a trace as ``repro.obs.calibrate`` does: on an emulated
trace from each package and on a saved wall-clock trace (the port's traced
``local`` run, loaded into both packages) ``observe_stages``,
``calibrate_profile``, ``stage_prediction_errors``, the named warnings and
``replan`` give exactly JAX's numbers, and the measured profile and the
re-planned plan have JAX's JSON and fingerprint.  ``Session(...).plan()
.emulate(trace=True).calibrate().plan()`` follows JAX's chain step for
step; ``PlanCache`` keys and files are JAX's and each package reads the
other's entries.  The CLI's ``plan``, ``simulate``, ``emulate``,
``calibrate`` and ``inspect`` write the files and print the reports
``repro.cli.main`` does; ``train``, ``dryrun`` and ``bench`` raise naming
item 7.  A subprocess shows that the CLI and a chaos run on ``process``
import neither ``jax`` nor ``repro``.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.api import ExecutionConfig as JaxExecutionConfig
from repro.api import PlanCache as JaxPlanCache
from repro.api import session as jax_session
from repro.api.plan import DeploymentPlan as JaxPlan
from repro.api.plan import profile_fingerprint as jax_fingerprint
from repro.cli import main as jax_cli
from repro.core.partition import ModelProfile as JaxModelProfile
from repro.obs import Trace as JaxTrace
from repro.obs import calibrate as jcal

from repro_torch.api import (
    DeploymentPlan,
    ExecutionConfig,
    PlanCache,
    PlanCompatibilityError,
    profile_fingerprint,
    session,
)
from repro_torch.cli import main as cli
from repro_torch.core.partition import ModelProfile
from repro_torch.launch import emulate as launch_emulate
from repro_torch.obs import Trace, validate_trace
from repro_torch.obs import calibrate as cal

REPO = Path(__file__).resolve().parents[1]
ALPHA = (1.0, 2**16 * 1e-9)
FAST = dict(merge_to=6, d_options=(1, 2, 4))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's CPU training runs (the spawned
    children inherit it): the suite runs several workers on the host's
    cores, and torch pools of a thread a core each starve one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan_json(plan) -> dict:
    """A plan's document with the solve's wall clock set aside."""
    d = json.loads(plan.to_json())
    d["solve_seconds"] = 0.0
    return d


def _calibration_doc(c) -> dict:
    """Every number a Calibration carries, JSON-comparable."""
    return json.loads(json.dumps({
        "profile": json.loads(c.profile.to_json()),
        "observations": [dataclasses.asdict(o) for o in c.observations],
        "scales": c.scales, "warnings": [dataclasses.asdict(w) for w in c.warnings],
        "baseline": c.baseline, "residual": c.residual, "observed_sync": c.observed_sync,
        "predicted_sync": c.predicted_sync, "warmup": c.warmup, "meta": c.meta,
        "describe": c.describe()}))


def _replan_doc(rep) -> dict:
    return {"new": _plan_json(rep.new_plan), "old": _plan_json(rep.old_plan),
            "old_on_measured": dataclasses.asdict(rep.old_on_measured),
            "new_on_measured": dataclasses.asdict(rep.new_on_measured),
            "describe": rep.describe()}


# -------------------------------------------------------------- emulated
@pytest.fixture(scope="module")
def traced():
    """bert-large planned at CI size and emulated with a trace, in each
    package: (plan, jax plan, port run, jax run)."""
    s = session("bert-large", platform="aws", global_batch=64).plan(alpha=ALPHA, **FAST)
    js = jax_session("bert-large", platform="aws", global_batch=64).plan(alpha=ALPHA, **FAST)
    plan, jplan = s.deployment_plan, js.deployment_plan
    res = plan.emulate(ExecutionConfig(steps=1, trace=True))
    jres = jplan.emulate(JaxExecutionConfig(steps=1, trace=True))
    return plan, jplan, res, jres


def test_emulate_embeds_the_plan_and_equals_jax(traced):
    plan, jplan, res, jres = traced
    assert _plan_json(plan) == _plan_json(jplan)
    assert res.trace.meta["plan"] == plan._as_dict()
    assert (res.t_iter, res.cost) == (jres.t_iter, jres.cost)
    assert res.store_stats.as_dict() == jres.store_stats.as_dict()
    rows = lambda tr: [(s.stage, s.replica, s.step, s.phase, s.op, s.start, s.end,  # noqa: E731
                        s.nbytes, s.key) for s in tr.spans]
    assert rows(res.trace) == rows(jres.trace)


@pytest.mark.parametrize("edit", ["as-is", "slowed", "holey", "sync-x3"])
def test_calibration_of_an_emulated_trace_equals_jax(traced, edit):
    """Each package calibrates its own emulated trace (edited alike: compute
    spans doubled, stage 0's compute dropped, the sync tripled) to the same
    measured profile, observations, scales, warnings and errors; the
    re-plan on it is the same plan."""
    plan, jplan, res, jres = traced

    def edited(tr, T):
        spans, meta = list(tr.spans), dict(tr.meta)
        if edit == "slowed":
            spans = [dataclasses.replace(s, end=s.start + 2.0 * s.duration)
                     if s.op == "compute" else s for s in spans]
        elif edit == "holey":
            spans = [s for s in spans if not (s.stage == 0 and s.op == "compute")]
        elif edit == "sync-x3":
            meta["step_syncs"] = [3.0 * v for v in meta["step_syncs"]]
        return T(spans=spans, meta=meta)

    tr, jtr = edited(res.trace, Trace), edited(jres.trace, JaxTrace)
    rp, jrp = plan.resolve(), jplan.resolve()
    args = (rp.profile, rp.platform, rp.config, rp.total_micro_batches)
    jargs = (jrp.profile, jrp.platform, jrp.config, jrp.total_micro_batches)
    c = cal.calibrate_profile(tr, *args, pipelined_sync=rp.pipelined_sync)
    jc = jcal.calibrate_profile(jtr, *jargs, pipelined_sync=jrp.pipelined_sync)
    assert _calibration_doc(c) == _calibration_doc(jc)
    assert [dataclasses.asdict(o) for o in cal.observe_stages(tr)] == \
        [dataclasses.asdict(o) for o in jcal.observe_stages(jtr)]
    obs = cal.observe_stages(tr)
    assert cal.stage_prediction_errors(*args, obs) == \
        jcal.stage_prediction_errors(*jargs, jcal.observe_stages(jtr))
    assert profile_fingerprint(c.profile, rp.platform) == \
        jax_fingerprint(jc.profile, jrp.platform)
    rep = cal.replan(c, plan, alpha=ALPHA, engine="dp")
    jrep = jcal.replan(jc, jplan, alpha=ALPHA, engine="dp")
    assert _replan_doc(rep) == _replan_doc(jrep)
    assert rep.new_plan.profile_source == "measured"
    assert rep.new_plan.profile_fingerprint == jrep.new_plan.profile_fingerprint


def test_measured_plans_resolve_only_with_their_profile(traced, tmp_path):
    plan, _, res, _ = traced
    rp = plan.resolve()
    c = cal.calibrate_profile(res.trace, rp.profile, rp.platform, rp.config,
                              rp.total_micro_batches)
    new = cal.replan(c, plan).new_plan
    with pytest.raises(PlanCompatibilityError, match="measured"):
        new.resolve()
    with pytest.raises(PlanCompatibilityError, match="source mismatch"):
        new.resolve(profile=rp.profile)
    assert new.resolve(profile=c.profile).profile is c.profile
    # the measured profile's file is JAX's, and loads there
    path = tmp_path / "measured.json"
    c.profile.save(path)
    assert ModelProfile.load(path) == c.profile
    assert JaxModelProfile.load(path).to_json() == c.profile.to_json()
    with pytest.raises(ValueError, match="analytic"):
        cal.calibrate_profile(res.trace, c.profile, rp.platform, rp.config,
                              rp.total_micro_batches)
    bare = Trace(spans=list(res.trace.spans),
                 meta={k: v for k, v in res.trace.meta.items() if k != "plan"})
    with pytest.raises(ValueError, match="plan"):
        cal.calibrate_trace(bare)
    assert cal.calibrate_trace(bare, plan=plan)[0].profile == c.profile


# ------------------------------------------------------------ wall clock
@pytest.fixture(scope="module")
def wall_trace(tmp_path_factory):
    """A traced 3-step run of phi3@reduced4 (2 stages x 2 replicas) on the
    port's ``local`` backend, through the port's CLI, saved with its plan."""
    d = tmp_path_factory.mktemp("wall")
    path = d / "trace.json"
    assert cli(["emulate", "--model", "phi3-mini-3.8b", "--numerics", "--device", "cpu",
                "--stages", "2", "--dp", "2", "--batch", "8", "--seq", "16", "--steps", "3",
                "--backend", "local", "--trace", str(path), "--no-plan-cache"]) == 0
    return path


@pytest.mark.parametrize("warmup", [None, 0, 2])
def test_calibration_of_a_saved_wall_clock_trace_equals_jax(wall_trace, warmup):
    """The same file loaded into each package: calibration (step 0 dropped
    by default on a wall clock), the measured profile, its warnings and the
    re-plan are exactly JAX's."""
    tr, jtr = Trace.load(wall_trace), JaxTrace.load(wall_trace)
    validate_trace(tr)
    assert tr.meta["clock"] == "wall" and tr.meta["backend"] == "local"
    c, plan = cal.calibrate_trace(tr, warmup=warmup)
    jc, jplan = jcal.calibrate_trace(jtr, warmup=warmup)
    assert _plan_json(plan) == _plan_json(jplan)
    assert c.warmup == (1 if warmup is None else warmup)
    assert _calibration_doc(c) == _calibration_doc(jc)
    assert any(row["fwd"] is not None and row["fwd"] != 1.0 for row in c.scales)
    rep = cal.replan(c, plan, alpha=ALPHA, d_options=(1, 2))
    jrep = jcal.replan(jc, jplan, alpha=ALPHA, d_options=(1, 2))
    assert _replan_doc(rep) == _replan_doc(jrep)
    assert rep.new_plan.profile_fingerprint == jrep.new_plan.profile_fingerprint
    assert rep.new_plan.content_hash == jrep.new_plan.content_hash


# --------------------------------------------------------------- Session
def test_session_calibrate_chain_equals_jax():
    """``Session.plan().emulate(trace=True).calibrate().plan()`` step for
    step with JAX's: the same plans, clocks, calibration and re-plan, and
    the measured plan replays through both sessions alike."""
    kw = dict(platform="aws", global_batch=64)
    s, js = session("bert-large", **kw), jax_session("bert-large", **kw)
    with pytest.raises(ValueError, match="traced emulation"):
        s.plan(alpha=ALPHA, **FAST).calibrate()
    js.plan(alpha=ALPHA, **FAST)
    s.emulate(ExecutionConfig(steps=1, trace=True)).calibrate()
    js.emulate(JaxExecutionConfig(steps=1, trace=True)).calibrate()
    assert s.model_profile.source == "measured"
    assert _calibration_doc(s.calibration) == _calibration_doc(js.calibration)
    s.plan(alpha=ALPHA, merge_to=None, engine="dp")
    js.plan(alpha=ALPHA, merge_to=None, engine="dp")
    assert s.deployment_plan.profile_source == "measured"
    assert _plan_json(s.deployment_plan) == _plan_json(js.deployment_plan)
    s.emulate(ExecutionConfig(steps=1)).simulate().evaluate()
    js.emulate(JaxExecutionConfig(steps=1)).simulate().evaluate()
    assert (s.engine_result.t_iter, s.engine_result.cost) == \
        (js.engine_result.t_iter, js.engine_result.cost)
    assert s.sim_result.t_iter == js.sim_result.t_iter
    assert dataclasses.asdict(s.evaluation) == dataclasses.asdict(js.evaluation)


def test_session_sweep_and_plan_io_equal_jax(tmp_path):
    kw = dict(platform="aws", global_batch=64)
    s = session("resnet101", **kw).sweep(**FAST)
    js = jax_session("resnet101", **kw).sweep(**FAST)
    assert [_plan_json(p) for p in s.plans] == [_plan_json(p) for p in js.plans]
    assert s.recommended == js.recommended
    path = tmp_path / "plan.json"
    js.save_plan(path)
    assert _plan_json(session("resnet101", **kw).load_plan(path).deployment_plan) == \
        _plan_json(js.deployment_plan)


# ------------------------------------------------------------- PlanCache
def test_plan_cache_keys_and_files_equal_jax(tmp_path):
    """The same solve key for the same inputs; a session with a cache
    misses, writes, then hits; each package reads the other's entry."""
    key_kw = dict(profile_fingerprint="ab" * 8, platform="aws_lambda", alpha=ALPHA,
                  total_micro_batches=16, solver="cd", engine="batch", merge_to=6,
                  d_options=(1, 2, 4), max_stages=None, pipelined_sync=True)
    assert PlanCache.solve_key(**key_kw) == JaxPlanCache.solve_key(**key_kw)
    bayes = dict(key_kw, solver="bayes", rounds=100, seed=0)
    assert PlanCache.solve_key(**bayes) == JaxPlanCache.solve_key(**bayes)
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    kw = dict(platform="aws", global_batch=64)
    s = session("bert-large", plan_cache=str(ours), **kw).plan(alpha=ALPHA, **FAST)
    js = jax_session("bert-large", plan_cache=str(theirs), **kw).plan(alpha=ALPHA, **FAST)
    assert (s.plan_cache.misses, s.plan_cache.hits) == (1, 0)
    files, jfiles = sorted(os.listdir(ours)), sorted(os.listdir(theirs))
    assert files == jfiles and len(files) == 1
    got = json.loads((ours / files[0]).read_text())
    want = json.loads((theirs / jfiles[0]).read_text())
    got["solve_seconds"] = want["solve_seconds"] = 0.0
    assert got == want
    again = session("bert-large", plan_cache=str(theirs), **kw).plan(alpha=ALPHA, **FAST)
    assert (again.plan_cache.hits, again.plan_cache.misses) == (1, 0)
    assert again.deployment_plan.to_json() == js.deployment_plan.to_json()
    jagain = jax_session("bert-large", plan_cache=str(ours), **kw).plan(alpha=ALPHA, **FAST)
    assert jagain.plan_cache.hits == 1
    # a corrupt entry is evicted and re-solved
    (ours / files[0]).write_text("{not json")
    third = session("bert-large", plan_cache=str(ours), **kw).plan(alpha=ALPHA, **FAST)
    assert (third.plan_cache.evictions, third.plan_cache.misses) == (1, 1)


# ------------------------------------------------------------------- CLI
_TIMES = re.compile(r"solve: [0-9.]+s|solve [0-9.]+s")


def _run(main, argv, capsys) -> str:
    assert main(argv) == 0
    return _TIMES.sub("solve: -", capsys.readouterr().out)


def test_cli_outputs_equal_jax(tmp_path, capsys):
    """``plan``, ``simulate``, ``emulate``, ``calibrate`` and ``inspect``:
    the port's files and reports are ``repro.cli.main``'s (the solve's wall
    clock aside), for a plan file written by JAX's CLI."""
    out = {}
    for name, main in (("jax", jax_cli), ("port", cli)):
        d = tmp_path / name
        d.mkdir()
        f = {k: str(d / f"{k}.json") for k in ("plan", "sim", "emu", "measured", "replan")}
        text = [_run(main, ["plan", "--model", "bert-large", "--fast", "--no-plan-cache",
                            "-o", f["plan"]], capsys)]
        src = str(tmp_path / "jax" / "plan.json") if name == "port" else f["plan"]
        text.append(_run(main, ["simulate", src, "--trace", f["sim"]], capsys))
        text.append(_run(main, ["emulate", src, "--steps", "2", "--trace", f["emu"]], capsys))
        text.append(_run(main, ["inspect", f["emu"]], capsys))
        text.append(_run(main, ["calibrate", f["emu"], "--profile-out", f["measured"],
                                "-o", f["replan"]], capsys))
        text.append(_run(main, ["simulate", f["replan"], "--profile", f["measured"]], capsys))
        # each CLI names its own command in its hints
        out[name] = (f, [t.replace(str(d), "DIR").replace(str(tmp_path / "jax"), "DIR")
                         .replace("python -m repro_torch ", "repro ") for t in text])
    (f, text), (jf, jtext) = out["port"], out["jax"]
    assert text == jtext
    for k in ("sim", "emu", "measured"):
        assert json.loads(Path(f[k]).read_text()) == json.loads(Path(jf[k]).read_text()), k
    for k in ("plan", "replan"):
        assert _plan_json(DeploymentPlan.load(f[k])) == _plan_json(JaxPlan.load(jf[k])), k
    with pytest.raises(SystemExit, match="measured"):
        cli(["simulate", f["replan"]])


def test_cli_chaos_emulate_prints_jax_report(tmp_path, capsys):
    """A generated fault plan on a timing-only run: the same schedule, the
    same recovery report and clock as JAX's CLI."""
    texts = []
    for main in (cli, jax_cli):
        texts.append(_run(main, ["emulate", "--model", "bert-large", "--fast",
                                 "--no-plan-cache", "--steps", "3", "--fault-seed", "4",
                                 "--checkpoint-every", "1"], capsys))
    assert texts[0] == texts[1]
    assert "fault tolerance: faults injected" in texts[0]
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli(["emulate", "--model", "bert-large", "--fast", "--fault-seed", "1",
             "--fault-plan", "x.json"])


def test_cli_serve_and_launch_shim(tmp_path, capsys):
    """``serve`` plans and autoscales as JAX's does and executes on the CPU
    when asked (``--device cpu``); the launch shim maps ``--arch``; ``train``
    reaches the mesh driver's own parser; ``dryrun`` (item 7b, the mesh
    path's analytic half) writes its shape-only record; the benchmark
    folder is not ported and says so."""
    args = ["serve", "--model", "phi3-mini-3.8b@reduced", "--slo", "60",
            "--prefill-tokens", "16", "--new-tokens", "4", "--autoscale", "1,2",
            "--horizon", "30"]
    assert _run(cli, args, capsys) == _run(jax_cli, args, capsys)
    text = _run(cli, args + ["--execute", "emulated", "--device", "cpu"], capsys)
    assert "serve[emulated]" in text and "(drained)" in text
    assert launch_emulate.main(["--arch", "bert-large", "--fast", "--no-plan-cache",
                                "--steps", "1"]) == 0
    assert "engine[emulated]" in capsys.readouterr().out
    assert cli(["dryrun", "--arch", "qwen2.5-14b", "--shape", "decode_32k",
                "--out", str(tmp_path / "dry")]) == 0
    rec = json.loads((tmp_path / "dry" / "qwen2.5-14b_decode_32k_16x16.json").read_text())
    assert rec["status"] == "ok" and rec["memory"]["argument_bytes_by_part"]["caches"] > 0
    assert "[dryrun] qwen2.5-14b x decode_32k mesh=16x16" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="benchmark folder is the JAX package's"):
        cli(["bench"])
    with pytest.raises(SystemExit) as exit_:
        cli(["train", "--help"])
    assert exit_.value.code == 0 and "--stages" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli(["emulate", "--model", "phi3-mini-3.8b", "--numerics", "--steps", "1"])


def test_cli_and_process_chaos_never_import_jax(tmp_path):
    """The CLI's ``plan``/``emulate``/``calibrate`` and a chaos run on the
    ``process`` backend (a generated plan whose crash SIGKILLs a child) with
    ``jax`` and ``repro`` shadowed by packages that refuse to import."""
    for name in ("jax", "repro"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('the port imported {name}')\n")
    code = '''
import sys
from repro_torch.cli import main


def run():
    assert main(["plan", "--model", "bert-large", "--fast", "--no-plan-cache",
                 "-o", "p.json"]) == 0
    assert main(["emulate", "--model", "phi3-mini-3.8b", "--numerics", "--device", "cpu",
                 "--stages", "2", "--dp", "2", "--batch", "8", "--seq", "16",
                 "--steps", "3", "--backend", "process", "--fault-seed", "3",
                 "--trace", "t.json"]) == 0
    assert main(["calibrate", "t.json", "--no-replan"]) == 0
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
    print("LEAKED", bad)


if __name__ == "__main__":
    run()
'''
    script = tmp_path / "run.py"
    script.write_text(code)
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO / 'src'}",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          env=env, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout
    assert "fault tolerance: faults injected" in proc.stdout and "crash=1" in proc.stdout
    assert "engine[process]" in proc.stdout and "prediction error" in proc.stdout
