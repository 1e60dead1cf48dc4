"""The port's serving slice against the JAX package, on the CPU.

A serve plan that the JAX planner saved to JSON loads and resolves in the
port with the same fingerprint; the cost model (``estimate_serving``,
``stage_aggregates``, ``kv_bytes_per_instance``) is exactly the JAX one; and
``run_serve_plan`` fed the JAX package's weights and prompt emits the JAX
``reference_decode`` tokens with a bit-equal emulated clock, cost and store
traffic — as planned and forced to two stages, as ``tests/test_serving.py``
runs the JAX engine.  Traced (``trace=True``), the emulated run's spans and
meta equal the JAX engine's traced run's exactly.  The port itself never
imports jax.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.models import registry as jreg
from repro.serverless.simulator import stage_aggregates as jax_stage_aggregates
from repro.serving import (
    ServingSpec as JaxServingSpec,
    arch_config_for_model as jax_arch,
    estimate_serving as jax_estimate,
    kv_bytes_per_instance as jax_kv_bytes,
    make_prompt as jax_make_prompt,
    plan_serving,
    reference_decode as jax_reference_decode,
    run_serve_plan as jax_run_serve_plan,
)

from repro_torch.api.plan import DeploymentPlan, PlanCompatibilityError, profile_fingerprint
from repro_torch.models import registry
from repro_torch.obs import validate_trace
from repro_torch.serverless.simulator import stage_aggregates
from repro_torch.serving import (
    ServingSpec,
    arch_config_for_model,
    estimate_serving,
    greedy_token,
    kv_bytes_per_instance,
    make_prompt,
    reference_decode,
    run_serve_plan,
)

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["phi3-mini-3.8b@reduced", "qwen2.5-14b@reduced"]
BATCH, PREFILL, NEW = 2, 8, 3
SPLITS = ["planned", "two-stage"]


def _force_two_stages(plan):
    # cut after the embed instance, as tests/test_serving.py does
    cuts = [0] * len(plan.x)
    cuts[1] = 1
    return dataclasses.replace(plan, x=tuple(cuts), z=(0,) * (len(plan.x) + 1))


@pytest.fixture(scope="module", params=ARCHS)
def served(request, tmp_path_factory):
    """A JAX-planned deployment saved to JSON, the JAX weights and prompt
    (as numpy), the JAX oracle tokens, and the JAX engine's runs."""
    model = request.param
    jplan = plan_serving(model, "aws", slo=60.0, batch=BATCH,
                         prefill_tokens=PREFILL, new_tokens=NEW)
    path = tmp_path_factory.mktemp("plans") / "serve_plan.json"
    jplan.save(path)
    jcfg = jax_arch(model)
    params = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    prompt = jax_make_prompt(jcfg, BATCH, PREFILL, seed=0)
    jplans = {"planned": jplan, "two-stage": _force_two_stages(jplan)}
    return SimpleNamespace(
        model=model, path=path, jplans=jplans,
        params_np=jax.tree.map(np.asarray, params), prompt=prompt,
        ref=jax_reference_decode(jcfg, params, prompt, NEW),
        jax_runs={k: jax_run_serve_plan(p, backend="emulated", seed=0)
                  for k, p in jplans.items()})


def _port_plan(served, split):
    plan = DeploymentPlan.load(served.path)
    return plan if split == "planned" else _force_two_stages(plan)


def test_saved_plan_loads_and_resolves(served):
    jplan = served.jplans["planned"]
    plan = DeploymentPlan.load(served.path)
    assert plan._as_dict() == jplan._as_dict()
    assert plan.content_hash == jplan.content_hash
    rp, jrp = plan.resolve(), jplan.resolve()
    assert profile_fingerprint(rp.profile, rp.platform) == jplan.profile_fingerprint
    assert rp.config.x == jrp.config.x and rp.config.z == jrp.config.z
    assert dataclasses.asdict(rp.platform) == dataclasses.asdict(jrp.platform)


def test_tampered_plan_is_rejected(served, tmp_path):
    plan = DeploymentPlan.load(served.path)
    with pytest.raises(PlanCompatibilityError, match="fingerprint"):
        dataclasses.replace(plan, seq=PREFILL + 1).resolve()
    with pytest.raises(PlanCompatibilityError, match="unknown platform"):
        dataclasses.replace(plan, platform="warp-drive").resolve()
    (tmp_path / "bad.json").write_text(plan.to_json().replace('"version": 1', '"version": 9'))
    with pytest.raises(PlanCompatibilityError, match="schema version"):
        DeploymentPlan.load(tmp_path / "bad.json")


@pytest.mark.parametrize("split", SPLITS)
def test_cost_model_is_exactly_jax(served, split):
    plan, jplan = _port_plan(served, split), served.jplans[split]
    rp, jrp = plan.resolve(), jplan.resolve()
    cfg, jcfg = arch_config_for_model(plan.model), jax_arch(plan.model)
    spec = ServingSpec(slo_s=60.0, batch=BATCH, prefill_tokens=PREFILL, new_tokens=NEW)
    jspec = JaxServingSpec(slo_s=60.0, batch=BATCH, prefill_tokens=PREFILL,
                           new_tokens=NEW)
    assert kv_bytes_per_instance(cfg, BATCH, spec.s_ctx) == \
        jax_kv_bytes(jcfg, BATCH, jspec.s_ctx)
    est = estimate_serving(rp.profile, rp.platform, rp.config, cfg, spec)
    jest = jax_estimate(jrp.profile, jrp.platform, jrp.config, jcfg, jspec)
    assert dataclasses.asdict(est) == dataclasses.asdict(jest)
    agg = stage_aggregates(rp.profile, rp.platform, rp.config, 1)
    jagg = jax_stage_aggregates(jrp.profile, jrp.platform, jrp.config, 1)
    for f in dataclasses.fields(agg):
        a, b = getattr(agg, f.name), getattr(jagg, f.name)
        assert np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype, f.name


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("split", SPLITS)
def test_serve_matches_jax_engine(served, split, use_kernels):
    """Tokens equal the JAX oracle's; the virtual clock, the cost, the KV
    bytes and the store traffic equal the JAX engine's to the bit.  With
    ``use_kernels`` on a CPU tensor, each capable layer goes through the
    kernel's dispatcher to its plain version."""
    plan = _port_plan(served, split)
    params = registry.params_from_jax(served.params_np, device="cpu")
    res = run_serve_plan(plan, device="cpu", params=params, prompt=served.prompt,
                         use_kernels=use_kernels)
    jres = served.jax_runs[split]
    assert res.tokens.dtype == np.int32
    assert np.array_equal(res.tokens, served.ref), (res.tokens, served.ref)
    assert res.t_request == jres.t_request
    assert res.cost_per_request == jres.cost_per_request
    assert res.kv_bytes == jres.kv_bytes
    assert res.store_stats.as_dict() == jres.store_stats.as_dict()
    assert res.store_stats.class_bytes_in["kv"] > 0
    assert len(res.round_wall_s) == NEW


@pytest.mark.parametrize("split", SPLITS)
def test_traced_serve_spans_equal_jax(served, split):
    """The emulated request traced in both packages: the same spans in the
    same order with equal floats, phases prefill then decode, and the same
    meta (the plan's record, the clock, ``t_request``, ``S``, the store's
    counters); the tokens stay the untraced run's."""
    plan = _port_plan(served, split)
    params = registry.params_from_jax(served.params_np, device="cpu")
    res = run_serve_plan(plan, device="cpu", params=params, prompt=served.prompt, trace=True)
    jres = jax_run_serve_plan(served.jplans[split], backend="emulated", seed=0, trace=True)
    rows = [(sp.stage, sp.replica, sp.step, sp.phase, sp.op, sp.start, sp.end, sp.nbytes,
             sp.key) for sp in res.trace.spans]
    jrows = [(sp.stage, sp.replica, sp.step, sp.phase, sp.op, sp.start, sp.end, sp.nbytes,
              sp.key) for sp in jres.trace.spans]
    assert len(rows) > 0 and rows == jrows
    assert res.trace.meta == jres.trace.meta
    assert {sp.phase for sp in res.trace.spans} == {"prefill", "decode"}
    validate_trace(res.trace)
    assert np.array_equal(res.tokens, served.ref)
    assert run_serve_plan(plan, device="cpu", params=params, prompt=served.prompt).trace is None


def test_monolithic_loop_matches_jax_oracle(served):
    cfg = arch_config_for_model(served.model)
    params = registry.params_from_jax(served.params_np, device="cpu")
    assert np.array_equal(reference_decode(cfg, params, served.prompt, NEW), served.ref)


def test_seeded_weights_and_prompt_are_deterministic(served):
    plan = _port_plan(served, "two-stage")
    a = run_serve_plan(plan, device="cpu", seed=1)
    b = run_serve_plan(plan, device="cpu", seed=1)
    assert np.array_equal(a.tokens, b.tokens) and a.tokens.shape == (BATCH, NEW)
    cfg = arch_config_for_model(served.model)
    toks = make_prompt(cfg, BATCH, PREFILL, seed=1)
    assert toks.dtype == np.int32 and toks.min() >= 0 and toks.max() < cfg.vocab_size
    assert not np.array_equal(toks, make_prompt(cfg, BATCH, PREFILL, seed=2))


def test_entry_point_guard_rails(served):
    plan = _port_plan(served, "planned")
    with pytest.raises(ValueError, match="serving backend"):
        run_serve_plan(plan, backend="warp-drive", device="cpu")
    with pytest.raises(ValueError, match="serving backend"):
        run_serve_plan(plan, backend="local", device="cpu")   # JAX serves on two
    with pytest.raises(PlanCompatibilityError, match="workload"):
        run_serve_plan(dataclasses.replace(plan, workload="train", serving=None),
                       device="cpu")
    with pytest.raises(ValueError, match="prompt shape"):
        run_serve_plan(plan, device="cpu", prompt=np.zeros((1, 2), np.int32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_serve_plan(plan)


def test_greedy_token_rule():
    logits = torch.zeros((3, 2, 5))
    logits[0, -1, 4] = 1.0
    logits[1, -1, 2] = 1.0
    logits[2, -1, [1, 3]] = 2.0          # a tie: first maximum, as np.argmax
    tok = greedy_token(logits)
    assert tok.dtype == torch.int32 and tok.shape == (3, 1)
    assert tok[:, 0].tolist() == [4, 2, 1]
    assert np.array_equal(tok.numpy(), np.argmax(logits[:, -1].numpy(), -1)[:, None])


def test_port_never_imports_jax(tmp_path):
    """A traced CPU serve through the port, with ``repro_torch.obs``'s
    metrics, leaves jax and repro out of sys.modules, and no module of the
    port has an import of the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\s|\.|$)", re.M)
    offenders = [str(p) for p in (REPO / "src" / "repro_torch").rglob("*.py")
                 if pat.search(p.read_text())]
    assert not offenders
    path = tmp_path / "plan.json"
    plan_serving(ARCHS[0], "aws", slo=60.0, batch=BATCH, prefill_tokens=PREFILL,
                 new_tokens=NEW).save(path)
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from repro_torch.api.plan import DeploymentPlan\n"
        "from repro_torch.serving import run_serve_plan\n"
        "from repro_torch.obs import pipeline_health, validate_trace\n"
        f"res = run_serve_plan(DeploymentPlan.load({str(path)!r}), device='cpu', trace=True)\n"
        "assert res.tokens.shape == (%d, %d)\n"
        "validate_trace(res.trace)\n"
        "assert pipeline_health(res.trace)['reconciliation']['ok']\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.')) or m == 'repro')\n"
        "print('LEAKED', bad)\n"
        "assert not bad, bad\n" % (BATCH, NEW))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout
