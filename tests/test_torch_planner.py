"""The port's planners, simulator and baselines against the JAX package, on
the CPU.

``repro_torch.core.{partition,perfmodel,profiler,planner}``,
``serverless.{simulator,frameworks}``, ``api.plan`` and
``serving.{planner,autoscale}`` are copies of the JAX package's numpy code.
Every number here is held EXACTLY equal to the live JAX package's on the
same inputs (``==`` on floats, tuples and dataclass fields, equal dtypes and
bits on arrays): plans, objectives, ``Evaluation``s, ``PlannerStats``
counts, ``SimResult``s, predicted spans, costs, fingerprints and plan JSON
bytes.  The only fields left out are wall-clock ones (``solve_seconds``,
which a plan also carries in its JSON and its ``describe`` line does not).
"""
import dataclasses

import numpy as np
import pytest

from repro.api.plan import DeploymentPlan as JaxPlan
from repro.api.plan import profile_fingerprint as jax_fingerprint
from repro.configs import get_config as jax_get_config
from repro.core import partition as jpart
from repro.core import perfmodel as jperf
from repro.core import planner as jplanner
from repro.core import profiler as jprofiler
from repro.serverless import frameworks as jfw
from repro.serverless import simulator as jsim
from repro.serverless.platform import get_platform as jax_platform
from repro.serving import autoscale as jauto
from repro.serving import planner as jserve

from repro_torch.api.plan import DeploymentPlan, PlanCompatibilityError, profile_fingerprint
from repro_torch.api.session import DEFAULT_ALPHA, InfeasiblePlanError
from repro_torch.configs import get_config
from repro_torch.core import partition as part
from repro_torch.core import perfmodel as perf
from repro_torch.core import planner
from repro_torch.core import profiler
from repro_torch.obs import Span
from repro_torch.serverless import frameworks as fw
from repro_torch.serverless import simulator as sim
from repro_torch.serverless.platform import MB, get_platform
from repro_torch.serving import autoscale as auto
from repro_torch.serving import planner as serve

AWS, JAWS = get_platform("aws"), jax_platform("aws")
# J = 3 so exhaustive memory search stays small (tests/test_planner.py:31-34)
SMALL = dataclasses.replace(AWS, memory_options=AWS.memory_options[3:6])
JSMALL = dataclasses.replace(JAWS, memory_options=JAWS.memory_options[3:6])
WALL_CLOCK_FIELDS = ("solve_seconds",)


def same(a, b, path="$"):
    """Exact structural equality across the two packages' classes: a
    dataclass matches the same-named class field by field, an array its
    dtype, shape and every element, a float with ``==``; a span (whose port
    class adds the optional device interval) by its serialised form."""
    if isinstance(a, Span):
        assert a.to_dict() == b.to_dict(), path
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert dataclasses.is_dataclass(b), path
        assert type(a).__name__ == type(b).__name__, path
        fa = [f.name for f in dataclasses.fields(a)]
        assert fa == [f.name for f in dataclasses.fields(b)], path
        for name in fa:
            if name in WALL_CLOCK_FIELDS:
                continue
            same(getattr(a, name), getattr(b, name), f"{path}.{name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _layers(mod, rng, L, J):
    layers = []
    for i in range(L):
        fwd = tuple(float(rng.uniform(0.05, 2.0) / (j + 1)) for j in range(J))
        layers.append(mod.LayerProfile(
            name=f"l{i}",
            param_bytes=float(rng.uniform(5, 200)) * MB,
            act_bytes=float(rng.uniform(5, 150)) * MB,
            out_bytes=float(rng.uniform(1, 50)) * MB,
            grad_out_bytes=float(rng.uniform(1, 50)) * MB,
            fwd_time=fwd,
            bwd_time=tuple(2 * t for t in fwd),
        ))
    return mod.ModelProfile(name="rand", layers=tuple(layers))


def random_profiles(seed, L=5, J=3):
    """``tests/test_planner.py:13``'s ``random_profile`` in both packages,
    from the same draws."""
    return (_layers(part, np.random.default_rng(seed), L, J),
            _layers(jpart, np.random.default_rng(seed), L, J))


def random_configs(rng, L, J, d, n):
    out = []
    for _ in range(n):
        x = tuple(int(v) for v in rng.integers(0, 2, size=L - 1))
        stage_mem = [int(v) for v in rng.integers(0, J, size=sum(x) + 1)]
        out.append((x, d, planner._expand_z(stage_mem, x, L)))
    return out


# ------------------------------------------------------------- partition
@pytest.mark.parametrize("seed", range(3))
def test_partition_helpers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for shape in ((7,), (5, 7), (2, 3, 6)):
        u = rng.normal(size=shape)
        x = rng.integers(0, 2, size=shape[:-1] + (shape[-1] - 1,))
        for name in ("hat", "tilde"):
            same(getattr(part, name)(u, x), getattr(jpart, name)(u, x), name)
        for name in ("suffix_sum", "suffix_max", "segment_sum_table",
                     "segment_sum_table_rev"):
            same(getattr(part, name)(u), getattr(jpart, name)(u), name)
        same(part.stage_ids(x), jpart.stage_ids(x), "stage_ids")
    x1 = tuple(int(v) for v in rng.integers(0, 2, size=9))
    for name in ("stages_of", "highest_layers", "lowest_layers"):
        same(getattr(part, name)(x1), getattr(jpart, name)(x1), name)


@pytest.mark.parametrize("which", ["random", "amoebanet-d36", "bert-large"])
def test_merge_layers_equal_jax(which):
    if which == "random":
        prof, jprof = random_profiles(7, L=13)
    else:
        prof = profiler.paper_model_profile(which, AWS)
        jprof = jprofiler.paper_model_profile(which, JAWS)
    for criterion in ("compute", "param", "activation"):
        for target in (1, 3, 8, 14, 64):
            same(part.merge_boundaries(prof, target, criterion),
                 jpart.merge_boundaries(jprof, target, criterion))
            m, jm = (part.merge_layers(prof, target, criterion),
                     jpart.merge_layers(jprof, target, criterion))
            same(m, jm)
            assert profile_fingerprint(m, AWS) == jax_fingerprint(jm, JAWS)
    with pytest.raises(ValueError):
        part.merge_boundaries(prof, 3, "flops")


def test_profile_provenance_equal_jax():
    prof, jprof = random_profiles(3)
    meta = dict(backend="local", clock="wall", steps=2, base_fingerprint="0" * 16,
                t_total=1.25)
    cal = part.CalibrationMeta(**meta)
    measured = dataclasses.replace(prof, source="measured", calibration=cal)
    jmeasured = dataclasses.replace(jprof, source="measured",
                                    calibration=jpart.CalibrationMeta(**meta))
    assert profile_fingerprint(measured, AWS) == jax_fingerprint(jmeasured, JAWS)
    assert profile_fingerprint(measured) != profile_fingerprint(prof)
    assert profile_fingerprint(prof, AWS) == jax_fingerprint(jprof, JAWS)
    assert measured.to_json() == jmeasured.to_json()
    same(part.ModelProfile.from_json(jmeasured.to_json()), jmeasured)
    for bad in (dict(source="guessed"), dict(source="measured")):
        with pytest.raises(ValueError):
            part.ModelProfile(name="p", layers=prof.layers, **bad)


# ------------------------------------------------------------- perfmodel
@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("pipelined", [True, False], ids=["eq2", "eq1"])
def test_evaluate_equal_jax(d, pipelined):
    for seed in range(3):
        rng = np.random.default_rng(100 + seed)
        L = 4 + seed % 3
        prof, jprof = random_profiles(seed, L=L)
        cfgs = random_configs(rng, L, 3, d, 12)
        for M in (d, 4 * d):
            for x, dd, z in cfgs:
                ev = perf.evaluate(prof, SMALL, perf.Config(x, dd, z), M,
                                   pipelined_sync=pipelined)
                same(ev, jperf.evaluate(jprof, JSMALL, jperf.Config(x, dd, z), M,
                                        pipelined_sync=pipelined))
                assert ev.objective(1.0, 1e-4) == jperf.Evaluation(
                    **dataclasses.asdict(ev)).objective(1.0, 1e-4)
            X = np.array([c[0] for c in cfgs], dtype=np.int64)
            Z = np.array([c[2] for c in cfgs], dtype=np.int64)
            be = perf.evaluate_batch(prof, SMALL, X, Z, d, M, pipelined_sync=pipelined)
            jbe = jperf.evaluate_batch(jprof, JSMALL, X, Z, d, M, pipelined_sync=pipelined)
            same(be, jbe)
            same(be.masked_objective(1.0, 1e-4), jbe.masked_objective(1.0, 1e-4))
            same(be.pick(3), jbe.pick(3))
        same(perf.segment_tables(prof, SMALL), jperf.segment_tables(jprof, JSMALL))
        same(perf.perf_tables(prof, SMALL), jperf.perf_tables(jprof, JSMALL))
    for n in (1, 2, 5, 16):
        for fn in ("sync_time_nonpipelined", "sync_time_pipelined"):
            assert getattr(perf, fn)(3e8, 7e7, n, 0.02) == getattr(jperf, fn)(3e8, 7e7, n, 0.02)


# --------------------------------------------------------------- profiler
def test_known_models_and_profiles_equal_jax():
    from repro_torch.configs import ARCH_IDS

    known = profiler.known_models()
    assert known == sorted(jprofiler._PAPER_MODELS) + sorted(ARCH_IDS)
    assert set(known) <= set(jprofiler.known_models())
    for model in known:
        for kw in ({}, dict(micro_batch=2, seq=64)):
            prof = profiler.resolve_profile(model, AWS, **kw)
            jprof = jprofiler.resolve_profile(model, JAWS, **kw)
            same(prof, jprof)
            assert profile_fingerprint(prof, AWS) == jax_fingerprint(jprof, JAWS)
            assert profile_fingerprint(prof) == jax_fingerprint(jprof)
        if model in jprofiler._PAPER_MODELS:
            same(profiler.paper_model_profile(model, get_platform("alibaba")),
                 jprofiler.paper_model_profile(model, jax_platform("alibaba")))
    same(profiler.resolve_profile("phi3-mini-3.8b@reduced3", AWS),
         jprofiler.resolve_profile("phi3-mini-3.8b@reduced3", JAWS))
    for bad in ("vgg16", "phi3-mini-3.8b@wide", "phi3-mini-3.8b@reducedX"):
        with pytest.raises(KeyError) as e:
            profiler.resolve_profile(bad, AWS)
        with pytest.raises(KeyError) as je:
            jprofiler.resolve_profile(bad, JAWS)
        assert ("malformed" in str(e.value)) == ("malformed" in str(je.value))


# -------------------------------------------------------------- simulator
@pytest.mark.parametrize("contention", [False, True], ids=["free", "contended"])
@pytest.mark.parametrize("pipelined", [True, False], ids=["eq2", "eq1"])
def test_simulate_funcpipe_equal_jax(contention, pipelined):
    plat, jplat = AWS, JAWS
    for seed in range(3):
        rng = np.random.default_rng(200 + seed)
        prof, jprof = random_profiles(seed, L=6, J=len(AWS.memory_options))
        for d in (1, 2, 4, 32):
            for x, dd, z in random_configs(rng, 6, len(AWS.memory_options), d, 3):
                kw = dict(pipelined_sync=pipelined, contention=contention, trace=True)
                r = sim.simulate_funcpipe(prof, plat, perf.Config(x, dd, z), 4 * d, **kw)
                jr = jsim.simulate_funcpipe(jprof, jplat, jperf.Config(x, dd, z), 4 * d, **kw)
                same(r.trace.spans, jr.trace.spans)
                assert r.trace.meta == jr.trace.meta
                same(dataclasses.replace(r, trace=None), dataclasses.replace(jr, trace=None))
                untraced = sim.simulate_funcpipe(prof, plat, perf.Config(x, dd, z), 4 * d,
                                                 pipelined_sync=pipelined,
                                                 contention=contention)
                assert untraced.trace is None and untraced.t_iter == r.t_iter


@pytest.mark.parametrize("sync", ["scatter_reduce", "pipelined", "ps"])
def test_simulate_data_parallel_equal_jax(sync):
    prof = profiler.paper_model_profile("amoebanet-d18", AWS)
    jprof = jprofiler.paper_model_profile("amoebanet-d18", JAWS)
    for plat, jplat in ((AWS, JAWS), (get_platform("alibaba"), jax_platform("alibaba"))):
        for n in (1, 2, 8, 32):
            for ga in (False, True):
                kw = dict(n_workers=n, mem_index=5, samples_per_worker=8, micro_batch=4,
                          sync=sync, grad_accum=ga, contention=n > 16)
                r = sim.simulate_data_parallel(prof, plat, **kw)
                same(r, jsim.simulate_data_parallel(jprof, jplat, **kw))
                assert r.throughput == jsim.SimResult(**dataclasses.asdict(r)).throughput


# ---------------------------------------------------------------- planner
def _same_plan(r, jr):
    assert (r is None) == (jr is None)
    if r is not None:
        same(r, jr)      # config, evaluation, objective, merged profile, stats
        if r.stats is not None:
            assert r.stats.describe() == jr.stats.describe()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("engine", ["scalar", "batch"])
@pytest.mark.parametrize("method", ["cd", "cd-steepest", "exhaustive"])
def test_solve_equal_jax(seed, engine, method):
    prof, jprof = random_profiles(300 + seed, L=4 + seed % 3)
    kw = dict(alpha=(1.0, 1e-4), total_micro_batches=8, d_options=(1, 2, 4),
              merge_to=4, method=method, engine=engine)
    _same_plan(planner.solve(prof, SMALL, **kw), jplanner.solve(jprof, JSMALL, **kw))


@pytest.mark.parametrize("seed", range(3))
def test_dp_solve_equal_jax(seed):
    prof, jprof = random_profiles(300 + seed, L=6)
    for kw in (dict(merge_to=None), dict(merge_to=4, max_stages=2),
               dict(merge_to=None, pipelined_sync=False)):
        kw |= dict(alpha=(1.0, 1e-4), total_micro_batches=8, d_options=(1, 2, 4))
        _same_plan(planner.solve(prof, SMALL, engine="dp", **kw),
                   jplanner.solve(jprof, JSMALL, engine="dp", **kw))


@pytest.mark.parametrize("engine", ["scalar", "batch", "dp"])
def test_tpdmp_solve_equal_jax(engine):
    for seed in range(2):
        prof, jprof = random_profiles(400 + seed, L=5)
        kw = dict(alpha=(1.0, 1e-4), total_micro_batches=8, d_options=(1, 2, 4),
                  merge_to=5, engine=engine)
        _same_plan(planner.tpdmp_solve(prof, SMALL, **kw),
                   jplanner.tpdmp_solve(jprof, JSMALL, **kw))


def test_bayes_solve_and_recommend_equal_jax():
    prof, jprof = random_profiles(500, L=6)
    results, jresults = [], []
    for seed, batch in ((0, 16), (1, 1), (2, 5)):
        kw = dict(alpha=(1.0, 1e-4), total_micro_batches=8, d_options=(1, 2, 4),
                  merge_to=6, rounds=40, seed=seed, batch_size=batch)
        r, jr = planner.bayes_solve(prof, SMALL, **kw), jplanner.bayes_solve(jprof, JSMALL, **kw)
        _same_plan(r, jr)
        results.append(r)
        jresults.append(jr)
    for alpha in ((1.0, 0.0), (0.0, 1.0), (1.0, 1e-3)):
        kw = dict(alpha=alpha, total_micro_batches=8, d_options=(1, 2, 4), merge_to=6)
        results.append(planner.solve(prof, SMALL, **kw))
        jresults.append(jplanner.solve(jprof, JSMALL, **kw))
    for threshold in (0.0, 0.8, 5.0):
        _same_plan(planner.recommend(results, threshold),
                   jplanner.recommend(jresults, threshold))
    with pytest.raises(ValueError):
        planner.solve(prof, SMALL, alpha=(1, 0), total_micro_batches=8, method="annealing")
    with pytest.raises(ValueError):
        planner.solve(prof, SMALL, alpha=(1, 0), total_micro_batches=8, engine="gpu")


def _train_planned_profiles():
    """chip_smoke.py's train_planned profile: phi3-mini-3.8b at full width cut
    to 4 layers (L = 6 profile layers), seq 1024, micro-batch 2, on aws."""
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=4)
    jcfg = dataclasses.replace(jax_get_config("phi3-mini-3.8b"), n_layers=4)
    return (profiler.arch_model_profile(cfg, AWS, seq=1024, micro_batch=2),
            jprofiler.arch_model_profile(jcfg, JAWS, seq=1024, micro_batch=2))


def test_train_planned_plan_equal_jax():
    """The plan the card trains is the plan JAX picks, and DP's is no worse
    (``tests/test_planner.py::test_dp_never_worse_than_batch``)."""
    prof, jprof = _train_planned_profiles()
    assert prof.L == 6 and profile_fingerprint(prof, AWS) == jax_fingerprint(jprof, JAWS)
    kw = dict(alpha=DEFAULT_ALPHA, total_micro_batches=4, d_options=(1, 2))
    r, jr = planner.solve(prof, AWS, **kw), jplanner.solve(jprof, JAWS, **kw)
    _same_plan(r, jr)
    dp, jdp = planner.dp_solve(prof, AWS, **kw), jplanner.dp_solve(jprof, JAWS, **kw)
    _same_plan(dp, jdp)
    assert dp.objective <= r.objective * (1 + 1e-9)
    s = sim.simulate_funcpipe(prof, AWS, r.config, 4)
    same(s, jsim.simulate_funcpipe(jprof, JAWS, jr.config, 4))


def test_paper_model_solve_equal_jax():
    prof = profiler.paper_model_profile("resnet101", AWS)
    jprof = jprofiler.paper_model_profile("resnet101", JAWS)
    kw = dict(alpha=(1.0, 2**19 * 1e-9), total_micro_batches=16, merge_to=8)
    _same_plan(planner.solve(prof, AWS, **kw), jplanner.solve(jprof, JAWS, **kw))


# ------------------------------------------------------------- frameworks
def test_baselines_and_funcpipe_equal_jax():
    prof = profiler.paper_model_profile("amoebanet-d36", AWS)
    jprof = jprofiler.paper_model_profile("amoebanet-d36", JAWS)
    for kw in (dict(), dict(grad_accum=True), dict(contention=True),
               dict(sync="pipelined"), dict(ps=True), dict(ps=True, grad_accum=True)):
        same(fw.lambda_ml(prof, AWS, 64, **kw), jfw.lambda_ml(jprof, JAWS, 64, **kw))
    for ga in (False, True):
        same(fw.hybrid_ps(prof, AWS, 64, grad_accum=ga),
             jfw.hybrid_ps(jprof, JAWS, 64, grad_accum=ga))
    assert fw.ALPHA_PAIRS == jfw.ALPHA_PAIRS
    res, jres = fw.funcpipe(prof, AWS, 64), jfw.funcpipe(jprof, JAWS, 64)
    same(res, jres)
    same(res.recommended_sim, jres.recommended_sim)


def _plans(prof_args, alphas, merge_to, M):
    """The same solves in both packages, frozen as DeploymentPlans."""
    out, jout = [], []
    prof = profiler.resolve_profile(*prof_args)
    jprof = jprofiler.resolve_profile(prof_args[0], JAWS)
    mprof, jmprof = part.merge_layers(prof, merge_to), jpart.merge_layers(jprof, merge_to)
    for alpha in alphas:
        kw = dict(alpha=alpha, total_micro_batches=M, merge_to=None, d_options=(1, 2, 4))
        r, jr = planner.solve(mprof, AWS, **kw), jplanner.solve(jmprof, JAWS, **kw)
        plan_kw = dict(alpha=alpha, total_micro_batches=M, model=prof_args[0],
                       merge_to=merge_to)
        # solve_seconds is the solve's wall clock: set alike
        out.append(dataclasses.replace(DeploymentPlan.from_result(r, platform=AWS, **plan_kw),
                                       solve_seconds=0.0))
        jout.append(dataclasses.replace(JaxPlan.from_result(jr, platform=JAWS, **plan_kw),
                                        solve_seconds=0.0))
    return out, jout


def test_funcpipe_replay_emulated_equal_jax():
    plans, jplans = _plans(("bert-large", AWS), fw.ALPHA_PAIRS[:3], 6, 8)
    for backend in (None, "emulated"):
        res = fw.funcpipe_replay(plans + plans[:1], backend=backend)
        jres = jfw.funcpipe_replay(jplans + jplans[:1], backend=backend)
        same(res.plans, jres.plans)
        same(res.sims, jres.sims)
        assert res.recommended == jres.recommended
        assert [p.to_json() for p in res.deployment_plans] == \
            [p.to_json() for p in jres.deployment_plans]
        if backend is None:
            assert res.engine_results is None and jres.engine_results is None
            continue
        for e, je in zip(res.engine_results, jres.engine_results):
            for name in ("t_iter", "t_total", "steps", "cost", "n_workers", "total_mem_gb",
                         "backend", "wall_clock", "breakdown"):
                same(getattr(e, name), getattr(je, name), name)
            assert e.store_stats.as_dict() == je.store_stats.as_dict()
    assert fw.funcpipe_replay([]) is None


# ------------------------------------------------------------ DeploymentPlan
@pytest.mark.parametrize("merge_to", [None, 8])
def test_deployment_plan_crosses_packages(merge_to):
    """``from_result`` -> ``to_json`` byte-equal to JAX's (solve_seconds set
    alike: it is the solve's wall clock); each package loads the other's
    JSON to the same fingerprint and bytes, and evaluates, simulates and
    describes it alike."""
    M, alpha = 16, (1.0, 2**19 * 1e-9)
    prof = profiler.resolve_profile("amoebanet-d18", AWS)
    jprof = jprofiler.resolve_profile("amoebanet-d18", JAWS)
    if merge_to is not None:
        prof, jprof = part.merge_layers(prof, merge_to), jpart.merge_layers(jprof, merge_to)
    kw = dict(alpha=alpha, total_micro_batches=M, merge_to=None, engine="dp")
    r, jr = planner.solve(prof, AWS, **kw), jplanner.solve(jprof, JAWS, **kw)
    plan_kw = dict(alpha=alpha, total_micro_batches=M, merge_to=merge_to, engine="dp")
    plan = dataclasses.replace(DeploymentPlan.from_result(r, platform=AWS, **plan_kw),
                               solve_seconds=0.5)
    jplan = dataclasses.replace(JaxPlan.from_result(jr, platform=JAWS, **plan_kw),
                                solve_seconds=0.5)
    assert plan.to_json() == jplan.to_json()
    assert plan.content_hash == jplan.content_hash and plan.n_workers == jplan.n_workers
    back, jback = DeploymentPlan.from_json(jplan.to_json()), JaxPlan.from_json(plan.to_json())
    assert back.to_json() == jplan.to_json() and jback.to_json() == plan.to_json()
    rp, jrp = back.resolve(), jback.resolve()
    assert profile_fingerprint(rp.profile, rp.platform) == plan.profile_fingerprint
    same(rp.profile, jrp.profile)
    same(back.evaluate(), jback.evaluate())
    ev = back.evaluate()
    assert (ev.t_iter, ev.c_iter) == (plan.t_iter, plan.c_iter)
    s, js = back.simulate(trace=True), jback.simulate(trace=True)
    same(s.trace.spans, js.trace.spans)
    same(dataclasses.replace(s, trace=None), dataclasses.replace(js, trace=None))
    assert back.describe() == jback.describe()
    # explicit overrides are fingerprint-checked too
    assert back.resolve(profile=rp.profile, platform=AWS).config == plan.config
    with pytest.raises(PlanCompatibilityError, match="fingerprint"):
        back.resolve(profile=profiler.resolve_profile("resnet101", AWS))
    # emulate (ported, item 5) runs the engine through an ExecutionConfig:
    # the virtual clock, cost and store traffic are JAX's
    from repro.serverless.execution import ExecutionConfig as JaxExecutionConfig

    from repro_torch.serverless.execution import ExecutionConfig

    e, je = back.emulate(ExecutionConfig(steps=1)), jback.emulate(JaxExecutionConfig(steps=1))
    assert (e.t_iter, e.cost, e.n_workers) == (je.t_iter, je.cost, je.n_workers)
    assert e.store_stats.as_dict() == je.store_stats.as_dict()


def test_from_config_equal_jax():
    prof = profiler.resolve_profile("phi3-mini-3.8b@reduced", AWS, seq=16, micro_batch=2)
    jprof = jprofiler.resolve_profile("phi3-mini-3.8b@reduced", JAWS, seq=16, micro_batch=2)
    x, z = (0, 1, 0), (1, 1, 2, 2)
    for d, pipelined in ((1, True), (2, False)):
        plan = DeploymentPlan.from_config(prof, AWS, perf.Config(x, d, z), 4,
                                          model="phi3-mini-3.8b@reduced", seq=16,
                                          micro_batch=2, pipelined_sync=pipelined)
        jplan = JaxPlan.from_config(jprof, JAWS, jperf.Config(x, d, z), 4,
                                    model="phi3-mini-3.8b@reduced", seq=16, micro_batch=2,
                                    pipelined_sync=pipelined)
        assert plan.to_json() == jplan.to_json()
        assert plan.describe() == jplan.describe()
        same(plan.simulate(), JaxPlan.from_json(plan.to_json()).simulate())


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("model", ["phi3-mini-3.8b@reduced", "qwen2.5-14b@reduced"])
def test_serving_planner_and_autoscale_equal_jax(model, tmp_path):
    kw = dict(slo=60.0, batch=2, prefill_tokens=8, new_tokens=3)
    plan, jplan = serve.plan_serving(model, "aws", **kw), jserve.plan_serving(model, "aws", **kw)
    plan = dataclasses.replace(plan, solve_seconds=jplan.solve_seconds)
    assert plan.to_json() == jplan.to_json() and plan.describe() == jplan.describe()
    spec = serve.ServingSpec(slo_s=60.0, batch=2, prefill_tokens=8, new_tokens=3)
    jspec = jserve.ServingSpec(slo_s=60.0, batch=2, prefill_tokens=8, new_tokens=3)
    sol, jsol = serve.solve_serving(model, AWS, spec, max_stages=2), \
        jserve.solve_serving(model, JAWS, jspec, max_stages=2)
    for name in ("model", "config", "estimate", "spec", "n_candidates", "n_feasible"):
        same(getattr(sol, name), getattr(jsol, name), name)
    (tmp_path / "gaps.txt").write_text("# gaps\n0.5\n1.5\n\n0.25\n")
    for arrival, extra in (("poisson", {}), ("bursty", {}),
                           ("trace", {"trace_file": str(tmp_path / "gaps.txt")})):
        akw = dict(rate=2.0, horizon=90.0, replicas=(1, 2, 4), arrival=arrival, seed=3,
                   **extra)
        rows = auto.autoscale_plan(plan, **akw)
        jrows = jauto.autoscale_plan(JaxPlan.from_json(plan.to_json()), **akw)
        assert [r.as_dict() for r in rows] == [r.as_dict() for r in jrows]
    same(auto.bursty_arrivals(3.0, 200.0, seed=5), jauto.bursty_arrivals(3.0, 200.0, seed=5))
    train = DeploymentPlan.from_json(plan.to_json().replace('"serve"', '"train"'))
    with pytest.raises(PlanCompatibilityError, match="workload"):
        auto.autoscale_plan(train)
    with pytest.raises(PlanCompatibilityError, match="workload"):
        plan.evaluate()
    with pytest.raises(serve.InfeasibleSLOError) as e:
        serve.plan_serving(model, "aws", slo=1e-6, prefill_tokens=4, new_tokens=2)
    assert isinstance(e.value, InfeasiblePlanError)
    with pytest.raises(KeyError, match="analytic-only"):
        serve.plan_serving("bert-large", "aws", slo=60.0)
