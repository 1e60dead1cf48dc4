"""The port's MoE FFN and Mamba mixer (``repro_torch.models.moe`` and
``mamba``) and the four archs they bring (dbrx-132b, qwen3-moe-235b-a22b,
jamba-v0.1-52b, internlm2-20b) against the live JAX package on the CPU.

Configs, parameter counts and profiles exactly equal; ``moe_forward``
(output, aux, the slots kept under a capacity drop) and ``mamba_forward`` /
``mamba_decode`` at 2e-4 (``tests/test_models_unit.py:62-63``), with their
gradients against ``jax.vjp``; prefill + decode against the forward for the
four archs (``tests/test_models_unit.py:23-48``); ``run_plan`` for
jamba@reduced and dbrx@reduced against JAX's (losses 2e-4, params 2e-3,
clock, cost and ``StoreStats`` exactly equal) and on ``local`` bit-identical
to ``emulated``; ``run_serve_plan`` for jamba@reduced against JAX's (tokens,
clock, ``StoreStats`` with the Mamba caches in the KV bytes); and a run
that never imports jax.  Weights come from the JAX package's
``init_params`` through ``params_from_jax``, inputs from numpy with a seed;
fp32.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import InputShape as JaxInputShape
from repro.core.perfmodel import Config as JaxConfig
from repro.core.profiler import arch_model_profile as jax_profile
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro.optim import SGD as JaxSGD
from repro.serverless.execution import ExecutionConfig as JaxExecutionConfig
from repro.serverless.platform import AWS_LAMBDA
from repro.serverless.runtime import Execution as JaxExecution
from repro.serverless.runtime import run_plan as jax_run_plan
from repro.serving import kv_bytes_per_instance as jax_kv_bytes
from repro.serving import plan_serving
from repro.serving import run_serve_plan as jax_run_serve_plan

from repro_torch.api.plan import DeploymentPlan
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.perfmodel import Config
from repro_torch.core.profiler import arch_model_profile
from repro_torch.models import mamba, moe, registry
from repro_torch.models.common import tree_leaves
from repro_torch.optim import SGD
from repro_torch.serverless.execution import ExecutionConfig
from repro_torch.serverless.platform import get_platform
from repro_torch.serverless.runtime import Execution, run_plan
from repro_torch.serving import kv_bytes_per_instance, run_serve_plan

torch.backends.cuda.matmul.allow_tf32 = False
REPO = Path(__file__).resolve().parents[1]
AWS = get_platform("aws")
FAMILIES = ["dbrx-132b", "qwen3-moe-235b-a22b", "jamba-v0.1-52b", "internlm2-20b"]
MOE_ARCHS = ["dbrx-132b", "qwen3-moe-235b-a22b"]
JAMBA = "jamba-v0.1-52b"
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's CPU runs: the suite runs several
    workers on the host's cores, and torch pools of a thread a core each
    starve one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, **moe_kw):
    """(jax cfg, port cfg) of ``arch`` reduced, the MoE config replaced by
    ``moe_kw``."""
    jcfg, cfg = jconfigs.get_config(arch).reduced(), get_config(arch).reduced()
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    return jcfg, cfg


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", FAMILIES)
def test_config_counts_and_profile_equal_jax(arch):
    """Every field of the port's config, ``param_count``,
    ``active_param_count`` and ``reduced()`` equal JAX's;
    ``arch_model_profile`` (which reads the counts) is exactly JAX's."""
    assert arch in ARCH_IDS
    for cfg, jcfg in ((get_config(arch), jconfigs.get_config(arch)),
                      (get_config(arch).reduced(), jconfigs.get_config(arch).reduced())):
        for f in dataclasses.fields(cfg):
            a, b = getattr(cfg, f.name), getattr(jcfg, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            elif f.name == "period":
                a, b = [dataclasses.asdict(s) for s in a], [dataclasses.asdict(s) for s in b]
            assert a == b, (arch, f.name)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        for kw in ({}, dict(seq=64, micro_batch=2)):
            assert dataclasses.asdict(arch_model_profile(cfg, AWS, **kw)) == \
                dataclasses.asdict(jax_profile(jcfg, AWS_LAMBDA, **kw))


def test_full_width_depth_cut_spelling():
    """``<arch>@layers<L>`` (the port's spelling of a full-width model cut
    to L layers, as the card's smoke run serves jamba) resolves to the
    config and profile JAX gives the same cut; malformed depths and unknown
    spellings raise KeyError."""
    from repro_torch.core.profiler import arch_config, resolve_profile

    cfg = arch_config(f"{JAMBA}@layers8")
    jcfg = dataclasses.replace(jconfigs.get_config(JAMBA), n_layers=8)
    assert cfg == dataclasses.replace(get_config(JAMBA), n_layers=8)
    assert cfg.param_count() == jcfg.param_count() == 13_264_830_464
    assert dataclasses.asdict(resolve_profile(f"{JAMBA}@layers8", AWS, seq=64)) == \
        dataclasses.asdict(jax_profile(jcfg, AWS_LAMBDA, seq=64))
    for bad in (f"{JAMBA}@layers", f"{JAMBA}@layersX", f"{JAMBA}@wide"):
        with pytest.raises(KeyError):
            arch_config(bad)


# ------------------------------------------------------------------ MoE
def _jax_slots(p, x, jcfg):
    """``moe_forward``'s routing and slot lines (src/repro/models/moe.py:
    58-81) in JAX: (sel [T, k], dispatch_idx [T*k])."""
    mc = jcfg.moe
    T = x.shape[0] * x.shape[1]
    C = jmoe.capacity(T, mc)
    probs = jax.nn.softmax((x.reshape(T, -1) @ p["router"]).astype(jnp.float32), axis=-1)
    _, sel = jax.lax.top_k(probs, mc.top_k)
    flat_sel = sel.reshape(-1)
    onehot = jax.nn.one_hot(flat_sel, mc.n_experts, dtype=jnp.float32)
    slot = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1).astype(jnp.int32)
    return np.asarray(sel), np.asarray(jnp.where(slot < C, flat_sel * C + slot,
                                                 mc.n_experts * C))


@pytest.mark.parametrize("capacity_factor", [None, 0.1], ids=["default", "drop"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_jax(arch, capacity_factor):
    """Output and aux at 2e-4; every token routed to the same experts and
    every kept (token, choice) in the same slot, also when capacity 0.1
    drops most of them."""
    kw = {} if capacity_factor is None else dict(capacity_factor=capacity_factor)
    jcfg, cfg = _cfgs(arch, **kw)
    p = jmoe.init_moe_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = registry.params_from_jax(_np_tree(p), device="cpu")
    x = np.random.default_rng(3).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.moe_forward(p, jnp.asarray(x), cfg=jcfg)
    out, aux = moe.moe_forward(tp, torch.from_numpy(x), cfg=cfg)
    np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
    assert abs(float(aux) - float(jaux)) < 2e-4 and aux.dtype == torch.float32

    jsel, jdispatch = _jax_slots(p, jnp.asarray(x), jcfg)
    T, mc = 32, cfg.moe
    C = moe.capacity(T, mc)
    _, sel, _ = moe.route(tp, torch.from_numpy(x).reshape(T, -1), mc)
    dispatch, keep, source = moe.slots(sel, mc.n_experts, C)
    flipped = int((np.sort(_np(sel), -1) != np.sort(jsel, -1)).any(-1).sum())
    assert flipped == 0, f"{flipped} tokens routed to other experts than JAX's"
    assert np.array_equal(_np(dispatch), jdispatch)
    dropped = int((~keep).sum())
    assert (dropped > T * mc.top_k // 2) == (capacity_factor is not None), dropped
    # source is dispatch's inverse: each kept entry read back from its row
    kept = np.flatnonzero(_np(keep))
    assert np.array_equal(_np(source)[_np(dispatch)[kept]], kept)


def test_moe_vjp_matches_jax():
    """Autograd of (out, aux) against ``jax.vjp`` for the same cotangents,
    every parameter and the input, with drops (capacity 0.5)."""
    jcfg, cfg = _cfgs("dbrx-132b", capacity_factor=0.5)
    p = jmoe.init_moe_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    (_, _), vjp = jax.vjp(lambda pp, xx: jmoe.moe_forward(pp, xx, cfg=jcfg), p, jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(g), jnp.asarray(0.7, jnp.float32)))
    tp = {k: v.requires_grad_() for k, v in
          registry.params_from_jax(_np_tree(p), device="cpu").items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_forward(tp, tx, cfg=cfg)
    grads = torch.autograd.grad([out, aux], [tx, *tp.values()],
                                [torch.from_numpy(g), torch.tensor(0.7)])
    np.testing.assert_allclose(_np(grads[0]), np.asarray(jgx), **TOL)
    for name, gt in zip(tp, grads[1:]):
        np.testing.assert_allclose(_np(gt), np.asarray(jgp[name]), **TOL, err_msg=name)


# ---------------------------------------------------------------- Mamba
@pytest.fixture(scope="module")
def jamba_mixer():
    jcfg, cfg = _cfgs(JAMBA)
    p = jmamba.init_mamba_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jcfg, cfg, p, registry.params_from_jax(_np_tree(p), device="cpu")


@pytest.mark.parametrize("S", [16, 512])
def test_mamba_forward_matches_jax(jamba_mixer, S):
    """One chunk (S 16) and two (S 512, the state carried across the chunk
    boundary): output and the prefill cache (conv tail, state) at 2e-4."""
    jcfg, cfg, p, tp = jamba_mixer
    x = 0.5 * np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jout, jstate = jmamba.mamba_forward(p, jnp.asarray(x), cfg=jcfg, return_state=True)
    out, state = mamba.mamba_forward(tp, torch.from_numpy(x), cfg=cfg, return_state=True)
    np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
    np.testing.assert_allclose(_np(state.h), np.asarray(jstate.h), **TOL)
    np.testing.assert_allclose(_np(state.conv), np.asarray(jstate.conv), **TOL)
    assert state.h.dtype == torch.float32 and state.conv.shape == jstate.conv.shape


def test_mamba_decode_matches_jax(jamba_mixer):
    """16 single-token steps from an empty cache, each step's output and
    cache against JAX's ``mamba_decode``, and the outputs against the
    chunked forward (the recurrent and parallel forms agree); the cache is
    updated in place."""
    jcfg, cfg, p, tp = jamba_mixer
    B, S = 2, 16
    x = 0.5 * np.random.default_rng(5).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jcache = jmamba.init_mamba_cache(B, jcfg, jcfg.mamba.d_inner(jcfg.d_model), jnp.float32)
    cache = mamba.MambaCache(*(a[0] for a in mamba.init_mamba_cache(1, B, cfg, torch.float32,
                                                                     "cpu")))
    ys = []
    for t in range(S):
        jy, jcache = jmamba.mamba_decode(p, jnp.asarray(x[:, t:t + 1]), jcache, cfg=jcfg)
        y, new = mamba.mamba_decode(tp, torch.from_numpy(x[:, t:t + 1]), cache, cfg=cfg)
        assert new is cache
        np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL, err_msg=f"step {t}")
        np.testing.assert_allclose(_np(cache.h), np.asarray(jcache.h), **TOL)
        np.testing.assert_allclose(_np(cache.conv), np.asarray(jcache.conv), **TOL)
        ys.append(_np(y))
    full = mamba.mamba_forward(tp, torch.from_numpy(x), cfg=cfg)
    np.testing.assert_allclose(np.concatenate(ys, axis=1), _np(full), **TOL)


@pytest.mark.parametrize("S", [16, 512])
def test_mamba_vjp_matches_jax(jamba_mixer, S):
    """Autograd through the checkpointed chunks against ``jax.vjp`` of the
    JAX mixer (its chunk body under ``jax.checkpoint``): the input's and
    every parameter's gradient at 2e-4."""
    jcfg, cfg, p, _ = jamba_mixer
    rng = np.random.default_rng(6 + S)
    x = 0.5 * rng.standard_normal((1, S, cfg.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda pp, xx: jmamba.mamba_forward(pp, xx, cfg=jcfg), p, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    tp = {k: v.requires_grad_() for k, v in
          registry.params_from_jax(_np_tree(p), device="cpu").items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = mamba.mamba_forward(tp, tx, cfg=cfg)
    grads = torch.autograd.grad(out, [tx, *tp.values()], torch.from_numpy(g))
    np.testing.assert_allclose(_np(grads[0]), np.asarray(jgx), **TOL)
    for name, gt in zip(tp, grads[1:]):
        scale = max(1.0, float(np.abs(np.asarray(jgp[name])).max()))
        np.testing.assert_allclose(_np(gt) / scale, np.asarray(jgp[name]) / scale, **TOL,
                                   err_msg=name)


# -------------------------------------------------------- prefill / decode
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_matches_forward(arch):
    """tests/test_models_unit.py:23-48 on the port, for the JAX package's
    weights: the forward's hidden state and aux against JAX's, then the
    port's prefill of 28 tokens and 4 decode steps against the port's own
    forward logits (1e-4 / 2e-4); capacity raised to ``n_experts`` so no
    token is dropped, as there."""
    jcfg, cfg = _cfgs(arch)
    if cfg.moe is not None:
        jcfg, cfg = _cfgs(arch, capacity_factor=float(cfg.moe.n_experts))
    jparams = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    params = registry.params_from_jax(_np_tree(jparams), device="cpu")
    B, S = 2, 32
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jh, jaux = jreg.forward(jcfg, jparams, {"tokens": jnp.asarray(toks), "labels": toks})
    tt = torch.from_numpy(toks)
    h, aux = registry.forward(cfg, params, {"tokens": tt, "labels": tt})
    np.testing.assert_allclose(_np(h), np.asarray(jh), **TOL)
    assert abs(float(aux) - float(jaux)) < 2e-4
    assert (float(aux) > 0) == (cfg.moe is not None)
    ref = _np(registry._logits(cfg, params, h))
    logits, caches = registry.prefill(cfg, params, {"tokens": tt[:, :S - 4]}, capacity=S)
    np.testing.assert_allclose(_np(logits[:, 0]), ref[:, S - 5], rtol=1e-4, atol=1e-4)
    for t in range(S - 4, S):
        logits, caches = registry.decode_step(cfg, params, caches, tt[:, t:t + 1])
        np.testing.assert_allclose(_np(logits[:, 0]), ref[:, t], rtol=1e-4, atol=2e-4,
                                   err_msg=f"{arch} step {t}")
    meta = registry.init_decode_caches(cfg, B, S, device="meta")
    assert [tuple(a.shape) for a in tree_leaves(meta)] == \
        [tuple(a.shape) for a in tree_leaves(caches)]


# ----------------------------------------------------------------- engine
def _x(L, cut):
    return tuple(1 if i == cut else 0 for i in range(L - 1))


def _run_on_jax(arch, cut):
    """The plan of tests/test_runtime.py's engine test for ``arch``@reduced:
    2 stages cut after profile layer ``cut`` x 2 replicas, mu 2, 8 x 16
    tokens, eq (2), SGD(0.05), 2 steps, on the JAX engine."""
    jcfg, cfg = _cfgs(arch)
    B, S, d, mu, steps = 8, 16, 2, 2, 2
    L = cfg.n_layers + 2
    x = _x(L, cut)
    params0 = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    batches = [jax_make_batch(jcfg, JaxInputShape("emu", S, B, "train"), step=k)
               for k in range(steps)]
    jres = jax_run_plan(
        jax_profile(jcfg, AWS_LAMBDA, seq=S, micro_batch=B // (d * mu)), AWS_LAMBDA,
        JaxConfig(x=x, d=d, z=(0,) * L), total_micro_batches=d * mu,
        exec_config=JaxExecutionConfig(steps=steps),
        execution=JaxExecution(cfg=jcfg, optimizer=JaxSGD(lr=0.05), init_params=params0,
                               batch_fn=lambda k: batches[k]))
    return SimpleNamespace(
        cfg=cfg, S=S, B=B, d=d, mu=mu, steps=steps, x=x, L=L, jres=jres,
        params=registry.params_from_jax(_np_tree(params0), device="cpu"),
        batches=[{k: torch.from_numpy(np.array(v)) for k, v in b.items()} for b in batches])


def _run_on_port(r, backend="emulated"):
    prof = arch_model_profile(r.cfg, AWS, seq=r.S, micro_batch=r.B // (r.d * r.mu))
    return run_plan(prof, AWS, Config(x=r.x, d=r.d, z=(0,) * r.L),
                    total_micro_batches=r.d * r.mu,
                    exec_config=ExecutionConfig(steps=r.steps, backend=backend),
                    execution=Execution(cfg=r.cfg, optimizer=SGD(lr=0.05),
                                        init_params=r.params,
                                        batch_fn=lambda k: r.batches[k], device="cpu"))


_ENGINE_RUNS: dict = {}


def _engine(arch, cut):
    if arch not in _ENGINE_RUNS:
        r = _run_on_jax(arch, cut)
        r.res = _run_on_port(r)
        _ENGINE_RUNS[arch] = r
    return _ENGINE_RUNS[arch]


@pytest.fixture(scope="module", params=[(JAMBA, 8), ("dbrx-132b", 1)],
                ids=["jamba", "dbrx"])
def engine_runs(request):
    """jamba@reduced cut into [embed + its period | head] (the routers' aux
    all on stage 0, seeded there) and dbrx@reduced into [embed, l0 | l1,
    head] (a router on each stage)."""
    return _engine(*request.param)


def test_run_plan_matches_jax_engine(engine_runs):
    """Losses (ce and aux apart) within 2e-4 and params within 2e-3 of the
    JAX engine's (tests/test_runtime.py:250-253), SGD where AdamW's first
    steps would amplify summation-order noise (ROADMAP §3); the clock,
    cost and store traffic exactly equal."""
    r = engine_runs
    res, jres = r.res, r.jres
    assert len(res.metrics) == 2
    for m, jm in zip(res.metrics, jres.metrics):
        for key in ("ce", "aux", "loss"):
            assert abs(m[key] - jm[key]) < 2e-4, (key, m, jm)
        assert m["aux"] > 0
    worst = max(float(np.max(np.abs(_np(b) - np.asarray(a))))
                for a, b in zip(jax.tree.leaves(jres.params), tree_leaves(res.params)))
    assert worst < 2e-3
    # the routers learned: their update is the aux seed's as well as the CE's
    router = [jax.tree.leaves(jres.params["layers"][j]["ff"]["router"])
              for j, s in enumerate(r.cfg.period) if s.ff == "moe"][0][0]
    assert float(np.abs(np.asarray(router)).max()) > 0
    assert res.t_iter == jres.t_iter and res.t_total == jres.t_total
    assert res.cost == jres.cost and res.breakdown == jres.breakdown
    assert res.store_stats.as_dict() == jres.store_stats.as_dict()


def test_local_run_bit_identical_to_emulated():
    """jamba@reduced's plan on worker threads over a blocking store trains
    to the emulated run's params bit for bit, with equal losses and the
    same store traffic."""
    r = _engine(JAMBA, 8)
    loc = _run_on_port(r, backend="local")
    assert loc.backend == "local" and loc.metrics == r.res.metrics
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(loc.params),
                                                  tree_leaves(r.res.params)))
    st, se = loc.store_stats, r.res.store_stats
    assert (st.puts, st.gets, st.deletes) == (se.puts, se.gets, se.deletes)


# ---------------------------------------------------------------- serving
def test_serve_matches_jax_engine(tmp_path):
    """jamba@reduced served on emulated, 2 stages [embed + period | head]:
    tokens equal the JAX engine's, the clock, cost and store traffic exact,
    and the KV bytes that cross the store each round hold the Mamba caches
    (conv window and fp32 state) beside the attention layer's KV cache."""
    model, B, prefill, new = f"{JAMBA}@reduced", 2, 8, 3
    jplan = plan_serving(model, "aws", slo=60.0, batch=B, prefill_tokens=prefill,
                         new_tokens=new)
    x = [0] * len(jplan.x)
    x[8] = 1
    jplan = dataclasses.replace(jplan, x=tuple(x), z=(0,) * (len(x) + 1))
    jplan.save(tmp_path / "plan.json")
    plan = DeploymentPlan.load(tmp_path / "plan.json")
    jcfg, cfg = _cfgs(JAMBA)
    jres = jax_run_serve_plan(jplan, backend="emulated", seed=0)
    params = registry.params_from_jax(_np_tree(jreg.init_params(jcfg, jax.random.PRNGKey(0))),
                                      device="cpu")
    from repro.serving import make_prompt as jax_make_prompt
    prompt = jax_make_prompt(jcfg, B, prefill, seed=0)
    res = run_serve_plan(plan, device="cpu", params=params, prompt=prompt)
    assert np.array_equal(res.tokens, jres.tokens), (res.tokens, jres.tokens)
    assert res.t_request == jres.t_request and res.cost_per_request == jres.cost_per_request
    assert res.kv_bytes == jres.kv_bytes
    assert res.store_stats.as_dict() == jres.store_stats.as_dict()
    s_ctx = prefill + new
    per_inst = kv_bytes_per_instance(cfg, B, s_ctx)
    assert per_inst == jax_kv_bytes(jcfg, B, s_ctx)
    di, N, kc = cfg.mamba.d_inner(cfg.d_model), cfg.mamba.d_state, cfg.mamba.d_conv - 1
    mamba_b = 7 * (B * kc * di * 4 + B * di * N * 4)
    kv_b = 2 * B * cfg.n_kv_heads * s_ctx * cfg.hd * 4 + B * 4
    assert per_inst == mamba_b + kv_b
    assert res.kv_bytes == (per_inst, 0.0)


# ---------------------------------------------------------------- no jax
def test_families_never_import_jax():
    """A CPU training step of jamba@reduced (one stage of each kind) and a
    served request through the port leave jax and repro out of
    sys.modules."""
    code = (
        "import sys, torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.configs.base import InputShape\n"
        "from repro_torch.core.perfmodel import Config\n"
        "from repro_torch.core.profiler import arch_model_profile\n"
        "from repro_torch.data.synthetic import make_batch\n"
        "from repro_torch.models import registry\n"
        "from repro_torch.optim import SGD\n"
        "from repro_torch.serverless.platform import get_platform\n"
        "from repro_torch.serverless.runtime import Execution, run_plan\n"
        "from repro_torch.serving import plan_serving, run_serve_plan\n"
        "cfg = get_config('jamba-v0.1-52b').reduced()\n"
        "plat = get_platform('aws')\n"
        "params = registry.init_params(cfg, torch.Generator().manual_seed(0), device='cpu')\n"
        "batch = make_batch(cfg, InputShape('t', 8, 4, 'train'), device='cpu')\n"
        "x = tuple(1 if i == 8 else 0 for i in range(9))\n"
        "res = run_plan(arch_model_profile(cfg, plat, seq=8, micro_batch=2), plat,\n"
        "               Config(x=x, d=1, z=(0,) * 10), 2, steps=1,\n"
        "               execution=Execution(cfg=cfg, optimizer=SGD(lr=0.05),\n"
        "                   init_params=params, batch_fn=lambda k: batch, device='cpu'))\n"
        "assert res.metrics[0]['aux'] > 0\n"
        "plan = plan_serving('jamba-v0.1-52b@reduced', 'aws', slo=60.0, batch=2,\n"
        "                    prefill_tokens=8, new_tokens=2)\n"
        "assert run_serve_plan(plan, device='cpu').tokens.shape == (2, 2)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.')) or m == 'repro')\n"
        "print('LEAKED', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout
