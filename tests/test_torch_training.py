"""The port's training slice against the live JAX package on the CPU.

Stage workers (gradient vectors element by element, optimizer updates), the
storage scatter-reduce (bit-equal reductions, equal end times and
``StoreStats``), and ``run_plan`` end to end: the ports of
``tests/test_runtime.py``'s two engine tests, held against the JAX engine
run on the same params and batches (losses and params within those tests'
tolerances; ``t_iter``, ``t_total``, cost and ``StoreStats`` exactly
equal), timing-only runs, saved plans and the guard rails.  Inputs come
from the JAX package (``init_params``, ``make_batch``) or from numpy with a
seed; fp32 with TF32 off, and one bf16 run (the main path's type).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import InputShape as JaxInputShape
from repro.core.perfmodel import Config as JaxConfig
from repro.core.profiler import arch_model_profile as jax_profile
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models import registry as jreg
from repro.optim import SGD as JaxSGD
from repro.optim import AdamW as JaxAdamW
from repro.serverless.execution import ExecutionConfig
from repro.serverless.platform import AWS_LAMBDA
from repro.serverless.runtime import Execution as JaxExecution
from repro.serverless.runtime import run_plan as jax_run_plan
from repro.serverless.runtime import scatter_reduce as jsr
from repro.serverless.runtime.store import ObjectStore as JaxStore
from repro.serverless.runtime.store import StageChannel as JaxChannel
from repro.serverless.runtime.worker import StageWorker as JaxWorker
from repro.serverless.runtime.worker import stage_instance_ranges as jax_spans

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.perfmodel import Config
from repro_torch.core.profiler import arch_model_profile
from repro_torch.data.synthetic import make_batch
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import params_from_jax
from repro_torch.obs import Trace
from repro_torch.optim import SGD, AdamW
from repro_torch.serverless.platform import get_platform
from repro_torch.serverless.runtime import Execution, run_plan
from repro_torch.serverless.runtime import scatter_reduce as sr
from repro_torch.serverless.runtime.store import ObjectStore, StageChannel
from repro_torch.serverless.runtime.worker import StageWorker, stage_instance_ranges

torch.backends.cuda.matmul.allow_tf32 = False
REPO = Path(__file__).resolve().parents[1]
AWS = get_platform("aws")
PHI3 = "phi3-mini-3.8b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's CPU torch runs: the suite runs
    several workers on the host's cores, and torch pools of a thread a core
    each starve one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch=PHI3, n_layers=None):
    jcfg, cfg = jconfigs.get_config(arch).reduced(), get_config(arch).reduced()
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return jcfg, cfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _x(L, cuts):
    return tuple(1 if i in cuts else 0 for i in range(L - 1))


# ---------------------------------------------------------------- workers
@pytest.fixture(scope="module")
def two_stage():
    """phi3@reduced with 4 layers cut into [embed, l0, l1 | l2, l3, head],
    params and two micro-batches from the JAX package."""
    jcfg, cfg = _cfgs(n_layers=4)
    x = _x(cfg.n_layers + 2, {2})
    params = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    batch = jax_make_batch(jcfg, JaxInputShape("w", 16, 4, "train"), seed=2)
    mbs = [jax.tree.map(lambda a, m=m: a[2 * m:2 * m + 2], batch) for m in range(2)]
    return jcfg, cfg, x, params, mbs


def _run_stages(workers, mbs, to_in, to_out):
    """The GPipe step of one replica: forwards down the stages, backwards up."""
    for m, mb in enumerate(mbs):
        h = None
        for w in workers:
            h, _ = w.forward(m, h, mb)
            h = to_in(h)
    for m in reversed(range(len(mbs))):
        g = None
        for s in reversed(range(len(workers))):
            g = workers[s].backward(m, g)
            g = None if g is None else to_in(g)
    return [to_out(w.grad_vector()) for w in workers]


@pytest.mark.parametrize("remat", [False, True])
def test_grad_vector_matches_jax_worker(two_stage, remat):
    """Element by element: same leaf order (``jax.tree.flatten``), same fp32
    accumulation over micro-batches, same 1/mu seed."""
    jcfg, cfg, x, params, mbs = two_stage
    jw = [JaxWorker(jcfg, sp, params, mu=2, optimizer=JaxSGD()) for sp in jax_spans(jcfg, x)]
    tp = params_from_jax(_np_tree(params), device="cpu")
    tw = [StageWorker(cfg, sp, tp, mu=2, replicas=1, optimizer=SGD(), remat=remat,
                      device="cpu")
          for sp in stage_instance_ranges(cfg, x)]
    want = _run_stages(jw, mbs, lambda a: a, np.asarray)
    got = _run_stages(tw, [_torch_batch(mb) for mb in mbs], lambda a: a,
                      lambda t: t.numpy())
    for s, (g, e) in enumerate(zip(got, want)):
        assert g.dtype == np.float32 and g.shape == e.shape, s
        np.testing.assert_allclose(g, e, rtol=1e-4, atol=1e-6, err_msg=f"stage {s}")


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_apply_update_matches_jax_optimizer(two_stage, opt):
    """Two updates from the same numpy-seeded gradient vectors: params and
    every optimizer state leaf against the JAX worker's."""
    jcfg, cfg, x, params, _ = two_stage
    jopt, topt = ((JaxSGD(lr=0.05), SGD(lr=0.05)) if opt == "sgd"
                  else (JaxAdamW(lr=1e-2, weight_decay=0.1), AdamW(lr=1e-2, weight_decay=0.1)))
    jspan, tspan = jax_spans(jcfg, x)[1], stage_instance_ranges(cfg, x)[1]
    jw = JaxWorker(jcfg, jspan, params, mu=2, optimizer=jopt)
    tw = StageWorker(cfg, tspan, params_from_jax(_np_tree(params), device="cpu"), mu=2,
                     replicas=1, optimizer=topt, device="cpu")
    rng = np.random.default_rng(21)
    n = int(jw.grad_nbytes // 4)
    assert tw.grad_nbytes == jw.grad_nbytes
    for step in range(2):
        g = (1e-2 * rng.standard_normal(n)).astype(np.float32)
        jw.apply_update(g, step=step)
        tw.apply_update(torch.from_numpy(g.copy()), step=step)
    for a, b in zip(jax.tree.leaves(jw.params), tree_leaves(tw.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    for a, b in zip(jax.tree.leaves(jw.opt_state), tree_leaves(tw.opt_state)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-7)


def test_export_load_state_round_trips(two_stage):
    jcfg, cfg, x, params, mbs = two_stage
    span = stage_instance_ranges(cfg, x)[0]
    tp = params_from_jax(_np_tree(params), device="cpu")
    a = StageWorker(cfg, span, tp, mu=1, replicas=1, optimizer=AdamW(lr=1e-2), device="cpu")
    a.forward(0, None, _torch_batch(mbs[0]))
    a.backward(0, torch.ones(2, 16, cfg.d_model))
    a.apply_update(a.grad_vector(), step=0)
    b = StageWorker(cfg, span, tp, mu=1, replicas=1, optimizer=AdamW(lr=1e-2), device="cpu")
    b.load_state(a.export_state())
    for p, q in zip(tree_leaves(a.export_state()), tree_leaves(b.export_state())):
        assert torch.equal(p, q)
    other = StageWorker(cfg, stage_instance_ranges(cfg, x)[1], tp, mu=1, replicas=1,
                        optimizer=SGD(), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        other.load_state(a.export_state())
    with pytest.raises(RuntimeError, match="backward"):
        b.grad_vector()


# ---------------------------------------------------------- scatter-reduce
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("pipelined", [True, False])
def test_scatter_reduce_bit_equal_to_jax(n, pipelined):
    """Same numpy-seeded vectors (an odd length, so the chunks differ in
    size): the reduction is bit-equal, the end times and StoreStats equal."""
    rng = np.random.default_rng(30 + n)
    vals = [rng.standard_normal(1001).astype(np.float32) for _ in range(n)]
    ready = [float(r) for r in rng.uniform(0.0, 0.5, n)]
    nbytes, bw, lat = 4.0 * 1001, 7.5e7, 0.031

    jstore = JaxStore(latency=lat)
    jch = [JaxChannel(jstore, bw, lat) for _ in range(n)]
    store = ObjectStore(latency=lat)
    ch = [StageChannel(store, bw, lat) for _ in range(n)]
    jfn, fn = ((jsr.pipelined_scatter_reduce, sr.pipelined_scatter_reduce) if pipelined
               else (jsr.three_phase_scatter_reduce, sr.three_phase_scatter_reduce))
    jred, jends = jfn(jstore, jch, nbytes, ready, values=vals)
    red, ends = fn(store, ch, nbytes, ready, values=[torch.from_numpy(v) for v in vals])
    assert red.dtype == torch.float32
    assert np.array_equal(red.numpy(), jred)
    assert ends == jends
    assert store.stats.as_dict() == jstore.stats.as_dict()
    assert store.keys() == [] and jstore.keys() == []
    # timing-only: the same clocks without values
    store2 = ObjectStore(latency=lat)
    none, ends2 = fn(store2, [StageChannel(store2, bw, lat) for _ in range(n)], nbytes, ready)
    assert none is None and ends2 == jends


def test_ring_reduce_order():
    a, b, c = (torch.tensor([1e8, 1.0], dtype=torch.float32),
               torch.tensor([1.0, 1e8], dtype=torch.float32),
               torch.tensor([-1e8, -1e8], dtype=torch.float32))
    np.testing.assert_array_equal(sr.ring_reduce(a, [b, c]).numpy(),
                                  jsr.ring_reduce(a.numpy(), [b.numpy(), c.numpy()]))


# ------------------------------------------------------------------ engine
def _stats(res):
    return res.store_stats.as_dict()


def _assert_same_clock(res, jres):
    assert res.t_iter == jres.t_iter
    assert res.t_total == jres.t_total
    assert res.cost == jres.cost
    assert res.n_workers == jres.n_workers and res.total_mem_gb == jres.total_mem_gb
    assert res.breakdown == jres.breakdown
    assert _stats(res) == _stats(jres)


def _param_err(params, jparams):
    worst = ("", 0.0)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                            tree_leaves(params)):
        e = float(np.max(np.abs(b.detach().float().numpy() - np.asarray(a, np.float32))))
        if e > worst[1]:
            worst = (jax.tree_util.keystr(path), e)
    return worst


_OPTIMIZERS = {"adamw": (AdamW, JaxAdamW), "sgd": (SGD, JaxSGD)}


def _two_steps_on_jax(param_dtype: str, lr: float, arch=PHI3, n_layers=4,
                      optimizer="adamw") -> dict:
    """tests/test_runtime.py::test_engine_two_steps_match_monolithic's plan
    (phi3@reduced, 4 layers, 2 stages x 2 replicas, mu 2, AdamW, 2 steps) in
    ``param_dtype``, on the JAX engine; for another ``arch``, ``n_layers``
    cut in half (each stage a whole number of periods)."""
    jcfg, cfg = _cfgs(arch, n_layers=n_layers)
    jcfg = dataclasses.replace(jcfg, param_dtype=param_dtype)
    cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    B, S, d, mu, steps = 8, 16, 2, 2, 2
    L = cfg.n_layers + 2
    x = _x(L, {n_layers // 2})
    params0 = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    batches = [jax_make_batch(jcfg, JaxInputShape("emu", S, B, "train"), step=k)
               for k in range(steps)]
    jres = jax_run_plan(
        jax_profile(jcfg, AWS_LAMBDA, seq=S, micro_batch=B // (d * mu)), AWS_LAMBDA,
        JaxConfig(x=x, d=d, z=(0,) * L), total_micro_batches=d * mu,
        exec_config=ExecutionConfig(steps=steps),
        execution=JaxExecution(cfg=jcfg, optimizer=_OPTIMIZERS[optimizer][1](lr=lr),
                               init_params=params0, batch_fn=lambda k: batches[k]))
    return dict(cfg=cfg, S=S, B=B, d=d, mu=mu, steps=steps, x=x, L=L, lr=lr, jres=jres,
                optimizer=optimizer,
                params=params_from_jax(_np_tree(params0), device="cpu"),
                batches=[_torch_batch(b) for b in batches])


def _two_steps_on_port(r: dict, use_kernels: bool):
    cfg, d, mu = r["cfg"], r["d"], r["mu"]
    prof = arch_model_profile(cfg, AWS, seq=r["S"], micro_batch=r["B"] // (d * mu))
    return run_plan(prof, AWS, Config(x=r["x"], d=d, z=(0,) * r["L"]),
                    total_micro_batches=d * mu, steps=r["steps"],
                    execution=Execution(cfg=cfg, optimizer=_OPTIMIZERS[r["optimizer"]][0](
                                            lr=r["lr"]),
                                        init_params=r["params"],
                                        batch_fn=lambda k: r["batches"][k],
                                        use_kernels=use_kernels, device="cpu"))


@pytest.fixture(scope="module")
def two_steps_jax():
    return _two_steps_on_jax("float32", 1e-2)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_engine_two_steps_match_jax_engine(two_steps_jax, use_kernels):
    """K=2 storage-backed AdamW steps, 2 stages x 2 replicas, pipelined
    sync: losses within 2e-4 and params within 2e-3 of the JAX engine's (the
    tolerances of tests/test_runtime.py:250-253); the virtual clock, cost
    and store traffic exactly equal."""
    res, jres = _two_steps_on_port(two_steps_jax, use_kernels), two_steps_jax["jres"]
    for got, want in zip(res.losses, jres.losses):
        assert abs(got - want) < 2e-4, (got, want)
    name, err = _param_err(res.params, jres.params)
    assert err < 2e-3, (name, err)
    _assert_same_clock(res, jres)
    assert res.steps == 2 and len(res.metrics) == 2 and res.backend == "emulated"


@pytest.fixture(scope="module", params=["sgd", "adamw"])
def two_steps_jax_gemma(request):
    """gemma3-4b@reduced at 12 layers: two periods of five window layers and
    one global layer, q/k norms; a stage of one period each."""
    return _two_steps_on_jax("float32", 1e-2, arch="gemma3-4b", n_layers=12,
                             optimizer=request.param)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_engine_gemma3_two_steps_match_jax_engine(two_steps_jax_gemma, use_kernels):
    """The same storage-backed steps on gemma3-4b@reduced (12 layers, 2
    stages of one period, 2 replicas), SGD and AdamW at lr 1e-2: losses
    within 2e-4 and params within 2e-3 of the JAX engine's; the clock, cost
    and store traffic exactly equal.  Under AdamW a few elements miss 2e-3:
    its first steps move each element by about lr whatever its gradient's
    size, so an element whose gradient is near 0 (100-1000x below the
    median) and whose sign the two summation orders decide differently
    lands up to 2 lr a step away.  There the bar is held on all but 1e-5 of
    the elements, and every element within 4 lr (two such steps)."""
    r = two_steps_jax_gemma
    res, jres = _two_steps_on_port(r, use_kernels), r["jres"]
    assert [s.inst_hi - s.inst_lo for s in stage_instance_ranges(r["cfg"], r["x"])] == [1, 1]
    for got, want in zip(res.losses, jres.losses):
        assert abs(got - want) < 2e-4, (got, want)
    name, err = _param_err(res.params, jres.params)
    if r["optimizer"] == "sgd":
        assert err < 2e-3, (name, err)
    else:
        past = sum(int((np.abs(b.detach().numpy() - np.asarray(a)) >= 2e-3).sum())
                   for a, b in zip(jax.tree.leaves(jres.params), tree_leaves(res.params)))
        total = sum(a.numel() for a in tree_leaves(res.params))
        assert past <= 1e-5 * total and err < 4 * r["lr"], (name, err, past, total)
    _assert_same_clock(res, jres)


# tests/test_torch_models.py's heads of 256 at the reduced width
HD256 = dict(d_model=512, n_heads=2, n_kv_heads=1, head_dim=256)


@pytest.fixture(scope="module")
def one_step_jax_gemma_hd256():
    """gemma3-4b@reduced at heads of 256 (``HD256``), one period (five
    window layers, window 64, and one global layer), fp32: one stage, d 1,
    2 micro-batches of 2 x 96 tokens (the window binds), SGD(0.05), 1 step
    on the JAX engine; the fp32 hd-256 path that train_gemma_fp32 runs on
    the card at full width."""
    jcfg, cfg = (dataclasses.replace(c, param_dtype="float32", **HD256)
                 for c in _cfgs("gemma3-4b", n_layers=6))
    B, S, mu = 4, 96, 2
    L = cfg.n_layers + 2
    x, z = (0,) * (L - 1), (0,) * L
    params0 = jreg.init_params(jcfg, jax.random.PRNGKey(3))
    batch = jax_make_batch(jcfg, JaxInputShape("hd256", S, B, "train"), seed=3, step=0)
    jres = jax_run_plan(
        jax_profile(jcfg, AWS_LAMBDA, seq=S, micro_batch=B // mu), AWS_LAMBDA,
        JaxConfig(x=x, d=1, z=z), total_micro_batches=mu, exec_config=ExecutionConfig(steps=1),
        execution=JaxExecution(cfg=jcfg, optimizer=JaxSGD(lr=0.05), init_params=params0,
                               batch_fn=lambda k: batch))
    return dict(cfg=cfg, S=S, B=B, mu=mu, x=x, z=z, jres=jres, batch=_torch_batch(batch),
                params=params_from_jax(_np_tree(params0), device="cpu"))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_engine_gemma3_hd256_fp32_sgd_matches_jax_engine(one_step_jax_gemma_hd256,
                                                         use_kernels):
    """The slice's fp32 hd-256 path end to end on the CPU (on the card,
    ``use_kernels`` sends flash attention to the tf32x3 route at hd 256):
    losses within 5e-5 and params within 1e-4 of the JAX engine's after one
    SGD step (tests/test_runtime.py:286-288); the clock, cost and store
    traffic exactly equal."""
    r = one_step_jax_gemma_hd256
    cfg = r["cfg"]
    assert cfg.head_dim == 256 and [s.window for s in cfg.period] == [64] * 5 + [0]
    res = run_plan(
        arch_model_profile(cfg, AWS, seq=r["S"], micro_batch=r["B"] // r["mu"]), AWS,
        Config(x=r["x"], d=1, z=r["z"]), total_micro_batches=r["mu"], steps=1,
        execution=Execution(cfg=cfg, optimizer=SGD(lr=0.05), init_params=r["params"],
                            batch_fn=lambda k: r["batch"], use_kernels=use_kernels,
                            device="cpu"))
    jres = r["jres"]
    assert abs(res.losses[0] - jres.losses[0]) < 5e-5, (res.losses, jres.losses)
    name, err = _param_err(res.params, jres.params)
    assert err < 1e-4, (name, err)
    _assert_same_clock(res, jres)


@pytest.fixture(scope="module")
def two_steps_jax_bf16():
    """The main path's types (bf16 params, fp32 masters) and the full-width
    run's AdamW(1e-4)."""
    return _two_steps_on_jax("bfloat16", 1e-4)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_engine_bf16_adamw_matches_jax_engine(two_steps_jax_bf16, use_kernels):
    """Mixed precision end to end (bf16 forward and backward, the bf16 ->
    fp32 gradient cast, fp32 masters, AdamW, the scatter-reduce): losses
    within 2e-3 (bf16 arithmetic on ~7) and params within 1e-3 of the JAX
    engine's.  The param bound is AdamW's first steps, which move each
    master by lr = 1e-4 whatever the gradient's size, so a gradient near 0
    whose sign differs costs 2e-4 a step, plus one bf16 ulp (4.9e-4 below
    0.125) when the masters are rounded to the params."""
    res, jres = _two_steps_on_port(two_steps_jax_bf16, use_kernels), two_steps_jax_bf16["jres"]
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(res.params))
    for got, want in zip(res.losses, jres.losses):
        assert abs(got - want) < 2e-3, (got, want)
    name, err = _param_err(res.params, jres.params)
    assert err < 1e-3, (name, err)
    _assert_same_clock(res, jres)


@pytest.mark.parametrize("pipelined", [True, False])
def test_engine_single_stage_sgd_is_tight(pipelined):
    """S=1, d=2: the pure scatter-reduce path with SGD, against the JAX
    engine within 5e-5 on the loss and 1e-4 on params
    (tests/test_runtime.py:286-288)."""
    jcfg, cfg = _cfgs()
    B, S = 8, 16
    L = cfg.n_layers + 2
    x, z = (0,) * (L - 1), (0,) * L
    params0 = jreg.init_params(jcfg, jax.random.PRNGKey(1))
    batch = jax_make_batch(jcfg, JaxInputShape("emu1", S, B, "train"), seed=1, step=0)
    jres = jax_run_plan(
        jax_profile(jcfg, AWS_LAMBDA, seq=S, micro_batch=2), AWS_LAMBDA,
        JaxConfig(x=x, d=2, z=z), total_micro_batches=4, exec_config=ExecutionConfig(steps=1),
        pipelined_sync=pipelined,
        execution=JaxExecution(cfg=jcfg, optimizer=JaxSGD(lr=0.05), init_params=params0,
                               batch_fn=lambda k: batch))
    tb = _torch_batch(batch)
    res = run_plan(
        arch_model_profile(cfg, AWS, seq=S, micro_batch=2), AWS, Config(x=x, d=2, z=z),
        total_micro_batches=4, steps=1, pipelined_sync=pipelined,
        execution=Execution(cfg=cfg, optimizer=SGD(lr=0.05),
                            init_params=params_from_jax(_np_tree(params0), device="cpu"),
                            batch_fn=lambda k: tb, device="cpu"))
    assert abs(res.losses[0] - jres.losses[0]) < 5e-5
    name, err = _param_err(res.params, jres.params)
    assert err < 1e-4, (name, err)
    _assert_same_clock(res, jres)


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("pipelined", [True, False])
def test_timing_only_run_equals_jax_engine(d, pipelined):
    """execution=None: only the virtual clocks and the store's byte counts
    move; 3 stages of phi3-mini-3.8b@reduced4 on arch_model_profile."""
    jcfg, cfg = _cfgs(n_layers=4)
    L = cfg.n_layers + 2
    x, z = _x(L, {1, 3}), (0, 0, 1, 1, 2, 2)
    jprof = jax_profile(jcfg, AWS_LAMBDA, seq=64, micro_batch=4)
    prof = arch_model_profile(cfg, AWS, seq=64, micro_batch=4)
    kw = dict(total_micro_batches=4 * d, pipelined_sync=pipelined)
    jres = jax_run_plan(jprof, AWS_LAMBDA, JaxConfig(x=x, d=d, z=z),
                        exec_config=ExecutionConfig(steps=3), **kw)
    res = run_plan(prof, AWS, Config(x=x, d=d, z=z), steps=3, **kw)
    _assert_same_clock(res, jres)
    assert res.params is None and res.metrics == []


def test_run_plan_takes_a_saved_training_plan(tmp_path):
    """A plan solved and saved by the JAX package loads in the port and
    runs numerically; its clock equals the JAX engine's on the same plan."""
    from repro.api import session

    from repro_torch.api.plan import DeploymentPlan

    model = "phi3-mini-3.8b@reduced4"
    jplan = session(model, "aws", global_batch=8, micro_batch=2, seq=16).plan(
        merge_to=None).deployment_plan
    path = tmp_path / "train.json"
    jplan.save(path)
    plan = DeploymentPlan.load(path)
    assert plan.workload == "train" and plan.merge_to is None
    jcfg, cfg = _cfgs(n_layers=4)
    params0 = jreg.init_params(jcfg, jax.random.PRNGKey(4))
    batch = _torch_batch(jax_make_batch(jcfg, JaxInputShape("p", 16, 8, "train")))
    res = run_plan(plan, steps=2, execution=Execution(
        cfg=cfg, optimizer=AdamW(lr=1e-2),
        init_params=params_from_jax(_np_tree(params0), device="cpu"),
        batch_fn=lambda k: batch, device="cpu"))
    jres = jax_run_plan(jplan, exec_config=ExecutionConfig(steps=2))
    _assert_same_clock(res, jres)
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert res.losses[1] < res.losses[0]


def test_run_plan_guard_rails():
    from repro_torch.api.plan import PlanCompatibilityError

    _, cfg = _cfgs()
    L = cfg.n_layers + 2
    args = (arch_model_profile(cfg, AWS, seq=16, micro_batch=2), AWS,
            Config(x=(0,) * (L - 1), d=1, z=(0,) * L), 2)
    traced = run_plan(*args, trace=True)     # ported (item 3a): a timing-only trace
    assert isinstance(traced.trace, Trace) and traced.trace.meta["clock"] == "virtual"
    assert len(traced.trace.spans) > 0 and run_plan(*args).trace is None
    from repro_torch.api.plan import DeploymentPlan

    measured = DeploymentPlan(
        model="phi3-mini-3.8b@reduced", platform="aws", x=(0,) * (L - 1), z=(0,) * L, d=1,
        total_micro_batches=2, alpha=(1.0, 0.0), pipelined_sync=True, merge_to=None, seq=16,
        micro_batch=2, profile_fingerprint="0" * 16, t_iter=0.0, c_iter=0.0, objective=0.0,
        solver="manual", engine="-", solve_seconds=0.0, profile_source="measured")
    with pytest.raises(PlanCompatibilityError, match="measured profile explicitly"):
        run_plan(measured)      # ported (item 3b): measured plans need their profile
    # ported (item 5): a chaos run recovers, a tolerance alone checkpoints
    from repro_torch.serverless import faults as F

    crash = F.FaultPlan(events=(F.FaultEvent(kind="crash", stage=0, replica=0, step=1),))
    chaos = run_plan(*args, steps=2, faults=crash)
    assert chaos.fault_report.restarts == 1 and chaos.fault_report.resumed_steps == [1]
    assert chaos.fault_report.checkpoints == 1 and chaos.store_stats.class_bytes_in["ckpt"] > 0
    tolerant = run_plan(*args, steps=2, tolerance=F.FaultTolerance())
    assert tolerant.fault_report.checkpoints == 1 and tolerant.fault_report.restarts == 0
    for backend in ("local", "process"):     # ported: timing-only runs drain
        assert run_plan(*args, backend=backend).backend == backend
    with pytest.raises(KeyError, match="unknown execution backend"):
        run_plan(*args, backend="warp-drive")
    with pytest.raises(ValueError, match="steps"):
        run_plan(*args, steps=0)

    class ServePlan:
        workload, model = "serve", "phi3-mini-3.8b@reduced"

        def resolve(self):   # pragma: no cover - refused before resolving
            raise AssertionError

    with pytest.raises(PlanCompatibilityError, match="workload"):
        run_plan(ServePlan())

    class TrainPlan(ServePlan):
        workload = "train"

    with pytest.raises(ValueError, match="takes no platform"):
        run_plan(TrainPlan(), AWS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_plan(*args, execution=Execution(
                cfg=cfg, optimizer=SGD(), init_params={}, batch_fn=lambda k: {}))


def test_make_batch_is_seeded_zipf():
    _, cfg = _cfgs()
    shape = InputShape("z", 64, 8, "train")
    a = make_batch(cfg, shape, seed=3, step=1, device="cpu")
    b = make_batch(cfg, shape, seed=3, step=1, device="cpu")
    c = make_batch(cfg, shape, seed=3, step=2, device="cpu")
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (8, 64)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], a["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < cfg.vocab_size
    shard = make_batch(cfg, shape, seed=3, step=1, shard=1, n_shards=2, device="cpu")
    assert shard["tokens"].shape == (4, 64)
    # Zipf(1.2): P(rank 1) = 1 / H(V, 1.2); JAX's sampler has the same law
    big = make_batch(cfg, InputShape("z", 512, 64, "train"), device="cpu")["tokens"]
    p0 = float((big == 0).float().mean())
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    expect = 1.0 / np.sum(ranks ** -1.2)
    assert abs(p0 - expect) < 0.01, (p0, expect)
    jtoks = np.asarray(jax_make_batch(_cfgs()[0], JaxInputShape("z", 512, 64, "train"))
                       ["tokens"])
    assert abs(float((jtoks == 0).mean()) - expect) < 0.01
    # decode batches: one uniform token a sequence, as JAX's randint
    dec = make_batch(cfg, InputShape("z", 8, 4096, "decode"), device="cpu")
    assert sorted(dec) == ["tokens"] and dec["tokens"].shape == (4096, 1)
    assert dec["tokens"].dtype == torch.int32
    assert int(dec["tokens"].min()) >= 0 and int(dec["tokens"].max()) < cfg.vocab_size
    assert abs(float((dec["tokens"] == 0).float().mean()) - 1 / cfg.vocab_size) < 0.002


def test_training_run_never_imports_jax():
    """A CPU training run through the port leaves jax and repro out of
    sys.modules."""
    code = (
        "import sys, dataclasses, torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.configs.base import InputShape\n"
        "from repro_torch.core.perfmodel import Config\n"
        "from repro_torch.core.profiler import arch_model_profile\n"
        "from repro_torch.data.synthetic import make_batch\n"
        "from repro_torch.models import registry\n"
        "from repro_torch.optim import AdamW\n"
        "from repro_torch.serverless.platform import get_platform\n"
        "from repro_torch.serverless.runtime import Execution, run_plan\n"
        "cfg = dataclasses.replace(get_config('phi3-mini-3.8b').reduced(), n_layers=2)\n"
        "plat = get_platform('aws')\n"
        "params = registry.init_params(cfg, torch.Generator().manual_seed(0), device='cpu')\n"
        "batch = make_batch(cfg, InputShape('t', 8, 4, 'train'), device='cpu')\n"
        "res = run_plan(arch_model_profile(cfg, plat, seq=8, micro_batch=1), plat,\n"
        "               Config(x=(0, 1, 0), d=2, z=(0, 0, 0, 0)), 4, steps=2,\n"
        "               execution=Execution(cfg=cfg, optimizer=AdamW(lr=1e-2),\n"
        "                   init_params=params, batch_fn=lambda k: batch, device='cpu'))\n"
        "assert len(res.losses) == 2\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.')) or m == 'repro')\n"
        "print('LEAKED', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout
