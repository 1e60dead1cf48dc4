"""The port's fault tolerance, checkpoints and ``ExecutionConfig`` against the
live JAX package, on the CPU.

``FaultPlan`` draws the JAX package's schedule from the same seed (the same
JSON), ``RetryPolicy`` its delays, and ``ExecutionConfig`` its JSON.  The
checkpoint wire format (msgpack + npy) is byte-equal to ``repro.checkpoint``
for fp32 and integer stage states, and blobs restore across the packages; a
bf16 state round-trips in the port; restores validate treedef, dtype, shape
and garbage; the port's msgpack codec encodes as ``msgpack.packb(...,
use_bin_type=True)`` does.  Then the chaos schedule of
``tests/test_faults.py:76-86`` (a transient put, a transient get, a mid-bwd
crash and a 2-step lifetime cap) on the port's ``emulated`` backend, held
against live JAX chaos runs of the same schedule for both sync schedules:
losses within 2e-4, params within 2e-3 (the AdamW rule of ROADMAP §3: all
but 1e-5 of the elements), the ``FaultReport`` counters, ``StoreStats``,
the emulated clock and the traced spans exactly equal.  On ``local`` (eq
(2)) and ``process`` (eq (1), a real SIGKILLed child) the chaos runs land
on the port's own fault-free params bit for bit.  Timing-only chaos runs
of generated plans equal JAX's exactly; retry and restart exhaustion raise
the typed errors.
"""
import dataclasses
import json
import os
import warnings
from types import SimpleNamespace

import jax
import msgpack
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint import pack_state as jax_pack_state
from repro.checkpoint import unpack_state as jax_unpack_state
from repro.configs.base import InputShape as JaxInputShape
from repro.core.perfmodel import Config as JaxConfig
from repro.core.profiler import arch_model_profile as jax_profile
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models import registry as jreg
from repro.optim import AdamW as JaxAdamW
from repro.serverless import faults as JF
from repro.serverless.execution import ExecutionConfig as JaxExecutionConfig
from repro.serverless.platform import AWS_LAMBDA
from repro.serverless.runtime import Execution as JaxExecution
from repro.serverless.runtime import run_plan as jax_run_plan
from repro.serverless.runtime.worker import StageWorker as JaxStageWorker
from repro.serverless.runtime.worker import stage_instance_ranges as jax_ranges

from repro_torch.checkpoint import (
    CheckpointError,
    FunctionManager,
    pack_state,
    restore_checkpoint,
    save_checkpoint,
    unpack_state,
)
from repro_torch.checkpoint.ckpt import msgpack_pack, msgpack_unpack, treedef_str
from repro_torch.configs import get_config
from repro_torch.core.perfmodel import Config
from repro_torch.core.profiler import arch_model_profile
from repro_torch.models import registry
from repro_torch.models.common import tree_leaves
from repro_torch.obs import pipeline_health, validate_trace
from repro_torch.optim import AdamW
from repro_torch.serverless import faults as F
from repro_torch.serverless.backends import LocalBackend, ProcessBackend
from repro_torch.serverless.execution import ExecutionConfig
from repro_torch.serverless.platform import get_platform
from repro_torch.serverless.runtime import Execution, run_plan
from repro_torch.serverless.runtime.worker import StageWorker, stage_instance_ranges

torch.backends.cuda.matmul.allow_tf32 = False
AWS = get_platform("aws")
WAIT = 60.0                     # leases of the wall-clock runs: generous, never a sleep
LR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's CPU training runs (the spawned
    children inherit it): the suite runs several workers on the host's
    cores, and torch pools of a thread a core each starve one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ fault plans
_GENERATE = [dict(steps=4, S=3, d=2, n_transient=3, n_crashes=2, n_stragglers=1,
                  lifetime_steps=3),
             dict(steps=3, S=2, d=2, n_stragglers=1, lifetime_steps=2),
             dict(steps=1, S=1, d=1, transient_times=2, straggle_s=0.2)]


@pytest.mark.parametrize("seed", [0, 5, 11])
@pytest.mark.parametrize("kw", range(len(_GENERATE)))
def test_fault_plan_generate_equals_jax(seed, kw):
    """The same seed and sizes draw the same schedule: the same JSON, which
    each package reads back as the other's plan."""
    plan = F.FaultPlan.generate(seed, **_GENERATE[kw])
    jplan = JF.FaultPlan.generate(seed, **_GENERATE[kw])
    assert plan.to_json() == jplan.to_json()
    assert plan.counts() == jplan.counts()
    assert F.FaultPlan.from_json(jplan.to_json()) == plan
    assert JF.FaultPlan.from_json(plan.to_json()).to_json() == jplan.to_json()


def test_fault_plan_file_and_strict_fields(tmp_path):
    plan = F.FaultPlan.generate(5, steps=3, S=2, d=2, n_stragglers=1, lifetime_steps=2)
    path = tmp_path / "plan.json"
    plan.save(path)
    assert F.FaultPlan.load(path) == plan and JF.FaultPlan.load(path).seed == 5
    with pytest.raises(ValueError, match="unknown FaultEvent fields"):
        F.FaultEvent.from_dict({"kind": "crash", "stage": 0, "replica": 0, "step": 0,
                                "flavor": "spicy"})
    for bad in ('{"version": 2, "events": []}', "[1, 2]"):
        with pytest.raises(ValueError, match="version 1"):
            F.FaultPlan.from_json(bad)


def test_retry_policy_delays_equal_jax():
    """Backoff is a pure function of the policy, the attempt and the token:
    the same delays as JAX's, capped, token-jittered."""
    for kw in (dict(), dict(max_attempts=4, base_delay_s=0.05, multiplier=2.0,
                            max_delay_s=0.12, jitter=0.25), dict(jitter=0.0), dict(seed=3)):
        pol, jpol = F.RetryPolicy(**kw), JF.RetryPolicy(**kw)
        for token in ("", "k0/r0/m0/act0", "ckpt/s1"):
            assert [pol.delay(a, token) for a in range(1, 8)] == \
                [jpol.delay(a, token) for a in range(1, 8)]
    assert F.RetryPolicy(jitter=0.0).delay(3) == pytest.approx(0.2)


def test_function_manager_policy():
    fm = FunctionManager(lifetime_steps=2, safety=0.9)
    assert [fm.should_restart(n) for n in range(3)] == [False, True, True]
    assert not FunctionManager().should_restart(100)
    fm.restarted()
    assert fm.restarts == 1


# ---------------------------------------------------------- ExecutionConfig
def test_execution_config_json_equals_jax():
    """The same fields, validation and JSON document as JAX's; the legacy
    keywords warn, and mixing them with a config is refused."""
    kw = dict(backend="process", steps=3, trace=True, payload_true=True, bandwidth=1e8,
              faults=F.FaultPlan.generate(1, steps=3, S=2, d=2),
              tolerance=F.FaultTolerance(retry=F.RetryPolicy(base_delay_s=0.01)),
              retries=4, checkpoint_every=2)
    jkw = dict(kw, faults=JF.FaultPlan.generate(1, steps=3, S=2, d=2),
               tolerance=JF.FaultTolerance(retry=JF.RetryPolicy(base_delay_s=0.01)))
    ec, jec = ExecutionConfig(**kw), JaxExecutionConfig(**jkw)
    assert ec.throttle and ec.to_json() == jec.to_json()
    back = ExecutionConfig.from_json(jec.to_json())
    assert back.to_json() == jec.to_json()
    tol, jtol = back.resolved_tolerance(), jec.resolved_tolerance()
    assert dataclasses.asdict(tol) == dataclasses.asdict(jtol)
    assert tol.retry.max_attempts == 4 and tol.checkpoint_every == 2
    with pytest.raises(ValueError, match="process backend"):
        ExecutionConfig(payload_true=True).resolve_backend()
    with pytest.raises(ValueError, match="positive int"):
        ExecutionConfig(steps=0)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        assert ExecutionConfig.merge(None, dict(steps=2), where="t").steps == 2
    with pytest.raises(ValueError, match="not both"):
        ExecutionConfig.merge(ExecutionConfig(), dict(steps=2), where="t")


# --------------------------------------------------------- the wire format
@pytest.mark.parametrize("obj", [
    {"step": 1},
    {"step": 2**40, "treedef": "x" * 40, "leaves": [b"y" * 300, b"", b"z" * 70000]},
    {"a": [1, -1, -33, 200, 70000, 2**33, -200, -40000, -2**33, 127, 128, -32]},
    {"k" * 300: [[1] * 20, {"n": {}}]},
], ids=["small", "step-and-bins", "ints", "nested"])
def test_msgpack_codec_equals_msgpack(obj):
    """The port's codec encodes as ``msgpack.packb(use_bin_type=True)`` and
    decodes msgpack's bytes (bins as views)."""
    blob = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_pack(obj) == blob
    back = msgpack_unpack(blob)
    assert json.dumps(_plain(back), sort_keys=True) == json.dumps(_plain(obj), sort_keys=True)
    for other in (None, True, 1.5):      # outside the checkpoint's subset
        with pytest.raises((TypeError, ValueError)):
            msgpack_unpack(msgpack.packb({"x": other}))
        with pytest.raises(TypeError):
            msgpack_pack({"x": other})


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (bytes, memoryview)):
        return bytes(x).hex()
    return x


def test_treedef_string_equals_jax():
    for tree in ({"a": [1, {"c": 2}], "b": (3, 4), "n": None}, (5,), [], {},
                 {"params": {"w": 1}, "opt_state": {"w": {"master": 1, "m": 2, "v": 3}}}):
        assert treedef_str(tree) == str(jax.tree.flatten(tree)[1])


def _stage_states(dtype: str, *, n_layers=2):
    """Stage 0's initial state, built by the port's and by JAX's stage
    worker from the same weights (phi3@reduced, 2 stages, AdamW)."""
    jcfg = dataclasses.replace(jconfigs.get_config("phi3-mini-3.8b").reduced(),
                               n_layers=n_layers, param_dtype=dtype)
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b").reduced(), n_layers=n_layers,
                              param_dtype=dtype)
    L = n_layers + 2
    x = tuple(1 if i == 1 else 0 for i in range(L - 1))
    params0 = jreg.init_params(jcfg, jax.random.PRNGKey(3))
    jw = JaxStageWorker(jcfg, jax_ranges(jcfg, x)[0], params0, mu=2, optimizer=JaxAdamW())
    params = registry.params_from_jax(jax.tree.map(np.asarray, params0), device="cpu")
    w = StageWorker(cfg, stage_instance_ranges(cfg, x)[0], params, mu=2, replicas=1,
                    optimizer=AdamW(), device="cpu")
    return w.export_state(), jw.export_state()


def _same_values(port_tree, jax_tree):
    pl, jl = tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(pl) == len(jl)
    for a, b in zip(pl, jl):
        b = np.asarray(b)
        if a.dtype == torch.bfloat16:
            assert np.array_equal(a.view(torch.int16).numpy(), b.view(np.int16))
        else:
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
            assert np.array_equal(a.numpy(), b)


def test_pack_state_bytes_equal_jax_for_an_fp32_stage_state():
    """An fp32 stage state (params, masters, AdamW moments) packs to the
    JAX package's bytes, so the engine charges the same checkpoint upload."""
    state, jstate = _stage_states("float32")
    blob = pack_state(state, step=4)
    assert blob == jax_pack_state(jstate, step=4)
    assert msgpack.unpackb(blob)["treedef"] == str(jax.tree.flatten(jstate)[1])


def test_blobs_load_across_the_packages():
    state, jstate = _stage_states("float32")
    got, step = unpack_state(jax_pack_state(jstate, step=2), state)
    assert step == 2
    _same_values(got, jstate)
    back, jstep = jax_unpack_state(pack_state(state, step=3), jstate)
    assert jstep == 3
    _same_values(state, back)
    # integer leaves cross too
    ints = {"i": np.arange(5, dtype=np.int32), "n": None, "t": (np.int64(7),)}
    assert pack_state(ints) == jax_pack_state(ints)
    out, _ = unpack_state(jax_pack_state(ints), ints)
    assert out["i"].dtype == torch.int32 and out["t"][0].item() == 7


def test_bf16_state_round_trips_in_the_port():
    """A bf16 stage state (bf16 params beside fp32 masters and moments) is
    written as JAX writes one (descr '<V2') and restores bit for bit here,
    from the port's blob and from JAX's."""
    state, jstate = _stage_states("bfloat16")
    assert any(a.dtype == torch.bfloat16 for a in tree_leaves(state))
    blob = pack_state(state, step=1)
    assert blob == jax_pack_state(jstate, step=1)
    assert b"'descr': '<V2'" in blob
    for b in (blob, jax_pack_state(jstate, step=1)):
        got, step = unpack_state(b, state)
        assert step == 1
        for x, y in zip(tree_leaves(got), tree_leaves(state)):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_restore_copies_each_leaf_once_onto_the_target():
    """A restored leaf owns its memory (not a view of the blob) and lands
    where the target leaf is."""
    like = {"w": torch.zeros(64, 32), "b": torch.zeros(3, dtype=torch.bfloat16)}
    src = {"w": torch.randn(64, 32), "b": torch.randn(3).bfloat16()}
    blob = bytearray(pack_state(src))
    got, _ = unpack_state(blob, like)
    blob[:] = b"\0" * len(blob)
    assert torch.equal(got["w"], src["w"]) and torch.equal(got["b"], src["b"])
    assert got["w"].device == like["w"].device


@pytest.mark.parametrize("case", ["treedef", "dtype", "shape", "bf16-into-fp32",
                                  "garbage", "no-leaves", "truncated"])
def test_restore_validates_like_jax(case):
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.zeros((), np.float32)}
    blobs = {
        "treedef": (pack_state({"other": tree["w"]}), "treedef"),
        "dtype": (pack_state({"w": tree["w"].astype(np.float64), "b": tree["b"]}), "dtype"),
        "shape": (pack_state({"w": tree["w"][:1], "b": tree["b"]}), "shape"),
        "bf16-into-fp32": (pack_state({"w": torch.zeros(2, 3, dtype=torch.bfloat16),
                                       "b": torch.zeros(())}), "dtype"),
        "garbage": (b"\xc1 definitely not msgpack", "msgpack"),
        "no-leaves": (msgpack.packb({"step": 1}), "leaves"),
        "truncated": (pack_state(tree)[:-7], "msgpack"),
    }
    blob, match = blobs[case]
    with pytest.raises(CheckpointError, match=match):
        unpack_state(blob, tree)
    if case not in ("bf16-into-fp32", "truncated"):
        with pytest.raises(Exception, match=match):
            jax_unpack_state(blob, tree)


def test_checkpoint_file_survives_a_crashed_save(tmp_path, monkeypatch):
    path = str(tmp_path / "state.ckpt")
    v1 = {"w": torch.full((3,), 1.0)}
    save_checkpoint(path, v1, step=1)

    def crash_replace(src, dst):
        raise OSError("simulated crash before publish")

    monkeypatch.setattr(os, "replace", crash_replace)
    with pytest.raises(OSError, match="simulated crash"):
        save_checkpoint(path, {"w": torch.full((3,), 2.0)}, step=2)
    monkeypatch.undo()
    tree, step = restore_checkpoint(path, v1)
    assert step == 1 and torch.equal(tree["w"], v1["w"])
    # and the JAX package reads the file
    jtree, jstep = jax_unpack_state(open(path, "rb").read(), {"w": np.zeros(3, np.float32)})
    assert jstep == 1 and np.array_equal(np.asarray(jtree["w"]), np.ones(3, np.float32))


# ------------------------------------------------------- the chaos schedule
def _chaos_plan(M):
    """``tests/test_faults.py:76-86``: a transient put, a transient get, a
    mid-bwd crash and a 2-step function-lifetime cap."""
    return M.FaultPlan(events=(
        M.FaultEvent(kind="transient", stage=0, replica=0, step=0, op="put", index=0),
        M.FaultEvent(kind="transient", stage=1, replica=1, step=1, op="get", index=1),
        M.FaultEvent(kind="crash", stage=1, replica=0, step=1, phase="bwd"),
    ), lifetime_steps=2, seed=None)


def _tolerance(M):
    """``tests/test_faults.py:114-120``: checkpoints every step by default."""
    return M.FaultTolerance(retry=M.RetryPolicy(base_delay_s=0.01), lifetime_safety=0.9)


@pytest.fixture(scope="module")
def inputs():
    """``tests/test_backends.py``'s numeric plan for 3 steps: phi3@reduced,
    4 layers, 2 stages x 2 replicas, mu 2, AdamW(1e-2), JAX weights and
    batches."""
    jcfg = dataclasses.replace(jconfigs.get_config("phi3-mini-3.8b").reduced(), n_layers=4)
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b").reduced(), n_layers=4)
    B, seq, d, mu, steps = 8, 16, 2, 2, 3
    L = cfg.n_layers + 2
    x = tuple(1 if i == 2 else 0 for i in range(L - 1))
    params0 = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    jbatches = [jax_make_batch(jcfg, JaxInputShape("bparity", seq, B, "train"), step=k)
                for k in range(steps)]
    return SimpleNamespace(
        jcfg=jcfg, cfg=cfg, B=B, seq=seq, d=d, mu=mu, steps=steps, L=L, x=x,
        params0=params0, jbatches=jbatches,
        params=registry.params_from_jax(jax.tree.map(np.asarray, params0), device="cpu"),
        batches=[{k: torch.from_numpy(np.array(v)) for k, v in b.items()} for b in jbatches])


def _port_run(p, backend, pipelined, *, chaos, trace=False):
    prof = arch_model_profile(p.cfg, AWS, seq=p.seq, micro_batch=p.B // (p.d * p.mu))
    ec = ExecutionConfig(backend=backend, steps=p.steps, trace=trace,
                         faults=_chaos_plan(F) if chaos else None,
                         tolerance=_tolerance(F) if chaos else None)
    return run_plan(prof, AWS, Config(x=p.x, d=p.d, z=(0,) * p.L), p.d * p.mu, ec,
                    pipelined_sync=pipelined,
                    execution=Execution(cfg=p.cfg, optimizer=AdamW(lr=LR), init_params=p.params,
                                        batch_fn=lambda k: p.batches[k], device="cpu"))


_FAULT_FREE = {}


def _fault_free(p, pipelined):
    """The port's fault-free emulated run (cached per schedule)."""
    if pipelined not in _FAULT_FREE:
        _FAULT_FREE[pipelined] = _port_run(p, "emulated", pipelined, chaos=False)
    return _FAULT_FREE[pipelined]


@pytest.fixture(scope="module", params=[True, False], ids=["eq2", "eq1"])
def chaos(request, inputs):
    """One traced chaos run of the JAX engine on its emulated backend and
    the port's, for one sync schedule."""
    p, pipelined = inputs, request.param
    jres = jax_run_plan(
        jax_profile(p.jcfg, AWS_LAMBDA, seq=p.seq, micro_batch=p.B // (p.d * p.mu)),
        AWS_LAMBDA, JaxConfig(x=p.x, d=p.d, z=(0,) * p.L), total_micro_batches=p.d * p.mu,
        pipelined_sync=pipelined,
        exec_config=JaxExecutionConfig(steps=p.steps, trace=True, faults=_chaos_plan(JF),
                                       tolerance=_tolerance(JF)),
        execution=JaxExecution(cfg=p.jcfg, optimizer=JaxAdamW(lr=LR), init_params=p.params0,
                               batch_fn=lambda k: p.jbatches[k]))
    res = _port_run(p, "emulated", pipelined, chaos=True, trace=True)
    return SimpleNamespace(pipelined=pipelined, res=res, jres=jres)


def _report_counters(rep) -> dict:
    d = rep.as_dict()
    d.pop("recovery_s")         # retry backoff plus the host's restore seconds
    return d


def test_emulated_chaos_run_matches_jax(chaos):
    """Through the same faults the port's emulated run and JAX's recover
    alike: the same report counters (a retry, a crash restart, planned
    restarts, checkpoints, resumed step 1), the same store traffic and
    virtual clock to the last bit, losses within 2e-4 and params within
    2e-3.  Under AdamW(1e-2) for 3 steps one embedding element of the 0.26
    M misses 2e-3 (an element whose near-0 gradient's sign the summation
    order decides moves by up to 2 lr a step, ROADMAP §3); the bar is held
    on all but 1e-5 of the elements, and every element within 6 lr."""
    res, jres = chaos.res, chaos.jres
    rep = res.fault_report
    assert _report_counters(rep) == _report_counters(jres.fault_report)
    assert rep.retries >= 1 and rep.restarts >= 1 and rep.planned_restarts >= 1
    assert rep.checkpoints >= 1 and rep.injected == {"transient": 2, "crash": 1}
    assert res.store_stats.as_dict() == jres.store_stats.as_dict()
    assert (res.t_total, res.t_iter, res.cost) == (jres.t_total, jres.t_iter, jres.cost)
    for got, want in zip(res.losses, jres.losses, strict=True):
        assert abs(got - want) < 2e-4, (got, want)
    errs = [np.abs(b.numpy() - np.asarray(a, np.float32))
            for a, b in zip(jax.tree.leaves(jres.params), tree_leaves(res.params), strict=True)]
    past = sum(int((e >= 2e-3).sum()) for e in errs)
    total = sum(e.size for e in errs)
    assert past <= 1e-5 * total and max(float(e.max()) for e in errs) < 6 * LR


def test_emulated_chaos_trace_equals_jax(chaos):
    """The traced chaos runs' spans (the retry stalls, the restart reads,
    the replayed step) equal JAX's field for field; the trace validates and
    its recovery and byte reconciliation read as JAX's do."""
    tr, jtr = chaos.res.trace, chaos.jres.trace

    def rows(spans):
        return [(s.stage, s.replica, s.step, s.phase, s.op, s.start, s.end, s.nbytes, s.key)
                for s in spans]

    assert rows(tr.spans) == rows(jtr.spans)
    assert {s.op for s in tr.spans} >= {"retry", "restart"}
    validate_trace(tr)
    assert tr.meta["fault_report"] == chaos.res.fault_report.as_dict()
    rcv = pipeline_health(tr)["recovery"]
    assert rcv["retry_count"] >= 1 and rcv["restart_count"] >= 1 and rcv["restart_bytes"] > 0
    assert pipeline_health(tr)["reconciliation"]["ok"]


def test_emulated_chaos_run_is_bit_identical_to_fault_free(chaos, inputs):
    """The port's own acceptance bar: params bit for bit and losses equal
    to its fault-free run."""
    ref = _fault_free(inputs, chaos.pipelined)
    assert chaos.res.losses == ref.losses
    assert _bits_equal(chaos.res.params, ref.params)


def _bits_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x.cpu(), y.cpu())
        for x, y in zip(la, lb))


def test_local_chaos_run_is_bit_identical_to_fault_free(inputs):
    """eq (2) on worker threads over the blocking store: the faults fire on
    real threads (the crash poisons the store, the peers fail over), the
    traced run validates with wall-clock retry and restart spans, and the
    params land on the fault-free run's bit for bit."""
    res = _port_run(inputs, LocalBackend(lease_timeout=WAIT), True, chaos=True, trace=True)
    ref = _fault_free(inputs, True)
    rep = res.fault_report
    assert rep.retries >= 1 and rep.restarts >= 1 and rep.planned_restarts >= 1
    assert rep.resumed_steps == [1] and rep.injected == {"transient": 2, "crash": 1}
    assert res.losses == ref.losses and _bits_equal(res.params, ref.params)
    validate_trace(res.trace)
    assert {s.op for s in res.trace.spans} >= {"retry", "restart"}


@pytest.mark.parametrize("backend", ["emulated", "local"])
def test_chaos_run_leaves_no_tensor_in_a_reference_cycle(inputs, backend):
    """A recovered run frees what it restored and what the crashed step
    held as soon as the run lets go of it: no tensor waits in a reference
    cycle for the garbage collector (on the card such a cycle held a
    restored stage's state, gigabytes, past the run)."""
    import gc

    gc.collect()
    gc.disable()
    try:
        res = _port_run(inputs, LocalBackend(lease_timeout=WAIT) if backend == "local"
                        else backend, True, chaos=True)
        assert res.fault_report.restarts >= 1
        del res
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert cyclic == []


def test_process_chaos_run_is_bit_identical_to_fault_free(inputs):
    """eq (1) on spawned worker processes over the file store: the injected
    crash SIGKILLs a real child, which the backend reaps and respawns; the
    children's retries reach the report, and the params land on the
    fault-free run's bit for bit."""
    be = ProcessBackend(lease_timeout=WAIT)
    res = _port_run(inputs, be, False, chaos=True)
    ref = _fault_free(inputs, False)
    rep = res.fault_report
    assert rep.retries >= 1 and rep.restarts >= 1 and rep.planned_restarts >= 1
    assert rep.checkpoints >= 1 and rep.injected.get("crash") == 1
    assert res.losses == ref.losses and _bits_equal(res.params, ref.params)


# ----------------------------------------------------- timing-only chaos runs
def _timing_args(M, d, S_cut):
    """A timing-only plan of phi3@reduced at ``d`` replicas, in one package."""
    if M is F:
        prof = arch_model_profile(get_config("phi3-mini-3.8b").reduced(), AWS, seq=64,
                                  micro_batch=4)
        return prof, AWS, Config(x=S_cut, d=d, z=(2,) * prof.L), 8
    prof = jax_profile(jconfigs.get_config("phi3-mini-3.8b").reduced(), AWS_LAMBDA, seq=64,
                       micro_batch=4)
    return prof, AWS_LAMBDA, JaxConfig(x=S_cut, d=d, z=(2,) * prof.L), 8


@pytest.mark.parametrize("seed", [1, 2, 7])
@pytest.mark.parametrize("pipelined", [True, False], ids=["eq2", "eq1"])
def test_generated_timing_chaos_equals_jax(seed, pipelined):
    """Seeded plans (transients, crashes, stragglers, a lifetime cap) over a
    timing-only 3-stage, d = 2 run: the report, store traffic and clock
    exactly JAX's, with checkpoints every 2 steps."""
    x = (1, 1, 0)
    out = {}
    for M, run, EC in ((F, run_plan, ExecutionConfig),
                       (JF, jax_run_plan, JaxExecutionConfig)):
        plan = M.FaultPlan.generate(seed, steps=4, S=3, d=2, n_transient=3, n_crashes=2,
                                    n_stragglers=1, lifetime_steps=3)
        ec = EC(steps=4, faults=plan, tolerance=M.FaultTolerance(checkpoint_every=2))
        out[M] = run(*_timing_args(M, 2, x), ec, pipelined_sync=pipelined)
    res, jres = out[F], out[JF]
    assert _report_counters(res.fault_report) == _report_counters(jres.fault_report)
    assert res.store_stats.as_dict() == jres.store_stats.as_dict()
    assert (res.t_total, res.t_iter, res.cost) == (jres.t_total, jres.t_iter, jres.cost)


# ------------------------------------------------------ budgets + exhaustion
def test_retry_exhaustion_raises_typed_error(inputs):
    plan = F.FaultPlan(events=(F.FaultEvent(kind="transient", stage=0, replica=0, step=0,
                                            op="put", index=0, times=10),))
    tol = F.FaultTolerance(retry=F.RetryPolicy(max_attempts=3, base_delay_s=0.001))
    with pytest.raises(F.FaultToleranceExceeded, match="still failing"):
        run_plan(*_timing_args(F, 2, (0, 1, 0)),
                 ExecutionConfig(steps=2, faults=plan, tolerance=tol))


def test_restart_budget_exhaustion_raises_typed_error():
    events = tuple(F.FaultEvent(kind="crash", stage=0, replica=0, step=k, phase=ph)
                   for k in range(2) for ph in ("fwd", "bwd"))
    with pytest.raises(F.FaultToleranceExceeded, match="max_restarts"):
        run_plan(*_timing_args(F, 2, (0, 1, 0)),
                 ExecutionConfig(steps=2, faults=F.FaultPlan(events=events),
                                 tolerance=F.FaultTolerance(max_restarts=2)))
    assert not F.is_recoverable(F.FaultToleranceExceeded("x"))
    assert F.is_recoverable(F.WorkerCrashed("x")) and F.is_recoverable(TimeoutError())


def test_execution_tolerance_field_and_checkpoint_cadence(inputs):
    """``Execution.tolerance`` turns the recovery on like the keyword; with
    ``checkpoint_every=2`` a crash in step 2 resumes from step 2 (the state
    after step 1), and the params land on the fault-free run's."""
    p = inputs
    prof = arch_model_profile(p.cfg, AWS, seq=p.seq, micro_batch=p.B // (p.d * p.mu))
    ex = Execution(cfg=p.cfg, optimizer=AdamW(lr=LR), init_params=p.params,
                   batch_fn=lambda k: p.batches[k], device="cpu",
                   tolerance=F.FaultTolerance(checkpoint_every=2))
    plan = F.FaultPlan(events=(F.FaultEvent(kind="crash", stage=0, replica=1, step=2,
                                            phase="fwd"),))
    res = run_plan(prof, AWS, Config(x=p.x, d=p.d, z=(0,) * p.L), p.d * p.mu,
                   ExecutionConfig(steps=p.steps, faults=plan), pipelined_sync=True,
                   execution=ex)
    assert res.fault_report.restarts == 1 and res.fault_report.resumed_steps == [2]
    assert res.fault_report.checkpoints == 1
    assert _bits_equal(res.params, _fault_free(p, True).params)


def test_straggler_and_warnings_do_not_change_numbers(inputs):
    """An injected straggle stalls the clock only; the legacy keywords still
    work (with a DeprecationWarning)."""
    p = inputs
    prof = arch_model_profile(p.cfg, AWS, seq=p.seq, micro_batch=p.B // (p.d * p.mu))
    plan = F.FaultPlan(events=(F.FaultEvent(kind="straggle", stage=0, replica=0, step=0,
                                            slow_s=0.5),))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = run_plan(prof, AWS, Config(x=p.x, d=p.d, z=(0,) * p.L), p.d * p.mu,
                       steps=p.steps, pipelined_sync=True, faults=plan,
                       execution=Execution(cfg=p.cfg, optimizer=AdamW(lr=LR),
                                           init_params=p.params,
                                           batch_fn=lambda k: p.batches[k], device="cpu"))
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    ref = _fault_free(p, True)
    assert res.fault_report.injected == {"straggle": 1} and res.t_total > ref.t_total
    assert _bits_equal(res.params, ref.params)


def test_blob_bytes_are_the_checkpoint_upload(chaos, inputs):
    """The engine charges a checkpoint its blob's length: the ckpt class of
    the store equals the JAX run's, and it is the packed state's size."""
    st = chaos.res.store_stats
    assert st.class_bytes_in["ckpt"] == chaos.jres.store_stats.class_bytes_in["ckpt"]
    p = inputs
    spans = stage_instance_ranges(p.cfg, p.x)
    blobs = [pack_state(StageWorker(p.cfg, spans[s], p.params, mu=p.mu, replicas=1,
                                    optimizer=AdamW(), device="cpu").export_state())
             for s in range(2)]
    per_ckpt = float(sum(len(b) for b in blobs))
    assert st.class_bytes_in["ckpt"] == pytest.approx(
        chaos.res.fault_report.checkpoints * per_ckpt, rel=1e-12)
