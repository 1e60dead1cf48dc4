"""Orchestrator: run a FuncPipe training plan end to end through an execution
backend (``repro.serverless.runtime.engine`` for the port).

Executes the GPipe schedule of the paper's Fig 3 for K steps on an
``S x d`` grid of serverless workers: per replica, the micro-batch forwards
flow downstream through activation keys, the reversed backwards flow
gradient keys upstream, then each stage's ``d`` replicas reduce their flat
fp32 gradients with a storage scatter-reduce (the pipelined eq (2) or the
three-phase eq (1)) and update their fp32 masters.

Two axes of use:

  * timing-only (``execution=None``): objects carry sizes, not values; on
    the emulated backend the virtual clocks charge the paper's cost model,
    exactly as the JAX package's engine does (same ``t_iter``, cost and
    ``StoreStats``);
  * numeric (``execution=Execution(...)``): K training steps with real
    PyTorch stage workers on ``Execution.device``; ``use_kernels=True``
    runs every attention layer and FFN through the CUDA kernels there.

Not charged (matching the simulator): input-batch fetches, the optimizer
update and cold starts.  After the last step the engine checks that the
store drained: every put deleted, bytes conserved.

The engine talks only to the ``ExecutionBackend`` protocol
(``serverless.backends``): ``emulated`` (virtual clocks, the default),
``local`` (worker threads over a blocking store) and ``process`` (spawned
worker processes over a file store, which run the programs themselves)
train to bit-identical params.  How to execute (backend, steps, tracing,
fault injection and the recovery policy) is an
:class:`~repro_torch.serverless.execution.ExecutionConfig`; a chaos run
(``faults=``) retries transient store errors, checkpoints each stage's
state into the object store and restarts the worker grid from the newest
checkpoint after a crash or under the platform's lifetime cap, and lands
on the fault-free run's params bit for bit.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.perfmodel import Config
from repro_torch.obs.ranges import STEP, phase_range
from repro_torch.serverless.execution import ExecutionConfig
from repro_torch.serverless.platform import GB, Platform
from repro_torch.serverless.runtime.store import StoreStats
from repro_torch.serverless.simulator import stage_aggregates, unpack_plan_args


@dataclass(frozen=True)
class Execution:
    """Numeric-execution attachment: which arch to run, and where."""

    cfg: Any                                  # ArchConfig
    optimizer: Any                            # repro_torch.optim.Optimizer
    init_params: dict                         # registry.init_params layout
    batch_fn: Callable[[int], dict]           # step -> global batch (leaves [B, ...])
    remat: bool = False                       # recompute the forward in the backward
    use_kernels: bool = False                 # flash_attention + swiglu kernels
    device: Any = "cuda"                      # where the stage workers run
    tolerance: Optional[Any] = None           # faults.FaultTolerance (retry /
    #                                           checkpoint / restart policy)


@dataclass(frozen=True)
class EngineResult:
    t_iter: float                 # seconds per training iteration (backend clock)
    t_total: float                # seconds for all steps (backend clock)
    steps: int
    cost: float                   # $ per iteration (GB-s pricing, all workers)
    n_workers: int
    total_mem_gb: float
    backend: str = "emulated"     # which ExecutionBackend executed the plan
    wall_clock: bool = False      # True: t_* are host seconds, not modeled
    breakdown: Dict[str, float] = field(default_factory=dict)
    metrics: List[Dict[str, float]] = field(default_factory=list)  # per step
    params: Optional[dict] = None          # final assembled params (numeric mode)
    store_stats: Optional[StoreStats] = None
    trace: Optional[Any] = None            # repro_torch.obs.Trace (trace=True runs)
    fault_report: Optional[Any] = None     # faults.FaultReport (chaos or
    #                                        fault-tolerant runs), else None

    @property
    def losses(self) -> List[float]:
        return [m["loss"] for m in self.metrics]


def _split_batch(batch: dict, r: int, d: int, m: int, mu: int) -> dict:
    """Micro-batch m of replica r from the global batch (row-contiguous)."""
    out = {}
    for key, a in batch.items():
        B = a.shape[0]
        if B % (d * mu):
            raise ValueError(f"global batch {B} does not split into d={d} x mu={mu}")
        mb = B // (d * mu)
        lo = r * (B // d) + m * mb
        out[key] = a[lo:lo + mb]
    return out


def _worker_step_program(ctx, *, k: int, s: int, r: int, agg, worker, batch,
                         losses: Dict):
    """One stage worker's step-``k`` program over its backend context: ``mu``
    forward micro-batches (a yield after each op group so the backend can
    interleave workers), the fwd/bwd phase fence, ``mu`` backwards in
    reverse order, then a ``("sync", grad_vector)`` yield answered with the
    reduced gradient (the sum over the stage's ``d`` replicas), from which
    the worker applies its update."""
    S, mu, d = agg.S, agg.mu, agg.d
    ce_acc = 0.0
    aux_acc = 0.0

    for m in range(mu):
        x_val, dep = (None, None)
        if s > 0:
            x_val, dep = ctx.download(f"k{k}/r{r}/m{m}/act{s - 1}")
        fn = None
        if worker is not None:
            batch_mb = _split_batch(batch, r, d, m, mu)
            fn = (lambda x_val=x_val, batch_mb=batch_mb, m=m:
                  worker.forward(m, x_val, batch_mb))
        res = ctx.compute(agg.t_fc[s], fn, after=dep)
        out = None
        if worker is not None:
            out, aux = res
            aux_acc += aux / (mu * d)
            if s == S - 1:
                ce_acc += float(out) / (mu * d)
        if s < S - 1:
            ctx.upload(f"k{k}/r{r}/m{m}/act{s}", agg.out_b[s], value=out)
        yield

    ctx.phase_barrier()   # backward downloads wait for the forward uploads

    for m in range(mu - 1, -1, -1):
        g_in, dep = (None, None)
        if s < S - 1:
            g_in, dep = ctx.download(f"k{k}/r{r}/m{m}/grad{s}")
        fn = None
        if worker is not None:
            fn = lambda g_in=g_in, m=m: worker.backward(m, g_in)  # noqa: E731
        g_out = ctx.compute(agg.t_bc[s], fn, after=dep)
        if s > 0:
            ctx.upload(f"k{k}/r{r}/m{m}/grad{s - 1}", agg.grad_b[s], value=g_out)
        yield

    vec = worker.grad_vector() if worker is not None else None
    reduced = yield ("sync", vec)
    if worker is not None:
        worker.apply_update(reduced, step=k)     # divides by d itself
        losses[(s, r)] = (ce_acc, aux_acc)


def measured_breakdown(spans) -> Dict[str, float]:
    """``compute`` and ``pipeline_comm`` of a wall-clock trace: the mean over
    steps of the slowest worker's compute seconds (each span's device
    interval where it has one, else its host interval) and of that worker's
    fwd/bwd transfer seconds (boundary downloads, their waits included, and
    uploads)."""
    compute: Dict[tuple, float] = {}
    comm: Dict[tuple, float] = {}
    for sp in spans:
        key = (sp.step, sp.stage, sp.replica)
        if sp.op == "compute":
            dev = sp.device_duration
            compute[key] = compute.get(key, 0.0) + (sp.duration if dev is None else dev)
        elif sp.op in ("download", "upload") and sp.phase in ("fwd", "bwd"):
            comm[key] = comm.get(key, 0.0) + sp.duration
    slowest: Dict[int, tuple] = {}
    for key, t in compute.items():
        if key[0] not in slowest or t > compute[slowest[key[0]]]:
            slowest[key[0]] = key
    if not slowest:
        return {}
    n = len(slowest)
    return {"compute": sum(compute[w] for w in slowest.values()) / n,
            "pipeline_comm": sum(comm.get(w, 0.0) for w in slowest.values()) / n}


def run_plan(
    profile,
    platform: Optional[Platform] = None,
    config: Optional[Config] = None,
    total_micro_batches: Optional[int] = None,
    exec_config: Optional[ExecutionConfig] = None,
    *,
    steps: Optional[int] = None,
    pipelined_sync: Optional[bool] = None,
    contention: bool = False,
    execution: Optional[Execution] = None,
    backend: Any = None,
    trace: Optional[bool] = None,
    faults: Optional[Any] = None,
    tolerance: Optional[Any] = None,
) -> EngineResult:
    """Execute training iterations of a plan through a backend.

    Takes the explicit ``(profile, platform, config, M)`` tuple or one
    training :class:`repro_torch.api.plan.DeploymentPlan` as the first
    argument.  How to execute is an :class:`ExecutionConfig`
    (``exec_config``); the ``steps`` / ``backend`` / ``trace`` / ``faults``
    / ``tolerance`` keywords are the deprecated legacy spelling of the same
    settings and may not be mixed with it.  ``pipelined_sync`` defaults to
    the plan's (eq (2) without a plan).  ``trace=True`` records one span per
    worker resource task (download, compute, upload, barrier, each
    scatter-reduce chunk's transfers, and the recovery's retry and restart
    reads) on the backend's clock and returns them as
    ``EngineResult.trace``; on a card a wall-clock compute span also carries
    its device interval, and ``local`` puts each worker's CPU seconds a step
    in the trace's ``meta["step_worker_cpu_s"]``.  On a wall-clock backend
    ``EngineResult.breakdown`` holds the measured ``sync`` and, traced,
    :func:`measured_breakdown`'s ``compute`` and ``pipeline_comm``.

    ``faults`` (a :class:`~repro_torch.serverless.faults.FaultPlan` or a
    path to its JSON) wraps the backend in a chaos ``FaultInjector``;
    ``tolerance`` (a ``FaultTolerance``, also settable as
    ``Execution.tolerance``) turns on the recovery: retry with backoff on
    transient store errors, per-stage param/optimizer checkpoints into the
    object store every N steps, and checkpoint/restart of the worker grid
    on a crash or under the function-lifetime cap."""
    ec = ExecutionConfig.merge(
        exec_config,
        dict(backend=backend, steps=steps, trace=trace, faults=faults,
             tolerance=tolerance),
        where="run_plan")
    steps, trace = ec.steps, ec.trace

    if hasattr(profile, "resolve") and getattr(profile, "workload", "train") != "train":
        from repro_torch.api.plan import PlanCompatibilityError

        raise PlanCompatibilityError(
            f"run_plan executes training plans; this plan for {profile.model!r} has "
            f"workload={profile.workload!r}: serve it with "
            "repro_torch.serving.run_serve_plan")
    # a plan given as such rides along in a traced run's meta
    plan_doc = profile._as_dict() if hasattr(profile, "_as_dict") else None
    profile, platform, config, total_micro_batches, pipelined_sync = \
        unpack_plan_args("run_plan", profile, platform, config, total_micro_batches,
                         pipelined_sync)
    agg = stage_aggregates(profile, platform, config, total_micro_batches,
                           contention=contention)
    S, mu, d = agg.S, agg.mu, agg.d

    from repro_torch.serverless.runtime.worker import (
        StageWorker,
        assemble_params,
        stage_instance_ranges,
    )

    be = base = ec.resolve_backend()

    # ------------------------------------------------ fault-tolerance setup
    report = None
    fm = None
    faults_obj = ec.resolved_faults()
    tol = ec.resolved_tolerance()
    if tol is None and execution is not None:
        tol = execution.tolerance
    if faults_obj is not None or tol is not None:
        from repro_torch.serverless import faults as F

        if faults_obj is not None and tol is None:
            tol = F.FaultTolerance()            # chaos implies recovery
        report = F.FaultReport()
        if faults_obj is not None:
            be = F.FaultInjector(be, faults_obj, report)
        # the Function Manager's lifetime policy: an explicit tolerance cap
        # wins, else the platform's (the fault plan's)
        cap = tol.lifetime_steps
        if cap is None and faults_obj is not None:
            cap = faults_obj.lifetime_steps
        if cap is not None:
            from repro_torch.checkpoint import FunctionManager

            fm = FunctionManager(lifetime_steps=cap, safety=tol.lifetime_safety)

    def mk_ctx(s: int, r: int):
        ctx = be.context(s, r)
        if tol is not None:
            ctx = F.ResilientContext(ctx, tol.retry, report)
        return ctx

    recorder = None
    if trace:
        from repro_torch.obs.schema import SpanRecorder

        recorder = SpanRecorder()
        be.attach_recorder(recorder)
    # a program-hosting backend (process) runs the worker programs in its
    # own workers: it takes the execution spec before open() and hands back
    # RPC proxies in place of StageWorkers
    hosts = be.hosts_programs
    if hosts:
        be.bind_run(execution=execution, config=config, tolerance=tol, report=report)

    def make_workers():
        if hosts:
            return be.worker_handles()
        spans = stage_instance_ranges(execution.cfg, config.x)
        return [[StageWorker(execution.cfg, spans[s], execution.init_params, mu=mu,
                             optimizer=execution.optimizer, remat=execution.remat,
                             use_kernels=execution.use_kernels, device=execution.device,
                             replicas=d)
                 for r in range(d)] for s in range(S)]

    metrics_by_step: Dict[int, Dict[str, float]] = {}
    iter_ends: Dict[int, float] = {}
    sync_durations: Dict[int, float] = {}
    worker_cpu: Dict[int, Dict] = {}
    workers = None

    # ------------------------------------------------ checkpoint / restart
    last_ckpt_step = -1          # state-after-step index of the newest ckpt
    ckpt_stages: set = set()     # stages with a live ckpt/s{s} object

    def write_checkpoint(k_done: int) -> None:
        """Checkpoint every stage's param/optimizer state into the object
        store (the state after step ``k_done``), charged like any upload.
        Replicas hold identical state, so one object a stage."""
        nonlocal last_ckpt_step
        from repro_torch.checkpoint import pack_state

        for s in range(S):
            blob = None
            if workers is not None:
                blob = pack_state(workers[s][0].export_state(), step=k_done + 1)
                nbytes = float(len(blob))
            else:
                # timing-only: fp32 masters and two moments beside the
                # stage's params, the modeled checkpoint payload
                nbytes = 3.0 * float(agg.s_stage[s])
            mk_ctx(s, 0).upload(f"ckpt/s{s}", nbytes, value=blob)
            del blob
            ckpt_stages.add(s)
        last_ckpt_step = k_done
        report.checkpoints += 1

    def restore_from_checkpoint() -> None:
        """Relaunch the worker grid from the newest store checkpoint (or from
        scratch when there is none yet): every worker re-fetches its stage's
        state (``op="restart"`` spans) and drops its transient step state.
        Bit-identical to never having crashed."""
        nonlocal workers
        from repro_torch.checkpoint import unpack_state

        if last_ckpt_step < 0:
            if execution is not None:       # nothing persisted: initial state
                workers = make_workers()
            return
        for s in range(S):
            state = None
            for r in range(d):
                value, _ = mk_ctx(s, r).fetch(f"ckpt/s{s}", op="restart")
                if workers is not None:
                    if state is None:       # restored onto the state's device
                        state, _step = unpack_state(value, workers[s][r].state_like())
                    workers[s][r].load_state(state)
                del value
            del state

    restarts = 0
    steps_since_launch = 0
    pending_restore = False
    k = 0
    try:
        be.open(agg)
        workers = make_workers() if execution is not None else None
        while k < steps:
            try:
                if pending_restore:
                    t0r = _time.perf_counter()
                    restore_from_checkpoint()
                    report.recovery_s += _time.perf_counter() - t0r
                    pending_restore = False
                if fm is not None and fm.should_restart(steps_since_launch):
                    # a planned relaunch under the platform's lifetime cap:
                    # checkpoint the progress, recycle the functions, restore
                    # (the paper's Function Manager, §3.1 ⑧)
                    if last_ckpt_step < k - 1:
                        write_checkpoint(k - 1)
                    be.recover()
                    fm.restarted()
                    report.planned_restarts += 1
                    t0r = _time.perf_counter()
                    restore_from_checkpoint()
                    report.recovery_s += _time.perf_counter() - t0r
                    steps_since_launch = 0
                with phase_range(STEP):
                    batch = execution.batch_fn(k) if execution is not None else None
                    losses: Dict = {}
                    if hosts:
                        be.stage_step(k, batch=batch, losses=losses)
                    programs = {
                        (s, r): _worker_step_program(
                            mk_ctx(s, r), k=k, s=s, r=r, agg=agg,
                            worker=None if workers is None else workers[s][r],
                            batch=batch, losses=losses)
                        for s in range(S) for r in range(d)
                    }
                    timing = be.run_step(k, programs, pipelined_sync=pipelined_sync)
            except Exception as e:
                from repro_torch.serverless import faults as F

                if tol is None or not F.is_recoverable(e):
                    raise
                if restarts >= tol.max_restarts:
                    raise F.FaultToleranceExceeded(
                        f"step {k} still failing after {restarts} restarts "
                        f"(max_restarts={tol.max_restarts}): {e}") from e
                restarts += 1
                report.restarts += 1
                be.recover()        # purge residual keys, revive the store
                k = last_ckpt_step + 1
                report.resumed_steps.append(k)
                steps_since_launch = 0
                pending_restore = True
                continue
            # a replayed step overwrites its aborted attempt's bookkeeping
            iter_ends[k] = timing.end
            sync_durations[k] = timing.sync
            if timing.worker_cpu_s:
                worker_cpu[k] = timing.worker_cpu_s
            if workers is not None:
                ce_sum = sum(losses[(S - 1, r)][0] for r in range(d))
                aux_sum = sum(losses[(s, r)][1] for s in range(S) for r in range(d))
                metrics_by_step[k] = {"ce": ce_sum, "aux": aux_sum, "loss": ce_sum + aux_sum}
            if (tol is not None and tol.checkpoint_every
                    and (k + 1) % tol.checkpoint_every == 0 and k + 1 < steps):
                write_checkpoint(k)
            k += 1
            steps_since_launch += 1
        # checkpoint objects are engine state, not leaked traffic: deleted
        # (counted) before the drain check
        for s in sorted(ckpt_stages):
            be.delete(f"ckpt/s{s}")
        be.verify_drained()
        stats = be.store_stats
        # assembled before close(): a program-hosting backend reads the
        # final params out of its worker processes
        params = None
        if workers is not None:
            params = assemble_params(execution.cfg, [workers[s][0] for s in range(S)])
    finally:
        be.close()

    ends = [iter_ends[i] for i in sorted(iter_ends)]
    syncs = [sync_durations[i] for i in sorted(sync_durations)]
    metrics = [metrics_by_step[i] for i in sorted(metrics_by_step)]
    t_total = iter_ends[steps - 1]
    t_iter = t_total / steps
    mem_total = d * float(agg.mem.sum())
    cost = platform.price_per_gb_s * (mem_total / GB) * t_iter
    comp = float(agg.t_fc.sum() + agg.t_bc.sum())
    sync_t = float(np.mean(syncs))
    trace_obj = None
    if recorder is not None:
        from repro_torch.obs.schema import Trace

        recorder.resolve()
        trace_obj = Trace(spans=recorder.spans, meta={
            "model": profile.name,
            "backend": be.name,
            "clock": "wall" if be.wall_clock else "virtual",
            "S": S, "d": d, "mu": mu, "steps": steps,
            "n_workers": agg.n_workers,
            "t_total": float(t_total),
            "t_iter": float(t_iter),
            "step_ends": [float(t) for t in ends],
            "step_syncs": [float(t) for t in syncs],
            "bandwidth": [float(w) for w in agg.w],
            "t_lat": float(agg.t_lat),
            "pipelined_sync": bool(pipelined_sync),
            "contention": bool(contention),
            "payload_true": bool(getattr(base, "payload_true", False)),
            "throttle": bool(getattr(base, "throttle", False)),
            "store": stats.as_dict(),
        })
        if worker_cpu:
            trace_obj.meta["step_worker_cpu_s"] = [
                {f"s{s}r{r}": t for (s, r), t in sorted(worker_cpu[i].items())}
                for i in sorted(worker_cpu)]
        if report is not None:
            trace_obj.meta["fault_report"] = report.as_dict()
        if plan_doc is not None:
            trace_obj.meta["plan"] = plan_doc
    if not be.wall_clock:
        breakdown = {
            "compute": comp,
            "pipeline_comm": float(max(0.0, t_iter - comp - sync_t)) if S > 1 else 0.0,
            "sync": sync_t,
        }
    else:
        # a wall clock's compute and transfers are measured or not given:
        # the analytic constants above are no reading of the host
        breakdown = {} if trace_obj is None else measured_breakdown(trace_obj.spans)
        breakdown["sync"] = sync_t
    return EngineResult(
        t_iter=float(t_iter),
        t_total=float(t_total),
        steps=steps,
        cost=float(cost),
        n_workers=agg.n_workers,
        total_mem_gb=mem_total / GB,
        breakdown=breakdown,
        backend=be.name,
        wall_clock=be.wall_clock,
        metrics=metrics,
        params=params,
        store_stats=stats,
        trace=trace_obj,
        fault_report=report,
    )
