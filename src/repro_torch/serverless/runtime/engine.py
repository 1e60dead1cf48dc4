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
train to bit-identical params.  Ported: those backends, tracing
(``trace=True``: ``EngineResult.trace``, a ``repro_torch.obs.Trace``) and
the legacy keywords ``steps``, ``backend``, ``pipelined_sync`` and
``execution``.  Not yet: fault injection and tolerance with
``ExecutionConfig`` (ROADMAP port queue item 5).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.perfmodel import Config
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
    reduced gradient, from which the worker applies its update."""
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
        # x / 1 is x: a single replica's gradient goes in without a copy
        worker.apply_update(reduced / d if d > 1 else reduced, step=k)
        losses[(s, r)] = (ce_acc, aux_acc)


def run_plan(
    profile,
    platform: Optional[Platform] = None,
    config: Optional[Config] = None,
    total_micro_batches: Optional[int] = None,
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
    argument.  ``backend`` is a registered name (``"emulated"`` when None,
    ``"local"``, ``"process"``, ...) or an :class:`ExecutionBackend`
    instance.  ``steps`` defaults to 1, ``pipelined_sync`` to the plan's
    (eq (2) without a plan).  ``trace=True`` records one span per worker
    resource task (download, compute, upload, barrier, and each
    scatter-reduce chunk's transfers) on the backend's clock and returns
    them as ``EngineResult.trace``."""
    if faults is not None or tolerance is not None:
        raise NotImplementedError(
            "faults / tolerance: fault injection and recovery are not ported "
            "yet: ROADMAP port queue item 5 (fault tolerance)")
    steps = 1 if steps is None else steps
    if not isinstance(steps, int) or steps < 1:
        raise ValueError(f"steps must be a positive int, got {steps!r}")

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

    from repro_torch.serverless.backends import get_backend
    from repro_torch.serverless.runtime.worker import (
        StageWorker,
        assemble_params,
        stage_instance_ranges,
    )

    be = get_backend("emulated" if backend is None else backend)
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
        be.bind_run(execution=execution, config=config)
    metrics: List[Dict[str, float]] = []
    iter_ends: List[float] = []
    sync_durations: List[float] = []
    try:
        be.open(agg)
        workers = None
        if execution is not None and hosts:
            workers = be.worker_handles()
        elif execution is not None:
            spans = stage_instance_ranges(execution.cfg, config.x)
            workers = [[StageWorker(execution.cfg, spans[s], execution.init_params, mu=mu,
                                    optimizer=execution.optimizer, remat=execution.remat,
                                    use_kernels=execution.use_kernels,
                                    device=execution.device)
                        for r in range(d)] for s in range(S)]
        for k in range(steps):
            batch = execution.batch_fn(k) if execution is not None else None
            losses: Dict = {}
            if hosts:
                be.stage_step(k, batch=batch, losses=losses)
            programs = {
                (s, r): _worker_step_program(
                    be.context(s, r), k=k, s=s, r=r, agg=agg,
                    worker=None if workers is None else workers[s][r],
                    batch=batch, losses=losses)
                for s in range(S) for r in range(d)
            }
            timing = be.run_step(k, programs, pipelined_sync=pipelined_sync)
            iter_ends.append(timing.end)
            sync_durations.append(timing.sync)
            if workers is not None:
                ce_sum = sum(losses[(S - 1, r)][0] for r in range(d))
                aux_sum = sum(losses[(s, r)][1] for s in range(S) for r in range(d))
                metrics.append({"ce": ce_sum, "aux": aux_sum, "loss": ce_sum + aux_sum})
        be.verify_drained()
        stats = be.store_stats
        # assembled before close(): a program-hosting backend reads the
        # final params out of its worker processes
        params = None
        if workers is not None:
            params = assemble_params(execution.cfg, [workers[s][0] for s in range(S)])
    finally:
        be.close()

    t_total = iter_ends[-1]
    t_iter = t_total / steps
    mem_total = d * float(agg.mem.sum())
    cost = platform.price_per_gb_s * (mem_total / GB) * t_iter
    comp = float(agg.t_fc.sum() + agg.t_bc.sum())
    sync_t = float(np.mean(sync_durations))
    trace_obj = None
    if recorder is not None:
        from repro_torch.obs.schema import Trace

        trace_obj = Trace(spans=recorder.spans, meta={
            "model": profile.name,
            "backend": be.name,
            "clock": "wall" if be.wall_clock else "virtual",
            "S": S, "d": d, "mu": mu, "steps": steps,
            "n_workers": agg.n_workers,
            "t_total": float(t_total),
            "t_iter": float(t_iter),
            "step_ends": [float(t) for t in iter_ends],
            "step_syncs": [float(t) for t in sync_durations],
            "bandwidth": [float(w) for w in agg.w],
            "t_lat": float(agg.t_lat),
            "pipelined_sync": bool(pipelined_sync),
            "contention": bool(contention),
            "payload_true": bool(getattr(be, "payload_true", False)),
            "throttle": bool(getattr(be, "throttle", False)),
            "store": stats.as_dict(),
        })
        if plan_doc is not None:
            trace_obj.meta["plan"] = plan_doc
    return EngineResult(
        t_iter=float(t_iter),
        t_total=float(t_total),
        steps=steps,
        cost=float(cost),
        n_workers=agg.n_workers,
        total_mem_gb=mem_total / GB,
        breakdown={
            "compute": comp,
            "pipeline_comm": float(max(0.0, t_iter - comp - sync_t)) if S > 1 else 0.0,
            "sync": sync_t,
        },
        backend=be.name,
        wall_clock=be.wall_clock,
        metrics=metrics,
        params=params,
        store_stats=stats,
        trace=trace_obj,
    )
