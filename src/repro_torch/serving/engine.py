"""Pipelined serving on the execution backends: partitioned prefill +
token-by-token decode as worker programs over the object store
(``repro.serving.engine`` for the port).

Each stage runs one :func:`serve_worker_program` generator over its
``WorkerContext``:

* **prefill** — download the upstream hidden state (``serve/p/act{s-1}``),
  run the stage's prefill, publish the boundary (``serve/p/act{s}``) and the
  stage's decode caches (``kv/s{s}``); the head stage emits token 0 and
  feeds it back (``serve/tok/t0``).
* **decode round t** — download the stage KV (``kv/s{s}``) and the input
  (the fed-back token on stage 0, ``serve/dec/t{t}/act{s-1}`` elsewhere),
  run one decode step, re-publish the KV, forward the boundary; the head
  stage emits token t.

Serverless functions are stateless between invocations, so the KV cache is
store traffic: every decode round round-trips it, which is what the cost
model charges.  On the emulated backend values stay tensors on the device
and the store and the virtual clocks see their byte counts, which equal the
JAX package's, so ``t_request``, the cost and ``StoreStats`` of a run match
the JAX run's exactly.  On the process backend each stage is a spawned
worker process and every value crosses a file as host bytes; the tokens
are the same.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import nbytes, resolve_device, tree_leaves
from repro_torch.serving.cost import ServingSpec, arch_config_for_model, estimate_serving
from repro_torch.serving.worker import ServeStageWorker, greedy_token

SERVE_BACKENDS = ("emulated", "process")


@dataclass(frozen=True)
class ServeResult:
    """One pipelined serving request, executed."""

    tokens: np.ndarray              # [B, new_tokens] int32 greedy tokens
    t_request: float                # request latency (s): virtual clock on
    #                                 emulated, host wall clock on process
    cost_per_request: float         # $ (stage memory occupied for t_request)
    cost_per_1k: float
    backend: str
    store_stats: Any                # runtime.store.StoreStats
    kv_bytes: Tuple[float, ...]     # [S] modeled per-stage KV-cache bytes
    round_wall_s: Tuple[float, ...]  # host wall time of each pipeline round
    #                                  (prefill first), device synchronised;
    #                                  emulated only (process: its stages
    #                                  overlap, t_request is the wall time)
    worker_reports: Tuple[dict, ...] = ()  # process: each stage worker's
    #                                  kernel launches and peak device memory
    trace: Optional[Any] = None     # repro_torch.obs.Trace when tracing


def serve_worker_program(ctx, *, s: int, S: int, worker: ServeStageWorker,
                         toks: torch.Tensor, n_new: int,
                         t_prefill=None, t_decode=None,
                         sink: Optional[List[torch.Tensor]] = None,
                         on_decode=None):
    """Stage ``s``'s serving program; yields once per pipeline round.

    ``t_prefill``/``t_decode`` are per-stage compute costs charged on the
    virtual clock.  The head stage appends each greedy token ([B, 1] int32)
    to ``sink``.  ``on_decode`` fires once when the program leaves prefill
    (a wall-clock tracer flips its phase there; the emulated driver sets
    the recorder's phase instead)."""
    tp = 0.0 if t_prefill is None else float(t_prefill[s])
    td = 0.0 if t_decode is None else float(t_decode[s])

    # ------------------------------------------------------------- prefill
    if s == 0:
        x_in, dep = toks, None
    else:
        x_in, dep = ctx.download(f"serve/p/act{s - 1}")
    out, caches = ctx.compute(tp, lambda: worker.prefill(x_in), after=dep)
    kv_nbytes = 0.0
    if worker.has_layers:
        kv_nbytes = float(sum(nbytes(leaf) for leaf in tree_leaves(caches)))
    if s < S - 1:
        ctx.upload(f"serve/p/act{s}", float(nbytes(out)), out)
    else:
        tok = greedy_token(out)
        if sink is not None:
            sink.append(tok)
        if n_new > 1:
            ctx.upload("serve/tok/t0", float(nbytes(tok)), tok)
    if worker.has_layers:
        ctx.upload(f"kv/s{s}", kv_nbytes, caches)
    yield

    # -------------------------------------------------------- decode rounds
    if on_decode is not None and n_new > 1:
        on_decode()
    for t in range(1, n_new):
        if worker.has_layers:
            caches, dep_kv = ctx.download(f"kv/s{s}")
        else:
            caches, dep_kv = None, None
        if s == 0:
            x_in, dep_in = ctx.download(f"serve/tok/t{t - 1}")
        else:
            x_in, dep_in = ctx.download(f"serve/dec/t{t}/act{s - 1}")
        deps = [d for d in (dep_kv, dep_in) if d is not None]
        out, caches = ctx.compute(
            td, lambda c=caches, x=x_in: worker.decode(c, x),
            after=max(deps) if deps else None)
        if worker.has_layers:
            ctx.upload(f"kv/s{s}", kv_nbytes, caches)
        if s < S - 1:
            ctx.upload(f"serve/dec/t{t}/act{s}", float(nbytes(out)), out)
        else:
            tok = greedy_token(out)
            if sink is not None:
                sink.append(tok)
            if t < n_new - 1:
                ctx.upload(f"serve/tok/t{t}", float(nbytes(tok)), tok)
        yield


def _spec_from_plan(plan) -> ServingSpec:
    sv = plan.serving or {}
    return ServingSpec(slo_s=sv["slo_s"], batch=sv["batch"],
                       prefill_tokens=sv["prefill_tokens"],
                       new_tokens=sv["new_tokens"])


def make_prompt(cfg, batch: int, prefill_tokens: int, *,
                seed: int = 0) -> np.ndarray:
    """Deterministic prompt token ids [batch, prefill_tokens] int32, drawn
    from a numpy generator seeded with ``seed`` (the JAX package draws with
    ``jax.random``: same distribution, other ids)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(batch, prefill_tokens),
                        dtype=np.int32)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_serve_plan(plan, *, backend: str = "emulated", seed: int = 0,
                   prompt: Optional[np.ndarray] = None,
                   use_kernels: bool = False, params: Optional[dict] = None,
                   device="cuda", root: Optional[str] = None,
                   payload_true: bool = True, throttle: bool = False,
                   trace: bool = False) -> ServeResult:
    """Execute a ``workload="serve"`` plan end to end on a backend, the
    numerics on ``device``.  ``"emulated"`` charges the serving cost model on
    per-stage virtual clocks; ``"process"`` runs each stage as a spawned
    worker process over a file store under ``root`` (a temporary directory
    when None) and reports the request's wall time, charging real payload
    bytes when ``payload_true`` and sleeping each transfer to the plan's
    bandwidth when ``throttle``.  ``params`` is the port's parameter tree
    (e.g. from ``registry.params_from_jax``); when None, weights are drawn
    from ``seed``.  ``use_kernels`` routes each capable decode layer through
    the CUDA decode-attention kernel (on a CPU device, its plain version).
    Tokens are bit-identical across backends and to the monolithic
    :func:`reference_decode` on the same device.  ``trace=True`` records
    the stages' spans (phases ``prefill`` and ``decode``) on the backend's
    clock as ``ServeResult.trace``."""
    from repro_torch.api.plan import PlanCompatibilityError
    from repro_torch.models import registry
    from repro_torch.serverless.backends.emulated import EmulatedBackend
    from repro_torch.serverless.platform import GB
    from repro_torch.serverless.runtime.worker import stage_instance_ranges
    from repro_torch.serverless.simulator import stage_aggregates

    if getattr(plan, "workload", "train") != "serve":
        raise PlanCompatibilityError(
            "run_serve_plan executes serving plans; this plan for "
            f"{plan.model!r} has workload={plan.workload!r}")
    if backend not in SERVE_BACKENDS:
        raise ValueError(
            f"unknown serving backend {backend!r}; supported: {SERVE_BACKENDS}")
    dev = resolve_device(device)

    rp = plan.resolve()
    cfg = arch_config_for_model(plan.model)
    spec = _spec_from_plan(plan)
    est = estimate_serving(rp.profile, rp.platform, rp.config, cfg, spec)
    agg = stage_aggregates(rp.profile, rp.platform, rp.config, 1)
    ranges = stage_instance_ranges(cfg, plan.x)
    S = len(ranges)
    if params is None:
        params = registry.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    toks = (np.asarray(prompt, dtype=np.int32) if prompt is not None
            else make_prompt(cfg, spec.batch, spec.prefill_tokens, seed=seed))
    if toks.shape != (spec.batch, spec.prefill_tokens):
        raise ValueError(
            f"prompt shape {toks.shape} != plan's request shape "
            f"({spec.batch}, {spec.prefill_tokens})")
    rec = None
    if trace:
        from repro_torch.obs.schema import SpanRecorder

        rec = SpanRecorder()

    if backend == "emulated":
        toks_t = torch.tensor(toks, device=dev)
        be = EmulatedBackend()
        if rec is not None:
            be.attach_recorder(rec)
        be.open(agg)
        try:
            workers = [ServeStageWorker(cfg, ranges[s], params, s_ctx=spec.s_ctx,
                                        use_kernels=use_kernels)
                       for s in range(S)]
            sink: List[torch.Tensor] = []
            programs = [serve_worker_program(
                be.context(s, 0), s=s, S=S, worker=workers[s], toks=toks_t,
                n_new=spec.new_tokens, t_prefill=est.t_prefill_stage,
                t_decode=est.t_decode_stage,
                sink=sink if s == S - 1 else None) for s in range(S)]
            walls = []
            for t in range(spec.new_tokens):   # prefill, then the decode rounds
                if rec is not None:
                    rec.set_phase("prefill" if t == 0 else "decode")
                _sync(dev)
                t0 = time.perf_counter()
                for s in range(S):             # producers before consumers
                    next(programs[s])
                _sync(dev)
                walls.append(time.perf_counter() - t0)
            for p in programs:
                p.close()
            tokens = torch.cat(sink, dim=1).cpu().numpy()
            t_request = max(float(be.channels[s][0].now) for s in range(S))
            _drain_kv(be, ranges)
            stats = be.store_stats
        finally:
            be.close()
        reports: Tuple[dict, ...] = ()
    else:
        from repro_torch.serverless.backends.process import ProcessBackend

        if use_kernels and dev.type == "cuda":
            # built once here: the stage processes load the finished libraries
            from repro_torch.kernels import build as kernel_build

            kernel_build.build_all()
        be = ProcessBackend(root=root, payload_true=payload_true, throttle=throttle)
        if rec is not None:
            be.attach_recorder(rec)
        try:
            be.open(agg)
            wall0 = time.perf_counter()
            tokens = be.serve({"cfg": cfg, "x": tuple(plan.x), "params": params,
                               "toks": toks, "n_new": spec.new_tokens,
                               "s_ctx": spec.s_ctx, "use_kernels": bool(use_kernels),
                               "device": str(dev)}).numpy()
            t_request = time.perf_counter() - wall0
            _drain_kv(be, ranges)
            stats = be.store_stats
            reports = tuple(be.reports[-1][(s, 0)] for s in range(S))
        finally:
            be.close()
        walls = []

    price = rp.platform.price_per_gb_s
    cost = float(price * (np.sum(agg.mem) / GB) * t_request)
    tr = None
    if rec is not None:
        from repro_torch.obs.schema import Trace

        tr = Trace(spans=rec.spans, meta={
            "plan": plan._as_dict(), "backend": backend, "workload": "serve",
            "model": plan.model, "clock": "wall" if backend == "process" else "virtual",
            "t_request": t_request, "t_total": t_request, "steps": 1, "d": 1, "S": S,
            "store": stats.as_dict()})
    return ServeResult(
        tokens=tokens, t_request=float(t_request),
        cost_per_request=cost, cost_per_1k=1000.0 * cost,
        backend=backend, store_stats=stats, kv_bytes=est.kv_bytes,
        round_wall_s=tuple(walls), worker_reports=reports, trace=tr)


def _drain_kv(be, ranges) -> None:
    """Free each stage's last KV-cache object, then check the store drained."""
    for span in ranges:
        if span.inst_hi > span.inst_lo:
            be.delete(f"kv/s{span.index}")
    be.verify_drained()


def reference_decode(cfg, params, toks: np.ndarray, n_new: int, *,
                     s_ctx: Optional[int] = None,
                     use_kernels: bool = False) -> np.ndarray:
    """Monolithic greedy loop (the parity oracle): ``registry.prefill`` +
    ``registry.decode_step`` on the params' device, same sampling rule."""
    from repro_torch.models import registry

    dev = params["embed"].device
    if s_ctx is None:
        s_ctx = toks.shape[1] + n_new
    logits, caches = registry.prefill(
        cfg, params, {"tokens": torch.tensor(np.asarray(toks, np.int32), device=dev)},
        capacity=s_ctx)
    out = [greedy_token(logits)]
    for _ in range(1, n_new):
        logits, caches = registry.decode_step(cfg, params, caches, out[-1],
                                              use_kernels=use_kernels)
        out.append(greedy_token(logits))
    return torch.cat(out, dim=1).cpu().numpy()
