"""Discrete-event simulation of serverless training
(``repro.serverless.simulator`` for the port, copied exactly), independent
of the closed-form performance model and used to validate it (Table 3
analog).

Each pipeline worker owns three serial resources: CPU, uplink, downlink.
Tasks are processed in the GPipe order of Fig 3 (all micro-batch forwards,
then reversed backwards, then sync), so the event-driven simulation reduces
to a longest-path DP over task end-times with per-resource serialization.
``simulate_funcpipe(trace=True)`` materializes those task intervals as
predicted ``repro_torch.obs`` spans, the input of ``obs.gap_attribution``.

Also simulates the data-parallel baselines (LambdaML / HybridPS, ±gradient
accumulation) under the same platform model.

This module stays *analytic*: it never moves bytes or runs layer math.  The
executable engine (``serverless.runtime``) charges the same per-stage cost
terms (``stage_aggregates``) on the emulated backend's virtual clocks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from repro_torch.core.partition import ModelProfile, stages_of
from repro_torch.core.perfmodel import (
    Config,
    perf_tables,
    sync_time_nonpipelined,
    sync_time_pipelined,
)
from repro_torch.serverless.platform import GB, Platform


@dataclass(frozen=True)
class SimResult:
    t_iter: float
    cost: float
    n_workers: int
    total_mem_gb: float
    breakdown: Dict[str, float] = field(default_factory=dict)
    # predicted repro_torch.obs.Trace (simulate_funcpipe(..., trace=True) only)
    trace: Optional[object] = None

    @property
    def throughput(self) -> float:  # samples/s given meta in breakdown
        return self.breakdown.get("samples", 0.0) / self.t_iter


def bandwidth_contention(n_workers: int, knee: int = 16, exp: float = 0.25) -> float:
    """Per-worker bandwidth multiplier: platforms co-locate functions, so
    per-function bandwidth degrades past ~``knee`` concurrent workers
    (paper §5.4 observation)."""
    if n_workers <= knee:
        return 1.0
    return (knee / n_workers) ** exp


def storage_capped_bw(platform: Platform, w: float, n_workers: int) -> float:
    """§5.7: Alibaba OSS (and Azure storage) cap TOTAL concurrent storage
    bandwidth; with n workers hitting storage at once each sees at most
    cap/n.  AWS S3 is modeled uncapped (paper §5.1)."""
    cap = platform.storage_total_bandwidth
    if cap is None or n_workers <= 0:
        return w
    return min(w, cap / n_workers)


def effective_bandwidth(
    platform: Platform, mem: int, n_workers: int, *, contention: bool = False
) -> float:
    """Per-worker storage bandwidth under §5.4 contention + §5.7 caps — the
    single derivation shared by the DP below and the runtime engine."""
    w = platform.bandwidth(mem)
    if contention:
        w *= bandwidth_contention(n_workers)
    return storage_capped_bw(platform, w, n_workers)


# --------------------------------------------------- shared per-stage costs
@dataclass(frozen=True)
class StageAggregates:
    """Per-stage cost terms of a FuncPipe configuration.

    Shared between the longest-path DP below and the executable runtime
    (``serverless.runtime.engine``) so both charge identical compute
    times, boundary-transfer times, effective bandwidths (§5.4 contention +
    §5.7 storage-side caps) and per-stage memory."""

    S: int                    # number of pipeline stages
    mu: int                   # micro-batches per worker
    d: int                    # data-parallel degree
    n_workers: int            # S * d
    t_lat: float              # storage latency
    t_fc: np.ndarray          # [S] forward compute per micro-batch
    t_bc: np.ndarray          # [S] backward compute per micro-batch
    w: np.ndarray             # [S] effective per-worker storage bandwidth
    out_b: np.ndarray         # [S] forward boundary bytes (stage output)
    grad_b: np.ndarray        # [S] backward boundary bytes (grad at stage lo)
    s_stage: np.ndarray       # [S] parameter bytes per stage
    mem: np.ndarray           # [S] allocated function memory (bytes)
    t_up_f: np.ndarray        # [S] fwd boundary upload time (stage s -> store)
    t_dn_f: np.ndarray        # [S] fwd boundary download time (store -> stage s)
    t_up_b: np.ndarray        # [S] bwd boundary upload time
    t_dn_b: np.ndarray        # [S] bwd boundary download time


def stage_aggregates(
    profile: ModelProfile,
    platform: Platform,
    config: Config,
    total_micro_batches: int,
    *,
    contention: bool = False,
) -> StageAggregates:
    tables = perf_tables(profile, platform)   # shared with evaluate/evaluate_batch
    x = np.asarray(config.x)
    d = config.d
    mu = max(1, total_micro_batches // d)
    stages = stages_of(x)
    S = len(stages)
    z = np.asarray(config.z)
    t_lat = tables.t_lat
    L = tables.L
    los = np.array([lo for lo, _ in stages])
    his = np.array([hi for _, hi in stages])

    n_workers = S * d

    # per-stage aggregates (memory option constant within stage) from the
    # precomputed per-(layer, option) tables — same beta-scaled compute terms
    # the closed-form model charges
    lidx = np.arange(L)
    t_fc = np.add.reduceat(tables.Tf_beta[lidx, z], los)
    t_bc = np.add.reduceat(tables.Tb_beta[lidx, z], los)
    w = np.array([
        effective_bandwidth(platform, platform.memory_options[z[lo]], n_workers,
                            contention=contention)
        for lo in los
    ])
    out_b = tables.o[his]                                          # fwd boundary
    grad_b = tables.g[los]                                         # bwd boundary
    s_stage = np.add.reduceat(tables.s, los)
    mem = tables.mem_opts[z[los]]

    t_up_f = out_b / w + t_lat      # stage s uploads its output
    t_dn_f = np.empty(S)
    t_dn_f[1:] = out_b[:-1] / w[1:] + t_lat
    t_dn_f[0] = 0.0
    t_up_b = grad_b / w + t_lat     # stage s uploads grad toward s-1
    t_dn_b = np.empty(S)
    t_dn_b[:-1] = grad_b[1:] / w[:-1] + t_lat
    t_dn_b[-1] = 0.0
    return StageAggregates(
        S=S, mu=mu, d=d, n_workers=n_workers, t_lat=t_lat,
        t_fc=t_fc, t_bc=t_bc, w=w, out_b=out_b, grad_b=grad_b,
        s_stage=s_stage, mem=mem,
        t_up_f=t_up_f, t_dn_f=t_dn_f, t_up_b=t_up_b, t_dn_b=t_dn_b,
    )


def unpack_plan_args(fn_name, profile, platform, config, total_micro_batches,
                     pipelined_sync):
    """Shared DeploymentPlan front door for the plan-accepting entry points
    (this module's :func:`simulate_funcpipe` and ``runtime.run_plan``): a
    plan as the first argument is resolved — profile rebuilt +
    fingerprint-checked — and its recorded sync algorithm used unless
    ``pipelined_sync`` overrides it.  Mixing a plan with explicit
    platform/config/M is rejected rather than silently ignored."""
    if not isinstance(profile, ModelProfile):
        if not hasattr(profile, "resolve"):
            raise TypeError(
                f"{fn_name} takes (profile, platform, config, M) or a "
                f"DeploymentPlan as first argument, got "
                f"{type(profile).__name__}")
        if platform is not None or config is not None \
                or total_micro_batches is not None:
            raise ValueError(
                f"{fn_name}(plan, ...) takes no platform/config/"
                "total_micro_batches — they are recorded in the plan; use "
                "plan.resolve(platform=...) for overrides")
        rp = profile.resolve()
        if pipelined_sync is None:
            pipelined_sync = rp.pipelined_sync
        profile, platform, config = rp.profile, rp.platform, rp.config
        total_micro_batches = rp.total_micro_batches
    if pipelined_sync is None:
        pipelined_sync = True
    return profile, platform, config, total_micro_batches, pipelined_sync


# ------------------------------------------------------------------- FuncPipe
def simulate_funcpipe(
    profile,
    platform: Optional[Platform] = None,
    config: Optional[Config] = None,
    total_micro_batches: Optional[int] = None,
    *,
    pipelined_sync: Optional[bool] = None,
    contention: bool = False,
    trace: bool = False,
) -> SimResult:
    """Simulate one FuncPipe iteration.

    Accepts either the explicit ``(profile, platform, config, M)`` tuple or
    a single :class:`repro_torch.api.plan.DeploymentPlan` as the first argument (see
    :func:`unpack_plan_args`).  ``trace=True`` additionally materializes the
    DP's task intervals as *predicted* spans — one representative replica
    (r=0) per stage, one step — in the same ``repro_torch.obs`` schema the runtime
    backends emit, returned as ``SimResult.trace`` for gap attribution."""
    profile, platform, config, total_micro_batches, pipelined_sync = \
        unpack_plan_args("simulate_funcpipe", profile, platform, config,
                         total_micro_batches, pipelined_sync)
    agg = stage_aggregates(profile, platform, config, total_micro_batches,
                           contention=contention)
    S, mu, d = agg.S, agg.mu, agg.d
    t_lat = agg.t_lat
    t_fc, t_bc, w = agg.t_fc, agg.t_bc, agg.w
    s_stage = agg.s_stage
    t_up_f, t_dn_f, t_up_b, t_dn_b = agg.t_up_f, agg.t_dn_f, agg.t_up_b, agg.t_dn_b
    n_workers = agg.n_workers

    NEG = 0.0
    fwd_d_end = np.zeros((S, mu))
    fwd_c_end = np.zeros((S, mu))
    fwd_u_end = np.zeros((S, mu))
    for m in range(mu):
        for s in range(S):
            if s == 0:
                ready = 0.0
            else:
                prev_dn = fwd_d_end[s, m - 1] if m else NEG
                fwd_d_end[s, m] = max(fwd_u_end[s - 1, m], prev_dn) + t_dn_f[s]
                ready = fwd_d_end[s, m]
            prev_c = fwd_c_end[s, m - 1] if m else NEG
            fwd_c_end[s, m] = max(ready, prev_c) + t_fc[s]
            if s < S - 1:
                prev_u = fwd_u_end[s, m - 1] if m else NEG
                fwd_u_end[s, m] = max(fwd_c_end[s, m], prev_u) + t_up_f[s]

    bwd_d_end = np.zeros((S, mu))
    bwd_c_end = np.zeros((S, mu))
    bwd_u_end = np.zeros((S, mu))
    for mi, m in enumerate(range(mu - 1, -1, -1)):  # reversed micro-batch order
        for s in range(S - 1, -1, -1):
            if s == S - 1:
                ready = fwd_c_end[s, mu - 1]
            else:
                prev_dn = bwd_d_end[s, m + 1] if mi else NEG
                bwd_d_end[s, m] = max(bwd_u_end[s + 1, m], prev_dn, fwd_u_end[s, mu - 1]) + t_dn_b[s]
                ready = bwd_d_end[s, m]
            prev_c = bwd_c_end[s, m + 1] if mi else fwd_c_end[s, mu - 1]
            bwd_c_end[s, m] = max(ready, prev_c) + t_bc[s]
            if s > 0:
                prev_u = bwd_u_end[s, m + 1] if mi else fwd_u_end[s, mu - 1]
                bwd_u_end[s, m] = max(bwd_c_end[s, m], prev_u) + t_up_b[s]

    sync_fn = sync_time_pipelined if pipelined_sync else sync_time_nonpipelined
    end = 0.0
    sync_total = 0.0
    sync_spans = []                                      # (s, done, ts)
    for s in range(S):
        done = bwd_c_end[s, 0] if S == 1 else max(bwd_c_end[s, 0], bwd_u_end[s, 0] if s > 0 else 0.0)
        ts = sync_fn(s_stage[s], w[s], d, t_lat) if d > 1 else 0.0
        sync_total = max(sync_total, ts)
        end = max(end, done + ts)
        sync_spans.append((s, done, ts))

    trace_obj = None
    if trace:
        trace_obj = _predicted_trace(
            profile, agg, fwd_d_end, fwd_c_end, fwd_u_end,
            bwd_d_end, bwd_c_end, bwd_u_end, sync_spans,
            end=float(end), pipelined_sync=pipelined_sync)

    mem_total = d * float(agg.mem.sum())
    cost = platform.price_per_gb_s * (mem_total / GB) * end
    comp = float(t_fc.sum() + t_bc.sum())
    return SimResult(
        t_iter=float(end),
        cost=float(cost),
        n_workers=n_workers,
        total_mem_gb=mem_total / GB,
        breakdown={
            "compute": comp,
            "pipeline_comm": float(end - comp - sync_total) if S > 1 else 0.0,
            "sync": float(sync_total),
        },
        trace=trace_obj,
    )


def _predicted_trace(profile, agg: StageAggregates,
                     fwd_d_end, fwd_c_end, fwd_u_end,
                     bwd_d_end, bwd_c_end, bwd_u_end, sync_spans,
                     *, end: float, pipelined_sync: bool):
    """Materialize the longest-path DP's task intervals as predicted spans.

    Every DP cell already *is* a task end-time on a serial resource, so the
    span is just ``[end - duration, end]`` with the shared cost-model sizes
    attached — same schema, keys and phase labels as the runtime backends
    (step 0, replica 0: the DP models one representative replica; the sync
    term is emitted as a single aggregate ``op="sync"`` span per stage, not
    per chunk, because eq (1)/(2) are closed forms)."""
    from repro_torch.obs import Span, Trace

    S, mu, d = agg.S, agg.mu, agg.d
    spans = []
    for m in range(mu):
        for s in range(S):
            if s > 0:
                spans.append(Span(
                    stage=s, replica=0, step=0, phase="fwd", op="download",
                    start=float(fwd_d_end[s, m] - agg.t_dn_f[s]),
                    end=float(fwd_d_end[s, m]),
                    nbytes=float(agg.out_b[s - 1]),
                    key=f"k0/r0/m{m}/act{s - 1}"))
            spans.append(Span(
                stage=s, replica=0, step=0, phase="fwd", op="compute",
                start=float(fwd_c_end[s, m] - agg.t_fc[s]),
                end=float(fwd_c_end[s, m])))
            if s < S - 1:
                spans.append(Span(
                    stage=s, replica=0, step=0, phase="fwd", op="upload",
                    start=float(fwd_u_end[s, m] - agg.t_up_f[s]),
                    end=float(fwd_u_end[s, m]),
                    nbytes=float(agg.out_b[s]),
                    key=f"k0/r0/m{m}/act{s}"))
    for m in range(mu - 1, -1, -1):
        for s in range(S - 1, -1, -1):
            if s < S - 1:
                spans.append(Span(
                    stage=s, replica=0, step=0, phase="bwd", op="download",
                    start=float(bwd_d_end[s, m] - agg.t_dn_b[s]),
                    end=float(bwd_d_end[s, m]),
                    nbytes=float(agg.grad_b[s + 1]),
                    key=f"k0/r0/m{m}/grad{s}"))
            spans.append(Span(
                stage=s, replica=0, step=0, phase="bwd", op="compute",
                start=float(bwd_c_end[s, m] - agg.t_bc[s]),
                end=float(bwd_c_end[s, m])))
            if s > 0:
                spans.append(Span(
                    stage=s, replica=0, step=0, phase="bwd", op="upload",
                    start=float(bwd_u_end[s, m] - agg.t_up_b[s]),
                    end=float(bwd_u_end[s, m]),
                    nbytes=float(agg.grad_b[s]),
                    key=f"k0/r0/m{m}/grad{s - 1}"))
    if d > 1:
        for s, done, ts in sync_spans:
            spans.append(Span(
                stage=s, replica=0, step=0, phase="sync", op="sync",
                start=float(done), end=float(done + ts),
                nbytes=float(agg.s_stage[s])))
    return Trace(
        spans=spans,
        meta={
            "model": profile.name,
            "backend": "predicted",
            "clock": "virtual",
            "S": S, "d": d, "mu": mu, "steps": 1,
            "n_workers": agg.n_workers,
            "t_total": end,
            "t_iter": end,
            "bandwidth": [float(x) for x in agg.w],
            "pipelined_sync": bool(pipelined_sync),
        },
    )


# ------------------------------------------------------- data-parallel designs
def simulate_data_parallel(
    profile: ModelProfile,
    platform: Platform,
    *,
    n_workers: int,
    mem_index: int,
    samples_per_worker: int,
    micro_batch: int,
    sync: str = "scatter_reduce",          # scatter_reduce | pipelined | ps
    grad_accum: bool = False,
    ps_bandwidth: float = 10e9 / 8,
    ps_price_per_s: float = 1.53 / 3600.0,  # c5.9xlarge
    contention: bool = False,
) -> SimResult:
    """One iteration of DP training (LambdaML / HybridPS + GA variants)."""
    arr = profile.arrays()
    mem = platform.memory_options[mem_index]
    w = platform.bandwidth(mem)
    if contention:
        w *= bandwidth_contention(n_workers)
    w_storage = storage_capped_bw(platform, w, n_workers)
    s_grad = arr["s"].sum()
    t_lat = platform.storage_latency

    n_mb = max(1, samples_per_worker // micro_batch)
    comp = (arr["Tf"][:, mem_index].sum() + arr["Tb"][:, mem_index].sum()) * n_mb
    if grad_accum:
        comp *= 1.10  # per-step overhead of accumulation

    if n_workers == 1:
        sync_t = 0.0
    elif sync == "ps":
        eff = min(w, ps_bandwidth / n_workers)
        sync_t = 2 * s_grad / eff + 2 * t_lat
    elif sync == "pipelined":
        sync_t = sync_time_pipelined(s_grad, w_storage, n_workers, t_lat)
    else:
        sync_t = sync_time_nonpipelined(s_grad, w_storage, n_workers, t_lat)

    t_iter = comp + sync_t
    cost = platform.price_per_gb_s * (mem / GB) * t_iter * n_workers
    if sync == "ps" and n_workers > 1:
        cost += ps_price_per_s * t_iter
    return SimResult(
        t_iter=float(t_iter),
        cost=float(cost),
        n_workers=n_workers,
        total_mem_gb=n_workers * mem / GB,
        breakdown={"compute": float(comp), "sync": float(sync_t),
                   "samples": float(n_workers * samples_per_worker)},
    )
