"""Autoscaling simulator (``repro.serving.autoscale`` for the port, copied
exactly): a serving plan under bursty arrival traces.

Composes the per-request latency the serving cost model predicts (one
pipeline replica serves one request at a time for ``t_request`` seconds)
with seeded arrival processes, and reports the latency distribution,
SLO-violation fraction, cold starts and cost as the replica count scales —
the capacity-planning table next to the SLO-aware partition choice.

Everything is deterministic under a fixed seed (``np.random.default_rng``);
the rows are byte-identical across runs and across the two packages.

Model notes (documented simplifications):

* a replica is one full pipeline (all stages); it serves requests FIFO with
  no cross-request pipelining — ``t_request`` of busy time per request;
* arrivals are dispatched to the earliest-free replica (central queue);
* the first request on each replica pays a cold-start penalty (function
  spawn + model fetch), after which the replica is warm for the trace.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serverless.platform import GB

#: default function cold start: spawn + runtime init + weight fetch (s).
#: FuncPipe's platforms report O(seconds) cold starts for GB-scale images.
DEFAULT_COLD_START_S = 2.0


def poisson_arrivals(rate: float, horizon: float, *, seed: int = 0) -> np.ndarray:
    """Arrival times of a Poisson process with ``rate`` req/s over
    ``[0, horizon)`` — seeded, deterministic."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = np.random.default_rng(seed)
    # draw enough exponential gaps to cover the horizon, then trim
    n = max(16, int(rate * horizon * 2) + 16)
    t = np.cumsum(rng.exponential(1.0 / rate, size=n))
    while t[-1] < horizon:
        t = np.concatenate([t, t[-1] + np.cumsum(
            rng.exponential(1.0 / rate, size=n))])
    return t[t < horizon]


def bursty_arrivals(rate: float, horizon: float, *, burst_factor: float = 4.0,
                    burst_fraction: float = 0.2, period: float = 60.0,
                    seed: int = 0) -> np.ndarray:
    """Two-phase modulated Poisson: each ``period``, a ``burst_fraction``
    window runs at ``burst_factor * rate`` and the remainder at a reduced
    base rate keeping the same average — the diurnal-burst shape of
    production function traces (Alibaba trace analyses), seeded."""
    if not 0.0 < burst_fraction < 1.0:
        raise ValueError(f"burst_fraction in (0,1), got {burst_fraction}")
    base = rate * (1 - burst_factor * burst_fraction) / (1 - burst_fraction)
    base = max(base, rate * 0.05)
    out = []
    n_periods = int(np.ceil(horizon / period))
    for i in range(n_periods):
        t0 = i * period
        burst_end = t0 + burst_fraction * period
        out.append(t0 + poisson_arrivals(
            burst_factor * rate, burst_fraction * period, seed=seed + 2 * i))
        out.append(burst_end + poisson_arrivals(
            base, (1 - burst_fraction) * period, seed=seed + 2 * i + 1))
    t = np.sort(np.concatenate(out))
    return t[t < horizon]


def trace_arrivals(path: str) -> np.ndarray:
    """Arrival times from a trace file: one inter-arrival gap (seconds) per
    line (comments/#-lines skipped) — the hook for replaying production
    request logs through the same simulator."""
    gaps = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            gaps.append(float(line))
    if not gaps:
        raise ValueError(f"trace file {path!r} has no inter-arrival gaps")
    return np.cumsum(np.asarray(gaps, dtype=np.float64))


@dataclass(frozen=True)
class AutoscaleRow:
    """One replica-count operating point."""

    replicas: int
    requests: int
    p50: float
    p95: float
    p99: float
    slo_violation_frac: float
    cold_starts: int
    cost: float                    # $ for the whole trace (busy-time billed)
    cost_per_1k: float
    utilization: float             # busy time / (replicas * horizon)

    def as_dict(self) -> dict:
        return {
            "replicas": self.replicas, "requests": self.requests,
            "p50": self.p50, "p95": self.p95, "p99": self.p99,
            "slo_violation_frac": self.slo_violation_frac,
            "cold_starts": self.cold_starts, "cost": self.cost,
            "cost_per_1k": self.cost_per_1k,
            "utilization": self.utilization,
        }


def simulate_replicas(arrivals: np.ndarray, *, replicas: int,
                      t_request: float, slo_s: float, mem_gb_total: float,
                      price_per_gb_s: float,
                      cold_start_s: float = DEFAULT_COLD_START_S) -> AutoscaleRow:
    """Queue one arrival trace onto ``replicas`` pipeline replicas."""
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    arrivals = np.sort(np.asarray(arrivals, dtype=np.float64))
    free = np.zeros(replicas)
    cold = np.ones(replicas, dtype=bool)
    lat = np.empty(len(arrivals))
    busy = 0.0
    cold_starts = 0
    for i, a in enumerate(arrivals):
        j = int(np.argmin(free))
        start = max(a, free[j])
        service = t_request
        if cold[j]:
            service += cold_start_s
            cold[j] = False
            cold_starts += 1
        done = start + service
        free[j] = done
        busy += service
        lat[i] = done - a
    if len(lat):
        p50, p95, p99 = (float(np.percentile(lat, q)) for q in (50, 95, 99))
        viol = float(np.mean(lat > slo_s))
    else:
        p50 = p95 = p99 = 0.0
        viol = 0.0
    cost = float(price_per_gb_s * mem_gb_total * busy)
    horizon = float(max(free.max(), arrivals[-1] if len(arrivals) else 0.0))
    util = float(busy / (replicas * horizon)) if horizon > 0 else 0.0
    return AutoscaleRow(
        replicas=replicas, requests=len(arrivals), p50=p50, p95=p95, p99=p99,
        slo_violation_frac=viol, cold_starts=cold_starts, cost=cost,
        cost_per_1k=(1000.0 * cost / len(arrivals)) if len(arrivals) else 0.0,
        utilization=util)


def autoscale_plan(plan, *, rate: float = 1.0, horizon: float = 120.0,
                   replicas: Sequence[int] = (1, 2, 4, 8),
                   arrival: str = "poisson", trace_file: Optional[str] = None,
                   seed: int = 0, burst_factor: float = 4.0,
                   cold_start_s: float = DEFAULT_COLD_START_S) -> List[AutoscaleRow]:
    """Scale a ``workload="serve"`` plan across replica counts under one
    seeded arrival trace (``"poisson"``, ``"bursty"``, or ``"trace"`` with
    ``trace_file``)."""
    from repro_torch.api.plan import PlanCompatibilityError

    if getattr(plan, "workload", "train") != "serve":
        raise PlanCompatibilityError(
            "autoscale_plan simulates serving plans; this plan for "
            f"{plan.model!r} has workload={plan.workload!r} "
            "(plan one with repro_torch.serving.plan_serving)")
    sv = plan.serving or {}
    t_request = float(sv.get("t_request", plan.t_iter))
    slo_s = float(sv["slo_s"])
    rp = plan.resolve()
    from repro_torch.serverless.simulator import stage_aggregates

    agg = stage_aggregates(rp.profile, rp.platform, rp.config, 1)
    mem_gb_total = float(np.sum(agg.mem) / GB)
    if arrival == "poisson":
        arrivals = poisson_arrivals(rate, horizon, seed=seed)
    elif arrival == "bursty":
        arrivals = bursty_arrivals(rate, horizon, burst_factor=burst_factor,
                                   seed=seed)
    elif arrival == "trace":
        if trace_file is None:
            raise ValueError("arrival='trace' needs trace_file=")
        arrivals = trace_arrivals(trace_file)
    else:
        raise ValueError(
            f"unknown arrival process {arrival!r}; "
            "expected poisson | bursty | trace")
    return [
        simulate_replicas(
            arrivals, replicas=int(n), t_request=t_request, slo_s=slo_s,
            mem_gb_total=mem_gb_total,
            price_per_gb_s=rp.platform.price_per_gb_s,
            cold_start_s=cold_start_s)
        for n in replicas
    ]
