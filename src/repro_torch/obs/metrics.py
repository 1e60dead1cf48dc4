"""Derived pipeline-health metrics over a span trace (``repro.obs.metrics``
for the port).

Definitions (also in README "Observability"):

* **bubble fraction** (per stage): ``1 - compute_busy / (d * elapsed)`` —
  the share of the stage's worker-seconds its CPUs sat idle (pipeline fill/
  drain, boundary-transfer waits, sync).  ``elapsed`` is the trace's total
  run time, so a perfectly packed stage scores 0.
* **uplink / downlink utilization**: transferred bytes divided by what the
  provisioned per-worker bandwidth (``StageAggregates.w``, §5.4/§5.7
  effective) could have moved over the whole run — how much of the paid-for
  link the schedule actually used.  The companion ``*_busy`` fraction is
  time-based (share of worker-seconds the link was charged).
* **straggler ratio**: max over workers of total busy time divided by the
  mean — 1.0 is perfectly balanced; the paper's symmetric stages should sit
  near 1 on the virtual clock, while wall-clock runs expose host jitter.
* **phase byte totals**: uploaded/downloaded bytes per (phase, direction),
  reconciled against the store's own ``StoreStats`` counters — the span
  layer and the byte-accounting layer must tell the same story.
"""
from __future__ import annotations

from typing import Any, Dict, List

from repro_torch.obs.schema import Trace


def pipeline_health(trace: Trace) -> Dict[str, Any]:
    """Utilization table + imbalance + byte reconciliation for a trace."""
    spans = trace.spans
    meta = trace.meta
    S = int(meta.get("S", 1 + max((s.stage for s in spans), default=0)))
    d = int(meta.get("d", 1 + max((s.replica for s in spans), default=0)))
    t_total = float(meta.get("t_total",
                             max((s.end for s in spans), default=0.0)))
    denom = d * t_total if t_total > 0 else float("inf")
    bandwidth = meta.get("bandwidth")    # [S] provisioned bytes/s, optional
    if meta.get("clock") == "wall":
        # modeled bytes over host seconds vs modeled bandwidth is not a
        # utilization — only virtual-clock traces get the bw columns
        bandwidth = None

    stages: List[Dict[str, float]] = []
    for s in range(S):
        mine = [sp for sp in spans if sp.stage == s]
        busy = {"cpu": 0.0, "uplink": 0.0, "downlink": 0.0}
        nbytes = {"uplink": 0.0, "downlink": 0.0}
        for sp in mine:
            res = sp.resource
            if res is not None:
                busy[res] += sp.duration
                if res != "cpu":
                    nbytes[res] += sp.nbytes
        row = {
            "stage": s,
            "compute_frac": busy["cpu"] / denom,
            "bubble_frac": 1.0 - busy["cpu"] / denom,
            "up_frac": busy["uplink"] / denom,
            "dn_frac": busy["downlink"] / denom,
            "up_bytes": nbytes["uplink"],
            "dn_bytes": nbytes["downlink"],
        }
        if bandwidth is not None and t_total > 0:
            cap = d * t_total * float(bandwidth[s])
            row["up_bw_util"] = nbytes["uplink"] / cap
            row["dn_bw_util"] = nbytes["downlink"] / cap
        stages.append(row)

    # straggler/imbalance: total busy seconds per worker
    busy_by_worker: Dict[tuple, float] = {}
    for sp in spans:
        if sp.resource is not None:
            k = (sp.stage, sp.replica)
            busy_by_worker[k] = busy_by_worker.get(k, 0.0) + sp.duration
    vals = list(busy_by_worker.values())
    mean = sum(vals) / len(vals) if vals else 0.0
    straggler = (max(vals) / mean) if mean > 0 else 1.0

    phase_bytes: Dict[str, Dict[str, float]] = {}
    for sp in spans:
        if sp.op in ("upload", "download"):
            direction = "up" if sp.op == "upload" else "dn"
            phase_bytes.setdefault(sp.phase, {"up": 0.0, "dn": 0.0})
            phase_bytes[sp.phase][direction] += sp.nbytes

    out: Dict[str, Any] = {
        "stages": stages,
        "straggler_ratio": straggler,
        "phase_bytes": phase_bytes,
    }

    # recovery overhead: retry-backoff stalls and checkpoint-restore reads
    # (the fault-tolerance layer's footprint on the timeline; zero on a
    # fault-free run)
    retry = [sp for sp in spans if sp.op == "retry"]
    restart = [sp for sp in spans if sp.op == "restart"]
    if retry or restart:
        out["recovery"] = {
            "retry_s": sum(sp.duration for sp in retry),
            "retry_count": len(retry),
            "restart_s": sum(sp.duration for sp in restart),
            "restart_count": len(restart),
            "restart_bytes": sum(sp.nbytes for sp in restart),
        }

    store = meta.get("store")
    if store is not None:
        span_up = sum(sp.nbytes for sp in spans if sp.op == "upload")
        # checkpoint-restore reads ("restart" op) are real store gets — the
        # byte-accounting layer counts them, so the span side must too
        span_dn = sum(sp.nbytes for sp in spans
                      if sp.op in ("download", "restart"))
        up_ref = float(store.get("bytes_in", 0.0))
        dn_ref = float(store.get("bytes_out", 0.0))
        tol = 1e-6 * max(up_ref, dn_ref, 1.0)
        out["reconciliation"] = {
            "span_bytes_up": span_up, "store_bytes_in": up_ref,
            "span_bytes_dn": span_dn, "store_bytes_out": dn_ref,
            "up_delta": span_up - up_ref, "dn_delta": span_dn - dn_ref,
            "ok": abs(span_up - up_ref) <= tol and abs(span_dn - dn_ref) <= tol,
        }
    return out
