"""Partition utilities (``repro.core.partition`` for the port, copied
exactly): the paper's hat/tilde accumulation operators (eq (4)), the
segment-sum tables the planner's DP reads, layer profiles with their
provenance, and the layer-merging pass (§4 "MIQP solution") that keeps the
optimization problem minute-scale.

A *partition* is represented by the boundary vector x ∈ {0,1}^(L-1):
x[i] == 1 iff the model is cut between layer i and i+1 (0-indexed; the paper's
x_i "partitioned after layer i").  Stages are the contiguous runs.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


def hat(u: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Forward accumulation within partitions: hat_u[i] = u[i] + hat_u[i-1]*(1-x[i-1]).

    Batch-aware: ``u`` may be ``[..., L]`` with ``x`` ``[..., L-1]`` — the
    recurrence runs along the last axis, vectorized over leading axes, with
    the same per-element operation order as the scalar form (so scalar and
    batched callers see bit-identical results)."""
    u = np.asarray(u, dtype=np.float64)
    x = np.asarray(x)
    out = np.empty_like(u)
    out[..., 0] = u[..., 0]
    for i in range(1, u.shape[-1]):
        out[..., i] = u[..., i] + out[..., i - 1] * (1 - x[..., i - 1])
    return out


def tilde(u: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Backward accumulation: tilde_u[i] = u[i] + tilde_u[i+1]*(1-x[i]).

    Batch-aware along the last axis, like :func:`hat`."""
    u = np.asarray(u, dtype=np.float64)
    x = np.asarray(x)
    L = u.shape[-1]
    out = np.empty_like(u)
    out[..., L - 1] = u[..., L - 1]
    for i in range(L - 2, -1, -1):
        out[..., i] = u[..., i] + out[..., i + 1] * (1 - x[..., i])
    return out


def suffix_sum(u: np.ndarray) -> np.ndarray:
    """Right-fold suffix sums along the last axis: out[i] = u[i] + out[i+1].

    Both the scalar oracle (`perfmodel.evaluate`) and the batched kernel
    (`perfmodel.evaluate_batch`) reduce suffixes through this helper so their
    floating-point association is identical — a requirement for the
    bit-for-bit property test between the two."""
    u = np.asarray(u, dtype=np.float64)
    out = np.empty_like(u)
    L = u.shape[-1]
    out[..., L - 1] = u[..., L - 1]
    for i in range(L - 2, -1, -1):
        out[..., i] = u[..., i] + out[..., i + 1]
    return out


def suffix_max(u: np.ndarray) -> np.ndarray:
    """Suffix maxima along the last axis: out[i] = max(u[i], out[i+1])."""
    u = np.asarray(u, dtype=np.float64)
    out = np.empty_like(u)
    L = u.shape[-1]
    out[..., L - 1] = u[..., L - 1]
    for i in range(L - 2, -1, -1):
        np.maximum(u[..., i], out[..., i + 1], out=out[..., i])
    return out


def segment_sum_table(u: np.ndarray) -> np.ndarray:
    """Sums of every contiguous segment of ``u`` along the last axis.

    ``seg[..., lo, hi] = u[lo] + ... + u[hi]`` (zero where ``lo > hi``),
    accumulated as ``seg[lo, hi] = seg[lo, hi - 1] + u[hi]`` — the same
    per-element operation order as :func:`hat` restricted to one stage, so a
    stage's entry is bit-identical to ``hat(u, x)[hi]`` for any partition in
    which ``[lo, hi]`` is a stage (IEEE addition commutes, so growing the
    segment on the right reproduces hat's fold exactly).  Batch-aware over
    leading axes like :func:`hat`."""
    u = np.asarray(u, dtype=np.float64)
    L = u.shape[-1]
    seg = np.zeros(u.shape[:-1] + (L, L), dtype=np.float64)
    for hi in range(L):
        seg[..., hi, hi] = u[..., hi]
        if hi:
            seg[..., :hi, hi] = seg[..., :hi, hi - 1] + u[..., hi, None]
    return seg


def segment_sum_table_rev(u: np.ndarray) -> np.ndarray:
    """Like :func:`segment_sum_table` but folded from the right —
    ``seg[lo, hi] = u[lo] + seg[lo + 1, hi]`` — matching :func:`tilde`'s
    association, so a stage's entry is bit-identical to ``tilde(u, x)[lo]``
    for any partition in which ``[lo, hi]`` is a stage."""
    u = np.asarray(u, dtype=np.float64)
    L = u.shape[-1]
    seg = np.zeros(u.shape[:-1] + (L, L), dtype=np.float64)
    for lo in range(L - 1, -1, -1):
        seg[..., lo, lo] = u[..., lo]
        if lo < L - 1:
            seg[..., lo, lo + 1:] = u[..., lo, None] + seg[..., lo + 1, lo + 1:]
    return seg


def stage_ids(x: np.ndarray) -> np.ndarray:
    """Per-layer stage index for a batch of partitions: ``x`` is ``[..., L-1]``
    boundary bits, the result is ``[..., L]`` with values in ``[0, n_stages)``
    (the segment-sum companion of :func:`stages_of`)."""
    x = np.asarray(x, dtype=np.int64)
    ids = np.zeros(x.shape[:-1] + (x.shape[-1] + 1,), dtype=np.int64)
    np.cumsum(x, axis=-1, out=ids[..., 1:])
    return ids


def stages_of(x: Sequence[int]) -> List[Tuple[int, int]]:
    """[(lo, hi)] inclusive layer ranges of each stage."""
    lo = 0
    out = []
    for i, xi in enumerate(x):
        if xi:
            out.append((lo, i))
            lo = i + 1
    out.append((lo, len(x)))
    return out


def highest_layers(x: Sequence[int]) -> List[int]:
    """The paper's H: last layer index of each stage."""
    return [hi for _, hi in stages_of(x)]


def lowest_layers(x: Sequence[int]) -> List[int]:
    return [lo for lo, _ in stages_of(x)]


# ------------------------------------------------------------------ profiles
@dataclass(frozen=True)
class LayerProfile:
    """Per-layer quantities (paper Table 2).  Sizes in bytes, times in
    seconds, indexed by memory option j for the compute times."""

    name: str
    param_bytes: float          # s_i
    act_bytes: float            # a_i  (per micro-batch)
    out_bytes: float            # o_i  (per micro-batch)
    grad_out_bytes: float       # g_i  (per micro-batch, bwd boundary)
    fwd_time: Tuple[float, ...]   # T_fc^{i,j}
    bwd_time: Tuple[float, ...]   # T_bc^{i,j}


PROFILE_SOURCES = ("analytic", "measured")
PROFILE_SCHEMA_VERSION = 1


@dataclass(frozen=True)
class CalibrationMeta:
    """Provenance of a *measured* profile: which traced run patched it.

    Frozen with scalar fields only — :class:`ModelProfile` is an
    ``lru_cache`` key in ``perfmodel.perf_tables``, so everything hanging
    off it must stay hashable."""

    backend: str                 # execution backend that produced the trace
    clock: str                   # "wall" | "virtual"
    steps: int                   # traced training steps folded in
    base_fingerprint: str        # fingerprint of the analytic profile patched
    t_total: float               # traced run's total seconds (trace clock)


@dataclass(frozen=True)
class ModelProfile:
    name: str
    layers: Tuple[LayerProfile, ...]
    source: str = "analytic"                      # analytic | measured
    calibration: Optional[CalibrationMeta] = None

    def __post_init__(self):
        if self.source not in PROFILE_SOURCES:
            raise ValueError(
                f"profile source {self.source!r} not in {PROFILE_SOURCES}")
        if self.source == "measured" and self.calibration is None:
            raise ValueError(
                "a measured profile must carry its CalibrationMeta")

    @property
    def L(self) -> int:
        return len(self.layers)

    def arrays(self):
        """Per-layer quantity arrays, built once per profile and cached (the
        planner hot path used to rebuild this dict on every ``evaluate``
        call).  The arrays are marked read-only; treat them as immutable."""
        cached = self.__dict__.get("_arrays_cache")
        if cached is not None:
            return cached
        ls = self.layers
        cached = {
            "s": np.array([l.param_bytes for l in ls]),
            "a": np.array([l.act_bytes for l in ls]),
            "o": np.array([l.out_bytes for l in ls]),
            "g": np.array([l.grad_out_bytes for l in ls]),
            "Tf": np.array([l.fwd_time for l in ls]),   # [L, J]
            "Tb": np.array([l.bwd_time for l in ls]),
        }
        for arr in cached.values():
            arr.setflags(write=False)
        object.__setattr__(self, "_arrays_cache", cached)
        return cached

    @property
    def param_bytes(self) -> float:
        return float(sum(l.param_bytes for l in self.layers))

    # --------------------------------------------------------- serialization
    # Analytic profiles are rebuilt from the profiler and never serialized;
    # measured profiles (calibration, ``obs.calibrate``) exist only as artifacts of a
    # traced run, so they round-trip through JSON like DeploymentPlans do.
    def to_json(self, *, indent: Optional[int] = 2) -> str:
        d = {
            "version": PROFILE_SCHEMA_VERSION,
            "name": self.name,
            "source": self.source,
            "calibration": (None if self.calibration is None
                            else dataclasses.asdict(self.calibration)),
            "layers": [dataclasses.asdict(l) for l in self.layers],
        }
        return json.dumps(d, indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, blob: str) -> "ModelProfile":
        d = json.loads(blob)
        version = d.get("version")
        if version != PROFILE_SCHEMA_VERSION:
            raise ValueError(f"profile schema version {version!r} != "
                             f"supported {PROFILE_SCHEMA_VERSION}")
        layers = tuple(LayerProfile(
            name=l["name"],
            param_bytes=float(l["param_bytes"]),
            act_bytes=float(l["act_bytes"]),
            out_bytes=float(l["out_bytes"]),
            grad_out_bytes=float(l["grad_out_bytes"]),
            fwd_time=tuple(float(t) for t in l["fwd_time"]),
            bwd_time=tuple(float(t) for t in l["bwd_time"]),
        ) for l in d["layers"])
        cal = d.get("calibration")
        return cls(name=d["name"], layers=layers,
                   source=d.get("source", "analytic"),
                   calibration=(None if cal is None
                                else CalibrationMeta(**cal)))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "ModelProfile":
        with open(path) as f:
            return cls.from_json(f.read())


def merge_boundaries(profile: ModelProfile, target_L: int,
                     criterion: str = "compute") -> List[int]:
    """Group edges of the §4 layer merge: ``[0, b_1, ..., b_{k-1}, L]`` with
    super-layer ``g`` spanning original layers ``[edges[g], edges[g+1])``.

    Hierarchical: starting from one group, the heaviest splittable group is
    repeatedly split at its most balanced interior point, so the boundary set
    at depth ``k`` is by construction a superset of every shallower depth's.
    Nested boundaries make the planner's search space grow monotonically with
    merge depth — deeper merging can never lose a plan that a shallower depth
    could express, which is what makes plan quality monotone in ``target_L``
    (the seed's one-pass greedy did not nest; see the ROADMAP
    merge-boundary item)."""
    ls = profile.layers
    if criterion == "compute":
        w = np.array([np.mean(l.fwd_time) + np.mean(l.bwd_time) for l in ls])
    elif criterion == "param":
        w = np.array([l.param_bytes for l in ls])
    elif criterion == "activation":
        w = np.array([l.act_bytes for l in ls])
    else:
        raise ValueError(criterion)
    w = np.maximum(w, 1e-12)
    csum = np.concatenate([[0.0], np.cumsum(w)])
    edges = [0, len(ls)]
    while len(edges) - 1 < min(target_L, len(ls)):
        # heaviest group with more than one layer; leftmost breaks ties
        best_g, best_w = None, -np.inf
        for g in range(len(edges) - 1):
            gw = csum[edges[g + 1]] - csum[edges[g]]
            if edges[g + 1] - edges[g] > 1 and gw > best_w:
                best_g, best_w = g, gw
        lo, hi = edges[best_g], edges[best_g + 1]
        left = csum[lo + 1:hi] - csum[lo]     # weight left of each interior cut
        total = csum[hi] - csum[lo]
        k = int(np.argmin(np.maximum(left, total - left)))  # first minimizer
        edges.insert(best_g + 1, lo + k + 1)
    return edges


def merge_layers(profile: ModelProfile, target_L: int,
                 criterion: str = "compute") -> ModelProfile:
    """Balanced hierarchical merging (paper §4): contiguous layers are merged
    so the chosen criterion (compute time / param size / activation size) is
    roughly balanced across the ``target_L`` merged super-layers, with
    boundaries that nest across depths (see :func:`merge_boundaries`)."""
    ls = profile.layers
    if len(ls) <= target_L:
        return profile
    edges = merge_boundaries(profile, target_L, criterion)
    groups: List[List[int]] = [list(range(edges[g], edges[g + 1]))
                               for g in range(len(edges) - 1)]

    def merge_group(idx: List[int]) -> LayerProfile:
        sub = [ls[i] for i in idx]
        J = len(sub[0].fwd_time)
        return LayerProfile(
            name=f"{sub[0].name}..{sub[-1].name}",
            param_bytes=sum(l.param_bytes for l in sub),
            act_bytes=sum(l.act_bytes for l in sub),
            out_bytes=sub[-1].out_bytes,           # boundary output only
            grad_out_bytes=sub[0].grad_out_bytes,  # boundary grad only
            fwd_time=tuple(sum(l.fwd_time[j] for l in sub) for j in range(J)),
            bwd_time=tuple(sum(l.bwd_time[j] for l in sub) for j in range(J)),
        )

    return ModelProfile(name=profile.name,
                        layers=tuple(merge_group(g) for g in groups),
                        source=profile.source,
                        calibration=profile.calibration)
