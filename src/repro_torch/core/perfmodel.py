"""The paper's performance model (§3.4.2 + Appendix A/B), term by term;
``repro.core.perfmodel`` for the port, copied exactly, so plans, emulated
clocks and costs agree with the JAX package's to the bit.

Given a concrete configuration (partition x, data-parallel degree d, per-layer
memory m_i) and a layer profile, computes the iteration time eq (7) and cost
eq (6), the memory constraint eq (3b), and the synchronization times for both
scatter-reduce algorithms — eq (1) (LambdaML, non-pipelined) and eq (2)
(FuncPipe, pipelined).

Two tiers:

  * ``evaluate`` — the scalar oracle: one configuration at a time, simple
    per-layer Python, easy to audit against the paper's equations.
  * ``evaluate_batch`` — the vectorized kernel: an ``[N, L-1]`` matrix of
    partition vectors plus ``[N, L]`` memory-index assignments, all N
    configurations evaluated with pure numpy (batched ``hat``/``tilde``
    recurrences, suffix sums/maxima, precomputed per-(layer, memory-option)
    tables from :func:`perf_tables`).  This is what the co-optimizer's hot
    path calls; it is bit-for-bit equal to the oracle (both reduce through
    the same right-fold helpers in ``core.partition``, so their float
    association is identical).

The closed forms are checked against the independent longest-path DP in
``serverless.simulator``, and both against the executable engine
(``serverless.runtime.run_plan``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.partition import (
    ModelProfile,
    hat,
    highest_layers,
    lowest_layers,
    segment_sum_table,
    segment_sum_table_rev,
    suffix_max,
    suffix_sum,
    tilde,
)
from repro_torch.serverless.platform import GB, Platform


# --------------------------------------------------------------- sync times
def sync_time_nonpipelined(s_grad: float, w: float, n: int, t_lat: float) -> float:
    """Eq (1): LambdaML's 3-phase storage scatter-reduce."""
    if n <= 1:
        return 0.0
    return 3 * s_grad / w - 2 * s_grad / (n * w) + 4 * t_lat


def sync_time_pipelined(s_grad: float, w: float, n: int, t_lat: float) -> float:
    """Eq (2): FuncPipe's full-duplex pipelined scatter-reduce."""
    if n <= 1:
        return 0.0
    return 2 * s_grad / w + (2 + n) * t_lat


@dataclass(frozen=True)
class Config:
    """A co-optimization decision: partition boundaries x (len L-1, {0,1}),
    data-parallel degree d, and per-layer memory option index z (len L,
    constant within a stage)."""

    x: tuple
    d: int
    z: tuple  # memory option INDEX per layer

    def mem(self, platform: Platform) -> np.ndarray:
        return np.array([platform.memory_options[j] for j in self.z], dtype=np.float64)


@dataclass(frozen=True)
class Evaluation:
    t_iter: float
    c_iter: float
    t_f: float
    t_sync_max: float
    mem_ok: bool
    c_mem_gb: float

    def objective(self, a1: float, a2: float) -> float:
        return a1 * self.c_iter + a2 * self.t_iter


# ---------------------------------------------------------- precomputed tables
@dataclass(frozen=True)
class PerfTables:
    """Per-(layer, memory-option) tables for one (profile, platform) pair.

    Built once and cached (:func:`perf_tables`); shared by the scalar oracle,
    the batched kernel and ``simulator.stage_aggregates`` so all three charge
    identical compute/bandwidth terms.  ``monotone`` records whether more
    memory is never worse (bandwidth non-decreasing, compute times
    non-increasing in the option index) — the property the planner's
    lower-bound pruning relies on."""

    L: int
    J: int
    t_lat: float
    base_memory: float
    price_per_gb_s: float
    mem_opts: np.ndarray        # [J] bytes
    W: np.ndarray               # [J] per-function bandwidth
    Tf_beta: np.ndarray         # [L, J] beta * forward compute time
    Tb_beta: np.ndarray         # [L, J] beta * backward compute time
    s: np.ndarray               # [L] parameter bytes
    a: np.ndarray               # [L] activation bytes per micro-batch
    o: np.ndarray               # [L] forward boundary bytes
    g: np.ndarray               # [L] backward boundary bytes
    monotone: bool


@functools.lru_cache(maxsize=256)
def perf_tables(profile: ModelProfile, platform: Platform) -> PerfTables:
    arr = profile.arrays()
    opts = np.array(platform.memory_options, dtype=np.float64)
    if not np.all(np.diff(opts) > 0):
        # the batched planner floors feasibility via searchsorted
        raise ValueError(
            f"platform {platform.name!r} memory_options must be strictly "
            "ascending")
    W = np.array([platform.bandwidth(mo) for mo in platform.memory_options],
                 dtype=np.float64)
    Tf_beta = platform.contention_beta * arr["Tf"].astype(np.float64)
    Tb_beta = platform.contention_beta * arr["Tb"].astype(np.float64)
    mem_opts = opts
    monotone = bool(
        np.all(np.diff(W) >= 0)
        and np.all(np.diff(Tf_beta, axis=1) <= 0)
        and np.all(np.diff(Tb_beta, axis=1) <= 0)
    )
    for t in (W, Tf_beta, Tb_beta, mem_opts):
        t.setflags(write=False)
    return PerfTables(
        L=profile.L, J=len(platform.memory_options),
        t_lat=platform.storage_latency, base_memory=float(platform.base_memory),
        price_per_gb_s=platform.price_per_gb_s, mem_opts=mem_opts, W=W,
        Tf_beta=Tf_beta, Tb_beta=Tb_beta,
        s=arr["s"], a=arr["a"], o=arr["o"], g=arr["g"], monotone=monotone,
    )


@dataclass(frozen=True)
class SegmentTables:
    """Per-(lo, hi[, mem-option]) stage aggregates for one (profile, platform)
    pair: every contiguous layer segment's compute/byte sums, materialized in
    O(L^2·J) once and cached.  This is what the planner's DP engine reads —
    a candidate stage ``[lo, hi]`` at memory level ``j`` costs one table
    lookup instead of a per-layer reduction.

    Association discipline: ``a_hat``/``s_hat`` reproduce :func:`hat`'s fold
    bit-for-bit (they feed the eq (3b) memory threshold, where a one-ulp
    disagreement with the scalar oracle could flip feasibility) and
    ``s_tilde`` reproduces :func:`tilde`'s (it feeds the eq (1)/(2) sync
    terms).  ``f``/``b`` use the hat fold for the per-stage compute sums."""

    f: np.ndarray        # [L, L, J] beta-scaled forward compute sum of [lo..hi]
    b: np.ndarray        # [L, L, J] beta-scaled backward compute sum
    a_hat: np.ndarray    # [L, L] activation bytes (hat association, eq 3b)
    s_hat: np.ndarray    # [L, L] parameter bytes (hat association, eq 3b)
    s_tilde: np.ndarray  # [L, L] parameter bytes (tilde association, sync)


@functools.lru_cache(maxsize=256)
def segment_tables(profile: ModelProfile, platform: Platform) -> SegmentTables:
    T = perf_tables(profile, platform)
    # fold per memory option: [J, L] -> [J, L, L] -> [L, L, J]
    f = np.moveaxis(segment_sum_table(np.ascontiguousarray(T.Tf_beta.T)), 0, -1)
    b = np.moveaxis(segment_sum_table(np.ascontiguousarray(T.Tb_beta.T)), 0, -1)
    a_hat = segment_sum_table(T.a)
    s_hat = segment_sum_table(T.s)
    s_tilde = segment_sum_table_rev(T.s)
    for t in (f, b, a_hat, s_hat, s_tilde):
        t.setflags(write=False)
    return SegmentTables(f=f, b=b, a_hat=a_hat, s_hat=s_hat, s_tilde=s_tilde)


# ------------------------------------------------------------- scalar oracle
def evaluate(
    profile: ModelProfile,
    platform: Platform,
    config: Config,
    total_micro_batches: int,
    *,
    pipelined_sync: bool = True,
) -> Evaluation:
    """Evaluate eq (3a)'s components for one configuration."""
    arr = profile.arrays()
    L = profile.L
    x = np.asarray(config.x, dtype=np.int64)
    assert len(x) == L - 1
    d = config.d
    m = config.mem(platform)
    z = np.asarray(config.z)
    mu = max(1, total_micro_batches // d)  # micro-batches per worker
    beta = platform.contention_beta
    t_lat = platform.storage_latency
    W = np.array([platform.bandwidth(mo) for mo in platform.memory_options])

    w_i = W[z]                                    # per-layer worker bandwidth
    t_fc = beta * arr["Tf"][np.arange(L), z]      # forward compute per layer
    t_bc = beta * arr["Tb"][np.arange(L), z]

    # forward boundary comms (eq 8)
    t_fu = np.zeros(L)
    t_fd = np.zeros(L)
    for i in range(L - 1):
        if x[i]:
            t_fu[i] = arr["o"][i] / w_i[i] + t_lat
            t_fd[i] = arr["o"][i] / w_i[i + 1] + t_lat
    # backward boundary comms (App. B)
    t_bu = np.zeros(L)
    t_bd = np.zeros(L)
    for i in range(1, L):
        if x[i - 1]:
            t_bu[i] = arr["g"][i] / w_i[i] + t_lat
            t_bd[i] = arr["g"][i] / w_i[i - 1] + t_lat

    # ---- forward time
    hat_tfc = hat(t_fc, x)
    t_f0 = suffix_sum(t_fc)[0] + suffix_sum(t_fu)[0] + suffix_sum(t_fd)[0]
    delta_f = max(hat_tfc.max(), t_fu.max() if L > 1 else 0.0, t_fd.max() if L > 1 else 0.0)
    t_f = t_f0 + (mu - 1) * delta_f

    # ---- backward completion per partition-lowest layer (App. B)
    tilde_tbc = tilde(t_bc, x)
    lows = lowest_layers(x)
    sync_fn = sync_time_pipelined if pipelined_sync else sync_time_nonpipelined
    tilde_s = tilde(arr["s"], x)

    # suffix reductions (right folds shared with evaluate_batch); the pads
    # make index i+1 == L read the scalar path's "else 0.0" branch
    zero = np.zeros(1)
    ss_bc = suffix_sum(t_bc)
    ss_bu = np.concatenate([suffix_sum(t_bu), zero])
    ss_bd = np.concatenate([suffix_sum(t_bd), zero])
    sm_bc = suffix_max(tilde_tbc)
    sm_bu = np.concatenate([suffix_max(t_bu), zero])
    sm_bd = np.concatenate([suffix_max(t_bd), zero])

    worst = 0.0
    t_sync_max = 0.0
    for i in lows:
        tb = ss_bc[i] + ss_bu[i + 1] + ss_bd[i + 1]
        db = max(sm_bc[i], sm_bu[i + 1], sm_bd[i + 1])
        tb += (mu - 1) * db
        ts = sync_fn(tilde_s[i], w_i[i], d, t_lat) if d > 1 else 0.0
        t_sync_max = max(t_sync_max, ts)
        worst = max(worst, tb + ts)

    t_iter = t_f + worst

    # ---- memory constraint (3b) and cost (5)/(6)
    hat_a = hat(arr["a"], x)
    hat_s = hat(arr["s"], x)
    highs = highest_layers(x)
    sync_mem_factor = 4 - 2 * (1 if d == 1 else 0)
    mem_ok = all(
        mu * hat_a[i] + hat_s[i] * sync_mem_factor + platform.base_memory <= m[i]
        for i in highs
    )
    c_mem = d * sum(m[i] for i in highs)          # bytes across all workers
    c_iter = platform.price_per_gb_s * (c_mem / GB) * t_iter

    return Evaluation(
        t_iter=float(t_iter),
        c_iter=float(c_iter),
        t_f=float(t_f),
        t_sync_max=float(t_sync_max),
        mem_ok=bool(mem_ok),
        c_mem_gb=float(c_mem / GB),
    )


# ------------------------------------------------------------ batched kernel
@dataclass(frozen=True)
class BatchEvaluation:
    """Column-wise :class:`Evaluation` for N configurations."""

    t_iter: np.ndarray            # [N]
    c_iter: np.ndarray            # [N]
    t_f: np.ndarray               # [N]
    t_sync_max: np.ndarray        # [N]
    mem_ok: np.ndarray            # [N] bool
    c_mem_gb: np.ndarray          # [N]

    def __len__(self) -> int:
        return len(self.t_iter)

    def objective(self, a1: float, a2: float) -> np.ndarray:
        return a1 * self.c_iter + a2 * self.t_iter

    def masked_objective(self, a1: float, a2: float) -> np.ndarray:
        """Objective with infeasible rows forced to +inf (argmin-safe)."""
        return np.where(self.mem_ok, self.objective(a1, a2), np.inf)

    def pick(self, i: int) -> Evaluation:
        return Evaluation(
            t_iter=float(self.t_iter[i]), c_iter=float(self.c_iter[i]),
            t_f=float(self.t_f[i]), t_sync_max=float(self.t_sync_max[i]),
            mem_ok=bool(self.mem_ok[i]), c_mem_gb=float(self.c_mem_gb[i]),
        )


def evaluate_batch(
    profile: ModelProfile,
    platform: Platform,
    X: np.ndarray,
    Z: np.ndarray,
    d: int,
    total_micro_batches: int,
    *,
    pipelined_sync: bool = True,
    tables: Optional[PerfTables] = None,
) -> BatchEvaluation:
    """Vectorized :func:`evaluate` over N configurations at one DP degree.

    ``X`` is ``[N, L-1]`` partition-boundary bits, ``Z`` is ``[N, L]``
    per-layer memory-option indices.  Every arithmetic step mirrors the
    scalar oracle's operation order (shared ``hat``/``tilde``/suffix
    helpers), so the outputs are bit-for-bit equal to N scalar calls."""
    T = tables if tables is not None else perf_tables(profile, platform)
    X = np.asarray(X, dtype=np.int64)
    Z = np.asarray(Z, dtype=np.int64)
    if X.ndim != 2 or Z.ndim != 2:
        raise ValueError("X must be [N, L-1] and Z [N, L]")
    N, L = Z.shape
    if X.shape != (N, L - 1):
        raise ValueError(f"X {X.shape} inconsistent with Z {Z.shape}")
    mu = max(1, total_micro_batches // d)
    t_lat = T.t_lat
    lidx = np.arange(L)

    w_i = T.W[Z]                                  # [N, L]
    t_fc = T.Tf_beta[lidx, Z]                     # [N, L]
    t_bc = T.Tb_beta[lidx, Z]

    cut = X == 1                                  # [N, L-1]
    t_fu = np.zeros((N, L))
    t_fd = np.zeros((N, L))
    t_fu[:, :-1] = np.where(cut, T.o[:L - 1] / w_i[:, :-1] + t_lat, 0.0)
    t_fd[:, :-1] = np.where(cut, T.o[:L - 1] / w_i[:, 1:] + t_lat, 0.0)
    t_bu = np.zeros((N, L))
    t_bd = np.zeros((N, L))
    t_bu[:, 1:] = np.where(cut, T.g[1:] / w_i[:, 1:] + t_lat, 0.0)
    t_bd[:, 1:] = np.where(cut, T.g[1:] / w_i[:, :-1] + t_lat, 0.0)

    # ---- forward time
    hat_tfc = hat(t_fc, X)
    t_f0 = suffix_sum(t_fc)[:, 0] + suffix_sum(t_fu)[:, 0] + suffix_sum(t_fd)[:, 0]
    # t_fu/t_fd are all-zero when L == 1, matching the scalar "else 0.0"
    delta_f = np.maximum(hat_tfc.max(axis=1),
                         np.maximum(t_fu.max(axis=1), t_fd.max(axis=1)))
    t_f = t_f0 + (mu - 1) * delta_f

    # ---- backward completion per partition-lowest layer (App. B)
    tilde_tbc = tilde(t_bc, X)
    tilde_s = tilde(np.broadcast_to(T.s, (N, L)), X)
    zero = np.zeros((N, 1))
    ss_bc = suffix_sum(t_bc)
    ss_bu = np.concatenate([suffix_sum(t_bu), zero], axis=1)
    ss_bd = np.concatenate([suffix_sum(t_bd), zero], axis=1)
    sm_bc = suffix_max(tilde_tbc)
    sm_bu = np.concatenate([suffix_max(t_bu), zero], axis=1)
    sm_bd = np.concatenate([suffix_max(t_bd), zero], axis=1)

    tb = ss_bc + ss_bu[:, 1:] + ss_bd[:, 1:]                     # [N, L]
    db = np.maximum(sm_bc, np.maximum(sm_bu[:, 1:], sm_bd[:, 1:]))
    tb = tb + (mu - 1) * db

    if d > 1:
        if pipelined_sync:
            ts = 2 * tilde_s / w_i + (2 + d) * t_lat
        else:
            ts = 3 * tilde_s / w_i - 2 * tilde_s / (d * w_i) + 4 * t_lat
    else:
        ts = np.zeros((N, L))

    is_low = np.zeros((N, L), dtype=bool)
    is_low[:, 0] = True
    is_low[:, 1:] = cut
    worst = np.where(is_low, tb + ts, 0.0).max(axis=1)
    t_sync_max = np.where(is_low, ts, 0.0).max(axis=1)
    t_iter = t_f + worst

    # ---- memory constraint (3b) and cost (5)/(6)
    hat_a = hat(np.broadcast_to(T.a, (N, L)), X)
    hat_s = hat(np.broadcast_to(T.s, (N, L)), X)
    is_high = np.zeros((N, L), dtype=bool)
    is_high[:, L - 1] = True
    is_high[:, :L - 1] = cut
    sync_mem_factor = 4 - 2 * (1 if d == 1 else 0)
    m = T.mem_opts[Z]                                            # [N, L]
    need = mu * hat_a + hat_s * sync_mem_factor + T.base_memory
    mem_ok = np.all(~is_high | (need <= m), axis=1)
    c_mem = np.zeros(N)
    for i in range(L):  # sequential accumulation == Python sum over highs
        c_mem = c_mem + np.where(is_high[:, i], m[:, i], 0.0)
    c_mem = d * c_mem
    c_iter = T.price_per_gb_s * (c_mem / GB) * t_iter

    return BatchEvaluation(
        t_iter=t_iter, c_iter=c_iter, t_f=t_f, t_sync_max=t_sync_max,
        mem_ok=mem_ok, c_mem_gb=c_mem / GB,
    )
