"""Co-optimization of model partition and resource allocation (paper §3.4);
``repro.core.planner`` for the port, copied exactly, so both packages pick
the same plan with the same objective bits.

The paper linearizes the nonlinear binary program (3) to an MIQP and calls
Gurobi.  No MIP solver ships offline, so we solve the *same formulation*
with layer merging (paper §4) + exhaustive enumeration over (d, partition)
+ per-stage memory by coordinate descent from the min-feasible assignment —
``method='exhaustive'`` cross-checks the heuristic on small instances (the
tests assert they agree).

Three engines drive the search:

  * ``engine='scalar'`` — the seed implementation: one ``perfmodel.evaluate``
    call per candidate.  Kept as the reference the batched engine is
    parity-tested against.
  * ``engine='batch'`` (default) — candidates are enumerated as index arrays
    and evaluated through ``perfmodel.evaluate_batch``: the coordinate
    descent runs every (partition, start) trajectory in lockstep, evaluating
    all (stage, level) neighbors of every incumbent in one batched call per
    coordinate step; exhaustive mode is one batched call per partition.  The
    update rule is the exact scalar rule (strict-improvement, first-minimizer
    tie-breaks), so both engines return the *identical* plan — the batch
    engine is just 1-2 orders of magnitude faster, which is what lets the
    default ``merge_to`` sit at 14 instead of the seed's 10.  On monotone
    platforms (more memory never slower) the batch engine additionally
    prunes partitions by an objective lower bound (t at max memory, cost at
    min-feasible memory); the bound only ever discards partitions that
    provably cannot tie the incumbent, so exactness of the CD-per-partition
    scheme is preserved.
  * ``engine='dp'`` (:func:`dp_solve`) — the exact dynamic program over
    stage cut-points: per-stage costs are (lo, hi, mem-level)-separable on
    the precomputed ``perfmodel.segment_tables`` except for the cross-stage
    boundary transfers, which the DP carries as a one-level boundary state;
    the pipeline bottleneck (max) terms ride along as a Pareto-valued state,
    so the result is *provably optimal* per (d, M) — no CD heuristic, no
    2^(L-1) enumeration.  The only engine for which ``merge_to=None`` (full
    layer depth) is tractable.

Also implements the two comparison algorithms of §5.6:
  * ``tpdmp_solve`` — throughput-maximizing partition under fixed resources,
    grid-searched over resource allocations (TPDMP [63] adaptation);
  * ``bayes_solve`` — black-box random/Bayesian-style search over the joint
    space with the performance model as the evaluator (paper's Bayes setup).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.partition import (
    ModelProfile,
    hat,
    merge_layers,
    stage_ids,
    stages_of,
)
from repro_torch.core.perfmodel import (
    BatchEvaluation,
    Config,
    Evaluation,
    PerfTables,
    SegmentTables,
    evaluate,
    evaluate_batch,
    perf_tables,
    segment_tables,
    sync_time_nonpipelined,
    sync_time_pipelined,
)
from repro_torch.serverless.platform import GB, Platform

DEFAULT_D_OPTIONS = (1, 2, 4, 8, 16)
DEFAULT_MERGE_TO = 14          # seed scalar solver had to stop at 10
_CHUNK_ROWS = 1 << 17          # max evaluate_batch rows per call
_CD_SWEEPS = 6


@dataclass
class PlannerStats:
    """Instrumentation counters from one solve: how much of the search space
    each engine actually expanded vs pruned.  Purely observational — no
    engine changes behavior based on them (``repro plan`` prints them; sweeps
    aggregate them next to the plan-cache hit/miss counters)."""

    engine: str = ""
    # batch/scalar engines: feasible partitions polished through coordinate
    # descent vs discarded by the lower-bound screen before any CD work
    partitions_polished: int = 0
    partitions_pruned: int = 0
    # dp engine: (p, j) suffix states expanded; Pareto rows kept vs discarded
    # by componentwise dominance vs discarded by the admissible completion
    # bound against the incumbent
    dp_states: int = 0
    dp_rows_kept: int = 0
    dp_rows_dominated: int = 0
    dp_rows_bounded: int = 0

    def describe(self) -> str:
        if self.engine == "dp":
            return (f"dp: {self.dp_states} states, "
                    f"{self.dp_rows_kept} rows kept, "
                    f"{self.dp_rows_dominated} dominated, "
                    f"{self.dp_rows_bounded} bounded")
        return (f"{self.engine}: {self.partitions_polished} partitions "
                f"polished, {self.partitions_pruned} pruned")


@dataclass(frozen=True)
class PlanResult:
    config: Config
    evaluation: Evaluation
    objective: float
    solve_seconds: float
    profile: ModelProfile  # (merged) profile the config indexes into
    stats: Optional[PlannerStats] = None   # search-space counters (optional)


def _merged(profile: ModelProfile, merge_to: Optional[int]) -> ModelProfile:
    """merge_to=None means plan at full layer depth (no merging)."""
    return profile if merge_to is None else merge_layers(profile, merge_to)


def _expand_z(stage_mem: Sequence[int], x: Sequence[int], L: int) -> tuple:
    z = []
    s = 0
    for i in range(L):
        z.append(stage_mem[s])
        if i < L - 1 and x[i]:
            s += 1
    return tuple(z)


def _min_feasible_stage_mem(profile, platform, x, d, mu) -> Optional[List[int]]:
    """Smallest memory option per stage satisfying eq (3b), else None.

    Stage sums come from the ``hat`` recurrence (same association as the
    batched path) so both engines agree on feasibility thresholds."""
    arr = profile.arrays()
    opts = platform.memory_options
    sync_f = 4 - 2 * (1 if d == 1 else 0)
    xa = np.asarray(x, dtype=np.int64)
    hat_a = hat(arr["a"], xa)
    hat_s = hat(arr["s"], xa)
    out = []
    for lo, hi in stages_of(x):
        need = mu * hat_a[hi] + hat_s[hi] * sync_f + platform.base_memory
        j = next((j for j, m in enumerate(opts) if m >= need), None)
        if j is None:
            return None
        out.append(j)
    return out


# ------------------------------------------------------------- scalar engine
def _cd_from(profile, platform, x, d, mu, a1, a2, pipelined_sync,
             start: List[int], floor: List[int], sweeps: int = _CD_SWEEPS):
    J = len(platform.memory_options)
    L = profile.L
    stage_mem = list(start)
    best_cfg = Config(x=tuple(x), d=d, z=_expand_z(stage_mem, x, L))
    best = evaluate(profile, platform, best_cfg, mu * d, pipelined_sync=pipelined_sync)
    if not best.mem_ok:
        return None, None, None
    best_obj = best.objective(a1, a2)
    n_stages = len(stage_mem)
    for _ in range(sweeps):
        improved = False
        for s in range(n_stages):
            for j in range(floor[s], J):  # never below min-feasible
                if j == stage_mem[s]:
                    continue
                trial = list(stage_mem)
                trial[s] = j
                cfg = Config(x=tuple(x), d=d, z=_expand_z(trial, x, L))
                ev = evaluate(profile, platform, cfg, mu * d, pipelined_sync=pipelined_sync)
                if ev.mem_ok and ev.objective(a1, a2) < best_obj:
                    stage_mem, best_cfg, best, best_obj = trial, cfg, ev, ev.objective(a1, a2)
                    improved = True
        if not improved:
            break
    return best_cfg, best, best_obj


def _cd_from_steepest(profile, platform, x, d, mu, a1, a2, pipelined_sync,
                      start: List[int], floor: List[int],
                      sweeps: int = _CD_SWEEPS):
    """Steepest-descent CD (``method='cd-steepest'``): each move evaluates
    *all* (stage, level) neighbors of the incumbent and accepts the single
    best strict improvement (ties: first in stage-major, level order).  The
    move budget ``sweeps * n_stages`` matches the first-improvement rule's
    maximum accepted-move count, so the two rules get equal search effort."""
    J = len(platform.memory_options)
    L = profile.L
    stage_mem = list(start)
    best_cfg = Config(x=tuple(x), d=d, z=_expand_z(stage_mem, x, L))
    best = evaluate(profile, platform, best_cfg, mu * d,
                    pipelined_sync=pipelined_sync)
    if not best.mem_ok:
        return None, None, None
    best_obj = best.objective(a1, a2)
    n_stages = len(stage_mem)
    for _ in range(sweeps * max(1, n_stages)):
        move = None                        # (obj, s, j, cfg, ev)
        for s in range(n_stages):
            for j in range(floor[s], J):   # never below min-feasible
                if j == stage_mem[s]:
                    continue
                trial = list(stage_mem)
                trial[s] = j
                cfg = Config(x=tuple(x), d=d, z=_expand_z(trial, x, L))
                ev = evaluate(profile, platform, cfg, mu * d,
                              pipelined_sync=pipelined_sync)
                obj = ev.objective(a1, a2)
                if ev.mem_ok and obj < best_obj and \
                        (move is None or obj < move[0]):
                    move = (obj, s, j, cfg, ev)
        if move is None:
            break
        best_obj, s_mv, j_mv, best_cfg, best = move
        stage_mem[s_mv] = j_mv
    return best_cfg, best, best_obj


def _cd_starts(init_mem: Sequence[int], J: int) -> List[List[int]]:
    """Multi-start list for the per-stage memory CD, deduplicated keeping
    first occurrence: the min-feasible assignment, the max assignment, and
    uniform levels clipped to the feasibility floor."""
    n_stages = len(init_mem)
    starts: List[List[int]] = []
    for cand in [list(init_mem), [J - 1] * n_stages] + [
            [max(j, f) for f in init_mem] for j in range(J)]:
        if cand not in starts:
            starts.append(cand)
    return starts


def _coordinate_descent(profile, platform, x, d, mu, a1, a2, pipelined_sync,
                        init_mem: List[int], sweeps: int = _CD_SWEEPS,
                        rule: str = "first"):
    """Multi-start coordinate descent on per-stage memory: starts from the
    min-feasible assignment, the max assignment, and uniform levels — greedy
    CD alone gets caught in neighbor-coupled local optima (upload/download
    terms couple adjacent stages).  ``rule`` picks the update rule: the
    first-improvement stage sweep (``'first'``) or steepest descent over all
    (stage, level) neighbors (``'steepest'``)."""
    J = len(platform.memory_options)
    descend = _cd_from if rule == "first" else _cd_from_steepest
    best_cfg, best_ev, best_obj = None, None, np.inf
    for start in _cd_starts(init_mem, J):
        cfg, ev, obj = descend(profile, platform, x, d, mu, a1, a2,
                               pipelined_sync, start, init_mem, sweeps)
        if cfg is None:
            continue
        if obj < best_obj:
            best_cfg, best_ev, best_obj = cfg, ev, obj
    if best_cfg is None:
        return None, None
    return best_cfg, best_ev


def _partitions(L: int, max_stages: Optional[int] = None):
    for bits in itertools.product((0, 1), repeat=L - 1):
        if max_stages is not None and sum(bits) + 1 > max_stages:
            continue
        yield bits


def _solve_scalar(profile, platform, *, alpha, total_micro_batches, d_options,
                  merge_to, max_stages, method, pipelined_sync):
    t0 = time.time()
    a1, a2 = alpha
    prof = _merged(profile, merge_to)
    L = prof.L
    J = len(platform.memory_options)
    best: Optional[PlanResult] = None
    stats = PlannerStats(engine="scalar")
    for d in d_options:
        if total_micro_batches % d or total_micro_batches < d:
            continue
        mu = total_micro_batches // d
        for x in _partitions(L, max_stages):
            init = _min_feasible_stage_mem(prof, platform, x, d, mu)
            if init is None:
                continue
            stats.partitions_polished += 1
            if method == "exhaustive":
                n_stages = sum(x) + 1
                best_cfg, best_ev, best_o = None, None, np.inf
                for combo in itertools.product(range(J), repeat=n_stages):
                    if any(c < i for c, i in zip(combo, init)):
                        continue
                    cfg = Config(x=tuple(x), d=d, z=_expand_z(list(combo), x, L))
                    ev = evaluate(prof, platform, cfg, total_micro_batches,
                                  pipelined_sync=pipelined_sync)
                    if ev.mem_ok and ev.objective(a1, a2) < best_o:
                        best_cfg, best_ev, best_o = cfg, ev, ev.objective(a1, a2)
                cfg, ev = best_cfg, best_ev
            else:
                cfg, ev = _coordinate_descent(
                    prof, platform, x, d, mu, a1, a2, pipelined_sync, init,
                    rule="steepest" if method == "cd-steepest" else "first")
            if cfg is None:
                continue
            obj = ev.objective(a1, a2)
            if best is None or obj < best.objective:
                best = PlanResult(cfg, ev, obj, 0.0, prof)
    if best is not None:
        best = dataclasses.replace(best, solve_seconds=time.time() - t0,
                                   stats=stats)
    return best


# ------------------------------------------------------------- batch engine
def _partition_matrix(L: int, max_stages: Optional[int] = None) -> np.ndarray:
    """All boundary vectors of ``_partitions`` as an ``[P, L-1]`` matrix, in
    the same (itertools.product) enumeration order."""
    if L <= 1:
        return np.zeros((1, 0), dtype=np.int64)
    P = 1 << (L - 1)
    bits = (np.arange(P, dtype=np.int64)[:, None]
            >> np.arange(L - 2, -1, -1, dtype=np.int64)) & 1
    if max_stages is not None:
        bits = bits[bits.sum(axis=1) + 1 <= max_stages]
    return bits


def _stage_layout(X: np.ndarray):
    """sid [P, L], n_stages [P], per-stage high-layer index [P, S_max]."""
    sid = stage_ids(X)
    n_stages = sid[:, -1] + 1
    S_max = int(n_stages.max())
    high_pos = np.empty((len(X), S_max), dtype=np.int64)
    for s in range(S_max):
        high_pos[:, s] = np.sum(sid <= s, axis=1) - 1
    return sid, n_stages, high_pos, S_max


def _floors_batch(tables: PerfTables, X, high_pos, n_stages, d, mu):
    """Vectorized `_min_feasible_stage_mem` over a partition matrix: returns
    the per-stage floor indices [P, S_max] (padded stages clamped to 0) and
    the feasibility mask [P]."""
    N = len(X)
    L = tables.L
    sync_f = 4 - 2 * (1 if d == 1 else 0)
    hat_a = hat(np.broadcast_to(tables.a, (N, L)), X)
    hat_s = hat(np.broadcast_to(tables.s, (N, L)), X)
    need = mu * hat_a + hat_s * sync_f + tables.base_memory
    j_need = np.searchsorted(tables.mem_opts, need, side="left")   # [N, L]
    floor_st = np.take_along_axis(j_need, high_pos, axis=1)        # [N, S_max]
    s_idx = np.arange(floor_st.shape[1])[None, :]
    real = s_idx < n_stages[:, None]
    feasible = np.all(~real | (floor_st < tables.J), axis=1)
    return np.where(real, floor_st, 0), feasible


def _starts_batch(floor_st: np.ndarray, n_stages: np.ndarray, J: int):
    """Per-partition CD start candidates [P, K, S_max] + validity mask [P, K],
    mirroring `_cd_starts` (order + keep-first-occurrence dedupe)."""
    N, S_max = floor_st.shape
    K = 2 + J
    cand = np.empty((N, K, S_max), dtype=np.int64)
    cand[:, 0] = floor_st
    cand[:, 1] = J - 1
    for j in range(J):
        cand[:, 2 + j] = np.maximum(j, floor_st)
    pad = np.broadcast_to(
        np.arange(S_max)[None, None, :] >= n_stages[:, None, None], cand.shape)
    cand[pad] = 0
    valid = np.ones((N, K), dtype=bool)
    for k in range(1, K):
        dup = np.zeros(N, dtype=bool)
        for kp in range(k):
            dup |= valid[:, kp] & np.all(cand[:, k] == cand[:, kp], axis=1)
        valid[:, k] = ~dup
    return cand, valid


def _eval_chunked(profile, platform, tables, X, Z, d, M, pipelined_sync) -> BatchEvaluation:
    N = len(X)
    if N <= _CHUNK_ROWS:
        return evaluate_batch(profile, platform, X, Z, d, M,
                              pipelined_sync=pipelined_sync, tables=tables)
    parts = [evaluate_batch(profile, platform, X[lo:lo + _CHUNK_ROWS],
                            Z[lo:lo + _CHUNK_ROWS], d, M,
                            pipelined_sync=pipelined_sync, tables=tables)
             for lo in range(0, N, _CHUNK_ROWS)]
    return BatchEvaluation(*[np.concatenate([getattr(p, f.name) for p in parts])
                             for f in dataclasses.fields(BatchEvaluation)])


def _cd_lockstep(profile, platform, tables, X, sid, n_stages, floor_st, sm, tp,
                 d, M, a1, a2, pipelined_sync, sweeps):
    """Run every (partition, start) CD trajectory in lockstep.

    Each trajectory follows the exact `_cd_from` update rule — per sweep,
    per stage, evaluate all memory levels of that stage against the
    trajectory's incumbent and accept the first minimizer iff it strictly
    improves — but all trajectories' (stage, level) neighbors are evaluated
    in one `evaluate_batch` call per coordinate step.  Returns per-trajectory
    best objectives and final stage assignments (both exactly what the
    scalar engine would compute)."""
    T_, S_max = sm.shape
    L = tables.L
    J = tables.J
    X_t, sid_t, ns_t, fl_t = X[tp], sid[tp], n_stages[tp], floor_st[tp]
    Z0 = np.take_along_axis(sm, sid_t, axis=1)
    be = _eval_chunked(profile, platform, tables, X_t, Z0, d, M, pipelined_sync)
    best_obj = be.masked_objective(a1, a2)
    alive = np.isfinite(best_obj)          # infeasible start == scalar None
    jr = np.arange(J)
    step = max(1, _CHUNK_ROWS // J)
    for _ in range(sweeps):
        improved = np.zeros(T_, dtype=bool)
        for s in range(S_max):
            act = np.nonzero(alive & (ns_t > s))[0]
            for lo in range(0, len(act), step):
                ai = act[lo:lo + step]
                A = len(ai)
                base_z = np.take_along_axis(sm[ai], sid_t[ai], axis=1)   # [A, L]
                mask_s = sid_t[ai] == s
                Z_nb = np.where(mask_s[:, None, :], jr[None, :, None],
                                base_z[:, None, :]).reshape(A * J, L)
                X_nb = np.repeat(X_t[ai], J, axis=0)
                be = evaluate_batch(profile, platform, X_nb, Z_nb, d, M,
                                    pipelined_sync=pipelined_sync, tables=tables)
                obj = be.masked_objective(a1, a2).reshape(A, J)
                obj[jr[None, :] < fl_t[ai, s][:, None]] = np.inf
                bj = np.argmin(obj, axis=1)          # lowest level on ties
                bv = obj[np.arange(A), bj]
                acc = bv < best_obj[ai]              # strict improvement only
                upd = ai[acc]
                sm[upd, s] = bj[acc]
                best_obj[upd] = bv[acc]
                improved[upd] = True
        alive &= improved
        if not alive.any():
            break
    return best_obj, sm


def _cd_lockstep_steepest(profile, platform, tables, X, sid, n_stages,
                          floor_st, sm, tp, d, M, a1, a2, pipelined_sync,
                          sweeps):
    """Lockstep twin of `_cd_from_steepest`: per move, every alive
    trajectory's full (stage, level) neighborhood is evaluated in one
    batched call and the single best strict improvement accepted
    (np.argmin's first-occurrence = the scalar rule's stage-major, level
    tie-break), with the same ``sweeps * n_stages`` per-trajectory move
    budget — so batch and scalar steepest return identical plans."""
    T_, S_max = sm.shape
    L = tables.L
    J = tables.J
    X_t, sid_t, ns_t, fl_t = X[tp], sid[tp], n_stages[tp], floor_st[tp]
    Z0 = np.take_along_axis(sm, sid_t, axis=1)
    be = _eval_chunked(profile, platform, tables, X_t, Z0, d, M, pipelined_sync)
    best_obj = be.masked_objective(a1, a2)
    alive = np.isfinite(best_obj)          # infeasible start == scalar None
    moves = np.zeros(T_, dtype=np.int64)
    max_moves = sweeps * np.maximum(ns_t, 1)
    NB = S_max * J
    jr = np.arange(J)
    sr = np.arange(S_max)
    step = max(1, _CHUNK_ROWS // NB)
    while alive.any():
        act = np.nonzero(alive)[0]
        for lo in range(0, len(act), step):
            ai = act[lo:lo + step]
            A = len(ai)
            base_z = np.take_along_axis(sm[ai], sid_t[ai], axis=1)   # [A, L]
            # neighbor (stage, level) tensor: set stage s to level j
            mask = sid_t[ai][:, None, :] == sr[None, :, None]        # [A, S, L]
            Z_nb = np.where(mask[:, :, None, :], jr[None, None, :, None],
                            base_z[:, None, None, :]).reshape(A * NB, L)
            X_nb = np.repeat(X_t[ai], NB, axis=0)
            be = evaluate_batch(profile, platform, X_nb, Z_nb, d, M,
                                pipelined_sync=pipelined_sync, tables=tables)
            obj = be.masked_objective(a1, a2).reshape(A, S_max, J)
            obj[sr[None, :] >= ns_t[ai][:, None]] = np.inf    # padded stages
            obj[jr[None, None, :] < fl_t[ai][:, :, None]] = np.inf  # floors
            flat = obj.reshape(A, NB)
            bj = np.argmin(flat, axis=1)         # first minimizer on ties
            bv = flat[np.arange(A), bj]
            acc = bv < best_obj[ai]              # strict improvement only
            upd = ai[acc]
            s_mv, j_mv = np.divmod(bj[acc], J)
            sm[upd, s_mv] = j_mv
            best_obj[upd] = bv[acc]
            moves[upd] += 1
            alive[ai[~acc]] = False
            alive[upd[moves[upd] >= max_moves[upd]]] = False
    return best_obj, sm


def _reduce_per_partition(tp, best_obj, sm):
    """Per-partition minimum over start trajectories, first-start tie-break
    (`tp` must be sorted ascending; trajectories ordered by start rank)."""
    seg = np.flatnonzero(np.r_[True, tp[1:] != tp[:-1]])
    pres = tp[seg]
    min_obj = np.minimum.reduceat(best_obj, seg)
    tidx = np.arange(len(tp))
    cand = np.where(best_obj == min_obj[np.searchsorted(pres, tp)], tidx, len(tp))
    win = np.minimum.reduceat(cand, seg)
    return pres, min_obj, sm[win]


def _lb_screen(profile, platform, tables, X, sid, floor_st, n_stages, d, M,
               a1, a2, pipelined_sync):
    """Pruning screen: per-partition objective lower bound + achievable prime.

    The lower bound combines the iteration time at max memory (valid because
    the tables are monotone) with the cost at the min-feasible allocation;
    it is shrunk by 1e-9 relative so float noise can never prune a partition
    that ties the optimum.  Both screening evaluations (floor and max
    assignments) are real CD start points, so the better of their objectives
    is an *achievable* incumbent that primes pruning before any CD runs."""
    N = len(X)
    Zmax = np.full((N, tables.L), tables.J - 1, dtype=np.int64)
    be_max = _eval_chunked(profile, platform, tables, X, Zmax, d, M, pipelined_sync)
    t_min = be_max.t_iter
    s_idx = np.arange(floor_st.shape[1])[None, :]
    memfloor = d * np.where(s_idx < n_stages[:, None],
                            tables.mem_opts[floor_st], 0.0).sum(axis=1)
    lb = a1 * tables.price_per_gb_s * (memfloor / GB) * t_min + a2 * t_min
    Zfloor = np.take_along_axis(floor_st, sid, axis=1)
    be_floor = _eval_chunked(profile, platform, tables, X, Zfloor, d, M,
                             pipelined_sync)
    prime = float(min(be_max.masked_objective(a1, a2).min(),
                      be_floor.masked_objective(a1, a2).min()))
    return lb * (1 - 1e-9), prime


def _solve_batch(profile, platform, *, alpha, total_micro_batches, d_options,
                 merge_to, max_stages, method, pipelined_sync):
    t0 = time.time()
    a1, a2 = alpha
    prof = _merged(profile, merge_to)
    L = prof.L
    M = total_micro_batches
    tables = perf_tables(prof, platform)
    J = tables.J
    best_key = None                  # (objective, d_rank, partition enum idx)
    best_state = None                # (x row, z row, d)
    stats = PlannerStats(engine="batch")
    X_all = _partition_matrix(L, max_stages)         # d-independent
    sid_all, ns_all, hp_all, S_max = _stage_layout(X_all)

    for d_rank, d in enumerate(d_options):
        if M % d or M < d:
            continue
        mu = M // d
        floor_st, feasible = _floors_batch(tables, X_all, hp_all, ns_all, d, mu)
        idx = np.nonzero(feasible)[0]
        if len(idx) == 0:
            continue
        X_f, sid_f, ns_f, fl_f = X_all[idx], sid_all[idx], ns_all[idx], floor_st[idx]

        if method == "exhaustive":
            for p in range(len(idx)):
                S = int(ns_f[p])
                total = J ** S
                if total > 10**12:  # int64 digit decode + any hope of finishing
                    raise ValueError(
                        f"method='exhaustive' would enumerate {J}^{S} memory "
                        "combos; use method='cd' at this depth")
                # stream combos in itertools.product order, chunked so memory
                # stays bounded (the scalar engine streamed one at a time)
                pows = J ** np.arange(S - 1, -1, -1, dtype=np.int64)
                best_o, best_z = np.inf, None
                for clo in range(0, total, _CHUNK_ROWS):
                    ci = np.arange(clo, min(clo + _CHUNK_ROWS, total),
                                   dtype=np.int64)
                    combos = (ci[:, None] // pows) % J
                    combos = combos[np.all(combos >= fl_f[p, :S], axis=1)]
                    if len(combos) == 0:
                        continue
                    Z = combos[:, sid_f[p]]                     # [C, L]
                    X_rep = np.broadcast_to(X_f[p], (len(combos), L - 1))
                    be = _eval_chunked(prof, platform, tables, X_rep, Z, d, M,
                                       pipelined_sync)
                    obj = be.masked_objective(a1, a2)
                    k = int(np.argmin(obj))                     # first minimizer
                    if obj[k] < best_o:     # strict: earlier chunks win ties
                        best_o, best_z = float(obj[k]), Z[k]
                if best_z is None or not np.isfinite(best_o):
                    continue
                key = (best_o, d_rank, int(idx[p]))
                if best_key is None or key < best_key:
                    best_key, best_state = key, (X_f[p], best_z, d)
            stats.partitions_polished += len(idx)
            continue

        # ---- coordinate descent over all partitions, LB-pruned and chunked
        cand_sm, valid = _starts_batch(fl_f, ns_f, J)
        pruning = tables.monotone and a1 >= 0 and a2 >= 0
        if pruning:
            lb, prime = _lb_screen(prof, platform, tables, X_f, sid_f, fl_f,
                                   ns_f, d, M, a1, a2, pipelined_sync)
            order = np.argsort(lb, kind="stable")
        else:
            lb, prime = np.full(len(idx), -np.inf), np.inf
            order = np.arange(len(idx))
        # grow chunks: a small first chunk (best LB candidates) establishes
        # the incumbent cheaply, so the bulk of the space is LB-pruned
        max_chunk = max(64, _CHUNK_ROWS // ((2 + J) * J))
        chunk, pos = 64, 0
        polished_d = 0
        while pos < len(order):
            sel = order[pos:pos + chunk]
            pos += chunk
            chunk = min(max_chunk, chunk * 4)
            inc = min(prime, best_key[0]) if best_key is not None else prime
            if pruning and lb[sel].min() > inc:
                break                    # lb sorted: nothing later can tie
            sel = sel[lb[sel] <= inc]
            if len(sel) == 0:
                continue
            polished_d += len(sel)
            tp, rank = np.nonzero(valid[sel])
            sm = cand_sm[sel][tp, rank].copy()
            lockstep = (_cd_lockstep_steepest if method == "cd-steepest"
                        else _cd_lockstep)
            b_obj, sm = lockstep(prof, platform, tables, X_f[sel], sid_f[sel],
                                 ns_f[sel], fl_f[sel], sm, tp, d, M, a1, a2,
                                 pipelined_sync, _CD_SWEEPS)
            pres, min_obj, win_sm = _reduce_per_partition(tp, b_obj, sm)
            for q in range(len(pres)):
                if not np.isfinite(min_obj[q]):
                    continue
                p_loc = int(pres[q])
                key = (float(min_obj[q]), d_rank, int(idx[sel[p_loc]]))
                if best_key is None or key < best_key:
                    z = np.take_along_axis(win_sm[q][None, :],
                                           sid_f[sel[p_loc]][None, :], axis=1)[0]
                    best_key, best_state = key, (X_f[sel[p_loc]], z, d)
        stats.partitions_polished += polished_d
        stats.partitions_pruned += len(idx) - polished_d

    if best_state is None:
        return None
    x_row, z_row, d = best_state
    cfg = Config(x=tuple(int(v) for v in x_row), d=int(d),
                 z=tuple(int(v) for v in z_row))
    ev = evaluate(prof, platform, cfg, M, pipelined_sync=pipelined_sync)
    return PlanResult(cfg, ev, ev.objective(a1, a2), time.time() - t0, prof,
                      stats)


# ----------------------------------------------------------------- dp engine
# Finalists within this relative band of the DP optimum are re-scored through
# the scalar oracle: the DP accumulates stage-at-a-time while `evaluate` folds
# whole-chain suffixes, so their float association differs by ~1e-13 relative
# — re-ranking a 1e-9 band through `evaluate` makes the returned plan the
# oracle-arithmetic argmin even across such near-ties.
_DP_FINALIST_RTOL = 1e-9
_DP_FINALIST_CAP = 64          # max finalists re-scored per (d, state sweep)
_INIT_ROW = -1                 # back-pointer sentinel: row starts a suffix


@dataclass(frozen=True)
class _DpTables:
    """Per-(profile, platform, d) working tables for the cut-point DP."""

    feas: np.ndarray       # [L, L, J] stage [lo, hi] fits at mem level j
    ts: np.ndarray         # [L, L, J] per-stage sync time (eq 1/2; 0 if d==1)
    cutf: np.ndarray       # [L, J] one side of the fwd boundary comm at cut k
    cutb: np.ndarray       # [L, J] one side of the bwd boundary comm at cut k
    fmin_pre: np.ndarray   # [L+1] lower bound on fwd compute of layers < p
    bmin_pre: np.ndarray   # [L+1] same for bwd compute
    cutf_min: np.ndarray   # [L] min over allowed j of cutf[k]
    cutb_min: np.ndarray   # [L] min over allowed j of cutb[k]
    minmem: np.ndarray     # [L+1] min total stage memory covering layers < p


def _dp_tables(tables: PerfTables, segs: SegmentTables, d: int, mu: int,
               pipelined_sync: bool, j_only: Optional[int]) -> _DpTables:
    L, J = tables.L, tables.J
    W, t_lat = tables.W, tables.t_lat
    sync_f = 4 - 2 * (1 if d == 1 else 0)
    # eq (3b), same operation order as the scalar oracle's threshold
    need = mu * segs.a_hat + segs.s_hat * sync_f + tables.base_memory
    feas = need[:, :, None] <= tables.mem_opts[None, None, :]
    if d > 1:
        # the scalar helpers broadcast over the [L, L, 1] / [J] operands with
        # the oracle's exact operation order (d > 1 here, so no early return)
        sync_fn = (sync_time_pipelined if pipelined_sync
                   else sync_time_nonpipelined)
        ts = sync_fn(segs.s_tilde[:, :, None], W, d, t_lat)
    else:
        ts = np.zeros((L, L, J))
    cutf = np.zeros((L, J))
    cutb = np.zeros((L, J))
    if L > 1:
        cutf[1:] = tables.o[:L - 1, None] / W[None, :] + t_lat
        cutb[1:] = tables.g[1:, None] / W[None, :] + t_lat
    if j_only is not None:
        mask = np.zeros(J, dtype=bool)
        mask[j_only] = True
        feas = feas & mask[None, None, :]
        jcols = [j_only]
    else:
        jcols = list(range(J))
    # ---- admissible completion bounds for layers [0, p): per-layer best-case
    # compute, the cheapest memory cover (a tiny DP over segment floors), and
    # the cheapest possible boundary terms of the one cut that is certain
    f_min = tables.Tf_beta[:, jcols].min(axis=1)
    b_min = tables.Tb_beta[:, jcols].min(axis=1)
    fmin_pre = np.concatenate([[0.0], np.cumsum(f_min)])
    bmin_pre = np.concatenate([[0.0], np.cumsum(b_min)])
    cutf_min = cutf[:, jcols].min(axis=1)
    cutb_min = cutb[:, jcols].min(axis=1)
    seg_mem = np.where(feas.any(-1),
                       tables.mem_opts[feas.argmax(-1)], np.inf)  # [L, L]
    minmem = np.full(L + 1, np.inf)
    minmem[0] = 0.0
    for q in range(1, L + 1):
        minmem[q] = np.min(minmem[:q] + seg_mem[:q, q - 1])
    return _DpTables(feas=feas, ts=ts, cutf=cutf, cutb=cutb,
                     fmin_pre=fmin_pre, bmin_pre=bmin_pre,
                     cutf_min=cutf_min, cutb_min=cutb_min, minmem=minmem)


def _nondominated(V: np.ndarray) -> np.ndarray:
    """Indices of the non-dominated rows of ``V`` (componentwise minimize),
    keeping one representative of every duplicate row.  Exactness of the DP
    only needs soundness here: a dropped row is always covered by a kept row
    that is <= it in every component (dominance is transitive, so comparing
    against *all* lexicographically earlier rows — kept or not — is enough).
    """
    n = len(V)
    if n <= 1:
        return np.arange(n)
    Vu, first = np.unique(V, axis=0, return_index=True)   # lex-sorted rows
    m = len(Vu)
    # a dominating row always sorts lexicographically earlier, so sweep in
    # lex order comparing each chunk only against the kept set so far (any
    # dominated-but-dropped earlier row has a kept dominator by transitivity)
    # plus its own chunk-internal predecessors — O(m * kept) instead of O(m^2)
    kept_idx = [0]
    P = Vu[0:1]
    step = 256
    for lo in range(1, m, step):
        hi = min(lo + step, m)
        C = Vu[lo:hi]
        dom = np.all(P[None, :, :] <= C[:, None, :], axis=-1).any(axis=1)
        intra = np.all(C[None, :, :] <= C[:, None, :], axis=-1)
        intra &= np.arange(lo, hi)[None, :] < np.arange(lo, hi)[:, None]
        dom |= intra.any(axis=1)
        new = np.nonzero(~dom)[0]
        if len(new):
            kept_idx.extend((lo + new).tolist())
            P = np.concatenate([P, C[new]])
    return np.sort(first[np.array(kept_idx)])


def _dp_candidates(tables: PerfTables, segs: SegmentTables, d: int, mu: int,
                   a1: float, a2: float, pipelined_sync: bool,
                   max_stages: Optional[int], j_only: Optional[int] = None,
                   incumbent: float = np.inf,
                   stats: Optional[PlannerStats] = None):
    """Exact DP over stage cut-points for one data-parallel degree.

    Suffix plans are built right to left.  A state is ``(p, j)`` — the suffix
    covers layers ``[p, L-1]`` and its leftmost stage runs at memory level
    ``j`` (the boundary state: the next cut's download/upload terms need it).
    A state's value is the Pareto set of 6-vectors

        (msum, fadd, fmax, bsum, bmax, worst)

    = (suffix stage-memory sum, additive forward time, forward per-round
    bottleneck delta_f candidates, additive backward suffix time, backward
    bottleneck candidates, max over suffix stages of eq (7)'s backward
    completion + sync).  The final objective and every transition are
    monotone nondecreasing in all six components, so componentwise dominance
    pruning is exact; an admissible completion bound additionally prunes
    against ``incumbent`` (any achievable objective, e.g. from the CD
    heuristic) without ever discarding a potential optimum.  Returns
    ``(finalists, best_dp_objective)`` where finalists are ``(x, z)`` tuples
    within ``_DP_FINALIST_RTOL`` of the DP optimum."""
    L, J = tables.L, tables.J
    mem = tables.mem_opts
    t = _dp_tables(tables, segs, d, mu, pipelined_sync, j_only)
    jcols = [j_only] if j_only is not None else list(range(J))
    b_cost = a1 * tables.price_per_gb_s * d / GB
    guard = incumbent * (1 + _DP_FINALIST_RTOL)
    use_count = max_stages is not None
    states = {}

    for p in range(L - 1, -1, -1):
        for j in jcols:
            blocks = []
            if t.feas[p, L - 1, j]:
                fc = segs.f[p, L - 1, j]
                bc = segs.b[p, L - 1, j]
                worst = bc + (mu - 1) * bc + t.ts[p, L - 1, j]
                blocks.append((
                    np.array([[mem[j], fc, fc, bc, bc, worst]]),
                    np.ones(1, dtype=np.int64),
                    np.array([[L, 0, _INIT_ROW]], dtype=np.int64)))
            for i in range(p + 1, L):
                if not t.feas[p, i - 1, j]:
                    continue
                fc = segs.f[p, i - 1, j]
                bc = segs.b[p, i - 1, j]
                cf_u = t.cutf[i, j]          # this stage uploads its output
                cb_d = t.cutb[i, j]          # ... and downloads the grad back
                tsn = t.ts[p, i - 1, j]
                for jl in jcols:
                    parent = states.get((i, jl))
                    if parent is None:
                        continue
                    Vp, cp, _ = parent
                    cf_d = t.cutf[i, jl]     # right stage downloads the fwd
                    cb_u = t.cutb[i, jl]     # ... and uploads the bwd grad
                    n = len(Vp)
                    V = np.empty((n, 6))
                    V[:, 0] = Vp[:, 0] + mem[j]
                    V[:, 1] = Vp[:, 1] + (fc + cf_u + cf_d)
                    V[:, 2] = np.maximum(Vp[:, 2], max(fc, cf_u, cf_d))
                    V[:, 3] = Vp[:, 3] + (bc + cb_u + cb_d)
                    V[:, 4] = np.maximum(Vp[:, 4], max(bc, cb_u, cb_d))
                    V[:, 5] = np.maximum(
                        Vp[:, 5], V[:, 3] + (mu - 1) * V[:, 4] + tsn)
                    cnt = cp + 1
                    bp = np.column_stack([
                        np.full(n, i, dtype=np.int64),
                        np.full(n, jl, dtype=np.int64),
                        np.arange(n, dtype=np.int64)])
                    if use_count:
                        ok = cnt <= max_stages - (1 if p > 0 else 0)
                        if not ok.all():
                            V, cnt, bp = V[ok], cnt[ok], bp[ok]
                        if len(V) == 0:
                            continue
                    blocks.append((V, cnt, bp))
            if not blocks:
                continue
            if p > 0 and not np.isfinite(t.minmem[p]):
                continue            # layers [0, p) cannot be covered at all
            V = np.vstack([b[0] for b in blocks])
            cnt = np.concatenate([b[1] for b in blocks])
            bp = np.vstack([b[2] for b in blocks])
            if p > 0:
                # admissible completion bound: remaining layers at best-case
                # compute/memory plus the guaranteed cut at p (its j-side
                # terms are exact — j is this state's boundary level)
                f_pre = t.fmin_pre[p] + t.cutf[p, j] + t.cutf_min[p]
                b_pre = t.bmin_pre[p] + t.cutb[p, j] + t.cutb_min[p]
                t_lb = (V[:, 1] + f_pre + (mu - 1) * V[:, 2]
                        + np.maximum(V[:, 5],
                                     V[:, 3] + b_pre + (mu - 1) * V[:, 4]))
                obj_lb = (a2 + b_cost * (V[:, 0] + t.minmem[p])) * t_lb
                ok = obj_lb <= guard
                if not ok.all():
                    if stats is not None:
                        stats.dp_rows_bounded += int(len(ok) - ok.sum())
                    V, cnt, bp = V[ok], cnt[ok], bp[ok]
                if len(V) == 0:
                    continue
            key = np.column_stack([V, cnt]) if use_count else V
            idx = _nondominated(key)
            if stats is not None:
                stats.dp_states += 1
                stats.dp_rows_dominated += len(key) - len(idx)
                stats.dp_rows_kept += len(idx)
            V, cnt, bp = V[idx], cnt[idx], bp[idx]
            states[(p, j)] = (V, cnt, bp)
            if p > 0:
                # single-stage completions are real plans: refresh the
                # incumbent so later (deeper-prefix) states prune harder
                for jc in jcols:
                    if not t.feas[0, p - 1, jc]:
                        continue
                    if use_count and not (cnt + 1 <= max_stages).any():
                        continue
                    rows = (slice(None) if not use_count
                            else cnt + 1 <= max_stages)
                    Vr = V[rows]
                    bsum_c = Vr[:, 3] + (segs.b[0, p - 1, jc]
                                         + t.cutb[p, j] + t.cutb[p, jc])
                    bmax_c = np.maximum(Vr[:, 4], max(
                        segs.b[0, p - 1, jc], t.cutb[p, j], t.cutb[p, jc]))
                    worst_c = np.maximum(
                        Vr[:, 5],
                        bsum_c + (mu - 1) * bmax_c + t.ts[0, p - 1, jc])
                    fadd_c = Vr[:, 1] + (segs.f[0, p - 1, jc]
                                         + t.cutf[p, jc] + t.cutf[p, j])
                    fmax_c = np.maximum(Vr[:, 2], max(
                        segs.f[0, p - 1, jc], t.cutf[p, jc], t.cutf[p, j]))
                    t_c = fadd_c + (mu - 1) * fmax_c + worst_c
                    obj_c = (a2 + b_cost * (Vr[:, 0] + mem[jc])) * t_c
                    low = float(obj_c.min())
                    if low < incumbent:
                        incumbent = low
                        guard = incumbent * (1 + _DP_FINALIST_RTOL)

    # ---- collect full plans, keep the near-tie band, walk back-pointers
    done = []
    for j in jcols:
        st = states.get((0, j))
        if st is None:
            continue
        V = st[0]
        obj = ((a2 + b_cost * V[:, 0])
               * (V[:, 1] + (mu - 1) * V[:, 2] + V[:, 5]))
        for r in np.argsort(obj, kind="stable"):
            done.append((float(obj[r]), j, int(r)))
    if not done:
        return [], np.inf
    done.sort()
    best = done[0][0]
    finalists = []
    for obj, j, r in done[:_DP_FINALIST_CAP]:
        if obj > best * (1 + _DP_FINALIST_RTOL):
            break
        finalists.append(_dp_walk(states, L, j, r))
    return finalists, best


def _dp_walk(states, L: int, j: int, row: int) -> Tuple[tuple, tuple]:
    """Reconstruct (x, z) from the back-pointer chain of one final row."""
    x = [0] * (L - 1)
    z = [0] * L
    p = 0
    while True:
        _, _, bp = states[(p, j)]
        pi, pj, pr = (int(v) for v in bp[row])
        hi = L - 1 if pr == _INIT_ROW else pi - 1
        for k in range(p, hi + 1):
            z[k] = j
        if pr == _INIT_ROW:
            break
        x[pi - 1] = 1
        p, j, row = pi, pj, pr
    return tuple(x), tuple(z)


def _dp_seed_incumbent(prof, platform, tables, d, mu, M, a1, a2,
                       pipelined_sync):
    """A cheap achievable objective to prime the DP's completion-bound
    pruning: balanced compute splits at every stage count (the hierarchical
    merge boundaries restricted to full depth), floor/max memory per split,
    then the multi-start CD polish on the best split.  Purely an upper bound
    — the DP stays exact regardless of its quality."""
    L = prof.L
    w = tables.Tf_beta.mean(axis=1) + tables.Tb_beta.mean(axis=1)
    csum = np.cumsum(w)
    total = csum[-1]
    best_obj, best_x = np.inf, None
    for S in range(1, L + 1):
        cuts = sorted({int(np.searchsorted(csum, total * k / S))
                       for k in range(1, S)} - {L - 1})
        x = tuple(1 if i in cuts else 0 for i in range(L - 1))
        init = _min_feasible_stage_mem(prof, platform, x, d, mu)
        if init is None:
            continue
        J = tables.J
        for sm in (init, [J - 1] * len(init)):
            cfg = Config(x=x, d=d, z=_expand_z(sm, x, L))
            ev = evaluate(prof, platform, cfg, M, pipelined_sync=pipelined_sync)
            if ev.mem_ok and ev.objective(a1, a2) < best_obj:
                best_obj, best_x = ev.objective(a1, a2), x
    if best_x is None:
        return np.inf
    init = _min_feasible_stage_mem(prof, platform, best_x, d, mu)
    cfg, ev = _coordinate_descent(prof, platform, best_x, d, mu, a1, a2,
                                  pipelined_sync, init)
    if cfg is not None:
        best_obj = min(best_obj, ev.objective(a1, a2))
    return best_obj


def dp_solve(
    profile: ModelProfile,
    platform: Platform,
    *,
    alpha: Tuple[float, float],
    total_micro_batches: int,
    d_options: Sequence[int] = DEFAULT_D_OPTIONS,
    merge_to: Optional[int] = None,
    max_stages: Optional[int] = None,
    pipelined_sync: bool = True,
) -> Optional[PlanResult]:
    """Exact cut-point planner (``engine='dp'``): provably optimal (x, z) per
    (d, M) in polynomial table work — ``merge_to=None`` (the default) plans
    at full layer depth, the regime the enumeration engines cannot reach.
    Every returned plan is re-scored through the scalar ``evaluate`` oracle,
    so the reported objective is directly comparable across engines."""
    t0 = time.time()
    a1, a2 = alpha
    prof = _merged(profile, merge_to)
    M = total_micro_batches
    tables = perf_tables(prof, platform)
    segs = segment_tables(prof, platform)
    best, best_key = None, None
    stats = PlannerStats(engine="dp")
    for d_rank, d in enumerate(d_options):
        if M % d or M < d:
            continue
        mu = max(1, M // d)
        seed = _dp_seed_incumbent(prof, platform, tables, d, mu, M, a1, a2,
                                  pipelined_sync)
        finalists, _ = _dp_candidates(tables, segs, d, mu, a1, a2,
                                      pipelined_sync, max_stages,
                                      incumbent=seed, stats=stats)
        for x, z in finalists:
            cfg = Config(x=x, d=d, z=z)
            ev = evaluate(prof, platform, cfg, M, pipelined_sync=pipelined_sync)
            if not ev.mem_ok:
                continue
            key = (ev.objective(a1, a2), d_rank)
            if best_key is None or key < best_key:
                best_key = key
                best = PlanResult(cfg, ev, key[0], 0.0, prof)
    if best is not None:
        best = dataclasses.replace(best, solve_seconds=time.time() - t0,
                                   stats=stats)
    return best


def solve(
    profile: ModelProfile,
    platform: Platform,
    *,
    alpha: Tuple[float, float],
    total_micro_batches: int,
    d_options: Sequence[int] = DEFAULT_D_OPTIONS,
    merge_to: Optional[int] = DEFAULT_MERGE_TO,
    max_stages: Optional[int] = None,
    method: str = "cd",
    pipelined_sync: bool = True,
    engine: str = "batch",
) -> Optional[PlanResult]:
    """FuncPipe's co-optimizer.  Returns the best feasible plan or None.

    ``method`` selects the per-partition memory search: ``'cd'``
    (first-improvement coordinate descent, the reference rule),
    ``'cd-steepest'`` (steepest descent over all (stage, level) neighbors —
    same multi-start set and move budget, typically fewer moves to
    converge) or ``'exhaustive'`` (enumerate memory combos, small J^S only).

    ``engine='batch'`` (default) and ``engine='scalar'`` return identical
    plans; the batch engine evaluates candidate sets through
    ``perfmodel.evaluate_batch`` and is the one fast enough for
    ``merge_to`` >= 14.  ``engine='dp'`` runs the exact cut-point DP
    (:func:`dp_solve`): provably optimal per (d, M), polynomial instead of
    2^(L-1), and the only engine that reaches ``merge_to=None`` (full layer
    depth); ``method`` is ignored there — the DP is already exact.
    ``merge_to=None`` disables layer merging for any engine (the enumeration
    engines then pay the full 2^(L-1) space — only sensible for tiny L)."""
    if method not in ("cd", "cd-steepest", "exhaustive"):
        raise ValueError(f"unknown method {method!r}")
    if engine == "dp":
        return dp_solve(profile, platform, alpha=alpha,
                        total_micro_batches=total_micro_batches,
                        d_options=d_options, merge_to=merge_to,
                        max_stages=max_stages, pipelined_sync=pipelined_sync)
    kw = dict(alpha=alpha, total_micro_batches=total_micro_batches,
              d_options=d_options, merge_to=merge_to, max_stages=max_stages,
              method=method, pipelined_sync=pipelined_sync)
    if engine == "batch":
        return _solve_batch(profile, platform, **kw)
    if engine == "scalar":
        return _solve_scalar(profile, platform, **kw)
    raise ValueError(f"unknown engine {engine!r}")


# ------------------------------------------------------------------ baselines
def tpdmp_solve(
    profile: ModelProfile,
    platform: Platform,
    *,
    alpha: Tuple[float, float],
    total_micro_batches: int,
    d_options: Sequence[int] = DEFAULT_D_OPTIONS,
    merge_to: Optional[int] = DEFAULT_MERGE_TO,
    pipelined_sync: bool = True,
    engine: str = "batch",
) -> Optional[PlanResult]:
    """Throughput-only partitioning (TPDMP-style) under a grid of fixed
    resource allocations; the objective selects among grid points (§5.1).

    ``engine='dp'`` swaps the per-(d, memory-level) partition enumeration for
    the exact cut-point DP restricted to that uniform level and a pure
    time objective — the same fixed-resource optimum, reachable at full
    layer depth."""
    t0 = time.time()
    a1, a2 = alpha
    prof = _merged(profile, merge_to)
    L = prof.L
    J = len(platform.memory_options)
    best: Optional[PlanResult] = None
    if engine == "dp":
        M = total_micro_batches
        tables = perf_tables(prof, platform)
        segs = segment_tables(prof, platform)
        for d in d_options:
            if M % d or M < d:
                continue
            mu = max(1, M // d)
            for j in range(J):
                finalists, _ = _dp_candidates(
                    tables, segs, d, mu, 0.0, 1.0, pipelined_sync,
                    None, j_only=j)
                grid_t, grid_cfg, grid_ev = np.inf, None, None
                for x, z in finalists:
                    cfg = Config(x=x, d=d, z=z)
                    ev = evaluate(prof, platform, cfg, M,
                                  pipelined_sync=pipelined_sync)
                    if ev.mem_ok and ev.t_iter < grid_t:   # throughput only
                        grid_t, grid_cfg, grid_ev = ev.t_iter, cfg, ev
                if grid_cfg is None:
                    continue
                obj = grid_ev.objective(a1, a2)
                if best is None or obj < best.objective:
                    best = PlanResult(grid_cfg, grid_ev, obj, 0.0, prof)
        if best is not None:
            best = dataclasses.replace(best, solve_seconds=time.time() - t0)
        return best
    if engine == "batch":
        M = total_micro_batches
        tables = perf_tables(prof, platform)
        X_all = _partition_matrix(L)
        for d in d_options:
            if M % d or M < d:
                continue
            for j in range(J):
                Z = np.full((len(X_all), L), j, dtype=np.int64)
                be = _eval_chunked(prof, platform, tables, X_all, Z, d, M,
                                   pipelined_sync)
                t = np.where(be.mem_ok, be.t_iter, np.inf)
                k = int(np.argmin(t))                # first fastest partition
                if not np.isfinite(t[k]):
                    continue
                ev = be.pick(k)
                obj = ev.objective(a1, a2)
                if best is None or obj < best.objective:
                    cfg = Config(x=tuple(int(v) for v in X_all[k]), d=d,
                                 z=tuple([j] * L))
                    best = PlanResult(cfg, ev, obj, 0.0, prof)
        if best is not None:
            best = dataclasses.replace(best, solve_seconds=time.time() - t0)
        return best
    if engine != "scalar":
        raise ValueError(f"unknown engine {engine!r}")
    for d in d_options:
        if total_micro_batches % d or total_micro_batches < d:
            continue
        for j in range(J):  # uniform memory grid
            best_t, best_cfg, best_ev = np.inf, None, None
            for x in _partitions(L):
                cfg = Config(x=tuple(x), d=d, z=tuple([j] * L))
                ev = evaluate(prof, platform, cfg, total_micro_batches,
                              pipelined_sync=pipelined_sync)
                if ev.mem_ok and ev.t_iter < best_t:   # throughput only
                    best_t, best_cfg, best_ev = ev.t_iter, cfg, ev
            if best_cfg is None:
                continue
            obj = best_ev.objective(a1, a2)
            if best is None or obj < best.objective:
                best = PlanResult(best_cfg, best_ev, obj, 0.0, prof)
    if best is not None:
        best = dataclasses.replace(best, solve_seconds=time.time() - t0)
    return best


def bayes_solve(
    profile: ModelProfile,
    platform: Platform,
    *,
    alpha: Tuple[float, float],
    total_micro_batches: int,
    d_options: Sequence[int] = DEFAULT_D_OPTIONS,
    merge_to: Optional[int] = DEFAULT_MERGE_TO,
    rounds: int = 100,
    seed: int = 0,
    pipelined_sync: bool = True,
    batch_size: int = 16,
) -> Optional[PlanResult]:
    """Black-box joint search (paper's Bayes baseline): seeded random
    proposals + local mutation of the incumbent, evaluated on the performance
    model (the paper does the same to avoid measurement cost, App. E).

    Proposals are drawn in chunks of ``batch_size`` (mutations within a
    chunk share the incumbent at chunk start) and each chunk is evaluated
    through the batched kernel; ``batch_size=1`` recovers the fully
    sequential seed behavior."""
    t0 = time.time()
    a1, a2 = alpha
    prof = _merged(profile, merge_to)
    L = prof.L
    J = len(platform.memory_options)
    tables = perf_tables(prof, platform)
    rng = np.random.default_rng(seed)
    ds = [d for d in d_options if total_micro_batches % d == 0 and total_micro_batches >= d]
    best: Optional[PlanResult] = None

    def propose():
        if best is not None and rng.random() < 0.5:  # local mutation
            cfg = best.config
            x = list(cfg.x)
            if L > 1 and rng.random() < 0.5:
                i = rng.integers(0, L - 1)
                x[i] = 1 - x[i]
            stage_mem = [cfg.z[lo] for lo, _ in stages_of(x)]
            s = rng.integers(0, len(stage_mem))
            stage_mem[s] = int(np.clip(stage_mem[s] + rng.integers(-1, 2), 0, J - 1))
            return tuple(x), int(cfg.d), stage_mem
        x = tuple(rng.integers(0, 2, size=L - 1))
        d = int(rng.choice(ds))
        stage_mem = list(rng.integers(0, J, size=sum(x) + 1))
        return x, d, stage_mem

    done = 0
    while done < rounds:
        n = min(batch_size, rounds - done)
        done += n
        props = [propose() for _ in range(n)]
        cfgs = [Config(x=tuple(x), d=d, z=_expand_z(sm, x, L))
                for x, d, sm in props]
        evs: List[Optional[Evaluation]] = [None] * n
        by_d = {}
        for i, cfg in enumerate(cfgs):
            by_d.setdefault(cfg.d, []).append(i)
        for d, ids in by_d.items():
            X = np.array([cfgs[i].x for i in ids], dtype=np.int64).reshape(len(ids), L - 1)
            Z = np.array([cfgs[i].z for i in ids], dtype=np.int64)
            be = evaluate_batch(prof, platform, X, Z, d, total_micro_batches,
                                pipelined_sync=pipelined_sync, tables=tables)
            for row, i in enumerate(ids):
                evs[i] = be.pick(row)
        for cfg, ev in zip(cfgs, evs):
            if not ev.mem_ok:
                continue
            obj = ev.objective(a1, a2)
            if best is None or obj < best.objective:
                best = PlanResult(cfg, ev, obj, 0.0, prof)
    if best is not None:
        best = dataclasses.replace(best, solve_seconds=time.time() - t0)
    return best


# -------------------------------------------------------------- recommendation
def recommend(results: Sequence[PlanResult], threshold: float = 0.8) -> PlanResult:
    """Paper §5.1: fastest config whose speedup/cost-increase ratio over the
    min-cost config satisfies delta >= threshold."""
    feas = [r for r in results if r is not None]
    assert feas
    mc = min(feas, key=lambda r: r.evaluation.c_iter)
    t_mc, c_mc = mc.evaluation.t_iter, mc.evaluation.c_iter
    cands = []
    for r in feas:
        t_p, c_p = r.evaluation.t_iter, r.evaluation.c_iter
        if c_p <= c_mc or t_p >= t_mc:
            delta = np.inf if (c_p <= c_mc and t_p <= t_mc) else 0.0
        else:
            delta = (t_mc / t_p - 1) / (c_p / c_mc - 1)
        if delta >= threshold:
            cands.append(r)
    if not cands:
        return mc
    return min(cands, key=lambda r: r.evaluation.t_iter)
