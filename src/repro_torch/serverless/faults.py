"""Deterministic fault injection and the recovery policy objects that
defeat it (``repro.serverless.faults`` for the port).

The paper's Function Manager (§3.1 ⑧) exists because serverless failure is
the contract: Lambda kills functions at 15 minutes, invocations fail
transiently, stragglers are routine.  This module is the chaos side of that
story and the policies the engine survives it with:

* :class:`FaultPlan`: a seeded, serializable schedule of fault events
  (transient store put/get errors, worker crashes at (stage, replica, step,
  phase), stragglers, a function-lifetime cap).  The same seed draws the
  same ``random.Random`` stream as the JAX package, so the same plan and
  the same JSON.
* :class:`FaultInjector`: wraps any ``ExecutionBackend`` and decorates the
  worker contexts it hands out, firing the plan's events at deterministic
  per-worker op counts.
* :class:`RetryPolicy` / :class:`FaultTolerance`: backoff with
  deterministic jitter, checkpoint cadence, restart budget and the
  lifetime safety margin.
* :class:`ResilientContext`: the engine's retry wrapper (``op="retry"``
  spans), raising :class:`FaultToleranceExceeded` when the budget is spent.

The acceptance bar is numeric: a plan trained through a FaultPlan lands on
params bit-identical to the fault-free run's.
"""
from __future__ import annotations

import json
import random
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.serverless.backends.base import (
    ExecutionBackend,
    StepTiming,
    WorkerContext,
    WorkerProgram,
)
from repro_torch.serverless.retry import RetryPolicy
from repro_torch.serverless.runtime.store import ProducerDeadError, StoreAbortedError

PHASES = ("fwd", "bwd")


# --------------------------------------------------------------------- errors
class TransientStoreError(RuntimeError):
    """An injected transient store failure (the 5xx/throttle class of S3/OSS
    errors): the request never happened, retrying is safe and expected."""


class WorkerCrashed(RuntimeError):
    """A worker function died mid-step (injected crash or lifetime-cap kill).
    Recoverable: the engine relaunches from the last store checkpoint."""

    def __init__(self, msg: str, *, stage: int = -1, replica: int = -1,
                 step: int = -1, kind: str = "crash"):
        super().__init__(msg)
        self.stage = stage
        self.replica = replica
        self.step = step
        self.kind = kind


class FaultToleranceExceeded(RuntimeError):
    """The configured recovery budget ran out (retries exhausted on one op,
    or more restarts than ``FaultTolerance.max_restarts``)."""


#: what the engine may catch and recover from (via checkpoint/restart) when
#: fault tolerance is enabled; FaultToleranceExceeded is deliberately NOT
#: recoverable — it is the typed "give up" signal
RECOVERABLE_ERRORS: Tuple[type, ...] = (
    WorkerCrashed, TimeoutError, StoreAbortedError, ProducerDeadError,
)


def is_recoverable(exc: BaseException) -> bool:
    import threading

    if isinstance(exc, FaultToleranceExceeded):
        return False
    return isinstance(exc, RECOVERABLE_ERRORS + (threading.BrokenBarrierError,))


# --------------------------------------------------------------------- events
@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``kind``:

    * ``"transient"`` — the ``index``-th store op of kind ``op`` (``put`` |
      ``get``) issued by worker (stage, replica) during ``step`` fails with
      :class:`TransientStoreError` for ``times`` consecutive attempts.
    * ``"crash"`` — the worker raises :class:`WorkerCrashed` at its next op
      once it is in ``phase`` of ``step``.
    * ``"straggle"`` — the worker's first compute of ``step`` is slowed by
      ``slow_s`` seconds (virtual charge on modeled clocks, a real sleep on
      wall clocks).

    Events are *consumed* when they fire: a step replayed after recovery
    does not re-trigger the fault that killed it (the schedule is a list of
    events, not a rule), which is what makes chaos runs terminate.
    """

    kind: str                   # transient | crash | straggle
    stage: int
    replica: int
    step: int
    op: str = "get"             # transient: put | get
    index: int = 0              # transient: nth op of that kind in the step
    times: int = 1              # transient: consecutive failing attempts
    phase: str = "fwd"          # crash: fwd | bwd
    slow_s: float = 0.0         # straggle: extra seconds

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "stage": self.stage, "replica": self.replica,
             "step": self.step}
        if self.kind == "transient":
            d.update(op=self.op, index=self.index, times=self.times)
        elif self.kind == "crash":
            d["phase"] = self.phase
        elif self.kind == "straggle":
            d["slow_s"] = self.slow_s
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        known = {"kind", "stage", "replica", "step", "op", "index", "times",
                 "phase", "slow_s"}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown FaultEvent fields {sorted(extra)}")
        return cls(**{k: d[k] for k in d})


@dataclass(frozen=True)
class FaultPlan:
    """A serializable schedule of fault events plus the platform's lifetime
    cap.  ``lifetime_steps`` models the Lambda 15-minute limit in engine
    steps: any worker older than that many steps since its (re)launch is
    killed at its next op — the engine's Function Manager must checkpoint
    and relaunch under the cap to make progress."""

    events: Tuple[FaultEvent, ...] = ()
    lifetime_steps: Optional[int] = None
    seed: Optional[int] = None          # provenance only

    # ------------------------------------------------------------ generation
    @classmethod
    def generate(cls, seed: int, *, steps: int, S: int, d: int,
                 n_transient: int = 2, n_crashes: int = 1,
                 n_stragglers: int = 0, transient_times: int = 1,
                 straggle_s: float = 0.05,
                 lifetime_steps: Optional[int] = None) -> "FaultPlan":
        """Seeded random schedule over a ``steps`` x ``S`` x ``d`` run.  Same
        arguments -> identical plan (``random.Random(seed)``, no global
        state).  Crashes are only scheduled from step 1 on when possible so
        a checkpoint exists to recover from (step-0 crashes are legal — the
        engine rebuilds from initial state — just slower)."""
        rng = random.Random(seed)
        events: List[FaultEvent] = []
        for _ in range(n_transient):
            events.append(FaultEvent(
                kind="transient", stage=rng.randrange(S),
                replica=rng.randrange(d), step=rng.randrange(steps),
                op=rng.choice(("put", "get")), index=rng.randrange(2),
                times=transient_times))
        for _ in range(n_crashes):
            events.append(FaultEvent(
                kind="crash", stage=rng.randrange(S),
                replica=rng.randrange(d),
                step=rng.randrange(min(1, steps - 1), steps),
                phase=rng.choice(PHASES)))
        for _ in range(n_stragglers):
            events.append(FaultEvent(
                kind="straggle", stage=rng.randrange(S),
                replica=rng.randrange(d), step=rng.randrange(steps),
                slow_s=straggle_s * (1 + rng.random())))
        return cls(events=tuple(events), lifetime_steps=lifetime_steps,
                   seed=seed)

    # --------------------------------------------------------- serialization
    def to_json(self, *, indent: Optional[int] = 1) -> str:
        doc = {"version": 1, "seed": self.seed,
               "lifetime_steps": self.lifetime_steps,
               "events": [e.to_dict() for e in self.events]}
        return json.dumps(doc, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        doc = json.loads(text)
        if not isinstance(doc, dict) or doc.get("version") != 1:
            raise ValueError("not a FaultPlan JSON (expected version 1)")
        return cls(events=tuple(FaultEvent.from_dict(e)
                                for e in doc.get("events", [])),
                   lifetime_steps=doc.get("lifetime_steps"),
                   seed=doc.get("seed"))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read())

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        if self.lifetime_steps is not None:
            out["lifetime_steps"] = self.lifetime_steps
        return out


# --------------------------------------------------------------- retry policy
# RetryPolicy lives in serverless.retry (dependency-free) so the cloud backend
# config can carry it without importing this module; re-exported here.
@dataclass(frozen=True)
class FaultTolerance:
    """Engine-side recovery configuration (``run_plan(tolerance=...)``,
    ``Execution.tolerance``, ``python -m repro_torch emulate --retries/--checkpoint-every``).

    ``checkpoint_every=N`` uploads every stage's param/opt state into the
    object store after each N-th step (charged like any upload);
    ``None`` disables checkpointing — crashes then replay from step 0.
    ``lifetime_steps`` overrides the injected/platform function-lifetime cap
    the Function Manager restarts under (margin ``lifetime_safety``).
    """

    retry: RetryPolicy = RetryPolicy()
    checkpoint_every: Optional[int] = 1
    max_restarts: int = 8
    lifetime_steps: Optional[int] = None
    lifetime_safety: float = 0.9


# --------------------------------------------------------------- fault report
@dataclass
class FaultReport:
    """What the run survived: faults injected (by kind), retries spent,
    restarts driven, checkpoints written, and the recovery overhead on the
    backend's clock (retry backoff + checkpoint-restore time; replayed step
    time shows up in ``t_iter`` itself)."""

    injected: Dict[str, int] = field(default_factory=dict)
    retries: int = 0
    restarts: int = 0
    planned_restarts: int = 0       # lifetime-cap restarts (Function Manager)
    checkpoints: int = 0
    recovery_s: float = 0.0
    resumed_steps: List[int] = field(default_factory=list)

    def count_injected(self, kind: str) -> None:
        self.injected[kind] = self.injected.get(kind, 0) + 1

    def as_dict(self) -> dict:
        return {"injected": dict(self.injected), "retries": self.retries,
                "restarts": self.restarts,
                "planned_restarts": self.planned_restarts,
                "checkpoints": self.checkpoints,
                "recovery_s": self.recovery_s,
                "resumed_steps": list(self.resumed_steps)}

    def describe(self) -> str:
        inj = " ".join(f"{k}={v}" for k, v in sorted(self.injected.items())) \
            or "none"
        return (f"faults injected: {inj}; retries={self.retries} "
                f"restarts={self.restarts} "
                f"(planned={self.planned_restarts}) "
                f"checkpoints={self.checkpoints} "
                f"recovery={self.recovery_s:.3f}s")


# ------------------------------------------------------------------ injection
class _PlanState:
    """Mutable once-only firing state shared by all contexts of one run."""

    def __init__(self, plan: FaultPlan, report: Optional[FaultReport]):
        self.plan = plan
        self.report = report
        # transient events keep a remaining-attempts countdown; others a flag
        self.remaining: Dict[int, int] = {
            i: e.times for i, e in enumerate(plan.events)
            if e.kind == "transient"}
        self.fired: set = set()

    def _note(self, kind: str) -> None:
        if self.report is not None:
            self.report.count_injected(kind)

    # ---- per-op checks (called by FaultyContext before delegating) --------
    def transient_for(self, stage: int, replica: int, step: int, op: str,
                      count: int) -> bool:
        for i, e in enumerate(self.plan.events):
            if (e.kind == "transient" and e.stage == stage
                    and e.replica == replica and e.step == step
                    and e.op == op and e.index == count
                    and self.remaining.get(i, 0) > 0):
                self.remaining[i] -= 1
                self._note("transient")
                return True
        return False

    def crash_for(self, stage: int, replica: int, step: int,
                  phase: str) -> bool:
        for i, e in enumerate(self.plan.events):
            if (e.kind == "crash" and i not in self.fired
                    and e.stage == stage and e.replica == replica
                    and e.step == step and e.phase == phase):
                self.fired.add(i)
                self._note("crash")
                return True
        return False

    def straggle_for(self, stage: int, replica: int, step: int) -> float:
        for i, e in enumerate(self.plan.events):
            if (e.kind == "straggle" and i not in self.fired
                    and e.stage == stage and e.replica == replica
                    and e.step == step):
                self.fired.add(i)
                self._note("straggle")
                return e.slow_s
        return 0.0


class FaultyWorkerContext(WorkerContext):
    """Decorates a backend's worker context with the plan's fault events.

    Op counting is *per worker per step* and counts only ops that proceed
    (failed attempts re-match until the event's ``times`` are spent), so
    injection points are deterministic on single-threaded virtual clocks and
    on real concurrent threads alike — each worker's program is serial.
    """

    def __init__(self, inner: WorkerContext, state: _PlanState, stage: int,
                 replica: int, injector: "FaultInjector"):
        self.inner = inner
        self.state = state
        self.stage = stage
        self.replica = replica
        self.injector = injector
        self.phase = "fwd"
        self._n_put = 0
        self._n_get = 0

    # ------------------------------------------------------------- triggers
    def _step(self) -> int:
        return self.injector.current_step

    def _check_liveness(self) -> None:
        inj = self.injector
        cap = inj.plan.lifetime_steps
        if cap is not None and inj.age >= cap:
            if self.state.report is not None and not inj._lifetime_noted:
                inj._lifetime_noted = True
                self.state.report.count_injected("lifetime")
            raise WorkerCrashed(
                f"worker (stage {self.stage}, replica {self.replica}) "
                f"exceeded the function lifetime cap ({cap} steps since "
                "launch) — the platform killed it", stage=self.stage,
                replica=self.replica, step=self._step(), kind="lifetime")
        if self.state.crash_for(self.stage, self.replica, self._step(),
                                self.phase):
            raise WorkerCrashed(
                f"injected crash: worker (stage {self.stage}, replica "
                f"{self.replica}) died in {self.phase} of step "
                f"{self._step()}", stage=self.stage, replica=self.replica,
                step=self._step())

    def _check_transient(self, op: str, count: int, key: str) -> None:
        if self.state.transient_for(self.stage, self.replica, self._step(),
                                    op, count):
            raise TransientStoreError(
                f"injected transient store {op} error on {key!r} (worker "
                f"stage {self.stage}, replica {self.replica}, step "
                f"{self._step()})")

    # ------------------------------------------------------------- protocol
    def download(self, key: str):
        self._check_liveness()
        self._check_transient("get", self._n_get, key)
        out = self.inner.download(key)
        self._n_get += 1
        return out

    def compute(self, cost_s: float, fn: Optional[Callable[[], Any]] = None,
                after: Any = None) -> Any:
        self._check_liveness()
        extra = self.state.straggle_for(self.stage, self.replica,
                                        self._step())
        if extra > 0.0:
            self.inner.wait(extra, op="compute")
        return self.inner.compute(cost_s, fn, after=after)

    def upload(self, key: str, nbytes: float, value: Any = None) -> Any:
        self._check_liveness()
        self._check_transient("put", self._n_put, key)
        out = self.inner.upload(key, nbytes, value=value)
        self._n_put += 1
        return out

    def phase_barrier(self) -> None:
        self.inner.phase_barrier()
        self.phase = "bwd"
        self._check_liveness()          # bwd-phase crashes fire at the fence

    def wait(self, seconds: float, op: str = "retry") -> None:
        self.inner.wait(seconds, op=op)

    def fetch(self, key: str, op: str = "download"):
        self._check_liveness()
        self._check_transient("get", self._n_get, key)
        out = self.inner.fetch(key, op=op)
        self._n_get += 1
        return out


class FaultInjector(ExecutionBackend):
    """Chaos wrapper around any :class:`ExecutionBackend`: same registry
    contract, same store, same clocks — but worker contexts fire the
    :class:`FaultPlan`'s events.  ``name``/``wall_clock`` mirror the inner
    backend so results attribute to the substrate that actually ran."""

    def __init__(self, inner: ExecutionBackend, plan: FaultPlan,
                 report: Optional[FaultReport] = None):
        self.inner = inner
        self.plan = plan
        self.state = _PlanState(plan, report)
        self.name = inner.name
        self.wall_clock = inner.wall_clock
        self.current_step = 0
        self.age = 0                    # steps since last (re)launch
        self._lifetime_noted = False

    def set_report(self, report: FaultReport) -> None:
        self.state.report = report

    @property
    def lifetime_steps(self) -> Optional[int]:
        return self.plan.lifetime_steps

    # ------------------------------------------------------------ delegation
    @property
    def hosts_programs(self) -> bool:  # type: ignore[override]
        return bool(getattr(self.inner, "hosts_programs", False))

    def bind_run(self, **kw) -> None:
        """Program-hosting backends get the injector itself: they ship the
        plan's events to their worker processes and merge the consumed state
        back into ``self.state`` (the authoritative once-only schedule)."""
        self.inner.bind_run(**kw, injector=self)

    def stage_step(self, k: int, *, batch=None, losses=None) -> None:
        self.inner.stage_step(k, batch=batch, losses=losses)

    def worker_handles(self):
        return self.inner.worker_handles()

    def attach_recorder(self, recorder) -> None:
        self.inner.attach_recorder(recorder)

    def open(self, agg) -> None:
        self.inner.open(agg)
        self.current_step = 0
        self.age = 0

    def context(self, s: int, r: int) -> FaultyWorkerContext:
        return FaultyWorkerContext(self.inner.context(s, r), self.state,
                                   s, r, self)

    def run_step(self, k: int, programs: Dict[Tuple[int, int], WorkerProgram],
                 *, pipelined_sync: bool = True) -> StepTiming:
        self.current_step = k
        timing = self.inner.run_step(k, programs,
                                     pipelined_sync=pipelined_sync)
        self.age += 1
        return timing

    @property
    def store_stats(self):
        return self.inner.store_stats

    def _store_for_verification(self):
        return self.inner._store_for_verification()

    def delete(self, key: str) -> None:
        self.inner.delete(key)

    def recover(self) -> int:
        """A relaunch resets the function-lifetime age: the engine's restart
        provisioned fresh function instances."""
        self.age = 0
        return self.inner.recover()

    def verify_drained(self) -> None:
        self.inner.verify_drained()

    def close(self) -> None:
        self.inner.close()


class ResilientContext(WorkerContext):
    """The engine's retry wrapper: transient store errors back off and retry
    on the worker's own clock (``op="retry"`` spans — visible in ``python -m
    repro_torch inspect``), then surface as :class:`FaultToleranceExceeded` when
    ``RetryPolicy.max_attempts`` is spent.  Compute errors pass through —
    a crashed worker is the restart path's business, not the retry loop's."""

    def __init__(self, inner: WorkerContext, policy: RetryPolicy,
                 report: FaultReport):
        self.inner = inner
        self.policy = policy
        self.report = report

    def _retrying(self, op: Callable[[], Any], token: str) -> Any:
        attempt = 1
        while True:
            try:
                return op()
            except TransientStoreError as e:
                if attempt >= self.policy.max_attempts:
                    raise FaultToleranceExceeded(
                        f"store op on {token!r} still failing after "
                        f"{attempt} attempts: {e}") from e
                delay = self.policy.delay(attempt, token)
                self.report.retries += 1
                self.report.recovery_s += delay
                self.inner.wait(delay, op="retry")
                attempt += 1

    def download(self, key: str):
        return self._retrying(lambda: self.inner.download(key), key)

    def compute(self, cost_s: float, fn: Optional[Callable[[], Any]] = None,
                after: Any = None) -> Any:
        return self.inner.compute(cost_s, fn, after=after)

    def upload(self, key: str, nbytes: float, value: Any = None) -> Any:
        return self._retrying(
            lambda: self.inner.upload(key, nbytes, value=value), key)

    def phase_barrier(self) -> None:
        self.inner.phase_barrier()

    def wait(self, seconds: float, op: str = "retry") -> None:
        self.inner.wait(seconds, op=op)

    def fetch(self, key: str, op: str = "download"):
        return self._retrying(lambda: self.inner.fetch(key, op=op), key)


__all__ = [
    "FaultEvent", "FaultPlan", "FaultInjector", "FaultReport",
    "FaultTolerance", "FaultToleranceExceeded", "FaultyWorkerContext",
    "ResilientContext", "RetryPolicy", "TransientStoreError", "WorkerCrashed",
    "RECOVERABLE_ERRORS", "is_recoverable", "replace",
]
