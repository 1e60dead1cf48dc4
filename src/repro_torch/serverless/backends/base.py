"""The execution-backend contract (``repro.serverless.backends.base`` for the
port): an object store plus a worker-invocation surface.

The engines drive each stage worker as a generator program over its
:class:`WorkerContext` (download, compute, upload and, training, a phase
fence and a ``("sync", grad_vector)`` yield answered with the reduced
gradient by :meth:`ExecutionBackend.run_step`).  A backend whose workers
live in other processes runs those programs itself (``hosts_programs``).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Generator, Optional, Tuple

from repro_torch.serverless.runtime.store import StoreStats, assert_store_drained

# a worker's per-step training program: yields None after each fwd/bwd
# micro-batch op group, then ("sync", grad_vector_or_None), and receives the
# reduced vector via .send(); see runtime.engine._worker_step_program
WorkerProgram = Generator[Optional[Tuple[str, Any]], Any, None]


@dataclass(frozen=True)
class StepTiming:
    """What one training step cost on the backend's clock: ``end`` is its
    completion time from the start of the run (monotone across steps),
    ``sync`` the slowest stage's scatter-reduce duration within it.  A
    traced ``local`` step also gives each (stage, replica) worker thread's
    CPU seconds (``time.thread_time``) in ``worker_cpu_s``; empty elsewhere."""

    end: float
    sync: float
    worker_cpu_s: Dict[Tuple[int, int], float] = field(default_factory=dict)


class WorkerContext(ABC):
    """One stage worker's handle onto the backend: its serial resources and
    its view of the shared object store.  ``download``/``compute`` return
    tokens that express data dependencies to virtual-clock backends."""

    @abstractmethod
    def download(self, key: str) -> Tuple[Any, Any]:
        """Fetch-and-consume ``key``: waits for visibility, charges the
        downlink, frees the object.  Returns ``(value, token)``."""

    @abstractmethod
    def compute(self, cost_s: float, fn: Optional[Callable[[], Any]] = None,
                after: Any = None) -> Any:
        """Charge ``cost_s`` of serial CPU (no earlier than ``after``) and
        run the real math ``fn``.  Returns ``fn()``'s result (or None)."""

    @abstractmethod
    def upload(self, key: str, nbytes: float, value: Any = None) -> Any:
        """Publish ``value`` under ``key``, charging ``nbytes`` on the
        uplink.  Returns a token."""

    @abstractmethod
    def phase_barrier(self) -> None:
        """Program-order fence between the forward and backward phases: the
        worker issues no backward download before its forward uploads are
        done."""

    def wait(self, seconds: float, op: str = "retry") -> None:
        """Charge ``seconds`` of idle occupancy on this worker (retry
        backoff): virtual clocks stall its resources, wall-clock backends
        sleep.  A no-op by default."""

    def fetch(self, key: str, op: str = "download") -> Tuple[Any, Any]:
        """Non-consuming ``download``: waits for visibility, charges the
        downlink and leaves the object in the store (a checkpoint restore
        reads one object once per stage worker).  Returns ``(value,
        token)``; backends that restore from store checkpoints implement
        it."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement fetch(); this "
            "backend cannot restore from store-backed checkpoints")


class ExecutionBackend(ABC):
    """One storage+invocation substrate a DeploymentPlan can execute on.
    ``open(agg)`` provisions the store and worker slots; ``context(s, r)``
    hands out worker handles; ``verify_drained()`` asserts byte
    conservation after the run; ``close()`` tears down.

    Backends differ in their clock (``wall_clock``), never in numerics: a
    plan replayed on any backend trains to bit-identical params."""

    #: registry name (``repro_torch.serverless.backends.get_backend``)
    name: str = "?"
    #: True when timings are host wall-clock, False on a modeled clock
    wall_clock: bool = False
    #: True when the backend runs the worker programs itself, each in its
    #: own OS process: generators cannot cross a process boundary, so the
    #: engine calls ``bind_run``/``stage_step``/``worker_handles`` instead
    #: of building workers and handing out generators
    hosts_programs: bool = False
    #: optional ``repro_torch.obs.SpanRecorder`` installed before ``open()``;
    #: the backends emit one span per resource task into it
    recorder = None

    def bind_run(self, **kw) -> None:
        """Program-hosting hook: receive the run's execution spec
        (``execution=``, ``config=``) before ``open()``."""

    def stage_step(self, k: int, *, batch=None, losses=None) -> None:
        """Program-hosting hook, called right before ``run_step(k, ...)``
        with the step's evaluated batch (``Execution.batch_fn`` closures do
        not pickle) and the ``losses`` dict the hosted programs fill."""

    def worker_handles(self):
        """Program-hosting hook: the ``S x d`` grid of stage-worker proxies
        (``.params``/``.span`` like ``runtime.worker.StageWorker``) in place
        of the engine's own workers."""
        raise NotImplementedError(
            f"{type(self).__name__} does not host worker programs")

    def attach_recorder(self, recorder) -> None:
        """Install a span recorder (``repro_torch.obs.SpanRecorder``) for the
        next ``open()``/run: the emulated backend emits virtual-clock spans,
        ``local`` and ``process`` wall-clock spans."""
        self.recorder = recorder

    @abstractmethod
    def open(self, agg) -> None:
        """Provision the store + worker slots for one run of the plan whose
        per-stage cost terms are ``agg`` (``simulator.StageAggregates``)."""

    @abstractmethod
    def context(self, s: int, r: int) -> WorkerContext:
        """The handle for stage ``s``, replica ``r`` (valid after open)."""

    @abstractmethod
    def run_step(self, k: int, programs: Dict[Tuple[int, int], WorkerProgram],
                 *, pipelined_sync: bool = True) -> StepTiming:
        """Drive every worker's step-``k`` training program to completion,
        including the scatter-reduce each requests, and return the timing."""

    @property
    @abstractmethod
    def store_stats(self) -> StoreStats:
        """Byte-accounting counters of the run's object store."""

    @abstractmethod
    def _store_for_verification(self):
        """The underlying store object (must expose keys/live_bytes/stats)."""

    def delete(self, key: str) -> None:
        """Remove ``key`` from the run's store with counted accounting."""
        self._store_for_verification().delete(key)

    def recover(self) -> int:
        """Reset the substrate after a failed step so a replay can start:
        purge every residual non-checkpoint object (counted deletes, so bytes
        stay conserved).  Returns the number of purged objects."""
        store = self._store_for_verification()
        purged = 0
        for key in list(store.keys()):
            if not key.startswith("ckpt/"):
                store.delete(key)
                purged += 1
        return purged

    def verify_drained(self) -> None:
        """Raise if the store holds residual objects or the put/delete byte
        accounting does not conserve."""
        assert_store_drained(self._store_for_verification())

    def close(self) -> None:
        """Release resources.  Idempotent."""
