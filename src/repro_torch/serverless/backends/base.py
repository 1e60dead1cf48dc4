"""The execution-backend contract (``repro.serverless.backends.base`` for the
port): an object store plus a worker-invocation surface.

The serving engine drives each stage as a generator program over its
:class:`WorkerContext` (download, compute, upload).  Training's ``run_step``
and the scatter-reduce come with the training slice (ROADMAP port queue
item 1).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Optional, Tuple

from repro_torch.serverless.runtime.store import StoreStats, assert_store_drained


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


class ExecutionBackend(ABC):
    """One storage+invocation substrate a DeploymentPlan can execute on.
    ``open(agg)`` provisions the store and worker slots; ``context(s, r)``
    hands out worker handles; ``verify_drained()`` asserts byte
    conservation after the run; ``close()`` tears down."""

    name: str = "?"

    @abstractmethod
    def open(self, agg) -> None:
        """Provision the store + worker slots for one run of the plan whose
        per-stage cost terms are ``agg`` (``simulator.StageAggregates``)."""

    @abstractmethod
    def context(self, s: int, r: int) -> WorkerContext:
        """The handle for stage ``s``, replica ``r`` (valid after open)."""

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

    def verify_drained(self) -> None:
        """Raise if the store holds residual objects or the put/delete byte
        accounting does not conserve."""
        assert_store_drained(self._store_for_verification())

    def close(self) -> None:
        """Release resources.  Idempotent."""
