"""Virtual-clock backend: the paper's cost model as the execution substrate
(``repro.serverless.backends.emulated`` for the port).  Numerics run as fast
as the device allows while each worker's virtual clock charges what
Lambda/FC + S3/OSS would have; time here is modeled, never measured."""
from __future__ import annotations

from typing import Any, Callable, List, Optional

from repro_torch.serverless.backends.base import ExecutionBackend, WorkerContext
from repro_torch.serverless.runtime.store import ObjectStore, StageChannel, StoreStats


class EmulatedWorkerContext(WorkerContext):
    """A stage worker bound to one virtual-clock :class:`StageChannel`."""

    def __init__(self, channel: StageChannel, store: ObjectStore):
        self.channel = channel
        self.store = store

    def download(self, key: str):
        value, end = self.channel.download(key)
        self.store.delete(key)            # single consumer: free on arrival
        return value, end

    def compute(self, cost_s: float, fn: Optional[Callable[[], Any]] = None,
                after: Any = None) -> Any:
        ready = self.channel.cpu_free if after is None else after
        self.channel.compute(cost_s, ready=ready)
        return fn() if fn is not None else None

    def upload(self, key: str, nbytes: float, value: Any = None) -> Any:
        return self.channel.upload(key, nbytes, ready=self.channel.cpu_free,
                                   value=value)


class EmulatedBackend(ExecutionBackend):
    """The emulated store + one virtual clock per worker."""

    name = "emulated"

    def __init__(self) -> None:
        self.store: Optional[ObjectStore] = None
        self.channels: List[List[StageChannel]] = []

    def open(self, agg) -> None:
        self.store = ObjectStore(latency=agg.t_lat)
        self.channels = [
            [StageChannel(self.store, agg.w[s], agg.t_lat, name=f"s{s}r{r}")
             for r in range(agg.d)]
            for s in range(agg.S)
        ]

    def context(self, s: int, r: int) -> EmulatedWorkerContext:
        return EmulatedWorkerContext(self.channels[s][r], self.store)

    @property
    def store_stats(self) -> StoreStats:
        return self.store.stats

    def _store_for_verification(self):
        return self.store
