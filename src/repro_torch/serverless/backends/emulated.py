"""Virtual-clock backend: the paper's cost model as the execution substrate
(``repro.serverless.backends.emulated`` for the port).  Numerics run as fast
as the device allows while each worker's virtual clock charges what
Lambda/FC + S3/OSS would have; time here is modeled, never measured."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.serverless.backends.base import (
    ExecutionBackend,
    StepTiming,
    WorkerContext,
    WorkerProgram,
)
from repro_torch.serverless.runtime.scatter_reduce import (
    pipelined_scatter_reduce,
    three_phase_scatter_reduce,
)
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

    def phase_barrier(self) -> None:
        self.channel.join_uplink_into_downlink()

    def wait(self, seconds: float, op: str = "retry") -> None:
        # retry backoff or an injected straggle: the worker is blocked, so
        # its three virtual resources stall (a deterministic charge: chaos
        # runs repeat in time as well as in value)
        self.channel.stall(seconds, op=op)

    def fetch(self, key: str, op: str = "download"):
        # non-consuming download (a checkpoint restore): every worker of the
        # stage reads the same checkpoint object once
        return self.channel.download(key, ready=self.channel.dn_free, op=op)


class EmulatedBackend(ExecutionBackend):
    """The emulated store + one virtual clock per worker."""

    name = "emulated"

    def __init__(self) -> None:
        self.agg = None
        self.store: Optional[ObjectStore] = None
        self.channels: List[List[StageChannel]] = []

    def open(self, agg) -> None:
        self.agg = agg
        self.store = ObjectStore(latency=agg.t_lat)
        self.channels = [
            [StageChannel(self.store, agg.w[s], agg.t_lat, name=f"s{s}r{r}")
             for r in range(agg.d)]
            for s in range(agg.S)
        ]
        if self.recorder is not None:
            # every charged channel task emits one virtual-clock span
            for s in range(agg.S):
                for r in range(agg.d):
                    self.channels[s][r].tracer = self.recorder.tracer(s, r)

    def context(self, s: int, r: int) -> EmulatedWorkerContext:
        return EmulatedWorkerContext(self.channels[s][r], self.store)

    @property
    def store_stats(self) -> StoreStats:
        return self.store.stats

    def _store_for_verification(self):
        return self.store

    def run_step(self, k: int, programs: Dict[Tuple[int, int], WorkerProgram],
                 *, pipelined_sync: bool = True) -> StepTiming:
        """Advance every program single-threaded in the JAX package's GPipe
        interleave (replica-major, micro-batch, stage), so virtual times,
        store traffic and ``StoreStats.peak_bytes`` equal its engine's."""
        agg = self.agg
        S, mu, d = agg.S, agg.mu, agg.d
        sync_fn = (pipelined_scatter_reduce if pipelined_sync
                   else three_phase_scatter_reduce)
        rec = self.recorder
        if rec is not None:
            rec.set_step(k)
            rec.set_phase("fwd")
        # forward: one (download, compute, upload) group per advance
        for r in range(d):
            for _ in range(mu):
                for s in range(S):
                    next(programs[(s, r)])
        # backward (the first advance also runs the worker's phase fence)
        if rec is not None:
            rec.set_phase("bwd")
        for r in range(d):
            for _ in range(mu):
                for s in range(S - 1, -1, -1):
                    next(programs[(s, r)])
        # every program now flattens its gradient and requests the sync
        if rec is not None:
            rec.set_phase("sync")
        values: Dict[Tuple[int, int], Any] = {}
        for s in range(S):
            for r in range(d):
                tag, vec = next(programs[(s, r)])
                if tag != "sync":
                    raise RuntimeError(f"worker (s={s}, r={r}) yielded {tag!r}, not 'sync'")
                values[(s, r)] = vec

        step_end = 0.0
        step_sync = 0.0
        for s in range(S):
            row = self.channels[s]
            done = [row[r].cpu_free if s == 0 else max(row[r].cpu_free, row[r].up_free)
                    for r in range(d)]
            vals = [values[(s, r)] for r in range(d)]
            numeric = any(v is not None for v in vals)
            if d > 1:
                reduced, ends = sync_fn(self.store, row, agg.s_stage[s], done,
                                        values=vals if numeric else None,
                                        key_prefix=f"k{k}/sync{s}")
            else:
                reduced, ends = (vals[0] if numeric else None), done
            stage_end = max(ends)
            step_sync = max(step_sync, stage_end - max(done))
            step_end = max(step_end, stage_end)
            for r in range(d):
                row[r].release_at(ends[r])
            for r in range(d):
                try:
                    programs[(s, r)].send(reduced)
                except StopIteration:
                    pass
                else:
                    raise RuntimeError(f"worker (s={s}, r={r}) program yielded after sync")
        return StepTiming(end=step_end, sync=step_sync)
