"""Wall-clock backend: real concurrent stage workers on one host
(``repro.serverless.backends.local`` for the port).

The plan's ``S x d`` stage workers run as threads, exchanging every
boundary activation, gradient and scatter-reduce chunk through a
thread-safe :class:`LocalStore` whose ``get`` blocks until the producer's
``put`` lands: the visibility and ordering races of a real platform, which
the virtual clock's deterministic interleave never hits.  A plan replayed
here trains to params bit-identical to the emulated backend's (the same
stage math, the same ring-ordered fp32 reduction).

Time is host wall-clock (``wall_clock=True``): modeled compute costs are
not slept, and ``StoreStats`` records the modeled byte sizes, so the byte
accounting matches the emulated backend object for object.

On a card every (stage, replica) worker launches on a CUDA stream of its
own, made once when the backend opens for the plan, so one worker's
kernels never queue behind another's.  The store orders what crosses
streams: a ``put`` of CUDA tensors records an event on the putter's stream,
and a ``get``/``take`` makes the taker's stream wait on it and marks each
tensor it hands out as used there (``record_stream``), so the caching
allocator does not reuse a buffer the taker still reads.  The
scatter-reduce's chunks go through the same ``put``/``take``/``get``.
Each step's worker streams first wait on the caller's stream (the batch,
the params as the caller left them), and the caller's stream waits on
every worker stream before :meth:`LocalBackend.run_step` returns.  The
store keeps tensors by reference; with ``fs_root`` every payload goes
through a file instead (host bytes,
:func:`~repro_torch.serverless.runtime.store.to_wire`): the device-to-host
copy waits for the putter's work, and the taker's copy back to the device
runs on its own stream, so no event is needed there.
"""
from __future__ import annotations

import os
import pickle
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.serverless.backends.base import (
    ExecutionBackend,
    StepTiming,
    WorkerContext,
    WorkerProgram,
)
from repro_torch.models.common import tree_leaves
from repro_torch.obs.ranges import STORE_WAIT, phase_range
from repro_torch.serverless.runtime.scatter_reduce import local_scatter_reduce
from repro_torch.serverless.runtime.store import (
    ProducerDeadError,
    StoreAbortedError,
    StoreStats,
    check_lease,
    from_wire,
    producer_worker_of_key,
    timeout_message,
    to_wire,
)

# deadlock backstop: a blocking get that outwaits this is a lost producer
# (a peer worker thread died), not a slow one
DEFAULT_GET_TIMEOUT = 120.0

# a producer whose last heartbeat is older than this is dead, not slow: its
# consumers fail over at once instead of burning the get timeout
DEFAULT_LEASE_TIMEOUT = 5.0

# S x d real threads; past this the run measures the host's scheduler, not
# the plan: replay large plans on the emulated backend
MAX_WORKERS = 256


@dataclass
class _Stored:
    nbytes: float
    value: Any = None
    path: Optional[str] = None
    ready: Any = None          # torch.cuda.Event after the putter's writes


def _cuda_leaves(value: Any) -> list:
    return [a for a in tree_leaves(value) if isinstance(a, torch.Tensor) and a.is_cuda]


def _put_event(value: Any):
    """An event recorded on the current stream when ``value`` holds CUDA
    tensors (the work that wrote them is queued there), else None."""
    if not _cuda_leaves(value):
        return None
    event = torch.cuda.Event()
    event.record()
    return event


def _hand_out(obj: "_Stored", value: Any) -> Any:
    """Order the current stream after the putter's writes, and keep each
    CUDA tensor's memory from reuse until this stream's work on it is done."""
    if obj.ready is not None:
        stream = torch.cuda.current_stream()
        stream.wait_event(obj.ready)
        for a in _cuda_leaves(value):
            a.record_stream(stream)
    return value


class LocalStore:
    """Thread-safe key -> object namespace with blocking visibility.

    ``put`` makes the object visible at once and wakes waiters; ``get``
    blocks until the key exists (``TimeoutError`` after ``timeout`` seconds,
    naming what was missing); ``take`` is the fetch-and-consume of
    single-consumer pipeline objects.  ``nbytes`` is the modeled size,
    kept for byte accounting.

    Liveness: workers ``heartbeat()`` as they make progress and are
    ``mark_dead()``-ed when their thread dies.  A blocked ``get`` checks the
    awaited key's producer lease (the engine's key schema names one producer
    per key): a dead or heartbeat-stale producer raises
    :class:`ProducerDeadError` at once.  ``abort()`` poisons the store,
    waking every waiter with :class:`StoreAbortedError`; ``revive()`` clears
    it for a replay.
    """

    def __init__(self, timeout: float = DEFAULT_GET_TIMEOUT,
                 fs_root: Optional[str] = None,
                 lease_timeout: float = DEFAULT_LEASE_TIMEOUT):
        self.timeout = timeout
        self.lease_timeout = lease_timeout
        self.fs_root = fs_root
        self._cv = threading.Condition()
        self._objects: Dict[str, _Stored] = {}
        self._live_bytes = 0.0
        self._seq = 0
        self._poison: Optional[BaseException] = None
        self._heartbeats: Dict[Tuple[int, int], float] = {}
        self._dead: set = set()
        self.stats = StoreStats()
        if fs_root is not None:
            os.makedirs(fs_root, exist_ok=True)

    # ------------------------------------------------------ liveness / leases
    def heartbeat(self, worker: Tuple[int, int]) -> None:
        """Record that worker (stage, replica) is alive and making progress."""
        with self._cv:
            self._heartbeats[worker] = time.monotonic()

    def mark_dead(self, worker: Tuple[int, int]) -> None:
        """Declare a worker dead (its thread raised) and wake every waiter,
        so the consumers of its keys fail over at once."""
        with self._cv:
            self._dead.add(worker)
            self._cv.notify_all()

    def heartbeat_age(self, worker: Tuple[int, int]) -> Optional[float]:
        """Seconds since the worker's last heartbeat (None: never beat)."""
        with self._cv:
            return self._age_locked(worker)

    def abort(self, reason: BaseException) -> None:
        """Poison the store: every current and future blocking op raises
        :class:`StoreAbortedError` naming ``reason`` (the first death wins)."""
        with self._cv:
            if self._poison is None:
                self._poison = reason
            self._cv.notify_all()

    def revive(self) -> None:
        """Clear poison and liveness state for a replay."""
        with self._cv:
            self._poison = None
            self._dead.clear()
            self._heartbeats.clear()

    # ----------------------------------------------------------- fs payloads
    def _spill(self, value: Any) -> Optional[str]:
        if self.fs_root is None or value is None:
            return None
        with self._cv:
            self._seq += 1
            path = os.path.join(self.fs_root, f"obj-{self._seq}.pkl")
        with open(path, "wb") as f:
            pickle.dump(to_wire(value), f, protocol=pickle.HIGHEST_PROTOCOL)
        return path

    @staticmethod
    def _load(obj: _Stored) -> Any:
        if obj.path is None:
            return obj.value
        with open(obj.path, "rb") as f:
            return from_wire(pickle.load(f))

    @staticmethod
    def _unlink(obj: _Stored) -> None:
        if obj.path is not None:
            try:
                os.remove(obj.path)
            except FileNotFoundError:
                pass

    # ------------------------------------------------------------ store API
    def put(self, key: str, nbytes: float, value: Any = None) -> float:
        """Publish ``value`` under ``key``; returns the bytes charged."""
        path = self._spill(value)
        with self._cv:
            prev = self._objects.get(key)
            if prev is not None:
                # an overwrite frees the old object (and its spill file):
                # counted, so the drain accounting stays conserved
                self._live_bytes -= prev.nbytes
                self.stats.count_delete(key, prev.nbytes)
                self._unlink(prev)
            obj = _Stored(nbytes=float(nbytes),
                          value=None if path is not None else value, path=path,
                          ready=None if path is not None else _put_event(value))
            self._objects[key] = obj
            self._live_bytes += obj.nbytes
            self.stats.count_put(key, obj.nbytes, self._live_bytes)
            self._cv.notify_all()
        return obj.nbytes

    def _wait_for(self, key: str) -> _Stored:
        deadline = time.monotonic() + self.timeout
        producer = producer_worker_of_key(key)
        while True:
            if self._poison is not None:
                raise StoreAbortedError(
                    f"store aborted while waiting for {key!r}: "
                    f"{self._poison}") from self._poison
            if key in self._objects:
                return self._objects[key]
            if producer is not None:
                check_lease(key, producer, producer in self._dead,
                            self._age_locked(producer), self.lease_timeout)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(self._diagnose_timeout_locked(key))
            # woken early by put/abort/mark_dead; the poll interval bounds
            # only how late a silently stale heartbeat is noticed
            with phase_range(STORE_WAIT):
                self._cv.wait(min(remaining, self.lease_timeout / 4.0, 0.25))

    def _age_locked(self, worker: Tuple[int, int]) -> Optional[float]:
        beat = self._heartbeats.get(worker)
        return None if beat is None else time.monotonic() - beat

    def _diagnose_timeout_locked(self, key: str) -> str:
        producer = producer_worker_of_key(key)
        return timeout_message(key, self.timeout, self._objects, producer in self._dead,
                               None if producer is None else self._age_locked(producer))

    def get(self, key: str, return_nbytes: bool = False) -> Any:
        """Block until ``key`` is visible, then return its payload (or
        ``(payload, modeled_nbytes)`` with ``return_nbytes=True``)."""
        with self._cv:
            obj = self._wait_for(key)
            self.stats.count_get(key, obj.nbytes)
        value = _hand_out(obj, self._load(obj))
        return (value, obj.nbytes) if return_nbytes else value

    def take(self, key: str, return_nbytes: bool = False) -> Any:
        """Blocking fetch-and-consume (get + delete, atomically)."""
        with self._cv:
            obj = self._wait_for(key)
            self.stats.count_get(key, obj.nbytes)
            value = self._load(obj)   # before the delete unlinks its file
            self._delete_locked(key)
        value = _hand_out(obj, value)
        return (value, obj.nbytes) if return_nbytes else value

    def delete(self, key: str) -> None:
        with self._cv:
            self._delete_locked(key)

    def _delete_locked(self, key: str) -> None:
        obj = self._objects.pop(key, None)
        if obj is not None:
            self._live_bytes -= obj.nbytes
            self.stats.count_delete(key, obj.nbytes)
            self._unlink(obj)

    def keys(self):
        with self._cv:
            return list(self._objects)

    def __contains__(self, key: str) -> bool:
        with self._cv:
            return key in self._objects

    def __len__(self) -> int:
        with self._cv:
            return len(self._objects)

    @property
    def live_bytes(self) -> float:
        return self._live_bytes


def device_event(synchronize: bool = False):
    """A timing event recorded on this thread's current CUDA stream (on
    ``local``, the worker's own), or None in a process without a CUDA
    context.  It never waits, unless ``synchronize``: then the device drains
    first, so the event marks the moment it is recorded (a trace's anchor)."""
    if not torch.cuda.is_initialized():
        return None
    if synchronize:
        torch.cuda.synchronize()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


class LocalWorkerContext(WorkerContext):
    """A stage worker on a real thread: blocking store, no modeled clock.
    ``worker`` is its (stage, replica), whose lease every op renews.

    With ``tracer``/``clock`` set (a ``repro_torch.obs.WorkerTracer`` and
    seconds since the run began), every store op and compute emits one
    wall-clock span; a blocking download's visibility wait is part of its
    span.  PyTorch returns before the device finishes, so a compute span's
    interval is the launch: the time the worker's thread spent enqueueing
    the micro-batch, interpreter-lock waits included.  On a card it also
    records a :func:`device_event` before and after ``fn`` on the worker's
    own stream; the tracer keeps them until the recorder resolves them into
    the span's device interval (from the end of the work queued before it,
    its inputs' producers included, to the end of its own; kernels of other
    workers running at the same time share the device and stretch it).
    Nothing waits on the device.  An upload span carries the bytes the store
    charged (``put`` returns them): with ``payload_true`` on ``process`` the
    payload's real size, so the spans reconcile with ``StoreStats``."""

    def __init__(self, store, worker: Optional[Tuple[int, int]] = None,
                 tracer=None, clock=None):
        self.store = store
        self.worker = worker
        self.tracer = tracer
        self.clock = clock

    def _beat(self) -> None:
        if self.worker is not None:
            self.store.heartbeat(self.worker)

    def _fetch(self, fetch, key: str, op: str):
        if self.tracer is None:
            return fetch(key), None
        t0 = self.clock()
        value, nb = fetch(key, return_nbytes=True)
        self.tracer.emit(op, t0, self.clock(), nbytes=nb, key=key)
        return value, None

    def download(self, key: str):
        self._beat()
        return self._fetch(self.store.take, key, "download")

    def compute(self, cost_s: float, fn: Optional[Callable[[], Any]] = None,
                after: Any = None) -> Any:
        # the modeled cost is the virtual clock's business; here compute is real
        self._beat()
        if self.tracer is None:
            return fn() if fn is not None else None
        t0 = self.clock()
        e0 = device_event()
        out = fn() if fn is not None else None
        events = None if e0 is None else (e0, device_event())
        self.tracer.emit("compute", t0, self.clock(), events=events)
        return out

    def upload(self, key: str, nbytes: float, value: Any = None) -> Any:
        self._beat()
        if self.tracer is None:
            self.store.put(key, nbytes, value=value)
            return None
        t0 = self.clock()
        charged = self.store.put(key, nbytes, value=value)
        self.tracer.emit("upload", t0, self.clock(), nbytes=charged, key=key)
        return None

    def phase_barrier(self) -> None:
        # a serial worker's forward uploads are done before it goes on; for
        # tracing this is also the worker's fwd -> bwd phase flip
        self._beat()
        if self.tracer is not None:
            self.tracer.phase = "bwd"

    def wait(self, seconds: float, op: str = "retry") -> None:
        # a real backoff on the wall clock; traced, an ``op`` span makes the
        # recovery's cost visible
        self._beat()
        if self.tracer is None:
            time.sleep(seconds)
            return
        t0 = self.clock()
        time.sleep(seconds)
        self.tracer.emit(op, t0, self.clock())

    def fetch(self, key: str, op: str = "download"):
        self._beat()
        return self._fetch(self.store.get, key, op)


def _primary_error(errors: List[BaseException]) -> BaseException:
    """The error that caused a failed step, not the wreckage it stranded
    its peers in (aborted stores, broken barriers, dead producers, timeouts)."""
    def collateral(e: BaseException) -> bool:
        return isinstance(e, (StoreAbortedError, ProducerDeadError,
                              threading.BrokenBarrierError, TimeoutError))
    return min(errors, key=collateral)


class LocalBackend(ExecutionBackend):
    """Real-concurrency substitute platform on the host: a thread per worker."""

    name = "local"
    wall_clock = True

    def __init__(self, *, fs_root: Optional[str] = None,
                 get_timeout: float = DEFAULT_GET_TIMEOUT,
                 lease_timeout: float = DEFAULT_LEASE_TIMEOUT):
        self.fs_root = fs_root
        self.get_timeout = get_timeout
        self.lease_timeout = lease_timeout
        self.agg = None
        self.store: Optional[LocalStore] = None
        self._t0 = 0.0
        # per-(stage, replica) tracers when a recorder is attached; the
        # engine asks for step k's contexts after run_step(k - 1) returned,
        # so _steps_done is the step a new tracer starts in
        self._tracers: Dict[Tuple[int, int], Any] = {}
        self._steps_done = 0
        self._streams: Dict[Tuple[int, int], Any] = {}
        # (event, its time on the run's clock), recorded on an idle device
        # before the first traced step: what a compute span's events are
        # timed from; None without a CUDA context
        self._anchor: Optional[tuple] = None

    def _worker_streams(self) -> Dict[Tuple[int, int], Any]:
        """One CUDA stream per (stage, replica), made once for the plan, or
        none where this process has no CUDA context (a CPU run)."""
        if not self._streams and torch.cuda.is_initialized():
            self._streams = {(s, r): torch.cuda.Stream()
                             for s in range(self.agg.S) for r in range(self.agg.d)}
        return self._streams

    def open(self, agg) -> None:
        if agg.S * agg.d > MAX_WORKERS:
            raise ValueError(
                f"plan spawns {agg.S}x{agg.d}={agg.S * agg.d} concurrent "
                f"workers; the local backend caps at {MAX_WORKERS} threads "
                "— replay this plan on the emulated backend instead")
        self.agg = agg
        self.store = self._make_store()
        self._tracers = {}
        self._steps_done = 0
        self._streams = {}
        self._anchor = None
        self._worker_streams()
        self._t0 = time.perf_counter()

    def _make_store(self):
        """Store-provisioning hook: a cloud adapter swaps in a client-backed
        store with the same blocking surface."""
        return LocalStore(timeout=self.get_timeout, fs_root=self.fs_root,
                          lease_timeout=self.lease_timeout)

    def recover(self) -> int:
        """Revive the poisoned store and purge residual non-checkpoint keys."""
        self.store.revive()
        return super().recover()

    def _clock(self) -> float:
        """Seconds since the run began: the trace's time base."""
        return time.perf_counter() - self._t0

    def _anchor_recorder(self) -> None:
        """Give the recorder the run's anchor event, recorded once, between
        steps, after a device synchronisation."""
        if self._anchor is None:
            event = device_event(synchronize=True)
            if event is not None:
                self._anchor = (event, self._clock())
        self.recorder.anchor = self._anchor

    def context(self, s: int, r: int) -> LocalWorkerContext:
        if self.recorder is None:
            return LocalWorkerContext(self.store, worker=(s, r))
        self._anchor_recorder()
        tr = self.recorder.tracer(s, r)
        tr.step = self._steps_done
        self._tracers[(s, r)] = tr
        return LocalWorkerContext(self.store, worker=(s, r), tracer=tr, clock=self._clock)

    @property
    def store_stats(self) -> StoreStats:
        return self.store.stats

    def _store_for_verification(self):
        return self.store

    def run_step(self, k: int, programs: Dict[Tuple[int, int], WorkerProgram],
                 *, pipelined_sync: bool = True) -> StepTiming:
        agg = self.agg
        S, d = agg.S, agg.d
        # a peer that never arrives (a died worker) breaks the barrier after
        # the store's timeout instead of hanging the run
        barriers = ({s: threading.Barrier(d, timeout=self.get_timeout)
                     for s in range(S)} if d > 1 else {})
        streams = self._worker_streams()
        caller = torch.cuda.current_stream() if streams else None
        for ws in streams.values():
            ws.wait_stream(caller)     # the batch and the params as the caller left them
        sync_secs: Dict[Tuple[int, int], float] = {}
        # traced: each worker thread's CPU seconds in its program (time
        # blocked in the store, at a barrier or on the interpreter lock left out)
        cpu_secs: Dict[Tuple[int, int], float] = {}
        timed = self.recorder is not None
        errors: List[BaseException] = []
        err_lock = threading.Lock()

        def drive(s: int, r: int, gen: WorkerProgram) -> None:
            c0 = time.thread_time() if timed else 0.0
            try:
                with torch.cuda.stream(streams.get((s, r))):
                    y = next(gen)
                    while True:
                        if isinstance(y, tuple) and y[0] == "sync":
                            tr = self._tracers.get((s, r))
                            if tr is not None:
                                tr.phase = "sync"     # this worker's own tracer
                            t0 = time.perf_counter()
                            reduced = local_scatter_reduce(
                                self.store, r, d, agg.s_stage[s], y[1],
                                key_prefix=f"k{k}/sync{s}", pipelined=pipelined_sync,
                                barrier=barriers.get(s), tracer=tr, clock=self._clock)
                            sync_secs[(s, r)] = time.perf_counter() - t0
                            y = gen.send(reduced)
                        else:
                            y = next(gen)
            except StopIteration:
                return
            except BaseException as e:  # noqa: BLE001 - raised on the main thread
                with err_lock:
                    errors.append(e)
                # a died worker starves its peers' gets and their sync
                # barrier: mark it dead, poison the store and break the
                # barriers so every peer fails over now, not at the timeout
                self.store.mark_dead((s, r))
                self.store.abort(e)
                for b in barriers.values():
                    b.abort()
            finally:
                if timed:
                    cpu_secs[(s, r)] = time.thread_time() - c0

        threads = [threading.Thread(target=drive, args=(s, r, gen),
                                    name=f"funcpipe-s{s}r{r}", daemon=True)
                   for (s, r), gen in programs.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for ws in streams.values():
            caller.wait_stream(ws)     # the step's end, the params, the next step
        if errors:
            try:
                raise _primary_error(errors)
            finally:
                # the errors' tracebacks hold the threads' frames, which hold
                # this list: emptied, no reference cycle keeps the failed
                # step's tensors alive until the garbage collector runs
                errors.clear()
        sync = max((sync_secs.get((s, r), 0.0) for s in range(S) for r in range(d)),
                   default=0.0)
        self._steps_done += 1
        return StepTiming(end=time.perf_counter() - self._t0, sync=sync,
                          worker_cpu_s=cpu_secs)
