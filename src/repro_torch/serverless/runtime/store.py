"""Emulated cloud object store with a virtual clock (``repro.serverless.
runtime.store`` for the port).

Objects live under named keys and carry a ``visible_at`` time on the
virtual clock; each serverless worker owns a :class:`StageChannel` with
three serial resources (CPU, uplink, downlink) whose free times advance as
tasks are charged: a transfer occupies its link for ``nbytes / bandwidth``
plus one storage round trip, and a download starts once the object is
visible.  Values are stored as they are handed over (tensors stay on their
device); only the byte counts move the clock, so ``StoreStats`` and every
virtual time equal the JAX package's for the same run.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from repro_torch.models.common import tree_map


@dataclass
class StoredObject:
    nbytes: float
    visible_at: float
    value: Any = None


def classify_key(key: str) -> str:
    """Key class for the per-prefix byte breakdown: ``.../act{s}``
    (activations, including the serving boundaries ``serve/p/act{s}`` and
    ``serve/dec/t{t}/act{s}``), ``.../grad{s}``, scatter-reduce chunks
    (``/part/``, ``/red/``), ``ckpt/`` checkpoints and ``kv/s{s}`` (the
    serving engine's per-stage KV caches)."""
    if key.startswith("ckpt/"):
        return "ckpt"
    if key.startswith("kv/"):
        return "kv"
    if "/part/" in key or "/red/" in key:
        return "sync"
    base = key.rsplit("/", 1)[-1]
    if base.startswith("act"):
        return "act"
    if base.startswith("grad"):
        return "grad"
    return "other"


def producer_worker_of_key(key: str):
    """The (stage, replica) that produces ``key`` under the engine's key
    schema, or None outside it: the producer-lease rule of the wall-clock
    stores' liveness checks (every engine key has one producer worker)."""
    try:
        parts = key.split("/")
        base = parts[-1]
        if key.startswith("ckpt/"):
            return None
        if len(parts) >= 4 and parts[1].startswith("sync"):
            stage = int(parts[1][4:])
            if parts[2] == "part":
                # k{k}/sync{s}/part/{j}/{i}: uploaded by replica i
                return (stage, int(parts[4]))
            # k{k}/sync{s}/red/{j}: reduced by the owner replica of chunk j
            return (stage, int(parts[3]))
        replica = int(parts[1][1:])
        if base.startswith("act"):
            return (int(base[3:]), replica)
        if base.startswith("grad"):
            return (int(base[4:]) + 1, replica)
    except (ValueError, IndexError):
        pass
    return None


def producer_of_key(key: str) -> str:
    """Which worker produces ``key``, in words, for store-timeout messages
    when no lease was recorded."""
    try:
        parts = key.split("/")
        base = parts[-1]
        if key.startswith("ckpt/"):
            return "the engine's checkpoint writer"
        if "sync" in key and len(parts) >= 4:
            stage = int(parts[1][4:])
            if parts[2] == "part":
                return (f"replica {int(parts[4])} of stage {stage} "
                        "(scatter-reduce part)")
            return (f"the owner replica of chunk {int(parts[3])} at stage "
                    f"{stage} (scatter-reduce reduced chunk)")
        replica = int(parts[1][1:])
        if base.startswith("act"):
            return f"worker (stage {int(base[3:])}, replica {replica})"
        if base.startswith("grad"):
            return f"worker (stage {int(base[4:]) + 1}, replica {replica})"
    except (ValueError, IndexError):
        pass
    return "an unknown producer (key outside the engine schema)"


class StoreAbortedError(RuntimeError):
    """The store was poisoned because a worker died: every blocked consumer
    is woken with this instead of waiting out its get timeout."""


class ProducerDeadError(RuntimeError):
    """A consumer's lease check found the producer of the awaited key dead
    (marked dead, or no heartbeat within the lease timeout)."""


def check_lease(key: str, producer, dead: bool, age, lease_timeout: float) -> None:
    """Raise :class:`ProducerDeadError` when ``producer`` (the worker that
    puts ``key``) is marked dead or its last heartbeat, ``age`` seconds ago
    (None: never), is older than the lease."""
    who = f"its producer worker (stage {producer[0]}, replica {producer[1]})"
    if dead:
        raise ProducerDeadError(f"object {key!r} will never arrive: {who} died")
    if age is not None and age > lease_timeout:
        raise ProducerDeadError(
            f"object {key!r} will never arrive: {who} stopped heartbeating "
            f"{age:.1f}s ago (lease timeout {lease_timeout:.0f}s)")


def timeout_message(key: str, timeout: float, existing, dead: bool, age) -> str:
    """A get timeout, stated: the missing key, which keys exist, who holds
    the producer lease and how stale its heartbeat is (``dead``/``age`` as
    for :func:`check_lease`)."""
    producer = producer_worker_of_key(key)
    existing = sorted(existing)
    sample = ", ".join(existing[:8]) if existing else "none"
    if producer is None:
        lease = f"no producer lease on record ({producer_of_key(key)})"
    else:
        state = ("marked dead" if dead else f"last heartbeat {age:.1f}s ago"
                 if age is not None else "never heartbeat")
        lease = (f"producer lease held by worker (stage {producer[0]}, "
                 f"replica {producer[1]}) — {state}")
    return (f"object {key!r} never became visible within {timeout:.0f}s; "
            f"{lease}; {len(existing)} keys present (e.g. [{sample}])")


class WireTensor:
    """A tensor in host memory for a trip through a file or a pipe: its
    bytes, dtype and shape (numpy has no bfloat16, so the bytes travel
    raw), and the device it left, where :func:`from_wire` puts it back."""

    __slots__ = ("data", "dtype", "shape", "device")

    def __init__(self, t: torch.Tensor):
        host = t.detach().to("cpu", copy=True).reshape(-1)
        self.data = host.view(torch.uint8).numpy()
        self.dtype = str(t.dtype).removeprefix("torch.")
        self.shape = tuple(t.shape)
        self.device = str(t.device)

    def __getstate__(self):
        return (self.data, self.dtype, self.shape, self.device)

    def __setstate__(self, state):
        self.data, self.dtype, self.shape, self.device = state

    def tensor(self, device=None) -> torch.Tensor:
        data = self.data if self.data.flags.writeable else self.data.copy()
        t = torch.from_numpy(data).view(getattr(torch, self.dtype)).reshape(self.shape)
        return t.to(self.device if device is None else device)


def to_wire(value: Any) -> Any:
    """``value`` with every tensor leaf (dicts, tuples) copied to host
    memory as a :class:`WireTensor`, ready to pickle."""
    return tree_map(lambda a: WireTensor(a) if isinstance(a, torch.Tensor) else a, value)


def from_wire(value: Any, device=None) -> Any:
    """Inverse of :func:`to_wire`: each tensor back on the device it left,
    or on ``device`` when given."""
    return tree_map(lambda a: a.tensor(device) if isinstance(a, WireTensor) else a, value)


@dataclass
class StoreStats:
    puts: int = 0
    gets: int = 0
    deletes: int = 0
    bytes_in: float = 0.0
    bytes_out: float = 0.0
    bytes_deleted: float = 0.0
    peak_bytes: float = 0.0
    # per key-class breakdown (classify_key)
    class_bytes_in: Dict[str, float] = field(default_factory=dict)
    class_bytes_out: Dict[str, float] = field(default_factory=dict)
    class_bytes_deleted: Dict[str, float] = field(default_factory=dict)

    def count_put(self, key: str, nbytes: float, live_bytes: float) -> None:
        self.puts += 1
        self.bytes_in += nbytes
        self.peak_bytes = max(self.peak_bytes, live_bytes)
        cls = classify_key(key)
        self.class_bytes_in[cls] = self.class_bytes_in.get(cls, 0.0) + nbytes

    def count_get(self, key: str, nbytes: float) -> None:
        self.gets += 1
        self.bytes_out += nbytes
        cls = classify_key(key)
        self.class_bytes_out[cls] = self.class_bytes_out.get(cls, 0.0) + nbytes

    def count_delete(self, key: str, nbytes: float) -> None:
        self.deletes += 1
        self.bytes_deleted += nbytes
        cls = classify_key(key)
        self.class_bytes_deleted[cls] = \
            self.class_bytes_deleted.get(cls, 0.0) + nbytes

    def as_dict(self) -> dict:
        return {
            "puts": self.puts, "gets": self.gets, "deletes": self.deletes,
            "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
            "bytes_deleted": self.bytes_deleted,
            "peak_bytes": self.peak_bytes,
            "class_bytes_in": dict(self.class_bytes_in),
            "class_bytes_out": dict(self.class_bytes_out),
            "class_bytes_deleted": dict(self.class_bytes_deleted),
        }


class ObjectStore:
    """Flat key -> object namespace (one bucket)."""

    def __init__(self, latency: float = 0.0):
        self.latency = latency
        self._objects: Dict[str, StoredObject] = {}
        self._live_bytes = 0.0
        self.stats = StoreStats()

    def put(self, key: str, nbytes: float, value: Any = None,
            visible_at: float = 0.0) -> StoredObject:
        prev = self._objects.get(key)
        if prev is not None:
            # an overwrite frees the old object: counted, so puts == deletes
            self._live_bytes -= prev.nbytes
            self.stats.count_delete(key, prev.nbytes)
        obj = StoredObject(nbytes=float(nbytes), visible_at=visible_at, value=value)
        self._objects[key] = obj
        self._live_bytes += obj.nbytes
        self.stats.count_put(key, obj.nbytes, self._live_bytes)
        return obj

    def get(self, key: str) -> StoredObject:
        if key not in self._objects:
            raise KeyError(f"object {key!r} was never uploaded")
        obj = self._objects[key]
        self.stats.count_get(key, obj.nbytes)
        return obj

    def delete(self, key: str) -> None:
        obj = self._objects.pop(key, None)
        if obj is not None:
            self._live_bytes -= obj.nbytes
            self.stats.count_delete(key, obj.nbytes)

    def keys(self):
        return list(self._objects)

    @property
    def live_bytes(self) -> float:
        return self._live_bytes


def assert_store_drained(store) -> None:
    """End-of-run invariant: no residual objects, object count conserved,
    and bytes conserved up to float summation order."""
    leftover = store.keys()
    if leftover:
        sample = ", ".join(sorted(leftover)[:8])
        raise RuntimeError(
            f"store not drained: {len(leftover)} residual objects "
            f"({store.live_bytes:.0f} live bytes), e.g. [{sample}]")
    st = store.stats
    if st.puts != st.deletes:
        raise RuntimeError(
            f"store object count not conserved: {st.puts} puts vs "
            f"{st.deletes} deletes with an empty store")
    if abs(st.bytes_in - st.bytes_deleted) > 1e-6 * max(st.bytes_in, 1.0):
        raise RuntimeError(
            f"store bytes not conserved: {st.bytes_in:.0f} uploaded vs "
            f"{st.bytes_deleted:.0f} deleted with an empty store")


class StageChannel:
    """A worker's virtual clock: serial CPU, uplink and downlink resources;
    a task starts at ``max(data-ready, resource-free)``."""

    def __init__(self, store: ObjectStore, bandwidth: float, latency: float,
                 name: str = "worker"):
        if not bandwidth > 0:
            raise ValueError(f"bandwidth must be positive, got {bandwidth}")
        self.store = store
        self.bandwidth = bandwidth
        self.latency = latency
        self.name = name
        self.cpu_free = 0.0
        self.up_free = 0.0
        self.dn_free = 0.0
        # optional repro_torch.obs.WorkerTracer: when set, every charged
        # resource task (each scatter-reduce chunk too) emits one span
        self.tracer = None

    def compute(self, duration: float, ready: float = 0.0) -> float:
        start = max(ready, self.cpu_free)
        self.cpu_free = start + duration
        if self.tracer is not None:
            self.tracer.emit("compute", start, self.cpu_free)
        return self.cpu_free

    def upload(self, key: str, nbytes: float, ready: float = 0.0,
               value: Any = None, new_request: bool = True) -> float:
        """A request that continues a pipelined stream on the same link
        (``new_request=False``: the scatter-reduce's back-to-back chunk
        puts) skips the repeated storage round trip."""
        start = max(ready, self.up_free)
        end = start + nbytes / self.bandwidth + (self.latency if new_request else 0.0)
        self.up_free = end
        self.store.put(key, nbytes, value=value, visible_at=end)
        if self.tracer is not None:
            self.tracer.emit("upload", start, end, nbytes=nbytes, key=key)
        return end

    def download(self, key: str, ready: float = 0.0, new_request: bool = True,
                 op: str = "download"):
        obj = self.store.get(key)
        # the span starts when the transfer does: the visibility wait shows
        # as a gap (bubble), not as link occupancy
        start = max(ready, self.dn_free, obj.visible_at)
        end = start + obj.nbytes / self.bandwidth + (self.latency if new_request else 0.0)
        self.dn_free = end
        if self.tracer is not None:
            self.tracer.emit(op, start, end, nbytes=obj.nbytes, key=key)
        return obj.value, end

    def stall(self, duration: float, op: str = "retry") -> float:
        """Charge ``duration`` of idle occupancy across all three resources
        (the worker is blocked in a retry backoff or an injected straggle);
        one ``op`` span."""
        start = self.now
        end = start + duration
        self.release_at(end)
        if self.tracer is not None:
            self.tracer.emit(op, start, end)
        return end

    def join_uplink_into_downlink(self) -> None:
        """Program-order fence between the forward and backward phases: no
        backward download before the forward uploads are done."""
        if self.tracer is not None and self.up_free > self.dn_free:
            # the fence's wait (the downlink held back by the uplink)
            self.tracer.emit("barrier", self.dn_free, self.up_free)
        self.dn_free = max(self.dn_free, self.up_free)

    def release_at(self, t: float) -> None:
        """Advance every resource to at least ``t`` (post-sync barrier)."""
        self.cpu_free = max(self.cpu_free, t)
        self.up_free = max(self.up_free, t)
        self.dn_free = max(self.dn_free, t)

    @property
    def now(self) -> float:
        return max(self.cpu_free, self.up_free, self.dn_free)
