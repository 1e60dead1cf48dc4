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

    def compute(self, duration: float, ready: float = 0.0) -> float:
        start = max(ready, self.cpu_free)
        self.cpu_free = start + duration
        return self.cpu_free

    def upload(self, key: str, nbytes: float, ready: float = 0.0,
               value: Any = None) -> float:
        start = max(ready, self.up_free)
        end = start + nbytes / self.bandwidth + self.latency
        self.up_free = end
        self.store.put(key, nbytes, value=value, visible_at=end)
        return end

    def download(self, key: str, ready: float = 0.0):
        obj = self.store.get(key)
        start = max(ready, self.dn_free, obj.visible_at)
        end = start + obj.nbytes / self.bandwidth + self.latency
        self.dn_free = end
        return obj.value, end

    @property
    def now(self) -> float:
        return max(self.cpu_free, self.up_free, self.dn_free)
