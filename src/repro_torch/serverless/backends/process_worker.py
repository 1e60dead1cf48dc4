"""The ``process`` backend's worker side (``repro.serverless.backends.
process_worker`` for the port): what runs inside each of the ``S x d``
spawned worker processes, and the storage they share.

* :class:`FileStore` — the cross-process :class:`~repro_torch.serverless.
  backends.local.LocalStore`: a directory of object files with
  fcntl-locked atomic put/get/take/delete, one shared ``stats.json``
  updated through :class:`~repro_torch.serverless.runtime.store.StoreStats`,
  heartbeats by file mtime (a killed worker's heartbeat freezes, so its
  consumers raise ``ProducerDeadError``), a dead marker per worker and
  a poison file every process sees.  A tensor crosses as host bytes
  (:func:`~repro_torch.serverless.runtime.store.to_wire`: numpy has no
  bfloat16) and comes back on the device it left.
* :class:`FileBarrier` — a ``threading.Barrier`` lookalike over marker
  files, generation-counted so the eq (1) collective's fences line up
  across processes; a poisoned store breaks it.
* :func:`worker_main` — the child process: it applies the parent's global
  torch settings (deterministic algorithms, TF32, thread count; a spawned
  child inherits none of them), builds its stage worker from the spec the
  parent stashed in a file (the pipe carries only control messages and,
  when the command is traced, the child's spans), heartbeats from a daemon
  thread, and serves step, serve and params commands over a pipe, running
  the engine's own worker program locally (a generator cannot cross a
  process boundary).  A command that fails
  poisons the store, is reported to the parent with its traceback, and the
  child stays up.  In a chaos run the step program's context fires the
  parent's fault schedule; an injected crash poisons the store, sends a
  dying report and SIGKILLs the child, and a lifetime-cap kill exits it
  with :data:`EXIT_LIFETIME`.  The child also serves the checkpoint ops
  ``export_state``, ``load_state`` and ``reset``.

``payload_true`` charges each transfer its real size (``Tensor.nbytes``: 2
bytes a bf16 element) instead of the modeled one; a ``bandwidth`` throttle
sleeps ``nbytes / bandwidth + t_lat`` a transfer.
"""
from __future__ import annotations

import contextlib
import json
import os
import pickle
import signal
import struct
import threading
import time
import traceback
from typing import Any, Optional, Tuple

import torch

try:
    import fcntl
except ImportError:                      # non-POSIX host
    fcntl = None

from repro_torch.models.common import tree_map
from repro_torch.serverless.runtime.store import (
    StoreAbortedError,
    StoreStats,
    check_lease,
    from_wire,
    producer_worker_of_key,
    timeout_message,
    to_wire,
)

#: object-file header: little-endian float64 charged nbytes
_HEADER = struct.Struct("<d")

#: exit code of a child the function-lifetime cap killed (a planned death,
#: not a crash: the parent relaunches it)
EXIT_LIFETIME = 43


def _true_payload_nbytes(value: Any, pickled: int) -> float:
    """Real transfer size of ``value``: its ``nbytes`` when it has one (a
    tensor: element size times count), the length of a bytes-like, else its
    ``pickled`` size."""
    nb = getattr(value, "nbytes", None)
    if nb is not None:
        return float(nb)
    if isinstance(value, (bytes, bytearray, memoryview)):
        return float(len(value))
    return float(pickled)


class FileStore:
    """Cross-process key -> object namespace with blocking visibility, with
    :class:`~repro_torch.serverless.backends.local.LocalStore`'s surface (so
    ``LocalWorkerContext`` and ``local_scatter_reduce`` run over it
    unchanged): ``put`` publishes atomically (a tmp file and
    ``os.replace`` under a global file lock), ``get``/``take`` poll for the
    object file, failing over on a dead or poisoned producer."""

    def __init__(self, root: str, timeout: float = 120.0,
                 lease_timeout: float = 20.0, payload_true: bool = False,
                 bandwidth: Optional[float] = None, t_lat: float = 0.0):
        if fcntl is None:
            raise RuntimeError(
                "FileStore needs POSIX file locks (fcntl); the process "
                "backend is unavailable on this host")
        self.root = root
        self.timeout = timeout
        self.lease_timeout = lease_timeout
        self.payload_true = payload_true
        self.bandwidth = bandwidth      # bytes/s uplink and downlink throttle
        self.t_lat = t_lat              # per-request round trip, throttled
        self._objects = os.path.join(root, "objects")
        self._stash = os.path.join(root, "stash")
        self._tmp = os.path.join(root, "tmp")
        self._hb = os.path.join(root, "hb")
        self._dead = os.path.join(root, "dead")
        self.barriers_root = os.path.join(root, "barriers")
        self._lock_path = os.path.join(root, "lock")
        self._stats_path = os.path.join(root, "stats.json")
        self._poison_path = os.path.join(root, "poison")
        self._seq = 0
        for d in (self._objects, self._stash, self._tmp, self._hb, self._dead,
                  self.barriers_root):
            os.makedirs(d, exist_ok=True)
        with self._locked():
            if not os.path.exists(self._stats_path):
                self._dump_acct(StoreStats(), 0.0)

    @contextlib.contextmanager
    def _locked(self):
        fd = os.open(self._lock_path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)        # closing releases the flock, even on a kill

    # ------------------------------------------------------------- accounting
    def _load_acct(self) -> Tuple[StoreStats, float]:
        with open(self._stats_path) as f:
            d = json.load(f)
        live = d.pop("live_bytes", 0.0)
        return StoreStats(**d), live

    def _dump_acct(self, stats: StoreStats, live: float) -> None:
        d = stats.as_dict()
        d["live_bytes"] = live
        tmp = self._tmp_path()
        with open(tmp, "w") as f:
            json.dump(d, f)
        os.replace(tmp, self._stats_path)

    @property
    def stats(self) -> StoreStats:
        with self._locked():
            return self._load_acct()[0]

    @property
    def live_bytes(self) -> float:
        with self._locked():
            return self._load_acct()[1]

    # ------------------------------------------------------------------ paths
    def _obj_path(self, key: str) -> str:
        return os.path.join(self._objects, *key.split("/"))

    def _tmp_path(self) -> str:
        self._seq += 1
        return os.path.join(self._tmp, f"t{os.getpid()}-{threading.get_ident()}-{self._seq}")

    def _hb_path(self, worker: Tuple[int, int]) -> str:
        return os.path.join(self._hb, f"s{worker[0]}r{worker[1]}")

    def _dead_path(self, worker: Tuple[int, int]) -> str:
        return os.path.join(self._dead, f"s{worker[0]}r{worker[1]}")

    @staticmethod
    def _read_header(path: str) -> Optional[float]:
        try:
            with open(path, "rb") as f:
                return _HEADER.unpack(f.read(_HEADER.size))[0]
        except (OSError, struct.error):
            return None

    # ------------------------------------------------------ liveness / leases
    def heartbeat(self, worker: Tuple[int, int]) -> None:
        path = self._hb_path(worker)
        try:
            os.utime(path)
        except FileNotFoundError:
            with open(path, "a"):
                pass

    def mark_dead(self, worker: Tuple[int, int]) -> None:
        with open(self._dead_path(worker), "a"):
            pass

    def heartbeat_age(self, worker: Tuple[int, int]) -> Optional[float]:
        try:
            return time.time() - os.stat(self._hb_path(worker)).st_mtime
        except FileNotFoundError:
            return None

    def poison_text(self) -> Optional[str]:
        """What poisoned the store, or None."""
        try:
            with open(self._poison_path) as f:
                return f.read()
        except FileNotFoundError:
            return None

    def abort(self, reason: BaseException) -> None:
        # written aside, then renamed into place under the lock: a reader
        # never sees the poison file without its text, and the first poison
        # wins (peers' collateral errors must not overwrite the originating
        # failure)
        tmp = self._tmp_path()
        with open(tmp, "w") as f:
            f.write(f"{type(reason).__name__}: {reason}")
        with self._locked():
            if os.path.exists(self._poison_path):
                os.remove(tmp)
            else:
                os.replace(tmp, self._poison_path)

    def revive(self) -> None:
        with contextlib.suppress(FileNotFoundError):
            os.remove(self._poison_path)
        for d in (self._dead, self._hb):
            for fn in os.listdir(d):
                with contextlib.suppress(FileNotFoundError):
                    os.remove(os.path.join(d, fn))

    # ------------------------------------------------------- bulk hand-off
    def stash(self, name: str, value: Any) -> str:
        """Write ``value`` (its tensors as host bytes) to a file under the
        root, outside the object namespace and its accounting, for another
        process to :meth:`unstash`.  Bulk data between the parent and its
        children (a stage's params, both ways) goes through files: on the
        host of an NVIDIA H100 80GB HBM3 (700 W) a pipe moved ~10 MB/s and
        its file system GB/s (``tools/ipc_rates.py``)."""
        path = os.path.join(self._stash, name)
        tmp = self._tmp_path()
        with open(tmp, "wb") as f:
            pickle.dump(to_wire(value), f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        return path

    @staticmethod
    def unstash(path: str, device=None, remove: bool = False) -> Any:
        """Load what :meth:`stash` wrote, tensors on ``device`` (else the
        device they left); ``remove`` deletes the file after."""
        with open(path, "rb") as f:
            value = from_wire(pickle.load(f), device)
        if remove:
            os.remove(path)
        return value

    def _throttle(self, nbytes: float) -> None:
        if self.bandwidth:
            time.sleep(nbytes / self.bandwidth + self.t_lat)

    # -------------------------------------------------------------- store API
    def put(self, key: str, nbytes: float, value: Any = None) -> float:
        """Publish ``value`` under ``key``; returns the bytes charged (with
        ``payload_true`` the payload's real size, else ``nbytes``)."""
        # the payload streams into a private file (pickle writes a tensor's
        # bytes straight from its host copy) and is published by a rename
        # under the lock: the lock is held for metadata only
        tmp = self._tmp_path()
        with open(tmp, "wb") as f:
            f.write(_HEADER.pack(0.0))
            if value is None:
                f.write(b"\x00")
            else:
                f.write(b"\x01")
                pickle.dump(to_wire(value), f, protocol=pickle.HIGHEST_PROTOCOL)
                if self.payload_true:
                    nbytes = _true_payload_nbytes(value, f.tell() - _HEADER.size - 1)
            nbytes = float(nbytes)
            f.seek(0)
            f.write(_HEADER.pack(nbytes))
        self._throttle(nbytes)          # uplink: the transfer precedes visibility
        path = self._obj_path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with self._locked():
            stats, live = self._load_acct()
            prev = self._read_header(path)
            if prev is not None:
                # an overwrite frees the old object: count the implicit delete
                live -= prev
                stats.count_delete(key, prev)
            os.replace(tmp, path)
            live += nbytes
            stats.count_put(key, nbytes, live)
            self._dump_acct(stats, live)
        return nbytes

    def _wait_for(self, key: str) -> str:
        deadline = time.monotonic() + self.timeout
        producer = producer_worker_of_key(key)
        path = self._obj_path(key)
        poll = min(0.01, self.lease_timeout / 4.0)
        while True:
            poison = self.poison_text()
            if poison is not None:
                raise StoreAbortedError(f"store aborted while waiting for {key!r}: {poison}")
            if os.path.exists(path):
                return path
            if producer is not None:
                check_lease(key, producer, os.path.exists(self._dead_path(producer)),
                            self.heartbeat_age(producer), self.lease_timeout)
            if time.monotonic() > deadline:
                raise TimeoutError(self._diagnose_timeout(key))
            time.sleep(poll)

    def _diagnose_timeout(self, key: str) -> str:
        producer = producer_worker_of_key(key)
        dead = producer is not None and os.path.exists(self._dead_path(producer))
        return timeout_message(key, self.timeout, self.keys(), dead,
                               None if producer is None else self.heartbeat_age(producer))

    @staticmethod
    def _read_obj(f) -> Tuple[float, Any]:
        nbytes = _HEADER.unpack(f.read(_HEADER.size))[0]
        wire = pickle.load(f) if f.read(1) == b"\x01" else None
        return nbytes, wire

    def _fetch(self, key: str, consume: bool, return_nbytes: bool) -> Any:
        path = self._obj_path(key)
        while True:
            self._wait_for(key)
            if consume:
                # a take renames the object to a private file under the lock
                # (it is gone for everyone else), then reads it unlocked
                private = self._tmp_path()
                with self._locked():
                    try:
                        os.rename(path, private)
                    except FileNotFoundError:
                        continue        # taken between the poll and the lock
                    nbytes = self._read_header(private)
                    stats, live = self._load_acct()
                    stats.count_get(key, nbytes)
                    live -= nbytes
                    stats.count_delete(key, nbytes)
                    self._dump_acct(stats, live)
                with open(private, "rb") as f:
                    nbytes, wire = self._read_obj(f)
                os.remove(private)
            else:
                # a get reads unlocked: an open file keeps its content even if
                # a put replaces the object or a delete removes it meanwhile
                try:
                    f = open(path, "rb")
                except FileNotFoundError:
                    continue            # deleted between the poll and the open
                with f:
                    nbytes, wire = self._read_obj(f)
                with self._locked():
                    stats, live = self._load_acct()
                    stats.count_get(key, nbytes)
                    self._dump_acct(stats, live)
            break
        self._throttle(nbytes)          # downlink
        value = from_wire(wire)
        return (value, nbytes) if return_nbytes else value

    def get(self, key: str, return_nbytes: bool = False) -> Any:
        return self._fetch(key, consume=False, return_nbytes=return_nbytes)

    def take(self, key: str, return_nbytes: bool = False) -> Any:
        return self._fetch(key, consume=True, return_nbytes=return_nbytes)

    def delete(self, key: str) -> None:
        path = self._obj_path(key)
        with self._locked():
            nbytes = self._read_header(path)
            if nbytes is None:
                return
            os.remove(path)
            stats, live = self._load_acct()
            live -= nbytes
            stats.count_delete(key, nbytes)
            self._dump_acct(stats, live)

    def keys(self):
        out = []
        for dirpath, _dirs, files in os.walk(self._objects):
            rel = os.path.relpath(dirpath, self._objects)
            for fn in files:
                out.append(fn if rel == "." else f"{rel}/{fn}".replace(os.sep, "/"))
        return out

    def __contains__(self, key: str) -> bool:
        return os.path.exists(self._obj_path(key))

    def __len__(self) -> int:
        return len(self.keys())


class FileBarrier:
    """``threading.Barrier``-shaped rendezvous over marker files: party
    ``index`` of ``parties`` drops ``g{generation}/r{index}`` and polls until
    every party arrived.  The generation advances per ``wait()``, which keeps
    the eq (1) collective's successive fences apart.  A poisoned store (a
    peer died) breaks it with :class:`threading.BrokenBarrierError`, as the
    thread backend's aborted barriers do."""

    def __init__(self, store: FileStore, name: str, parties: int, index: int,
                 timeout: float):
        self.store = store
        self.dir = os.path.join(store.barriers_root, name)
        self.parties = parties
        self.index = index
        self.timeout = timeout
        self._generation = 0

    def wait(self) -> None:
        gen_dir = os.path.join(self.dir, f"g{self._generation}")
        self._generation += 1
        os.makedirs(gen_dir, exist_ok=True)
        with open(os.path.join(gen_dir, f"r{self.index}"), "a"):
            pass
        deadline = time.monotonic() + self.timeout
        while True:
            if self.store.poison_text() is not None:
                raise threading.BrokenBarrierError
            try:
                if len(os.listdir(gen_dir)) >= self.parties:
                    return
            except FileNotFoundError:   # purged under us by recover()
                raise threading.BrokenBarrierError from None
            if time.monotonic() > deadline:
                raise threading.BrokenBarrierError
            time.sleep(0.005)


# =========================================================== child entrypoint
def torch_flags() -> dict:
    """The process-global torch settings that decide a worker's bits, as the
    parent has them: a spawned child starts from torch's defaults."""
    return {"deterministic": torch.are_deterministic_algorithms_enabled(),
            "deterministic_warn_only": torch.is_deterministic_algorithms_warn_only_enabled(),
            "float32_matmul_precision": torch.get_float32_matmul_precision(),
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "num_threads": torch.get_num_threads()}


def apply_torch_flags(flags: dict) -> None:
    torch.use_deterministic_algorithms(flags["deterministic"],
                                       warn_only=flags["deterministic_warn_only"])
    torch.set_float32_matmul_precision(flags["float32_matmul_precision"])
    torch.backends.cudnn.allow_tf32 = flags["cudnn_allow_tf32"]
    torch.set_num_threads(flags["num_threads"])


def _device_report(device) -> dict:
    """Kernel launches since the command began, and the process's peak
    device memory (None off the card)."""
    from repro_torch.kernels import ops

    peak = (torch.cuda.max_memory_allocated(device)
            if device is not None and device.type == "cuda" else None)
    return {"launches": ops.launch_counts(), "max_memory_allocated": peak}


def _error_reply(store: FileStore, s: int, r: int, e: Exception, **extra) -> dict:
    """Poison the store for the peers and describe ``e`` for the parent."""
    store.mark_dead((s, r))
    store.abort(e)
    return {"error": {"type": type(e).__name__, "msg": str(e),
                      "traceback": traceback.format_exc(), **extra}}


def _fault_delta(state, report) -> Optional[dict]:
    """What the step consumed of the fault schedule, and its retries: the
    parent keeps the authoritative once-only schedule across workers and
    replays."""
    out: dict = {}
    if state is not None:
        out["remaining"] = dict(state.remaining)
        out["fired"] = sorted(state.fired)
    if report is not None:
        out["retries"] = report.retries
        out["recovery_s"] = report.recovery_s
    return out or None


class _InjectorView:
    """What ``FaultyWorkerContext`` reads off its injector, mirrored from the
    parent's ``FaultInjector`` for one step."""

    def __init__(self, plan, k: int, age: int):
        self.plan = plan
        self.current_step = k
        self.age = age
        self._lifetime_noted = True     # the parent counts "lifetime"


def _faulty(ctx, cmd: dict, s: int, r: int):
    """Wrap the step's context in the parent's fault schedule and retry
    policy; returns (context, schedule state, retry report)."""
    from repro_torch.serverless import faults as F

    state = report = None
    fp = cmd.get("fault")
    if fp is not None:
        plan = F.FaultPlan(events=tuple(F.FaultEvent.from_dict(e) for e in fp["events"]),
                           lifetime_steps=fp["lifetime_steps"])
        state = F._PlanState(plan, None)            # the parent owns the report
        state.remaining = {int(i): n for i, n in fp["remaining"].items()}
        state.fired = set(fp["fired"])
        ctx = F.FaultyWorkerContext(ctx, state, s, r, _InjectorView(plan, cmd["k"], fp["age"]))
    if cmd.get("retry") is not None:
        report = F.FaultReport()
        ctx = F.ResilientContext(ctx, cmd["retry"], report)
    return ctx, state, report


def _tracer(cmd: dict, s: int, r: int, phase: str):
    """The command's span recorder, its wall-clock tracer and their clock
    (``time.monotonic()`` less the parent's ``t0``: one clock across the
    processes); with a CUDA context the recorder's anchor event is recorded
    now, on this process's idle device (its last command ended in a
    synchronisation).  (None, None, None) when the command is untraced."""
    if not cmd["trace"]:
        return None, None, None
    from repro_torch.obs.schema import SpanRecorder
    from repro_torch.serverless.backends.local import device_event

    t0 = cmd["t0"]

    def clock() -> float:
        return time.monotonic() - t0

    rec = SpanRecorder()
    tracer = rec.tracer(s, r)
    tracer.step = cmd["trace_step"]
    tracer.phase = phase
    event = device_event(synchronize=True)
    if event is not None:
        rec.anchor = (event, clock())
    return rec, tracer, clock


def _spans(rec, resolve: bool = True) -> list:
    """The command's spans as dicts, with ``resolve`` each compute span's
    device interval stamped (the device has finished the command's work;
    a failed command's spans go without, as its device may have faulted)."""
    if rec is None:
        return []
    if resolve:
        rec.resolve()
    return [sp.to_dict() for sp in rec.spans]


def _drive(gen, sync) -> None:
    """Run a worker program to its end, answering each ``("sync", vector)``
    yield with ``sync(vector)``."""
    try:
        y = next(gen)
        while True:
            y = gen.send(sync(y[1])) if isinstance(y, tuple) and y[0] == "sync" else next(gen)
    except StopIteration:
        return


def _run_step(conn, store: FileStore, s: int, r: int, agg, worker, cmd) -> None:
    """Drive one training step's program locally; reply ok or error."""
    from repro_torch.kernels import ops
    from repro_torch.serverless.backends.local import LocalWorkerContext
    from repro_torch.serverless.runtime.engine import _worker_step_program
    from repro_torch.serverless.runtime.scatter_reduce import local_scatter_reduce

    k, d = cmd["k"], agg.d
    barrier = FileBarrier(store, f"k{k}-s{s}", d, r, store.timeout) if d > 1 else None
    losses: dict = {}
    sync_s = []
    rec, tracer, clock = _tracer(cmd, s, r, "fwd")

    def sync(vec):
        if tracer is not None:
            tracer.phase = "sync"
        t0 = time.monotonic()
        reduced = local_scatter_reduce(store, r, d, agg.s_stage[s], vec,
                                       key_prefix=f"k{k}/sync{s}",
                                       pipelined=cmd["pipelined"], barrier=barrier,
                                       tracer=tracer, clock=clock)
        sync_s.append(time.monotonic() - t0)
        return reduced

    from repro_torch.serverless import faults as F

    ops.reset_launch_counts()
    device = None if worker is None else worker.device
    ctx, state, report = _faulty(
        LocalWorkerContext(store, worker=(s, r), tracer=tracer, clock=clock), cmd, s, r)
    try:
        _drive(_worker_step_program(ctx, k=k, s=s, r=r, agg=agg, worker=worker,
                                    batch=from_wire(cmd["batch"]), losses=losses), sync)
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)   # a launch's fault surfaces here
        reply = {"ok": True, "sync_s": sum(sync_s), "loss": losses.get((s, r)),
                 "spans": _spans(rec), "fault": _fault_delta(state, report),
                 **_device_report(device)}
    except F.WorkerCrashed as e:
        # a function's real death: poison the store so the peers fail over,
        # send the dying report (the pipe keeps it past the death), then die
        # (SIGKILL for a crash, a planned exit for the lifetime cap)
        store.mark_dead((s, r))
        store.abort(e)
        conn.send({"dying": {"kind": e.kind, "msg": str(e), "step": k,
                             "spans": _spans(rec, resolve=False),
                             "fault": _fault_delta(state, report)}})
        if e.kind == "lifetime":
            os._exit(EXIT_LIFETIME)
        os.kill(os.getpid(), signal.SIGKILL)
    except Exception as e:  # noqa: BLE001 - shipped to the parent
        reply = _error_reply(store, s, r, e, spans=_spans(rec, resolve=False),
                             fault=_fault_delta(state, report))
    conn.send(reply)


def _run_serve(conn, store: FileStore, s: int, r: int, cmd) -> None:
    """Drive one serving request's stage program locally over the shared
    store (the blocking takes order the pipeline); the head stage replies
    with the greedy tokens [B, n_new]."""
    from repro_torch.kernels import ops
    from repro_torch.models.common import resolve_device
    from repro_torch.serverless.backends.local import LocalWorkerContext
    from repro_torch.serving.engine import serve_worker_program
    from repro_torch.serving.worker import ServeStageWorker

    ops.reset_launch_counts()
    tracer = None

    def on_decode() -> None:
        if tracer is not None:
            tracer.phase = "decode"

    try:
        dev = resolve_device(cmd["device"])      # no card: raise, never the CPU
        spec = store.unstash(cmd["spec"], dev)
        # after the unstash, which makes this process's CUDA context: the
        # recorder's anchor event needs one
        rec, tracer, clock = _tracer(cmd, s, r, "prefill")
        span = spec["span"]
        sworker = ServeStageWorker(spec["cfg"], span, spec["params"],
                                   s_ctx=spec["s_ctx"], use_kernels=spec["use_kernels"])
        head = span.index == span.n_stages - 1
        sink: list = []
        _drive(serve_worker_program(
            LocalWorkerContext(store, worker=(s, r), tracer=tracer, clock=clock),
            s=s, S=span.n_stages, worker=sworker,
            toks=torch.tensor(spec["toks"], device=dev), n_new=spec["n_new"],
            sink=sink if head else None, on_decode=on_decode), sync=None)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        reply = {"ok": True, "tokens": to_wire(torch.cat(sink, dim=1)) if head else None,
                 "spans": _spans(rec), **_device_report(dev)}
    except Exception as e:  # noqa: BLE001 - shipped to the parent
        reply = _error_reply(store, s, r, e)
    conn.send(reply)


def worker_main(conn, init: dict) -> None:
    """Child-process entrypoint (the ``multiprocessing`` spawn target): apply
    the parent's torch settings, take the exec spec from the pipe, build the
    stage worker, start heartbeating, then serve commands until told to
    exit."""
    apply_torch_flags(init["torch_flags"])
    s, r = init["s"], init["r"]
    store = FileStore(init["root"], timeout=init["get_timeout"],
                      lease_timeout=init["lease_timeout"],
                      payload_true=init["payload_true"],
                      bandwidth=init["bandwidth"], t_lat=init["t_lat"])
    # liveness from a daemon thread, not from op progress: a long first
    # build or launch must not look like death; a killed process stops the
    # thread with it, freezing the mtime, which is the lease going stale
    stop = threading.Event()

    def beat() -> None:
        while not stop.is_set():
            store.heartbeat((s, r))
            stop.wait(init["lease_timeout"] / 4.0)

    threading.Thread(target=beat, daemon=True, name=f"heartbeat-s{s}r{r}").start()

    worker = None
    es = None
    ship = conn.recv()

    def build():
        from repro_torch.serverless.runtime.worker import StageWorker

        return StageWorker(es["cfg"], es["span"], es["params"], mu=es["mu"],
                           optimizer=es["optimizer"], remat=es["remat"],
                           use_kernels=es["use_kernels"], device=dev,
                           replicas=es["replicas"])

    if ship["exec_spec"] is not None:
        from repro_torch.models.common import resolve_device

        try:
            dev = resolve_device(ship["device"])    # no card: raise, never the CPU
            es = store.unstash(ship["exec_spec"], dev)
            worker = build()
        except Exception as e:  # noqa: BLE001 - shipped to the parent
            conn.send(_error_reply(store, s, r, e))
            return
        if not ship.get("keep_initial"):
            es = None       # only a fault-tolerant run resets to its initial params
    conn.send({"ready": [s, r]})

    while True:
        try:
            cmd = conn.recv()
        except EOFError:        # the parent went away: nothing left to serve
            return
        op = cmd["op"]
        if op == "exit":
            return
        if op == "step":
            _run_step(conn, store, s, r, init["agg"], worker, cmd)
        elif op == "serve":
            _run_serve(conn, store, s, r, cmd)
        else:
            # the worker's state: its params, its checkpoint surface
            try:
                if op == "params":
                    reply = {"path": store.stash(f"params-s{s}r{r}", worker.params)}
                elif op == "state_spec":
                    reply = {"spec": tree_map(lambda a: [list(a.shape), str(a.dtype)
                                                         .removeprefix("torch.")],
                                              worker.export_state())}
                elif op == "export_state":
                    reply = {"path": store.stash(f"export-s{s}r{r}", worker.export_state())}
                elif op == "load_state":
                    worker.load_state(store.unstash(cmd["path"], worker.device))
                    reply = {"ok": True}
                elif op == "reset":
                    worker = build()
                    reply = {"ok": True}
                else:
                    raise ValueError(f"unknown worker op {op!r}")
            except Exception as e:  # noqa: BLE001 - shipped to the parent
                reply = {"error": {"type": type(e).__name__, "msg": str(e),
                                   "traceback": traceback.format_exc()}}
            conn.send(reply)
