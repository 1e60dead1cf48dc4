"""Process-parallel execution backend: the plan's ``S x d`` stage workers as
spawned OS processes over the file-backed
:class:`~repro_torch.serverless.backends.process_worker.FileStore`
(``repro.serverless.backends.process`` for the port).

Each child has its own interpreter and, on a card, its own CUDA context;
the children exchange every object through files, and their liveness is
filesystem truth (heartbeat mtimes, dead markers, a poison file).  The
engine cooperates through the ``hosts_programs`` hooks: ``bind_run`` gives
the execution spec before ``open`` (each child is shipped only the entries
of ``init_params`` its stage reads, through a file: bulk data never rides
the pipes), ``stage_step`` ships each step's batch, and ``worker_handles`` hands the engine RPC proxies whose
``.params`` assemble the final params.  The acceptance bar is the other
backends': trained params bit-identical to ``emulated`` on both sync
schedules, the store drained.

Children are spawned, never forked (the parent may hold a CUDA context and
threads).  A child asked for ``cuda`` where there is none raises; a child
whose kernel fails to build or launch reports the error and the run
raises.  Faults have teeth here: a chaos run's injected crash SIGKILLs the
child (its heartbeat mtime freezes and its peers fail over), a lifetime-cap
kill exits it with :data:`EXIT_LIFETIME`, and ``recover`` waits for each
dead child to be reaped (its device context released with its file
descriptors) before it spawns the replacement.  Each step's reply carries the child's kernel launches and peak
device memory (:attr:`ProcessBackend.reports`) and, with a recorder
attached, the child's wall-clock spans, which the parent appends to it.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.serverless.backends.base import (
    ExecutionBackend,
    StepTiming,
    WorkerProgram,
)
from repro_torch.serverless.backends.local import (
    DEFAULT_GET_TIMEOUT,
    LocalWorkerContext,
    _primary_error,
)
from repro_torch.serverless.backends.process_worker import (
    EXIT_LIFETIME,
    FileStore,
    torch_flags,
    worker_main,
)
from repro_torch.serverless.runtime.store import (
    ProducerDeadError,
    StoreAbortedError,
    StoreStats,
    from_wire,
    to_wire,
)

# a producer process whose heartbeat mtime is older than this is dead;
# generous against the thread backend's 5 s: child heartbeats ride a daemon
# thread, but process scheduling and first kernel loads add real jitter
DEFAULT_PROCESS_LEASE = 20.0

# S x d OS processes, each importing torch (and on a card holding a CUDA
# context): beyond this the host benchmarks its scheduler and memory
MAX_PROCESSES = 64

#: slack the parent's collect loop grants past the store's get timeout
#: before it declares a command wedged
_COLLECT_SLACK = 60.0

#: how long a child may take to import torch and build its stage worker
_READY_TIMEOUT = 300.0

#: how long recover() waits for a dead child to be reaped before respawning
_REAP_TIMEOUT = 60.0


def _errors_by_name() -> Dict[str, Any]:
    from repro_torch.serverless import faults as F

    return {"WorkerCrashed": F.WorkerCrashed,
            "TransientStoreError": F.TransientStoreError,
            "FaultToleranceExceeded": F.FaultToleranceExceeded,
            "StoreAbortedError": StoreAbortedError,
            "ProducerDeadError": ProducerDeadError,
            "TimeoutError": TimeoutError,
            "BrokenBarrierError": threading.BrokenBarrierError}


def _reconstruct_error(w: Tuple[int, int], body: dict) -> BaseException:
    """A child's reported error as an exception of the parent: the liveness
    and fault types as themselves (so the engine's recovery classifies them
    and the primary error outranks the collateral), the rest as a
    RuntimeError carrying the child's traceback."""
    cls = _errors_by_name().get(body["type"])
    if cls is not None:
        return cls(body["msg"])
    return RuntimeError(f"worker process s{w[0]}r{w[1]} failed with {body['type']}: "
                        f"{body['msg']}\n{body.get('traceback', '')}")


class ProcessWorkerHandle:
    """RPC proxy for one child's stage worker: ``.span``, ``.params`` (the
    params alone, as CPU tensors), and the checkpoint surface
    ``export_state``/``state_like``/``load_state``/``reset``; state crosses
    through a stash file, and each read is memoized per state of the
    child.  ``load_state`` returns once the command is sent: the replicas of
    a stage read their state at once, and the next command to any child
    first collects the replies."""

    def __init__(self, backend: "ProcessBackend", s: int, r: int, span):
        self._backend = backend
        self._w = (s, r)
        self.span = span
        self._cache: Dict[str, Tuple[int, dict]] = {}
        self._like: Optional[dict] = None

    def _read(self, op: str) -> dict:
        gen = self._backend._generation
        hit = self._cache.get(op)
        if hit is None or hit[0] != gen:
            reply = self._backend._rpc(self._w, {"op": op})
            hit = self._cache[op] = (gen, FileStore.unstash(reply["path"], "cpu", remove=True))
        return hit[1]

    @property
    def params(self) -> dict:
        return self._read("params")

    def export_state(self) -> dict:
        """The child's params, fp32 masters and moments, as CPU tensors."""
        return self._read("export_state")

    def state_like(self) -> dict:
        """Uninitialised CPU tensors of the state's shapes and dtypes (a
        restore's target): the child sends the layout alone, once."""
        if self._like is None:
            from repro_torch.models.common import tree_map

            spec = self._backend._rpc(self._w, {"op": "state_spec"})["spec"]
            # a [shape, dtype] pair is a leaf: tree_map descends dicts and tuples
            self._like = tree_map(lambda t: torch.empty(t[0], dtype=getattr(torch, t[1])), spec)
        return self._like

    def load_state(self, state: dict) -> None:
        b = self._backend
        b._send(self._w, {"op": "load_state", "path": b._stash_state(self._w[0], state)})
        self._cache.clear()

    def reset(self) -> None:
        """Back to the initial state (a crash before the first checkpoint)."""
        self._backend._rpc(self._w, {"op": "reset"})
        self._cache.clear()


class ProcessBackend(ExecutionBackend):
    """S x d worker OS processes over a file store."""

    name = "process"
    wall_clock = True
    hosts_programs = True

    def __init__(self, *, root: Optional[str] = None,
                 get_timeout: float = DEFAULT_GET_TIMEOUT,
                 lease_timeout: float = DEFAULT_PROCESS_LEASE,
                 payload_true: bool = False, throttle: bool = False,
                 bandwidth: Optional[float] = None):
        self.root = root
        self.get_timeout = get_timeout
        self.lease_timeout = lease_timeout
        self.payload_true = payload_true
        self.throttle = throttle
        self.bandwidth = bandwidth      # override; default agg.w[s]
        self.agg = None
        self.store: Optional[FileStore] = None
        self._root: Optional[str] = None
        self._owns_root = False
        self._t0 = 0.0
        self._generation = 0            # bumps invalidate handle caches
        self._steps_done = 0
        self._procs: Dict[Tuple[int, int], Any] = {}
        self._conns: Dict[Tuple[int, int], Any] = {}
        self._dead: Dict[Tuple[int, int], str] = {}    # worker -> death kind
        self._handles: Optional[list] = None
        self._execution = None
        self._spans = None
        self._tolerance = None
        self._injector = None
        self._batch = None
        self._losses: Optional[Dict] = None
        self._state_stash: Optional[Tuple[Any, str]] = None   # (state, its file)
        self._unanswered: List[Tuple[Tuple[int, int], str]] = []
        #: per command (each step, each serve request), per worker: its
        #: kernel launches during the command and its peak device memory
        self.reports: List[Dict[Tuple[int, int], dict]] = []

    # ------------------------------------------------------- run cooperation
    def bind_run(self, *, execution=None, config=None, tolerance=None,
                 report=None, injector=None) -> None:
        """``injector`` (a ``FaultInjector`` wrapping this backend) holds the
        authoritative once-only schedule: each step ships its state to the
        children and merges back what fired; the children's retries reach
        the run's report through it."""
        del report
        self._execution = execution
        self._tolerance = tolerance
        self._injector = injector
        self._spans = None
        if execution is not None:
            from repro_torch.serverless.runtime.worker import stage_instance_ranges

            self._spans = stage_instance_ranges(execution.cfg, config.x)

    def stage_step(self, k: int, *, batch=None, losses=None) -> None:
        self._batch = to_wire(batch)
        self._losses = losses

    def worker_handles(self) -> List[List[ProcessWorkerHandle]]:
        if self._handles is None:
            self._handles = [[ProcessWorkerHandle(self, s, r, self._spans[s])
                              for r in range(self.agg.d)] for s in range(self.agg.S)]
        else:
            # the engine rebuilding from scratch (a crash before the first
            # checkpoint): every child reloads its initial state
            for row in self._handles:
                for h in row:
                    h.reset()
        return self._handles

    # -------------------------------------------------------------- lifecycle
    def open(self, agg) -> None:
        if os.name != "posix":
            raise RuntimeError(
                "the process backend needs POSIX file locks and signals; "
                "replay this plan on 'local' or 'emulated' instead")
        if agg.S * agg.d > MAX_PROCESSES:
            raise ValueError(
                f"plan spawns {agg.S}x{agg.d}={agg.S * agg.d} worker "
                f"processes; the process backend caps at {MAX_PROCESSES} "
                "— replay this plan on the emulated backend instead")
        self.agg = agg
        self._owns_root = self.root is None
        self._root = self.root or tempfile.mkdtemp(prefix="funcpipe-procstore-")
        # the parent's client is unthrottled: it moves only engine-owned
        # objects, which a platform's control plane writes
        self.store = FileStore(self._root, timeout=self.get_timeout,
                               lease_timeout=self.lease_timeout,
                               payload_true=self.payload_true)
        self._t0 = time.monotonic()
        self._generation += 1
        self._steps_done = 0
        self._procs.clear()
        self._conns.clear()
        self._dead.clear()
        self._unanswered = []
        self._handles = None
        self.reports = []
        ex = self._execution
        if ex is not None and ex.use_kernels and torch.device(ex.device).type == "cuda":
            # built once here: the children load the finished libraries
            from repro_torch.kernels import build as kernel_build

            kernel_build.build_all()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()    # the children need the card's memory
        workers = [(s, r) for s in range(agg.S) for r in range(agg.d)]
        self._start(workers)

    def _start(self, workers) -> None:
        """Spawn ``workers`` (they import torch meanwhile), stash each
        stage's spec in a file once, and send each child its path."""
        for w in workers:
            self._spawn(*w)
        ex = self._execution
        specs: Dict[int, Optional[str]] = {}
        for s, r in workers:
            if s not in specs:
                specs[s] = None if ex is None else self.store.stash(
                    f"spec-s{s}", self._exec_spec(s))
            # a fault-tolerant run's child keeps its initial params for reset
            self._conns[(s, r)].send({"exec_spec": specs[s],
                                      "device": None if ex is None else str(ex.device),
                                      "keep_initial": self._tolerance is not None})
        self._await_ready(workers)
        for path in specs.values():
            if path is not None:
                os.remove(path)

    def _exec_spec(self, s: int) -> dict:
        from repro_torch.serverless.runtime.worker import stage_share

        ex, span = self._execution, self._spans[s]
        return {"cfg": ex.cfg, "span": span,
                "params": stage_share(ex.cfg, span, ex.init_params),
                "mu": int(self.agg.mu), "replicas": int(self.agg.d),
                "optimizer": ex.optimizer, "remat": ex.remat, "use_kernels": ex.use_kernels}

    def _spawn(self, s: int, r: int) -> None:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")   # no forked CUDA context or threads
        parent_conn, child_conn = ctx.Pipe()
        bw = (self.bandwidth or float(self.agg.w[s])) if self.throttle else None
        init = {"root": self._root, "s": s, "r": r, "agg": self.agg,
                "get_timeout": self.get_timeout, "lease_timeout": self.lease_timeout,
                "payload_true": self.payload_true, "bandwidth": bw,
                "t_lat": float(self.agg.t_lat), "torch_flags": torch_flags()}
        p = ctx.Process(target=worker_main, args=(child_conn, init),
                        name=f"funcpipe-s{s}r{r}", daemon=True)
        # the S x d children each run torch's OpenMP pool on the host's
        # cores; pools that spin between parallel regions starve each other
        # (a CPU step of the test plan ran many times slower), so unless
        # the caller chose, the children's pools sleep when idle.  OpenMP
        # reads this when torch loads, before worker_main runs.
        chosen = "OMP_WAIT_POLICY" in os.environ
        os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
        try:
            p.start()
        finally:
            if not chosen:
                del os.environ["OMP_WAIT_POLICY"]
        child_conn.close()
        self._procs[(s, r)] = p
        self._conns[(s, r)] = parent_conn

    def _await_ready(self, workers) -> None:
        deadline = time.monotonic() + _READY_TIMEOUT
        for w in workers:
            while not self._conns[w].poll(0.2):
                if not self._procs[w].is_alive():
                    raise RuntimeError(
                        f"worker process s{w[0]}r{w[1]} died during spawn "
                        f"(exit code {self._procs[w].exitcode})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"worker process s{w[0]}r{w[1]} never reported ready")
            try:
                msg = self._conns[w].recv()
            except EOFError:
                self._procs[w].join(timeout=5.0)
                raise RuntimeError(
                    f"worker process s{w[0]}r{w[1]} died during spawn "
                    f"(exit code {self._procs[w].exitcode})") from None
            if "error" in msg:
                raise _reconstruct_error(w, msg["error"])
            if "ready" not in msg:
                raise RuntimeError(f"worker process s{w[0]}r{w[1]} answered {msg!r}")

    def _send(self, w: Tuple[int, int], cmd: dict) -> None:
        """Send a command whose reply the next command collects."""
        self._conns[w].send(cmd)
        self._unanswered.append((w, cmd["op"]))

    def _reply(self, w: Tuple[int, int], op: str) -> dict:
        conn = self._conns[w]
        if not conn.poll(self.get_timeout + _COLLECT_SLACK):
            raise TimeoutError(f"worker s{w[0]}r{w[1]} did not answer {op!r}")
        reply = conn.recv()
        if "error" in reply:
            raise _reconstruct_error(w, reply["error"])
        return reply

    def _collect(self) -> None:
        """The replies of the commands sent ahead (``load_state``)."""
        pending, self._unanswered = self._unanswered, []
        for w, op in pending:
            self._reply(w, op)

    def _rpc(self, w: Tuple[int, int], cmd: dict) -> dict:
        self._collect()
        self._conns[w].send(cmd)
        return self._reply(w, cmd["op"])

    def _clock(self) -> float:
        return time.monotonic() - self._t0

    def context(self, s: int, r: int) -> LocalWorkerContext:
        # parent-side contexts carry engine traffic only (checkpoint writes
        # and restore reads); worker=None: the parent must not renew a
        # child's lease
        if self.recorder is None:
            return LocalWorkerContext(self.store)
        tr = self.recorder.tracer(s, r)
        tr.step = self._steps_done
        tr.phase = "fwd"
        return LocalWorkerContext(self.store, tracer=tr, clock=self._clock)

    @property
    def store_stats(self) -> StoreStats:
        return self.store.stats

    def _store_for_verification(self):
        return self.store

    # ------------------------------------------------------------- commands
    def _stash_state(self, s: int, state: dict) -> str:
        """The file of a stage state for ``load_state``: the engine restores
        every replica of a stage from one state, written once."""
        held = self._state_stash
        if held is not None and held[0] is state:
            return held[1]
        self._drop_state_stash()
        path = self.store.stash(f"state-s{s}", state)
        self._state_stash = (state, path)
        return path

    def _drop_state_stash(self) -> None:
        self._collect()                 # the children have read it
        if self._state_stash is not None:
            with contextlib.suppress(FileNotFoundError):
                os.remove(self._state_stash[1])
            self._state_stash = None

    # ---------------------------------------------------------- fault state
    def _fault_payload(self) -> Optional[dict]:
        """The injector's once-only schedule as the children need it."""
        inj = self._injector
        if inj is None:
            return None
        return {"events": [e.to_dict() for e in inj.plan.events],
                "lifetime_steps": inj.plan.lifetime_steps,
                "remaining": dict(inj.state.remaining),
                "fired": sorted(inj.state.fired),
                "age": inj.age}

    def _merge_fault(self, delta: Optional[dict]) -> None:
        """Fold a child's fault consumption back into the parent's injector
        (the authoritative schedule), count what fired, and add the child's
        retries to the run's report."""
        inj = self._injector
        if delta is None or inj is None:
            return
        state = inj.state
        for i, rem in delta.get("remaining", {}).items():
            i = int(i)
            spent = state.remaining.get(i, 0) - rem
            if spent > 0:
                state.remaining[i] = rem
                for _ in range(spent):
                    state._note("transient")
        for i in delta.get("fired", ()):
            if i not in state.fired:
                state.fired.add(i)
                state._note(inj.plan.events[i].kind)
        if state.report is not None:
            state.report.retries += delta.get("retries", 0)
            state.report.recovery_s += delta.get("recovery_s", 0.0)

    def _note_lifetime(self) -> None:
        inj = self._injector
        if inj is None or inj._lifetime_noted:
            return
        inj._lifetime_noted = True
        if inj.state.report is not None:
            inj.state.report.count_injected("lifetime")

    def _on_death(self, w: Tuple[int, int], what: str, errors: list, k: Optional[int] = None,
                  had_dying_msg: bool = False) -> None:
        """A child died: reap it, classify the death by its exit code, mark
        it dead and poison the store for its peers.  During a training step
        the error is the ``WorkerCrashed`` the engine's recovery expects."""
        from repro_torch.serverless import faults as F

        p = self._procs[w]
        p.join(timeout=5.0)
        kind = "lifetime" if p.exitcode == EXIT_LIFETIME else "crash"
        self._dead[w] = kind
        self.store.mark_dead(w)
        s, r = w
        if kind == "lifetime":
            self._note_lifetime()
            msg = (f"worker (stage {s}, replica {r}) exceeded the function lifetime cap: "
                   f"the platform recycled its process (exit {EXIT_LIFETIME})")
        else:
            msg = (f"worker process (stage {s}, replica {r}) died during {what} "
                   f"(exit code {p.exitcode})")
            if not had_dying_msg and k is not None and self._injector is not None:
                # the dying report died with the process: consume the crash
                # event it fired so the replay does not fire it again
                state = self._injector.state
                for i, e in enumerate(self._injector.plan.events):
                    if (e.kind == "crash" and i not in state.fired and e.stage == s
                            and e.replica == r and e.step == k):
                        state.fired.add(i)
                        state._note("crash")
                        break
        err = (F.WorkerCrashed(msg, stage=s, replica=r, step=k, kind=kind)
               if k is not None else RuntimeError(msg))
        self.store.abort(err)
        if not had_dying_msg:
            errors.append(err)

    def _absorb(self, w: Tuple[int, int], msg: dict, k: Optional[int], errors: list,
                replies: dict) -> bool:
        """One child message; True when the worker is accounted for."""
        if "ready" in msg:                  # a stale handshake
            return False
        if "dying" in msg:
            from repro_torch.serverless import faults as F

            d = msg["dying"]
            self._merge_fault(d.get("fault"))
            if d["kind"] == "lifetime":
                self._note_lifetime()
            errors.append(F.WorkerCrashed(d["msg"], stage=w[0], replica=w[1], step=k,
                                          kind=d["kind"]))
            self._record({w: d})
            # the child is killing itself; reaped when it lands
            self._dead[w] = d["kind"]
            self._procs[w].join(timeout=5.0)
            self.store.mark_dead(w)
            return True
        if "error" in msg:
            self._merge_fault(msg["error"].get("fault"))
            self._record({w: msg["error"]})
            errors.append(_reconstruct_error(w, msg["error"]))
            return True
        self._merge_fault(msg.get("fault"))
        replies[w] = msg
        return True

    def _broadcast(self, cmds: Dict[Tuple[int, int], dict], what: str,
                   k: Optional[int] = None) -> dict:
        """Send each worker its command and collect every reply; a died or
        failed worker raises the command's primary error once all are in
        (``k``: the training step the command runs)."""
        self._collect()
        errors: list = []
        replies: dict = {}
        pending = set(cmds)
        for w in list(pending):
            try:
                self._conns[w].send(cmds[w])
            except (BrokenPipeError, OSError):
                self._on_death(w, what, errors, k)
                pending.discard(w)
        deadline = time.monotonic() + self.get_timeout + _COLLECT_SLACK
        while pending:
            progressed = False
            for w in list(pending):
                conn = self._conns[w]
                try:
                    has_msg = conn.poll(0.0)
                except (BrokenPipeError, OSError):
                    has_msg = False
                if has_msg:
                    try:
                        msg = conn.recv()
                    except EOFError:
                        self._on_death(w, what, errors, k, had_dying_msg=w in self._dead)
                        pending.discard(w)
                    else:
                        if self._absorb(w, msg, k, errors, replies):
                            pending.discard(w)
                    progressed = True
                elif not self._procs[w].is_alive() and not conn.poll(0.0):
                    self._on_death(w, what, errors, k, had_dying_msg=w in self._dead)
                    pending.discard(w)
                    progressed = True
            if pending and not progressed:
                if time.monotonic() > deadline:
                    who = ", ".join(f"s{s}r{r}" for s, r in sorted(pending))
                    raise TimeoutError(
                        f"{what} wedged: no reply from worker processes [{who}] "
                        f"within {self.get_timeout + _COLLECT_SLACK:.0f}s")
                time.sleep(0.01)
        self._generation += 1
        self.reports.append({w: {"launches": m["launches"],
                                 "max_memory_allocated": m["max_memory_allocated"]}
                             for w, m in replies.items()})
        if errors:
            raise _primary_error(errors)
        return replies

    def _trace_fields(self, step: int) -> dict:
        """What a child needs to trace a command: the flag, the step its
        spans carry and the parent's ``t0`` (a clock shared by the
        processes: ``time.monotonic``)."""
        return {"trace": self.recorder is not None, "trace_step": step, "t0": self._t0}

    def _record(self, replies: dict) -> None:
        """Append the children's spans to the recorder, worker by worker."""
        if self.recorder is not None:
            from repro_torch.obs.schema import Span

            for w in sorted(replies):
                self.recorder.spans.extend(Span.from_dict(d)
                                           for d in replies[w].get("spans") or ())

    def run_step(self, k: int, programs: Dict[Tuple[int, int], WorkerProgram],
                 *, pipelined_sync: bool = True) -> StepTiming:
        self._drop_state_stash()
        # the engine's generators cannot cross the process boundary: each
        # child runs the same program locally, so these never start
        for gen in programs.values():
            gen.close()
        cmd = {"op": "step", "k": k, "pipelined": bool(pipelined_sync), "batch": self._batch,
               "fault": self._fault_payload(),
               "retry": None if self._tolerance is None else self._tolerance.retry,
               **self._trace_fields(k)}
        replies = self._broadcast(dict.fromkeys(self._conns, cmd), f"step {k}", k=k)
        self._record(replies)
        for (s, r), msg in replies.items():
            if msg["loss"] is not None and self._losses is not None:
                self._losses[(s, r)] = tuple(msg["loss"])
        self._steps_done += 1
        return StepTiming(end=time.monotonic() - self._t0,
                          sync=max(msg["sync_s"] for msg in replies.values()))

    def serve(self, spec: dict) -> torch.Tensor:
        """Run one pipelined serving request (``repro_torch.serving``) on
        every stage worker.  ``spec`` holds ``cfg``, ``x``, the full
        ``params``, the prompt ``toks``, ``n_new``, ``s_ctx``,
        ``use_kernels`` and ``device``; each child gets its stage's share of
        the params and drives its serving program over the shared store.
        Returns the head stage's greedy tokens [B, n_new] on the CPU."""
        from repro_torch.serverless.runtime.worker import stage_instance_ranges, stage_share

        spans = stage_instance_ranges(spec["cfg"], spec["x"])
        base = {k: v for k, v in spec.items() if k not in ("params", "x", "device")}
        paths = {s: self.store.stash(f"serve-s{s}", {
                     **base, "span": spans[s],
                     "params": stage_share(spec["cfg"], spans[s], spec["params"])})
                 for s in {s for s, _ in self._conns}}
        try:
            replies = self._broadcast(
                {(s, r): {"op": "serve", "spec": paths[s], "device": spec["device"],
                          **self._trace_fields(0)}
                 for s, r in self._conns}, "serve request")
        finally:
            for path in paths.values():
                os.remove(path)
        self._record(replies)
        tokens = [m["tokens"] for m in replies.values() if m["tokens"] is not None]
        if len(tokens) != 1:
            raise RuntimeError(f"serve request produced {len(tokens)} token sinks, not 1")
        return from_wire(tokens[0], "cpu")

    # ------------------------------------------------------------- recovery
    def recover(self) -> int:
        """Revive the poisoned store, purge residual non-checkpoint objects
        (counted) and the barrier files, and respawn only the dead worker
        processes: what a Function Manager relaunching failed functions
        does.  Survivors keep their built workers and are re-stated by the
        engine through ``load_state``/``reset``.  A dead child is reaped
        (``Process.join``: the kernel has closed its file descriptors, the
        card's device files among them, which releases its CUDA context)
        before its replacement spawns and builds a context of its own."""
        self.store.revive()
        shutil.rmtree(self.store.barriers_root, ignore_errors=True)
        os.makedirs(self.store.barriers_root, exist_ok=True)
        purged = super().recover()
        dead = sorted(self._dead)
        self._dead.clear()
        for w in dead:
            self._conns[w].close()
            self._procs[w].join(timeout=_REAP_TIMEOUT)
            if self._procs[w].is_alive():
                raise RuntimeError(f"dead worker process s{w[0]}r{w[1]} was not reaped "
                                   f"within {_REAP_TIMEOUT:.0f}s")
        if dead:
            self._start(dead)
        self._generation += 1
        return purged

    def close(self) -> None:
        self._unanswered = []
        if self.store is not None and self._state_stash is not None:
            with contextlib.suppress(FileNotFoundError):
                os.remove(self._state_stash[1])
        self._state_stash = None
        for conn in self._conns.values():
            try:
                conn.send({"op": "exit"})
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs.values():
            p.join(timeout=10.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        for conn in self._conns.values():
            conn.close()
        self._procs.clear()
        self._conns.clear()
        self._dead.clear()
        self._handles = None
        if self.store is not None and self._owns_root:
            shutil.rmtree(self._root, ignore_errors=True)
        self.store = None
