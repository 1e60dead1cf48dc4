"""Backend-agnostic span schema for pipeline tracing (``repro.obs.schema``
for the port; the substrate behind ``EngineResult.trace`` and
``ServeResult.trace``).

A :class:`Span` is one op on one worker's serial resource (a boundary
download, a micro-batch compute, an upload, a phase fence, or a closed-form
sync interval), stamped with the worker's (stage, replica), the training
step, the phase (``fwd``/``bwd``/``sync``, or ``prefill``/``decode`` when
serving) and the clock interval it occupied.  The same schema carries:

  * **virtual** spans from the emulated backend (``StageChannel`` emits one
    span per charged resource task, including every scatter-reduce chunk);
  * **wall** spans from the ``local`` and ``process`` backends (host
    ``perf_counter``/``monotonic`` intervals around the blocking store ops;
    a compute span's interval is the launch, the time its worker spent
    enqueueing the work, and on a card the span also carries the work's
    device interval, ``device_start``/``device_end``, from two CUDA events
    on the worker's stream, stamped on the same clock by
    :meth:`SpanRecorder.resolve`);
  * **predicted** spans from the JAX package's ``simulate_funcpipe``, read
    here from a saved trace, so ``repro_torch.obs.attribution`` can
    difference them cell by cell.

:class:`Trace` bundles spans + run metadata and serializes to the Chrome
Trace Event Format (the ``{"traceEvents": [...]}`` object form), so the file
loads in Perfetto / ``chrome://tracing``; the typed payload rides along
under a ``"repro"`` top-level key (viewers ignore unknown keys), which is
what ``Trace.load`` reads back.  The file format is the JAX package's byte
for byte: a trace saved by either package loads in the other.

:func:`validate_trace` enforces the schema invariants: per-(worker,
resource) spans never overlap, and phases are ordered within each (worker,
step) — all forward work ends before backward work starts, and backward
work ends before the worker's sync uploads begin (sync *downloads* may
legitimately start earlier: the pipelined collective prefetches peers'
chunks on the idle downlink).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional

# fwd/bwd/sync are the training phases (ordering-checked below); prefill and
# decode are the serving engine's phases — serving traces have no intra-step
# phase-order invariant beyond lane occupancy
PHASES = ("fwd", "bwd", "sync", "prefill", "decode")
OPS = ("download", "compute", "upload", "barrier", "sync", "retry", "restart")

# which serial worker resource a span occupies; barrier and the closed-form
# sync interval are ordering/aggregate marks, not resource occupancy.
# "retry" (backoff stall across all resources) and "restart" (checkpoint
# restore reads during recovery) are likewise whole-worker recovery marks,
# not single-lane occupancy; they are summed as recovery overhead.
RESOURCE_OF = {
    "download": "downlink",
    "compute": "cpu",
    "upload": "uplink",
    "barrier": None,
    "sync": None,
    "retry": None,
    "restart": None,
}


class TraceValidationError(ValueError):
    """A trace violates the span-schema invariants (overlapping resource
    spans, out-of-order phases, malformed fields)."""


@dataclass(frozen=True)
class Span:
    """One op on one worker's timeline (all times on the trace's clock)."""

    stage: int
    replica: int
    step: int
    phase: str                  # fwd | bwd | sync
    op: str                     # download | compute | upload | barrier | sync
    start: float
    end: float
    nbytes: float = 0.0         # modeled object size (transfers), else 0
    key: Optional[str] = None   # store key (transfers), else None
    # a wall-clock compute span's work on the card, on the same clock
    # (resolved from CUDA events); None elsewhere
    device_start: Optional[float] = None
    device_end: Optional[float] = None

    @property
    def worker(self) -> str:
        return f"s{self.stage}r{self.replica}"

    @property
    def duration(self) -> float:
        return self.end - self.start

    @property
    def device_duration(self) -> Optional[float]:
        """Seconds of the span's device interval (None without one)."""
        if self.device_start is None:
            return None
        return self.device_end - self.device_start

    @property
    def resource(self) -> Optional[str]:
        return RESOURCE_OF[self.op]

    def to_dict(self) -> dict:
        d = {"stage": self.stage, "replica": self.replica, "step": self.step,
             "phase": self.phase, "op": self.op,
             "start": self.start, "end": self.end}
        if self.nbytes:
            d["nbytes"] = self.nbytes
        if self.key is not None:
            d["key"] = self.key
        if self.device_start is not None:
            d["device_start"] = self.device_start
            d["device_end"] = self.device_end
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        dev = d.get("device_start")
        return cls(stage=int(d["stage"]), replica=int(d["replica"]),
                   step=int(d["step"]), phase=d["phase"], op=d["op"],
                   start=float(d["start"]), end=float(d["end"]),
                   nbytes=float(d.get("nbytes", 0.0)), key=d.get("key"),
                   device_start=None if dev is None else float(dev),
                   device_end=None if dev is None else float(d["device_end"]))


class WorkerTracer:
    """One worker's span emitter: bound to a (stage, replica), carrying the
    mutable step/phase state the backend driver keeps current.  ``emit`` is
    the only hot-path call; backends guard it with ``if tracer is not None``
    so untraced runs pay nothing."""

    __slots__ = ("_spans", "_pending", "stage", "replica", "step", "phase")

    def __init__(self, spans: List[Span], stage: int, replica: int,
                 pending: Optional[list] = None):
        self._spans = spans
        self._pending = pending
        self.stage = stage
        self.replica = replica
        self.step = 0
        self.phase = "fwd"

    def emit(self, op: str, start: float, end: float, *,
             nbytes: float = 0.0, key: Optional[str] = None,
             events: Optional[tuple] = None) -> None:
        """Append one span; ``events`` (the start and end CUDA events of a
        compute span's device work) wait in the recorder's ``pending`` list
        for :meth:`SpanRecorder.resolve`."""
        span = Span(
            stage=self.stage, replica=self.replica, step=self.step,
            phase=self.phase, op=op, start=float(start), end=float(end),
            nbytes=float(nbytes), key=key)
        self._spans.append(span)
        if events is not None:
            self._pending.append((span, *events))


class SpanRecorder:
    """The per-run span sink a backend fills (``ExecutionBackend.
    attach_recorder``).  One shared list; per-worker :class:`WorkerTracer`
    handles append into it (``list.append`` is atomic under the GIL, so the
    local backend's concurrent threads need no extra locking).

    On a card a compute span's CUDA events wait in ``pending`` until
    :meth:`resolve`, so tracing never waits on the device inside a step;
    ``anchor`` is ``(event, seconds)``: an event recorded on an idle device
    and its time on the trace's clock, set by the backend."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.tracers: List[WorkerTracer] = []
        self.pending: List[tuple] = []      # (span, start event, end event)
        self.anchor: Optional[tuple] = None

    def tracer(self, stage: int, replica: int) -> WorkerTracer:
        t = WorkerTracer(self.spans, stage, replica, self.pending)
        self.tracers.append(t)
        return t

    def resolve(self) -> None:
        """Stamp every pending span with its device interval: the anchor's
        time plus the anchor's elapsed time to each event.  Waits for the
        events' work to finish; a no-op with nothing pending."""
        if not self.pending:
            return
        if self.anchor is None:
            raise ValueError("device events pending but no anchor event was recorded")
        pending = list(self.pending)
        del self.pending[:]          # the tracers share this list
        anchor, t_anchor = self.anchor
        for _, _, end in pending:
            end.synchronize()

        def at(event) -> float:
            return t_anchor + anchor.elapsed_time(event) / 1e3

        done = {id(sp): replace(sp, device_start=at(a), device_end=at(b))
                for sp, a, b in pending}
        self.spans[:] = [done.get(id(sp), sp) for sp in self.spans]

    def set_step(self, step: int) -> None:
        for t in self.tracers:
            t.step = step

    def set_phase(self, phase: str) -> None:
        for t in self.tracers:
            t.phase = phase


TRACE_SCHEMA_VERSION = 1


@dataclass
class Trace:
    """Spans + run metadata (+ optionally the simulator's predicted spans in
    the same schema), serializable as a Perfetto-loadable Chrome trace."""

    spans: List[Span] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)
    predicted: Optional[List[Span]] = None

    # ------------------------------------------------------------- payload
    def to_payload(self) -> dict:
        p = {"version": TRACE_SCHEMA_VERSION, "meta": self.meta,
             "spans": [s.to_dict() for s in self.spans]}
        if self.predicted is not None:
            p["predicted"] = [s.to_dict() for s in self.predicted]
        return p

    @classmethod
    def from_payload(cls, p: dict) -> "Trace":
        if not isinstance(p, dict):
            raise ValueError("trace payload is not a JSON object")
        version = p.get("version")
        if version != TRACE_SCHEMA_VERSION:
            raise TraceValidationError(
                f"trace schema version {version!r} != supported "
                f"{TRACE_SCHEMA_VERSION}")
        pred = p.get("predicted")
        return cls(spans=[Span.from_dict(d) for d in p.get("spans", [])],
                   meta=dict(p.get("meta", {})),
                   predicted=(None if pred is None
                              else [Span.from_dict(d) for d in pred]))

    # -------------------------------------------------------- chrome export
    _RES_TID = {"cpu": 0, "uplink": 1, "downlink": 2, None: 3}

    def chrome_events(self) -> List[dict]:
        """Trace Event Format events: pid = stage (predicted stages offset
        by 1000, device intervals by 2000), tid = replica x resource lane
        (the device's: replica), ts/dur in microseconds."""
        events: List[dict] = []
        seen_pids: Dict[int, str] = {}
        seen_tids: set = set()

        def add(spans: List[Span], pid_base: int, tag: str) -> None:
            for s in spans:
                pid = pid_base + s.stage
                if pid not in seen_pids:
                    seen_pids[pid] = f"stage {s.stage}{tag}"
                    events.append({"ph": "M", "name": "process_name",
                                   "pid": pid, "tid": 0,
                                   "args": {"name": seen_pids[pid]}})
                tid = s.replica * 4 + self._RES_TID[s.resource]
                if (pid, tid) not in seen_tids:
                    seen_tids.add((pid, tid))
                    lane = s.resource or "events"
                    events.append({"ph": "M", "name": "thread_name",
                                   "pid": pid, "tid": tid,
                                   "args": {"name": f"r{s.replica} {lane}"}})
                ev = {"ph": "X", "name": f"{s.phase}/{s.op}", "cat": s.phase,
                      "pid": pid, "tid": tid,
                      "ts": s.start * 1e6, "dur": (s.end - s.start) * 1e6,
                      "args": {"step": s.step}}
                if s.nbytes:
                    ev["args"]["bytes"] = s.nbytes
                if s.key is not None:
                    ev["args"]["key"] = s.key
                events.append(ev)

        add(self.spans, 0, "")
        if self.predicted:
            add(self.predicted, 1000, " (predicted)")
        # the compute spans' device intervals, a lane a replica under a
        # process of their own a stage
        for s in self.spans:
            if s.device_start is None:
                continue
            pid = 2000 + s.stage
            if pid not in seen_pids:
                seen_pids[pid] = f"stage {s.stage} (device)"
                events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                               "args": {"name": seen_pids[pid]}})
            if (pid, s.replica) not in seen_tids:
                seen_tids.add((pid, s.replica))
                events.append({"ph": "M", "name": "thread_name", "pid": pid,
                               "tid": s.replica, "args": {"name": f"r{s.replica} device"}})
            events.append({"ph": "X", "name": f"{s.phase}/{s.op}", "cat": s.phase,
                           "pid": pid, "tid": s.replica, "ts": s.device_start * 1e6,
                           "dur": (s.device_end - s.device_start) * 1e6,
                           "args": {"step": s.step}})
        return events

    def to_chrome_json(self, *, indent: Optional[int] = None) -> str:
        # object form of the Trace Event Format; viewers ignore the extra
        # "repro" key, Trace.load reads it back — one file serves both
        doc = {"traceEvents": self.chrome_events(),
               "displayTimeUnit": "ms",
               "repro": self.to_payload()}
        return json.dumps(doc, indent=indent)

    # ----------------------------------------------------------------- file
    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_chrome_json() + "\n")

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            doc = json.load(f)
        if "repro" in doc:
            return cls.from_payload(doc["repro"])
        return cls.from_payload(doc)   # bare payload also accepted


# ------------------------------------------------------------------ checking
def _check_no_overlap(spans: List[Span], eps: float, where: str,
                      problems: List[str]) -> None:
    ordered = sorted(spans, key=lambda s: (s.start, s.end))
    for a, b in zip(ordered, ordered[1:]):
        if b.start < a.end - eps:
            problems.append(
                f"{where}: {a.phase}/{a.op} [{a.start:.6f}, {a.end:.6f}] "
                f"overlaps {b.phase}/{b.op} [{b.start:.6f}, {b.end:.6f}]")
            return           # one report per lane is enough to fail


def validate_trace(trace: Trace, *, eps: Optional[float] = None) -> None:
    """Raise :class:`TraceValidationError` unless the trace satisfies the
    span-schema invariants (see module docstring).  ``eps`` defaults to a
    1e-9 relative slack on the trace's time extent — bit-exact virtual
    clocks pass at equality, wall clocks get timer-granularity room."""
    problems: List[str] = []
    spans = trace.spans
    t_max = max((s.end for s in spans), default=0.0)
    if eps is None:
        eps = 1e-9 * max(1.0, t_max)

    for i, s in enumerate(spans):
        if s.phase not in PHASES:
            problems.append(f"span {i}: unknown phase {s.phase!r}")
        if s.op not in OPS:
            problems.append(f"span {i}: unknown op {s.op!r}")
        if not (s.start == s.start and s.end == s.end):   # NaN
            problems.append(f"span {i}: non-finite times")
        elif s.end < s.start - eps:
            problems.append(f"span {i}: end {s.end} < start {s.start}")
        if s.nbytes < 0:
            problems.append(f"span {i}: negative nbytes {s.nbytes}")
        if problems and len(problems) >= 8:
            raise TraceValidationError("; ".join(problems))

    # per-(worker, resource) serial occupancy
    lanes: Dict[tuple, List[Span]] = {}
    for s in spans:
        if s.resource is not None:
            lanes.setdefault((s.stage, s.replica, s.resource), []).append(s)
    for (st, r, res), lane in sorted(lanes.items()):
        _check_no_overlap(lane, eps, f"worker s{st}r{r} {res}", problems)

    # per-(worker, step) phase ordering; barriers are the fences themselves
    # and span the transition, so they are exempt; sync downloads may start
    # before the worker's own bwd tail (full-duplex prefetch), so the sync
    # gate is checked against sync *uploads* only
    groups: Dict[tuple, Dict[str, List[Span]]] = {}
    for s in spans:
        if s.op == "barrier":
            continue
        groups.setdefault((s.stage, s.replica, s.step), {}) \
              .setdefault(s.phase, []).append(s)
    # a recovered run may replay a step after a mid-step fault: the same
    # (worker, step) then holds several *attempts*, sequential in time.
    # Replay leniency is earned, not assumed: only a trace that carries
    # recovery evidence (restart spans, or a fault_report recording
    # restarts) gets it — a phase-disordered ordinary trace still fails.
    fr = trace.meta.get("fault_report") or {}
    recovered = (any(s.op == "restart" for s in spans)
                 or bool(fr.get("restarts") or fr.get("planned_restarts")))
    for (st, r, k), by_phase in sorted(groups.items()):
        # within the group, a fwd span starting after bwd/sync spans were
        # seen opens a new attempt; phase ordering must hold within each
        # attempt, not across the aborted one and its replay
        ordered = sorted((s for ph in by_phase.values() for s in ph),
                         key=lambda s: (s.start, s.end))
        if recovered and any(s.op == "restart" for s in ordered):
            # the crashed step itself: its group mixes the aborted attempt,
            # the checkpoint-restore reads, and a replay whose spans virtual
            # clocks charge at per-lane free times with no causal edge to
            # the restore — phase order across that mix is meaningless.
            # Lane occupancy (above) still holds; numeric parity is the
            # real invariant for recovered steps (tests/test_faults.py).
            continue
        attempts: List[List[Span]] = [[]]
        if recovered:
            past_fwd = False
            for s in ordered:
                if s.phase == "fwd" and past_fwd:
                    attempts.append([])
                    past_fwd = False
                if s.phase in ("bwd", "sync"):
                    past_fwd = True
                attempts[-1].append(s)
        else:
            attempts[0] = ordered
        for att in attempts:
            fwd_end = max((s.end for s in att if s.phase == "fwd"),
                          default=None)
            bwd = [s for s in att if s.phase == "bwd"]
            if fwd_end is not None and bwd:
                bwd_start = min(s.start for s in bwd)
                if bwd_start < fwd_end - eps:
                    problems.append(
                        f"worker s{st}r{r} step {k}: bwd starts at "
                        f"{bwd_start:.6f} before fwd ends at {fwd_end:.6f}")
            bwd_end = max((s.end for s in bwd), default=None)
            sync_up = [s for s in att
                       if s.phase == "sync" and s.op == "upload"]
            if bwd_end is not None and sync_up:
                sync_start = min(s.start for s in sync_up)
                if sync_start < bwd_end - eps:
                    problems.append(
                        f"worker s{st}r{r} step {k}: sync upload at "
                        f"{sync_start:.6f} before bwd ends at {bwd_end:.6f}")

    if problems:
        raise TraceValidationError("; ".join(problems[:8]))
