"""Tracing inside the ``local`` backend's stage workers.

On the CPU: an untraced run enters no profiler range and reads no thread
clock; under ``torch.profiler`` every ``funcpipe/*`` range of
``repro_torch.obs.ranges`` shows, the workers' on their own threads and the
step's on the engine's; a traced run's trace validates on the wall clock,
holds the boundary waits as fwd- and bwd-phase downloads, carries each
worker's CPU seconds a step and a measured ``breakdown``; a span's device
interval round-trips, is drawn in a lane of its own, and is what
``obs.calibrate`` and ``measured_breakdown`` read.  On a card (marker
``cuda``): a traced phi3-shaped run never synchronises inside a step, a
compute span's device interval times the work it launched, and a traced
``process`` run's children, training or serving, return every compute span
with its device interval.  This file does not import jax.
"""
import dataclasses
import json
import time

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.perfmodel import Config
from repro_torch.core.profiler import arch_model_profile
from repro_torch.data.synthetic import make_batch
from repro_torch.models import registry
from repro_torch.models.common import tree_leaves
from repro_torch.obs import Span, SpanRecorder, Trace, observe_stages, validate_trace
from repro_torch.obs import ranges
from repro_torch.optim import AdamW
from repro_torch.serverless.backends import local
from repro_torch.serverless.backends.local import LocalBackend
from repro_torch.serverless.execution import ExecutionConfig
from repro_torch.serverless.platform import get_platform
from repro_torch.serverless.runtime import Execution, run_plan
from repro_torch.serverless.runtime.engine import measured_breakdown

AWS = get_platform("aws")
WAIT = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's CPU torch runs: the suite runs
    several workers on the host's cores, and torch pools of a thread a core
    each starve one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(trace, *, steps=2, backend=None, device="cpu", cfg=None, seq=16, micro_batch=2,
         batch_fn=None):
    """phi3 (reduced, 4 layers, unless ``cfg``), 2 stages x 2 replicas, 2
    micro-batches a replica, AdamW, on ``local``."""
    cfg = cfg or dataclasses.replace(get_config("phi3-mini-3.8b").reduced(), n_layers=4)
    prof = arch_model_profile(cfg, AWS, seq=seq, micro_batch=micro_batch)
    L = cfg.n_layers + 2
    x = tuple(1 if i == L // 2 - 1 else 0 for i in range(L - 1))
    params = registry.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                  device=device)
    B = 4 * micro_batch
    batches = [{k: v.to(device) for k, v in make_batch(
        cfg, InputShape("train", seq, B, "train"), seed=0, step=k, device="cpu").items()}
        for k in range(steps)]
    return run_plan(prof, AWS, Config(x=x, d=2, z=(0,) * L), 4,
                    ExecutionConfig(backend=backend or LocalBackend(lease_timeout=WAIT),
                                    steps=steps, trace=trace),
                    execution=Execution(cfg=cfg, optimizer=AdamW(lr=1e-3), init_params=params,
                                        batch_fn=batch_fn or batches.__getitem__,
                                        device=device))


def _profiler():
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


# ------------------------------------------------------------ untraced cost
def test_untraced_run_enters_no_range_and_reads_no_thread_clock(monkeypatch):
    entered, cpu_reads = [], []
    real_range, real_clock = torch.profiler.record_function, time.thread_time
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a: entered.append(name) or real_range(name, *a))
    monkeypatch.setattr(time, "thread_time", lambda: cpu_reads.append(1) or real_clock())
    assert ranges.phase_range(ranges.FWD) is ranges.phase_range(ranges.STEP)  # the no-op
    res = _run(False)
    assert entered == [] and cpu_reads == [] and res.trace is None
    assert res.breakdown == {"sync": res.breakdown["sync"]}      # nothing modelled
    traced = _run(True)
    assert entered == [] and len(cpu_reads) == 2 * 4 * 2        # start, end; 4 workers; 2 steps
    assert traced.losses == res.losses


# ------------------------------------------------------------ the ranges
def test_profiled_run_shows_every_range_on_its_thread():
    """The workers' ranges on the worker threads, the step's on the engine's
    (eq (2) with two replicas: the cleanup fence is the barrier)."""
    with _profiler() as prof:
        _run(False)
    threads: dict = {}
    for e in prof.events():
        if e.name.startswith("funcpipe/"):
            threads.setdefault(e.name, set()).add(e.thread)
    assert set(threads) == set(ranges.NAMES)
    (engine,) = threads[ranges.STEP]
    workers = set().union(*(t for n, t in threads.items() if n != ranges.STEP))
    assert engine not in workers
    assert len(threads[ranges.OPTIMIZER]) == 4 * 2     # a thread a worker and step


# ------------------------------------------------------------ the trace
def test_traced_local_trace_validates_and_carries_cpu_seconds():
    res = _run(True)
    tr = res.trace
    validate_trace(tr)
    waits = {(sp.phase, sp.stage) for sp in tr.spans if sp.op == "download"}
    assert {("fwd", 1), ("bwd", 0), ("sync", 0), ("sync", 1)} <= waits
    cpu = tr.meta["step_worker_cpu_s"]
    assert len(cpu) == 2 and all(set(c) == {"s0r0", "s0r1", "s1r0", "s1r1"} for c in cpu)
    assert all(v > 0.0 for c in cpu for v in c.values())
    assert set(res.breakdown) == {"compute", "pipeline_comm", "sync"}
    assert res.breakdown["compute"] == measured_breakdown(tr.spans)["compute"] > 0.0
    # no device here: compute spans carry their launch alone
    assert all(sp.device_start is None for sp in tr.spans)
    assert Trace.from_payload(json.loads(json.dumps(tr.to_payload()))).meta == tr.meta


# ------------------------------------------------------------ the schema
SPAN = dict(stage=1, replica=0, step=2, phase="bwd", op="compute", start=1.0, end=1.25)


@pytest.mark.parametrize("device", [None, (1.5, 2.0)], ids=["host", "device"])
def test_span_round_trips_with_and_without_device_fields(device):
    kw = {} if device is None else dict(device_start=device[0], device_end=device[1])
    sp = Span(**SPAN, **kw)
    d = sp.to_dict()
    assert Span.from_dict(d) == sp and Span.from_dict(json.loads(json.dumps(d))) == sp
    if device is None:       # the JAX package's dict, key for key
        assert d == SPAN and sp.device_duration is None
    else:
        assert d == dict(SPAN, device_start=1.5, device_end=2.0) and sp.device_duration == 0.5


def test_device_intervals_draw_a_lane_of_their_own():
    spans = [Span(**SPAN), Span(**dict(SPAN, replica=1), device_start=1.5, device_end=2.0)]
    host_only = Trace(spans=[Span(**SPAN), Span(**dict(SPAN, replica=1))]).chrome_events()
    events = Trace(spans=spans).chrome_events()
    assert events[:len(host_only)] == host_only           # the existing lanes unmoved
    lane = events[len(host_only):]
    assert [e["args"]["name"] for e in lane if e["ph"] == "M"] == ["stage 1 (device)",
                                                                   "r1 device"]
    (x,) = [e for e in lane if e["ph"] == "X"]
    assert (x["pid"], x["tid"], x["name"], x["ts"], x["dur"]) == (2001, 1, "bwd/compute",
                                                                  1.5e6, 0.5e6)


class _Event:
    def __init__(self, ms):
        self.ms = ms
        self.synced = 0

    def synchronize(self):
        self.synced += 1

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_resolve_stamps_device_intervals_on_the_run_clock():
    rec = SpanRecorder()
    rec.resolve()                                          # nothing pending: a no-op
    a, b = rec.tracer(0, 0), rec.tracer(1, 0)
    ends = [_Event(40.0), _Event(90.0)]
    a.emit("compute", 0.1, 0.2, events=(_Event(20.0), ends[0]))
    b.emit("upload", 0.2, 0.3, nbytes=8.0, key="k0/r0/m0/act0")
    b.emit("compute", 0.3, 0.4, events=(_Event(60.0), ends[1]))
    with pytest.raises(ValueError, match="anchor"):
        rec.resolve()
    rec.anchor = (_Event(10.0), 0.05)                      # 10 ms on the device = 0.05 s
    rec.resolve()
    got = [(sp.op, sp.device_start, sp.device_end) for sp in rec.spans]
    assert got == [("compute", pytest.approx(0.06), pytest.approx(0.08)),
                   ("upload", None, None),
                   ("compute", pytest.approx(0.10), pytest.approx(0.13))]
    assert [e.synced for e in ends] == [1, 1] and rec.pending == []
    rec.resolve()                                          # once only
    assert [e.synced for e in ends] == [1, 1]


def test_measured_breakdown_takes_the_slowest_workers_spans():
    def sp(stage, step, phase, op, start, end, dev=None):
        kw = {} if dev is None else dict(device_start=dev[0], device_end=dev[1])
        return Span(stage=stage, replica=0, step=step, phase=phase, op=op, start=start,
                    end=end, **kw)

    spans = [sp(0, 0, "fwd", "compute", 0.0, 0.1, (0.0, 0.5)),    # device 0.5
             sp(0, 0, "fwd", "upload", 0.1, 0.2),
             sp(1, 0, "fwd", "download", 0.0, 0.3),
             sp(1, 0, "fwd", "compute", 0.3, 0.6),                  # host 0.3
             sp(0, 0, "sync", "download", 0.6, 0.9),                # not a boundary transfer
             sp(0, 1, "bwd", "compute", 1.0, 1.1, (1.0, 1.2)),
             sp(1, 1, "bwd", "compute", 1.0, 1.4),
             sp(1, 1, "bwd", "download", 0.9, 1.0)]
    got = measured_breakdown(spans)
    assert got["compute"] == pytest.approx((0.5 + 0.4) / 2)
    assert got["pipeline_comm"] == pytest.approx((0.1 + 0.1) / 2)
    assert measured_breakdown([]) == {}


def test_calibrate_reads_device_intervals_where_there_are_some():
    def trace(dev):
        spans = []
        for k in range(3):
            for phase, t in (("fwd", 0.1), ("bwd", 0.2)):
                kw = {} if not dev else dict(device_start=10.0 * k, device_end=10.0 * k + 3 * t)
                spans.append(Span(stage=0, replica=0, step=k, phase=phase, op="compute",
                                  start=10.0 * k, end=10.0 * k + t, **kw))
        return Trace(spans=spans, meta={"S": 1, "steps": 3, "clock": "wall"})

    host, = observe_stages(trace(False))
    device, = observe_stages(trace(True))
    assert (host.fwd_compute_s, host.bwd_compute_s) == pytest.approx((0.1, 0.2))
    assert (device.fwd_compute_s, device.bwd_compute_s) == pytest.approx((0.3, 0.6))
    assert (device.n_fwd, device.n_bwd) == (host.n_fwd, host.n_bwd) == (2, 2)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


class _Windowed(LocalBackend):
    """``local`` with a flag set while a step runs."""

    in_step = False

    def run_step(self, k, programs, *, pipelined_sync=True):
        type(self).in_step = True
        try:
            return super().run_step(k, programs, pipelined_sync=pipelined_sync)
        finally:
            type(self).in_step = False


def _phi3_shaped():
    """phi3-mini-3.8b at its published widths, 2 layers, bf16."""
    return dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=2)


@pytest.mark.cuda
def test_traced_run_never_synchronises_inside_a_step(cuda_device, monkeypatch):
    waits = []
    real_sync, real_event_sync = torch.cuda.synchronize, torch.cuda.Event.synchronize

    def sync(*a, **k):
        waits.append(("torch.cuda.synchronize", _Windowed.in_step))
        return real_sync(*a, **k)

    def event_sync(self):
        waits.append(("Event.synchronize", _Windowed.in_step))
        return real_event_sync(self)

    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", event_sync)
    res = _run(True, steps=3, backend=_Windowed(lease_timeout=WAIT), device="cuda",
               cfg=_phi3_shaped(), seq=2048, micro_batch=1)
    assert [w for w in waits if w[1]] == []
    # the anchor's, before the first step; resolve's, after the last
    assert {w[0] for w in waits} == {"torch.cuda.synchronize", "Event.synchronize"}
    compute = [sp for sp in res.trace.spans if sp.op == "compute"]
    assert compute and all(sp.device_end > sp.device_start for sp in compute)


SLEEP_CYCLES = 60_000_000        # ~30 ms at the H100's ~1.98 GHz


@pytest.mark.cuda
def test_compute_device_interval_times_the_device_work(cuda_device):
    """Two traced compute spans on one worker stream, each launching a sleep
    kernel: each span's host interval is its launch, far shorter than the
    kernel (nothing waits); its device interval holds the kernel and ends
    after the host interval; the second, queued behind the first, starts on
    the device when the first ends.  (In a traced run's host-paced steps an
    interval also holds its stream's waits for the next launch: the union of
    the compute spans' intervals there reads ~1.3x the device's busy time.)"""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        b.record()
        b.synchronize()
        sleep_s = a.elapsed_time(b) / 1e3
        t0 = time.perf_counter()

        def clock():
            return time.perf_counter() - t0

        rec = SpanRecorder()
        rec.anchor = (local.device_event(synchronize=True), clock())
        ctx = local.LocalWorkerContext(local.LocalStore(timeout=WAIT), worker=(0, 0),
                                       tracer=rec.tracer(0, 0), clock=clock)
        for _ in range(2):
            ctx.compute(0.0, lambda: torch.cuda._sleep(SLEEP_CYCLES))
        launched = clock()
    rec.resolve()
    first, second = rec.spans
    assert launched < 0.5 * sleep_s                 # two launches, no wait
    for sp in (first, second):
        assert sp.duration < 0.25 * sleep_s
        assert 0.9 * sleep_s <= sp.device_duration <= 1.5 * sleep_s
        assert sp.device_start >= sp.start - 1e-3 and sp.device_end >= sp.end
    assert second.device_start == pytest.approx(first.device_end, abs=1e-3)


@pytest.mark.cuda
def test_traced_process_run_carries_device_intervals(cuda_device, tmp_path):
    """On ``process`` each child anchors, times and resolves its own compute
    spans before it replies: every compute span of a traced run comes back
    with a device interval, the trace validates, and the params equal an
    untraced run's."""
    from repro_torch.serverless.backends import ProcessBackend

    runs = [_run(trace, steps=2, device="cuda",
                 backend=ProcessBackend(root=str(tmp_path / f"store{trace}"),
                                        lease_timeout=WAIT))
            for trace in (False, True)]
    spans = runs[1].trace.spans
    validate_trace(runs[1].trace)
    compute = [sp for sp in spans if sp.op == "compute"]
    assert len(compute) == 2 * 4 * 4          # steps x workers x (2 fwd + 2 bwd)
    assert all(sp.device_end > sp.device_start >= 0.0 for sp in compute)
    assert all(sp.device_start is None for sp in spans if sp.op != "compute")
    assert runs[1].losses == runs[0].losses
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(runs[1].params),
                                                 tree_leaves(runs[0].params)))


@pytest.mark.cuda
def test_traced_serve_on_process_carries_device_intervals(cuda_device, tmp_path):
    """A traced request on ``process``: each child makes its CUDA context
    (its stage's weights) before its recorder's anchor event, so every
    compute span comes back with a device interval, and the tokens are the
    untraced request's."""
    from repro_torch.serving import plan_serving, run_serve_plan

    plan = plan_serving("phi3-mini-3.8b@reduced", "aws", slo=60.0, batch=2,
                        prefill_tokens=8, new_tokens=3)
    cuts = [0] * len(plan.x)
    cuts[1] = 1                                  # two stages: two children
    plan = dataclasses.replace(plan, x=tuple(cuts), z=(0,) * (len(plan.x) + 1))
    plain, res = (run_serve_plan(plan, backend="process", device="cuda", trace=trace,
                                 root=str(tmp_path / f"store{trace}"))
                  for trace in (False, True))
    assert (res.tokens == plain.tokens).all()
    validate_trace(res.trace)
    compute = [sp for sp in res.trace.spans if sp.op == "compute"]
    assert {sp.stage for sp in compute} == {0, 1}
    assert all(sp.device_end > sp.device_start >= 0.0 for sp in compute)
