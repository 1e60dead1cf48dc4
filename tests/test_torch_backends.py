"""The port's execution backends against the live JAX package, on the CPU.

The wall-clock stores (``LocalStore``, with and without its file spill, the
process backend's ``FileStore`` and the S3 adapter over an in-memory fake
client): blocking visibility, get timeouts, bit-exact bf16 and fp32 payloads
through files, implicit-delete accounting, producer leases and dead
markers, poison and revive, ``FileBarrier``, payload-true bytes and the
throttle (the ports of ``tests/test_backends.py:82-168``,
``tests/test_process_backend.py`` and ``tests/test_cloud_s3.py``).  The
liveness cases wait on events and generous timeouts, not on sleeps.  Then
``local_scatter_reduce`` bit-equal to the JAX function's on the same
chunks, ``run_plan`` bit-identical across the port's ``emulated``,
``local`` and ``process`` backends and within the reference tolerances of
the JAX engine on ``local``, and ``run_serve_plan`` on ``process`` emitting
the JAX package's tokens.  Traced runs on ``local`` and ``process``
(``trace=True``) validate on the wall clock, cover every worker, reconcile
their span bytes with ``StoreStats`` within 1e-9 relative, and leave params
and tokens bit-identical to the untraced runs'; a traced compute span
records its device events without waiting and an untraced run records
none.  The spawned children never import jax.
"""
import dataclasses
import io
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import InputShape as JaxInputShape
from repro.core.perfmodel import Config as JaxConfig
from repro.core.profiler import arch_model_profile as jax_profile
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models import registry as jreg
from repro.optim import AdamW as JaxAdamW
from repro.serverless.backends.local import LocalBackend as JaxLocalBackend
from repro.serverless.backends.local import LocalStore as JaxLocalStore
from repro.serverless.execution import ExecutionConfig
from repro.serverless.platform import AWS_LAMBDA
from repro.serverless.runtime import Execution as JaxExecution
from repro.serverless.runtime import run_plan as jax_run_plan
from repro.serverless.runtime import scatter_reduce as jsr
from repro.serving import arch_config_for_model as jax_arch
from repro.serving import make_prompt as jax_make_prompt
from repro.serving import plan_serving
from repro.serving import run_serve_plan as jax_run_serve_plan

from repro_torch.api.plan import DeploymentPlan
from repro_torch.configs import get_config
from repro_torch.core.perfmodel import Config
from repro_torch.core.profiler import arch_model_profile
from repro_torch.models import registry
from repro_torch.models.common import tree_leaves
from repro_torch.obs import SpanRecorder, pipeline_health, validate_trace
from repro_torch.optim import AdamW
from repro_torch.serverless.backends import (
    AwsS3Backend,
    EmulatedBackend,
    ExecutionBackend,
    LocalBackend,
    LocalStore,
    ProcessBackend,
    available_backends,
    backend_availability,
    get_backend,
    register_backend,
)
from repro_torch.serverless.backends import local as local_mod
from repro_torch.serverless.backends.cloud import (
    BackendUnavailableError,
    CloudConfig,
    S3ObjectStore,
)
from repro_torch.serverless.backends.local import LocalWorkerContext
from repro_torch.serverless.backends.process_worker import FileBarrier, FileStore
from repro_torch.serverless.platform import get_platform
from repro_torch.serverless.retry import RetryPolicy
from repro_torch.serverless.runtime import Execution, run_plan
from repro_torch.serverless.runtime import scatter_reduce as sr
from repro_torch.serverless.runtime.store import (
    ObjectStore,
    ProducerDeadError,
    StoreAbortedError,
    assert_store_drained,
)
from repro_torch.serving import run_serve_plan

torch.backends.cuda.matmul.allow_tf32 = False
REPO = Path(__file__).resolve().parents[1]
AWS = get_platform("aws")
WAIT = 60.0                     # every join and get: generous, never a sleep


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's CPU torch runs: the suite runs
    several workers on the host's cores, and torch pools of a thread a core
    each starve one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- the fake S3 client
class FakeClientError(Exception):
    """botocore.exceptions.ClientError look-alike: carries .response."""

    def __init__(self, code, op="GetObject"):
        super().__init__(f"An error occurred ({code}) when calling {op}")
        self.response = {"Error": {"Code": code}}


class FakeS3Client:
    """In-memory boto3-S3-shaped client (a copy of ``tests/test_cloud_s3.py``'s):
    put/get/delete/list_objects_v2 with boto3's call and return shapes,
    scripted failures, and a small list page so pagination is exercised."""

    def __init__(self, page_size=2):
        self.objects = {}
        self.page_size = page_size
        self._fail_queue = []           # (op, code) consumed FIFO
        self._lock = threading.Lock()

    def fail_next(self, op, code, times=1):
        with self._lock:
            self._fail_queue.extend((op, code) for _ in range(times))

    def _maybe_fail(self, op):
        with self._lock:
            if self._fail_queue and self._fail_queue[0][0] == op:
                _, code = self._fail_queue.pop(0)
                raise FakeClientError(code, op)

    def put_object(self, *, Bucket, Key, Body):
        self._maybe_fail("put_object")
        with self._lock:
            self.objects[(Bucket, Key)] = bytes(Body)
        return {}

    def get_object(self, *, Bucket, Key):
        self._maybe_fail("get_object")
        with self._lock:
            blob = self.objects.get((Bucket, Key))
        if blob is None:
            raise FakeClientError("NoSuchKey", "GetObject")
        return {"Body": io.BytesIO(blob)}

    def delete_object(self, *, Bucket, Key):
        self._maybe_fail("delete_object")
        with self._lock:
            self.objects.pop((Bucket, Key), None)
        return {}

    def list_objects_v2(self, *, Bucket, Prefix, ContinuationToken=None):
        with self._lock:
            keys = sorted(k for (b, k) in self.objects if b == Bucket and k.startswith(Prefix))
        start = int(ContinuationToken or 0)
        page = keys[start:start + self.page_size]
        out = {"Contents": [{"Key": k} for k in page],
               "IsTruncated": start + self.page_size < len(keys)}
        if out["IsTruncated"]:
            out["NextContinuationToken"] = str(start + self.page_size)
        return out


def _s3_config():
    return CloudConfig(bucket="test-bucket", key_prefix="funcpipe/",
                       retry=RetryPolicy(max_attempts=4, base_delay_s=0.001))


def _store(kind, tmp_path, **kw):
    kw.setdefault("timeout", WAIT)
    kw.setdefault("lease_timeout", WAIT)
    if kind == "emulated":
        return ObjectStore()
    if kind == "local":
        return LocalStore(**kw)
    if kind == "local-fs":
        return LocalStore(fs_root=str(tmp_path / "spill"), **kw)
    if kind == "file":
        return FileStore(str(tmp_path / "store"), **kw)
    return S3ObjectStore(FakeS3Client(), _s3_config(), **kw)


LIVE = ["local", "file", "s3"]


def _thread(fn):
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:      # noqa: BLE001 - asserted by the test
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def _join(t):
    t.join(timeout=WAIT)
    assert not t.is_alive(), "worker thread still blocked"


# ------------------------------------------------------------------- stores
@pytest.mark.parametrize("kind", LIVE)
def test_store_blocks_until_visible(kind, tmp_path):
    store = _store(kind, tmp_path)
    t, out = _thread(lambda: store.take("x"))
    assert t.is_alive()              # nothing to take yet
    store.put("x", 128.0, value="payload")
    _join(t)
    assert out == {"value": "payload"}
    assert "x" not in store and store.live_bytes == 0.0
    assert store.stats.puts == store.stats.deletes == 1


@pytest.mark.parametrize("kind", LIVE)
def test_store_get_timeout_diagnoses_missing_object(kind, tmp_path):
    store = _store(kind, tmp_path, timeout=0.05)
    with pytest.raises(TimeoutError, match="'missing' never became visible"):
        store.get("missing")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["local-fs", "file", "s3"])
def test_tensor_payload_round_trips_bit_exact(kind, dtype, tmp_path):
    """A tensor that crosses a file (or a fake bucket) comes back with its
    dtype, shape and bits, on the device it left; nested caches too."""
    gen = torch.Generator().manual_seed(3)
    a = (torch.randn(5, 7, generator=gen) * 1e3).to(dtype)
    chunk = torch.tensor_split(torch.randn(1001, generator=gen).to(dtype), 3)[1]
    caches = (a[:2], {"k": a[2:], "len": torch.tensor([7], dtype=torch.int32)})
    store = _store(kind, tmp_path)
    store.put("k0/r0/m0/act0", 1.0, value=a)
    store.put("k0/sync0/part/1/0", 1.0, value=chunk)
    store.put("kv/s0", 1.0, value=caches)
    for key, want in (("k0/r0/m0/act0", a), ("k0/sync0/part/1/0", chunk)):
        got = store.take(key)
        assert got.dtype == dtype and got.shape == want.shape and got.device == want.device
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    back = store.take("kv/s0")
    assert torch.equal(back[0], caches[0]) and torch.equal(back[1]["k"], caches[1]["k"])
    assert back[1]["len"].dtype == torch.int32
    back[0].add_(1)                      # a cache a decode round updates in place
    assert_store_drained(store)
    if kind == "local-fs":
        assert list((tmp_path / "spill").glob("*.pkl")) == []


@pytest.mark.parametrize("kind", ["emulated", "local", "file", "s3"])
def test_overwrite_put_counts_implicit_delete(kind, tmp_path):
    store = _store(kind, tmp_path)
    store.put("k", 100.0)
    store.put("k", 40.0)                  # overwrite: implicit delete of 100
    assert store.live_bytes == pytest.approx(40.0)
    store.delete("k")
    assert store.stats.puts == store.stats.deletes == 2
    assert store.stats.bytes_deleted == pytest.approx(store.stats.bytes_in)
    assert_store_drained(store)


@pytest.mark.parametrize("kind", LIVE)
def test_stale_lease_raises_producer_dead(kind, tmp_path):
    """A producer whose heartbeat went stale fails its consumers over well
    before the get timeout."""
    store = _store(kind, tmp_path, lease_timeout=0.2)
    store.heartbeat((0, 0))
    while store.heartbeat_age((0, 0)) <= 0.2:
        time.sleep(0.05)
    t0 = time.monotonic()
    with pytest.raises(ProducerDeadError, match="stopped heartbeating"):
        store.get("k0/r0/m0/act0")      # produced by stage 0, replica 0
    assert time.monotonic() - t0 < WAIT / 2


@pytest.mark.parametrize("kind", LIVE)
def test_dead_marker_raises_producer_dead(kind, tmp_path):
    store = _store(kind, tmp_path)
    store.mark_dead((0, 0))
    with pytest.raises(ProducerDeadError, match="died"):
        store.get("k0/r0/m0/act0")


@pytest.mark.parametrize("kind", LIVE)
def test_poison_aborts_waiters_and_revives(kind, tmp_path):
    """A waiter blocked on a key (or about to block: either way) wakes with
    StoreAbortedError naming the first poison; revive clears it."""
    store = _store(kind, tmp_path)
    waiting = threading.Event()

    def consume():
        waiting.set()
        return store.get("k0/r0/m0/act0")

    t, out = _thread(consume)
    assert waiting.wait(WAIT)
    store.abort(RuntimeError("worker s0r0 exploded"))
    _join(t)
    assert isinstance(out["error"], StoreAbortedError), out
    assert "exploded" in str(out["error"])
    store.abort(RuntimeError("collateral"))       # the first poison wins
    with pytest.raises(StoreAbortedError, match="exploded"):
        store.get("k0/r0/m0/act0")
    store.revive()
    store.put("k0/r0/m0/act0", 8.0, value="v")
    assert store.take("k0/r0/m0/act0") == "v"


def test_file_store_accounting_survives_a_second_client(tmp_path):
    a = _store("file", tmp_path)
    a.put("k0/r0/m0/act0", 32.0, value=b"v")
    b = FileStore(str(tmp_path / "store"), timeout=WAIT)
    assert b.stats.puts == 1 and b.live_bytes == 32.0
    assert b.take("k0/r0/m0/act0") == b"v"
    assert a.stats.deletes == 1 and a.live_bytes == 0.0


def test_file_barrier_meets_across_threads(tmp_path):
    store = _store("file", tmp_path)
    n = 3
    passed = [[] for _ in range(2)]

    def party(i):
        b = FileBarrier(store, "k0-s0", n, i, timeout=WAIT)
        for g in range(2):               # the second generation meets too
            b.wait()
            passed[g].append(i)

    threads = [_thread(lambda i=i: party(i)) for i in range(n)]
    for t, out in threads:
        _join(t)
        assert "error" not in out, out
    assert [sorted(p) for p in passed] == [[0, 1, 2], [0, 1, 2]]


def test_file_barrier_breaks_on_poison(tmp_path):
    store = _store("file", tmp_path)
    t, out = _thread(lambda: FileBarrier(store, "k0-s0", 2, 0, timeout=WAIT).wait())
    store.abort(RuntimeError("peer died"))
    _join(t)
    assert isinstance(out["error"], threading.BrokenBarrierError)


def test_payload_true_charges_two_bytes_a_bf16_element(tmp_path):
    store = _store("file", tmp_path, payload_true=True)
    payloads = {"k0/r0/m0/act0": torch.zeros(1000, dtype=torch.bfloat16),
                "k0/r0/m0/grad0": torch.ones(16, 8, dtype=torch.float32),
                "k0/sync0/red/0": torch.zeros(37, dtype=torch.int32)}
    for key, t in payloads.items():
        store.put(key, 1.0, value=t)   # modeled size deliberately wrong
    want = 2000.0 + 16 * 8 * 4 + 37 * 4
    assert store.stats.bytes_in == want
    got = sum(store.take(key, return_nbytes=True)[1] for key in payloads)
    assert got == want and store.stats.bytes_out == want
    assert_store_drained(store)
    plain = _store("file", tmp_path / "plain")
    plain.put("k", 999.0, value=torch.zeros(4))
    assert plain.stats.bytes_in == 999.0


def test_throttle_transfer_time_tracks_bytes_over_bandwidth(tmp_path):
    """A put and a take of B bytes at bandwidth W each take at least B/W."""
    bw = 2e6
    store = _store("file", tmp_path, payload_true=True, bandwidth=bw)
    t = torch.zeros(250_000, dtype=torch.float32)       # 1 MB: 0.5 s a leg
    t0 = time.monotonic()
    store.put("k0/r0/m0/act0", 0.0, value=t)
    up = time.monotonic() - t0
    t0 = time.monotonic()
    store.take("k0/r0/m0/act0")
    down = time.monotonic() - t0
    for leg in (up, down):
        assert 0.5 * 0.99 <= leg <= 0.5 * 1.6 + 2.0
    unthrottled = _store("file", tmp_path / "fast", payload_true=True)
    t0 = time.monotonic()
    unthrottled.put("k", 0.0, value=t)
    unthrottled.take("k")
    assert time.monotonic() - t0 < 0.5


# ----------------------------------------------------------------- registry
def test_registry_resolves_names_and_instances():
    assert set(available_backends()) == {"aws", "emulated", "local", "oss", "process"}
    be = get_backend("emulated")
    assert isinstance(be, EmulatedBackend) and not be.wall_clock
    assert get_backend("emulated") is not be        # a fresh instance per name
    lo = get_backend("local")
    assert isinstance(lo, LocalBackend) and lo.wall_clock and not lo.hosts_programs
    pr = get_backend("process")
    assert isinstance(pr, ProcessBackend) and pr.wall_clock and pr.hosts_programs
    mine = ProcessBackend(payload_true=True)
    assert get_backend(mine) is mine                 # an instance passes through

    class Custom(EmulatedBackend):
        name = "custom-test"

    register_backend("custom-test", Custom)
    try:
        assert isinstance(get_backend("custom-test"), Custom)
    finally:
        from repro_torch.serverless import backends

        backends._REGISTRY.pop("custom-test")


def test_availability_and_unknown_names():
    avail = backend_availability()
    assert avail["emulated"] is None and avail["local"] is None
    assert avail["process"] is None                 # a POSIX host
    import importlib.util

    with pytest.raises(KeyError) as ei:
        get_backend("s3-but-misspelled")
    msg = str(ei.value)
    assert "unknown execution backend" in msg
    for name in available_backends():
        assert name in msg
    if importlib.util.find_spec("boto3") is None:
        assert avail["aws"] == "boto3 not installed" and "boto3 not installed" in msg


@pytest.mark.parametrize("be,S,d", [(LocalBackend, 17, 16), (ProcessBackend, 9, 8)],
                         ids=["local-256-threads", "process-64-processes"])
def test_backends_cap_their_workers(be, S, d):
    with pytest.raises(ValueError, match="caps at"):
        be().open(SimpleNamespace(S=S, d=d))


# ----------------------------------------------------------------- S3 / OSS
def test_s3_round_trip_prefix_and_pagination():
    client = FakeS3Client(page_size=2)
    store = S3ObjectStore(client, _s3_config(), timeout=WAIT)
    store.put("k0/r0/m0/act0", 128.0, value={"a": 1})
    assert ("test-bucket", "funcpipe/k0/r0/m0/act0") in client.objects
    assert store.take("k0/r0/m0/act0", return_nbytes=True) == ({"a": 1}, 128.0)
    want = [f"ckpt/s{i}" for i in range(5)]
    for k in want:
        store.put(k, 1.0)
    assert sorted(store.keys()) == want


def test_s3_transient_codes_retry_per_policy():
    client = FakeS3Client()
    store = S3ObjectStore(client, _s3_config(), timeout=WAIT)
    client.fail_next("put_object", "SlowDown", times=2)
    store.put("k", 8.0, value="v")
    assert store.retried_ops == 2
    client.fail_next("get_object", "InternalError")
    assert store.take("k") == "v" and store.retried_ops == 3
    client.fail_next("put_object", "SlowDown", times=10)
    with pytest.raises(FakeClientError, match="SlowDown"):
        store.put("k", 8.0)                # the retry budget runs out
    client._fail_queue.clear()
    client.fail_next("put_object", "AccessDenied")
    with pytest.raises(FakeClientError, match="AccessDenied"):
        store.put("k", 8.0)                # not retryable: raised at once
    assert store.retried_ops == 6


def test_cloud_backends_name_what_is_missing():
    import importlib.util

    if importlib.util.find_spec("boto3") is None:
        aws = get_backend("aws")
        assert isinstance(aws, AwsS3Backend) and aws.wall_clock
        with pytest.raises(BackendUnavailableError, match="boto3"):
            aws.open(None)
    oss = get_backend("oss")
    assert isinstance(oss, ExecutionBackend) and oss.wall_clock
    with pytest.raises(NotImplementedError, match="stub"):
        oss.open(None)
    with pytest.raises(ValueError, match="bucket"):
        S3ObjectStore(FakeS3Client(), CloudConfig(bucket=""))


def test_retry_policy_equals_jax():
    from repro.serverless.retry import RetryPolicy as JaxRetryPolicy

    for kw in ({}, {"jitter": 0.0, "seed": 3}, {"base_delay_s": 0.2, "max_delay_s": 0.5}):
        ours, theirs = RetryPolicy(**kw), JaxRetryPolicy(**kw)
        assert [ours.delay(a, "k0/x") for a in range(1, 8)] == \
            [theirs.delay(a, "k0/x") for a in range(1, 8)]


# ------------------------------------------------ worker death and recover
def _timing_agg(d=2):
    """A timing-only 2-stage plan of phi3@reduced (4 layers) and its
    per-stage cost terms."""
    from repro_torch.serverless.simulator import stage_aggregates

    cfg = dataclasses.replace(get_config("phi3-mini-3.8b").reduced(), n_layers=4)
    prof = arch_model_profile(cfg, AWS, seq=16, micro_batch=2)
    L = cfg.n_layers + 2
    config = Config(x=tuple(1 if i == 2 else 0 for i in range(L - 1)), d=d, z=(0,) * L)
    return stage_aggregates(prof, AWS, config, 2 * d)


def _programs(be, agg, k, broken=None):
    from repro_torch.serverless.runtime.engine import _worker_step_program

    def dies():
        raise RuntimeError("worker s1r0 exploded")
        yield                                       # a generator that fails at once

    return {(s, r): dies() if (s, r) == broken else _worker_step_program(
                be.context(s, r), k=k, s=s, r=r, agg=agg, worker=None, batch=None,
                losses={})
            for s in range(agg.S) for r in range(agg.d)}


def test_local_worker_death_fails_peers_over_then_recovers():
    """A worker thread that raises poisons the store and breaks its stage's
    barrier: the peers blocked on its objects fail over at once, the step
    raises the originating error (not the collateral), and after
    ``recover()`` the next step runs and the store drains."""
    agg = _timing_agg()
    be = LocalBackend(get_timeout=WAIT, lease_timeout=WAIT)
    be.open(agg)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exploded"):
        be.run_step(0, _programs(be, agg, 0, broken=(1, 0)))
    assert time.monotonic() - t0 < WAIT / 2
    be.recover()
    be.run_step(1, _programs(be, agg, 1))
    be.verify_drained()


def test_process_worker_death_fails_over_and_recover_respawns():
    """A killed worker process is found dead, its peers fail over through
    the poisoned file store, the step raises; ``recover()`` respawns only
    that worker, and the next step runs with the store drained."""
    agg = _timing_agg()
    be = ProcessBackend(get_timeout=WAIT, lease_timeout=WAIT)
    try:
        be.open(agg)
        survivor = be._procs[(0, 1)]
        be._procs[(1, 0)].kill()
        be._procs[(1, 0)].join(timeout=WAIT)
        be.stage_step(0)
        with pytest.raises(RuntimeError, match=r"stage 1, replica 0\) died"):
            be.run_step(0, _programs(be, agg, 0))
        be.recover()
        assert be._procs[(0, 1)] is survivor and be._procs[(1, 0)].is_alive()
        be.stage_step(1)
        be.run_step(1, _programs(be, agg, 1))
        be.verify_drained()
    finally:
        be.close()


# ----------------------------------------------------- local scatter-reduce
def _run_parties(n, fn):
    threads = [_thread(lambda i=i: fn(i)) for i in range(n)]
    outs = []
    for t, out in threads:
        _join(t)
        assert "error" not in out, out
        outs.append(out["value"])
    return outs


@pytest.mark.parametrize("kind", ["local", "file"])
@pytest.mark.parametrize("pipelined", [True, False], ids=["eq2", "eq1"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_local_scatter_reduce_bit_equal_to_jax(n, pipelined, kind, tmp_path):
    """n worker threads reduce the same fp32 vectors (mixed magnitudes, so
    the order of the adds shows) through the port's and the JAX package's
    collectives: every worker's result is bit-equal to JAX's, and the stores
    move the same objects and bytes."""
    rng = np.random.default_rng(n)
    vecs = [(rng.standard_normal(1001) * 10.0 ** rng.integers(-4, 5, 1001)).astype(np.float32)
            for _ in range(n)]
    nbytes = 4.0 * 1001
    jstore, jbar = JaxLocalStore(timeout=WAIT), threading.Barrier(n, timeout=WAIT)
    jout = _run_parties(n, lambda i: jsr.local_scatter_reduce(
        jstore, i, n, nbytes, vecs[i], key_prefix="k0/sync0", pipelined=pipelined,
        barrier=jbar))
    store = _store(kind, tmp_path)
    tbar = threading.Barrier(n, timeout=WAIT)
    out = _run_parties(n, lambda i: sr.local_scatter_reduce(
        store, i, n, nbytes, torch.from_numpy(vecs[i]), key_prefix="k0/sync0",
        pipelined=pipelined,
        barrier=tbar if kind == "local" else FileBarrier(store, "k0-s0", n, i, WAIT)))
    for got, want in zip(out, jout):
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))
    assert_store_drained(store)
    st, jst = store.stats, jstore.stats
    assert (st.puts, st.gets, st.deletes) == (jst.puts, jst.gets, jst.deletes)
    assert (st.bytes_in, st.bytes_out) == (jst.bytes_in, jst.bytes_out)


# ---------------------------------------------------------------- run_plan
def _plan_inputs():
    """``tests/test_backends.py``'s numeric plan: phi3@reduced, 4 layers,
    2 stages x 2 replicas, mu 2, AdamW(1e-2), 2 steps, JAX weights and
    batches."""
    jcfg = dataclasses.replace(jconfigs.get_config("phi3-mini-3.8b").reduced(), n_layers=4)
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b").reduced(), n_layers=4)
    B, seq, d, mu, steps = 8, 16, 2, 2, 2
    L = cfg.n_layers + 2
    x = tuple(1 if i == 2 else 0 for i in range(L - 1))
    params0 = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    jbatches = [jax_make_batch(jcfg, JaxInputShape("bparity", seq, B, "train"), step=k)
                for k in range(steps)]
    return SimpleNamespace(
        jcfg=jcfg, cfg=cfg, B=B, seq=seq, d=d, mu=mu, steps=steps, L=L, x=x,
        params0=params0, jbatches=jbatches,
        params=registry.params_from_jax(jax.tree.map(np.asarray, params0), device="cpu"),
        batches=[{k: torch.from_numpy(np.array(v)) for k, v in b.items()} for b in jbatches])


def _port_run(p, backend, pipelined, steps=None, trace=False):
    prof = arch_model_profile(p.cfg, AWS, seq=p.seq, micro_batch=p.B // (p.d * p.mu))
    return run_plan(prof, AWS, Config(x=p.x, d=p.d, z=(0,) * p.L), p.d * p.mu,
                    steps=steps or p.steps, pipelined_sync=pipelined, backend=backend,
                    trace=trace,
                    execution=Execution(cfg=p.cfg, optimizer=AdamW(lr=1e-2),
                                        init_params=p.params,
                                        batch_fn=lambda k: p.batches[k], device="cpu"))


@pytest.fixture(scope="module", params=[True, False], ids=["eq2", "eq1"])
def trained(request):
    """The plan trained on the port's three backends, traced on ``local`` and
    ``process`` too, and on the JAX engine's local backend, for one sync
    schedule."""
    pipelined = request.param
    p = _plan_inputs()
    runs = {name: _port_run(p, be, pipelined, trace=name.endswith("traced"))
            for name, be in (
                ("emulated", "emulated"), ("local", LocalBackend(lease_timeout=WAIT)),
                ("process", ProcessBackend(lease_timeout=WAIT)),
                ("local_traced", LocalBackend(lease_timeout=WAIT)),
                ("process_traced", ProcessBackend(lease_timeout=WAIT)))}
    # the reference's local run gets the port's lease: under a loaded host a
    # JAX worker thread that is compiling can miss the default 5 s heartbeat
    jres = jax_run_plan(
        jax_profile(p.jcfg, AWS_LAMBDA, seq=p.seq, micro_batch=p.B // (p.d * p.mu)),
        AWS_LAMBDA, JaxConfig(x=p.x, d=p.d, z=(0,) * p.L), total_micro_batches=p.d * p.mu,
        pipelined_sync=pipelined,
        exec_config=ExecutionConfig(steps=p.steps,
                                    backend=JaxLocalBackend(lease_timeout=WAIT)),
        execution=JaxExecution(cfg=p.jcfg, optimizer=JaxAdamW(lr=1e-2),
                               init_params=p.params0, batch_fn=lambda k: p.jbatches[k]))
    return SimpleNamespace(inputs=p, runs=runs, jres=jres)


def _bits_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x.cpu(), y.cpu())
        for x, y in zip(la, lb))


def test_run_plan_bit_identical_across_backends(trained):
    """The acceptance bar of ``tests/test_backends.py:216-240`` held by the
    port: worker threads over a blocking store and spawned worker processes
    over files train to the emulated run's params, bit for bit, with equal
    losses, and move the same objects."""
    em = trained.runs["emulated"]
    assert em.backend == "emulated" and not em.wall_clock
    se = em.store_stats
    for name in ("local", "process"):
        res = trained.runs[name]
        assert res.backend == name and res.wall_clock
        assert res.losses == em.losses, name
        assert _bits_equal(res.params, em.params), name
        st = res.store_stats
        assert (st.puts, st.gets, st.deletes) == (se.puts, se.gets, se.deletes), name
        assert st.bytes_in == pytest.approx(se.bytes_in, rel=1e-12)
        assert st.bytes_out == pytest.approx(se.bytes_out, rel=1e-12)


def test_run_plan_local_matches_jax_engine(trained):
    """The port's local run against the JAX engine's local run of the same
    plan, weights and batches: losses within 2e-4, params within 2e-3
    (``tests/test_runtime.py:250-253``), the same store traffic."""
    res, jres = trained.runs["local"], trained.jres
    assert jres.backend == "local"
    for got, want in zip(res.losses, jres.losses):
        assert abs(got - want) < 2e-4, (got, want)
    worst = max(float(np.max(np.abs(b.float().numpy() - np.asarray(a, np.float32))))
                for a, b in zip(jax.tree.leaves(jres.params), tree_leaves(res.params)))
    assert worst < 2e-3
    st, jst = res.store_stats, jres.store_stats
    assert (st.puts, st.gets, st.deletes) == (jst.puts, jst.gets, jst.deletes)
    assert st.bytes_in == pytest.approx(jst.bytes_in, rel=1e-12)
    assert st.bytes_out == pytest.approx(jst.bytes_out, rel=1e-12)
    assert st.class_bytes_in == pytest.approx(jst.class_bytes_in, rel=1e-12)


@pytest.mark.parametrize("name", ["local", "process"])
def test_traced_wall_clock_run_validates_and_keeps_the_bits(trained, name):
    """A traced run on ``local`` or ``process``: a wall-clock trace that
    validates, covers every worker in every step and phase, and whose span
    bytes equal ``StoreStats`` within 1e-9 relative (summed in another
    order); losses equal and params bit-identical to the untraced run's.
    Wall-clock traces carry no bandwidth-utilization column."""
    p, traced, plain = trained.inputs, trained.runs[f"{name}_traced"], trained.runs[name]
    tr = traced.trace
    assert plain.trace is None and trained.runs["emulated"].trace is None
    assert tr.meta["clock"] == "wall" and tr.meta["backend"] == name
    validate_trace(tr)
    S = sum(p.x) + 1
    workers = {f"s{s}r{r}" for s in range(S) for r in range(p.d)}
    for k in range(p.steps):
        for phase in ("fwd", "bwd", "sync"):
            assert {sp.worker for sp in tr.spans if sp.step == k and sp.phase == phase} \
                == workers, (k, phase)
    assert {sp.op for sp in tr.spans} >= {"download", "compute", "upload"}
    st = traced.store_stats
    up = sum(sp.nbytes for sp in tr.spans if sp.op == "upload")
    dn = sum(sp.nbytes for sp in tr.spans if sp.op == "download")
    assert up == pytest.approx(st.bytes_in, rel=1e-9)
    assert dn == pytest.approx(st.bytes_out, rel=1e-9)
    h = pipeline_health(tr)
    assert h["reconciliation"]["ok"]
    assert all("up_bw_util" not in row and 0.0 <= row["compute_frac"] <= 1.0
               for row in h["stages"])
    assert len(tr.meta["step_ends"]) == p.steps and tr.meta["t_total"] == traced.t_total
    assert traced.losses == plain.losses
    assert _bits_equal(traced.params, plain.params)


class _FakeEvent:
    """A timing CUDA event's surface on the CPU: its time (ms) given."""

    def __init__(self, ms, log):
        self.ms, self.log = ms, log

    def synchronize(self):
        self.log.append("synchronize")

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_traced_compute_span_ends_after_the_device_wait(monkeypatch):
    """(Named for the device wait a traced compute span had.) The span's host
    interval wraps ``fn``: the clock is read before the start event and
    after the end event, both recorded around ``fn``; nothing waits on the
    device, and the events wait in the recorder until ``resolve``, which
    stamps the span's device interval from the anchor.  Transfers record no
    events; ``fn``'s result comes back."""
    log, ticks = [], iter(range(100))

    def clock():
        log.append("clock")
        return float(next(ticks))

    def event(synchronize=False):
        log.append("event")
        return _FakeEvent(10.0 * log.count("event"), log)

    monkeypatch.setattr(local_mod, "device_event", event)
    rec = SpanRecorder()
    ctx = LocalWorkerContext(LocalStore(timeout=WAIT), worker=(0, 0), tracer=rec.tracer(0, 0),
                             clock=clock)
    assert ctx.compute(1.0, lambda: log.append("fn") or 7) == 7
    assert log == ["clock", "event", "fn", "event", "clock"]
    assert [(sp.op, sp.start, sp.end, sp.device_start) for sp in rec.spans] == \
        [("compute", 0.0, 1.0, None)]
    assert [(sp, a.ms, b.ms) for sp, a, b in rec.pending] == [(rec.spans[0], 10.0, 20.0)]
    ctx.upload("k0/r0/m0/act0", 8.0, value=1)
    assert ctx.download("k0/r0/m0/act0") == (1, None)
    assert log.count("event") == 2 and "synchronize" not in log    # transfers: none
    assert [sp.op for sp in rec.spans] == ["compute", "upload", "download"]
    assert rec.spans[2].nbytes == 8.0 and rec.spans[2].key == "k0/r0/m0/act0"
    rec.anchor = (_FakeEvent(5.0, log), 100.0)       # at 5 ms on the device, 100 s here
    rec.resolve()
    assert log.count("synchronize") == 1 and rec.pending == []
    assert (rec.spans[0].device_start, rec.spans[0].device_end) == (100.005, 100.015)
    assert rec.spans[0].start == 0.0 and rec.spans[1].device_start is None


def test_untraced_runs_never_wait(monkeypatch):
    """No tracer, no event: a context's compute and a whole untraced
    ``local`` run record none; a traced run records its anchor once (after a
    device synchronisation) and two events a compute span, and every compute
    span gets a device interval; params stay bit-identical."""
    calls = []

    def event(synchronize=False):
        calls.append(synchronize)
        return _FakeEvent(float(len(calls)), [])

    monkeypatch.setattr(local_mod, "device_event", event)
    ctx = LocalWorkerContext(LocalStore(timeout=WAIT), worker=(0, 0))
    assert ctx.compute(1.0, lambda: 3) == 3 and calls == []
    p = _plan_inputs()
    res = _port_run(p, LocalBackend(lease_timeout=WAIT), True, steps=1)
    assert calls == [] and res.trace is None
    traced = _port_run(p, LocalBackend(lease_timeout=WAIT), True, steps=1, trace=True)
    compute = [sp for sp in traced.trace.spans if sp.op == "compute"]
    assert calls.count(True) == 1 and calls.count(False) == 2 * len(compute) > 0
    assert all(sp.device_end > sp.device_start for sp in compute)
    assert all(sp.device_start is None for sp in traced.trace.spans if sp.op != "compute")
    assert _bits_equal(traced.params, res.params)


@pytest.mark.parametrize("store", ["local-fs", "aws-fake-s3"])
def test_run_plan_through_files_and_a_bucket_is_bit_identical(store, tmp_path):
    """Every payload pickled through files (``LocalBackend(fs_root=...)``)
    or a fake S3 bucket (``AwsS3Backend``) trains one step to the emulated
    run's params, untraced and traced (a wall-clock trace that validates)."""
    p = _plan_inputs()

    def backend():
        return (LocalBackend(fs_root=str(tmp_path / "spill"), lease_timeout=WAIT)
                if store == "local-fs"
                else AwsS3Backend(_s3_config(), client=FakeS3Client(), lease_timeout=WAIT))

    em = _port_run(p, "emulated", True, steps=1)
    for trace in (False, True):
        res = _port_run(p, backend(), True, steps=1, trace=trace)
        assert res.losses == em.losses and _bits_equal(res.params, em.params)
        assert res.store_stats.puts == em.store_stats.puts
        assert (res.trace is not None) == trace
    validate_trace(res.trace)
    assert res.trace.meta["clock"] == "wall" and pipeline_health(res.trace)["reconciliation"]["ok"]


def test_process_child_without_cuda_raises():
    """No fallback: a child asked for ``cuda`` on a host without a card
    raises through ``resolve_device``, and the run raises with its message."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: a cuda child would run")
    p = _plan_inputs()
    prof = arch_model_profile(p.cfg, AWS, seq=p.seq, micro_batch=p.B // (p.d * p.mu))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_plan(prof, AWS, Config(x=p.x, d=1, z=(0,) * p.L), p.mu, backend="process",
                 execution=Execution(cfg=p.cfg, optimizer=AdamW(), init_params=p.params,
                                     batch_fn=lambda k: p.batches[k]))


# ----------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def served(tmp_path_factory):
    model, batch, prefill, new = "phi3-mini-3.8b@reduced", 2, 8, 3
    jplan = plan_serving(model, "aws", slo=60.0, batch=batch, prefill_tokens=prefill,
                         new_tokens=new)
    path = tmp_path_factory.mktemp("plans") / "serve_plan.json"
    jplan.save(path)
    jcfg = jax_arch(model)
    params = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    return SimpleNamespace(path=path, jplan=jplan, params_np=jax.tree.map(np.asarray, params),
                           prompt=jax_make_prompt(jcfg, batch, prefill, seed=0),
                           jax_tokens=jax_run_serve_plan(jplan, seed=0).tokens)


@pytest.mark.parametrize("split", ["planned", "two-stage"])
def test_serve_on_process_matches_emulated_and_jax(served, split):
    plan = DeploymentPlan.load(served.path)
    if split == "two-stage":
        cuts = [0] * len(plan.x)
        cuts[1] = 1
        plan = dataclasses.replace(plan, x=tuple(cuts), z=(0,) * (len(plan.x) + 1))
    params = registry.params_from_jax(served.params_np, device="cpu")
    kw = dict(device="cpu", params=params, prompt=served.prompt, use_kernels=True)
    em = run_serve_plan(plan, **kw)
    res = run_serve_plan(plan, backend="process", **kw)
    assert res.backend == "process" and res.tokens.dtype == np.int32
    assert np.array_equal(res.tokens, em.tokens)
    assert np.array_equal(res.tokens, served.jax_tokens)
    assert len(res.worker_reports) == plan.n_stages and res.round_wall_s == ()
    st = res.store_stats
    assert st.puts == st.deletes and st.puts == em.store_stats.puts
    # payload-true: the KV caches and boundaries are charged their real bytes
    assert st.class_bytes_in["kv"] > 0 and st.bytes_in != em.store_stats.bytes_in


def test_traced_serve_on_process_gives_the_untraced_tokens(served):
    """A traced request on ``process``: the untraced run's tokens (which
    are JAX's), a wall-clock trace that validates with exactly the phases
    prefill and decode on every stage, span bytes equal to ``StoreStats``
    within 1e-9 relative."""
    plan = DeploymentPlan.load(served.path)
    params = registry.params_from_jax(served.params_np, device="cpu")
    kw = dict(backend="process", device="cpu", params=params, prompt=served.prompt,
              use_kernels=True)
    plain = run_serve_plan(plan, **kw)
    res = run_serve_plan(plan, trace=True, **kw)
    assert plain.trace is None
    assert np.array_equal(res.tokens, plain.tokens)
    assert np.array_equal(res.tokens, served.jax_tokens)
    tr = res.trace
    validate_trace(tr)
    assert tr.meta["clock"] == "wall" and tr.meta["workload"] == "serve"
    assert tr.meta["S"] == plan.n_stages and tr.meta["t_request"] == res.t_request
    assert {sp.phase for sp in tr.spans} == {"prefill", "decode"}
    for phase in ("prefill", "decode"):
        assert {sp.stage for sp in tr.spans if sp.phase == phase} == set(range(plan.n_stages))
    st = res.store_stats
    assert sum(sp.nbytes for sp in tr.spans if sp.op == "upload") == \
        pytest.approx(st.bytes_in, rel=1e-9)
    assert sum(sp.nbytes for sp in tr.spans if sp.op == "download") == \
        pytest.approx(st.bytes_out, rel=1e-9)
    assert pipeline_health(tr)["reconciliation"]["ok"]


def test_process_children_never_import_jax(served, tmp_path):
    """A traced process-backend training step and serve request on the CPU,
    with ``jax`` and ``repro`` shadowed by packages that refuse to import:
    the parent and every spawned child run without them."""
    for name in ("jax", "repro"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('the port imported {name}')\n")
    code = '''
import dataclasses, sys
import numpy as np, torch
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.perfmodel import Config
from repro_torch.core.profiler import arch_model_profile
from repro_torch.data.synthetic import make_batch
from repro_torch.models import registry
from repro_torch.optim import SGD
from repro_torch.serverless.platform import get_platform
from repro_torch.serverless.runtime import Execution, run_plan


def main():
    aws = get_platform("aws")
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b").reduced(), n_layers=2)
    prof = arch_model_profile(cfg, aws, seq=8, micro_batch=2)
    batch = make_batch(cfg, InputShape("p", 8, 2, "train"), seed=0, device="cpu")
    params = registry.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    res = run_plan(prof, aws, Config(x=(0, 1, 0), d=1, z=(0,) * 4), 1, backend="process",
                   trace=True,
                   execution=Execution(cfg=cfg, optimizer=SGD(), init_params=params,
                                       batch_fn=lambda k: batch, device="cpu"))
    assert res.backend == "process" and np.isfinite(res.losses).all()
    assert len(res.trace.spans) > 0
    from repro_torch.api.plan import DeploymentPlan
    from repro_torch.serving import run_serve_plan

    served = run_serve_plan(DeploymentPlan.load(sys.argv[1]), backend="process", device="cpu",
                            trace=True)
    assert served.tokens.shape == (2, 3) and len(served.trace.spans) > 0
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
    print("LEAKED", bad)


if __name__ == "__main__":
    main()
'''
    script = tmp_path / "run.py"
    script.write_text(code)
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO / 'src'}")
    proc = subprocess.run([sys.executable, str(script), str(served.path)],
                          capture_output=True, text=True,
                          env=env, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout
