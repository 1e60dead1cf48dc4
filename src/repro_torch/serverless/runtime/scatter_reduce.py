"""Storage-based gradient scatter-reduce over store keys
(``repro.serverless.runtime.scatter_reduce`` for the port, paper §3.3).

``three_phase_scatter_reduce``
    LambdaML's barriered collective (paper eq (1)): every worker uploads the
    n-1 chunks owned by the others; after a barrier each worker downloads the
    n-1 partials of its own chunk, reduces and re-uploads it; after a second
    barrier everyone downloads the n-1 reduced chunks.  The emulated time is
    eq (1) exactly: ``3 s/w - 2 s/(n w) + 4 t_lat``.

``pipelined_scatter_reduce``
    FuncPipe's barrier-free full-duplex schedule (paper eq (2)): staggered
    partial uploads, each destination pulling its partials as they become
    visible, reducing and re-uploading, then pulling the other reduced
    chunks; ``~2 s/w + O(n) t_lat``.

``local_scatter_reduce``
    One worker's share of either schedule on a wall-clock store, run by
    ``n`` concurrent workers over blocking gets.

Numerics: the per-worker gradient vectors are fp32 tensors that stay on
their device.  ``torch.tensor_split`` cuts the same chunk sizes as
``np.array_split``, and :func:`ring_reduce` adds the partials in the JAX
package's order, so given the same vectors the reduction is bit-equal to
the JAX function's; every worker receives the same reduced chunks.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.obs.ranges import BARRIER, SYNC, phase_range, ranged
from repro_torch.serverless.runtime.store import ObjectStore, StageChannel


def _chunk_values(values, n: int):
    if values is None:
        return None
    return [torch.tensor_split(v, n) for v in values]


def _cleanup(store: ObjectStore, key_prefix: str, n: int) -> None:
    """Every consumer has pulled its chunks by return time: free the keys."""
    for j in range(n):
        for i in range(n):
            if i != j:
                store.delete(f"{key_prefix}/part/{j}/{i}")
        store.delete(f"{key_prefix}/red/{j}")


def ring_reduce(own: torch.Tensor, parts) -> torch.Tensor:
    """The collective's deterministic fp32 reduction: start from the owned
    chunk, add the partials in the order given."""
    acc = own.to(torch.float32, copy=True)
    for p in parts:
        acc += p.to(torch.float32)
    return acc


def _reduce_chunks(chunks, owner: int, n: int) -> torch.Tensor:
    """Owner's deterministic order: own chunk, then ring order."""
    return ring_reduce(chunks[owner][owner],
                       [chunks[(owner - r) % n][owner] for r in range(1, n)])


def _check(store, channels, ready) -> int:
    n = len(channels)
    if len(ready) != n:
        raise ValueError(f"{len(ready)} ready times for {n} workers")
    if any(ch.store is not store for ch in channels):
        raise ValueError("every channel must use the collective's store")
    return n


def three_phase_scatter_reduce(
    store: ObjectStore,
    channels: Sequence[StageChannel],
    nbytes: float,
    ready: Sequence[float],
    *,
    values: Optional[Sequence[torch.Tensor]] = None,
    key_prefix: str = "sr3",
) -> Tuple[Optional[torch.Tensor], List[float]]:
    """LambdaML 3-phase collective.  Returns (reduced vector | None, end times)."""
    n = _check(store, channels, ready)
    if n == 1:
        v = None if values is None else values[0].to(torch.float32)
        return v, [ready[0]]
    chunk_b = nbytes / n
    chunks = _chunk_values(values, n)

    # phase 1: worker i uploads its partials of everyone else's chunk
    for i, ch in enumerate(channels):
        for r in range(1, n):
            j = (i + r) % n
            val = None if chunks is None else chunks[i][j]
            ch.upload(f"{key_prefix}/part/{j}/{i}", chunk_b, ready=ready[i],
                      value=val, new_request=r == 1)
    barrier1 = max(ch.up_free for ch in channels)

    # phase 2: download the n-1 partials of the owned chunk, reduce, re-upload
    reduced_chunks: List[Optional[torch.Tensor]] = [None] * n
    for i, ch in enumerate(channels):
        for r in range(1, n):
            src = (i - r) % n
            _, t = ch.download(f"{key_prefix}/part/{i}/{src}", ready=barrier1,
                               new_request=r == 1)
        if chunks is not None:
            reduced_chunks[i] = _reduce_chunks(chunks, i, n)
        ch.upload(f"{key_prefix}/red/{i}", chunk_b, ready=t,
                  value=reduced_chunks[i], new_request=True)
    barrier2 = max(ch.up_free for ch in channels)

    # phase 3: everyone downloads the other n-1 reduced chunks
    ends = []
    for i, ch in enumerate(channels):
        t = barrier2
        for r in range(1, n):
            src = (i + r) % n
            _, t = ch.download(f"{key_prefix}/red/{src}", ready=barrier2,
                               new_request=r == 1)
        ends.append(t)

    _cleanup(store, key_prefix, n)
    reduced = None if chunks is None else torch.cat(reduced_chunks)
    return reduced, ends


@ranged(SYNC)
def local_scatter_reduce(
    store,
    index: int,
    n: int,
    nbytes: float,
    value: Optional[torch.Tensor],
    *,
    key_prefix: str,
    pipelined: bool = True,
    barrier=None,
    tracer=None,
    clock=None,
) -> Optional[torch.Tensor]:
    """One worker's share of the storage scatter-reduce on a wall-clock
    store (``backends.local.LocalStore`` and its file and S3 kin): call from
    ``n`` concurrent workers, each with its own ``index``.

    It moves the same objects under the same keys as the emulated
    collectives and reduces through :func:`ring_reduce` in the same ring
    order, so the vector is bit-identical to theirs; here ``store.take`` and
    ``store.get`` block until the producer's put lands.  ``pipelined=False``
    adds the two phase barriers of the eq (1) collective (``barrier`` a
    ``threading.Barrier(n)`` or a ``FileBarrier``); eq (2) needs none.
    Either way a last barrier fences the cleanup: a worker frees its reduced
    chunk only after every peer has pulled it.

    With ``tracer`` set (a ``repro_torch.obs.WorkerTracer``, its times read
    from ``clock``, seconds), every chunk put, take or get and every barrier wait
    emits one wall-clock span; a fetch's span covers its visibility wait.
    Under a running ``torch.profiler`` the whole share runs in the range
    ``funcpipe/sync`` and each barrier wait in ``funcpipe/barrier``."""
    i = index
    if n == 1:
        return None if value is None else value.to(torch.float32)

    def put(key, val):
        if tracer is None:
            store.put(key, chunk_b, value=val)
            return
        t0 = clock()
        charged = store.put(key, chunk_b, value=val)
        tracer.emit("upload", t0, clock(), nbytes=charged, key=key)

    def fetch(op, key):
        if tracer is None:
            return op(key)
        t0 = clock()
        val, nb = op(key, True)
        tracer.emit("download", t0, clock(), nbytes=nb, key=key)
        return val

    def wait(b):
        t0 = None if tracer is None else clock()
        with phase_range(BARRIER):
            b.wait()
        if tracer is not None:
            tracer.emit("barrier", t0, clock())

    chunk_b = nbytes / n
    chunks = None if value is None else torch.tensor_split(value, n)

    # scatter: upload my partials of everyone else's chunk, staggered order
    for r in range(1, n):
        j = (i + r) % n
        put(f"{key_prefix}/part/{j}/{i}", None if chunks is None else chunks[j])
    if not pipelined and barrier is not None:
        wait(barrier)                     # eq (1) phase-1 barrier

    # reduce: pull the n-1 partials of the owned chunk as they surface,
    # reduce in ring order, publish the reduced chunk
    parts = [fetch(store.take, f"{key_prefix}/part/{i}/{(i - r) % n}") for r in range(1, n)]
    reduced_i = None if chunks is None else ring_reduce(chunks[i], parts)
    put(f"{key_prefix}/red/{i}", reduced_i)
    if not pipelined and barrier is not None:
        wait(barrier)                     # eq (1) phase-2 barrier

    # all-gather: pull the other reduced chunks
    out: List[Optional[torch.Tensor]] = [None] * n
    out[i] = reduced_i
    for r in range(1, n):
        src = (i + r) % n
        out[src] = fetch(store.get, f"{key_prefix}/red/{src}")
    if barrier is not None:
        wait(barrier)                     # cleanup fence: every peer has read
    store.delete(f"{key_prefix}/red/{i}")
    return None if chunks is None else torch.cat(out)


def pipelined_scatter_reduce(
    store: ObjectStore,
    channels: Sequence[StageChannel],
    nbytes: float,
    ready: Sequence[float],
    *,
    values: Optional[Sequence[torch.Tensor]] = None,
    key_prefix: str = "srp",
) -> Tuple[Optional[torch.Tensor], List[float]]:
    """FuncPipe pipelined collective.  Returns (reduced vector | None, end times)."""
    n = _check(store, channels, ready)
    if n == 1:
        v = None if values is None else values[0].to(torch.float32)
        return v, [ready[0]]
    chunk_b = nbytes / n
    chunks = _chunk_values(values, n)

    # scatter: staggered partial-chunk uploads, one pipelined stream each
    for i, ch in enumerate(channels):
        for r in range(1, n):
            j = (i + r) % n
            val = None if chunks is None else chunks[i][j]
            ch.upload(f"{key_prefix}/part/{j}/{i}", chunk_b, ready=ready[i],
                      value=val, new_request=r == 1)

    # reduce: pull the partials as they surface, reduce, re-upload; the
    # reduced-chunk upload queues behind the scatter uploads on the uplink
    reduced_chunks: List[Optional[torch.Tensor]] = [None] * n
    red_up_end = [0.0] * n
    for i, ch in enumerate(channels):
        for r in range(1, n):
            src = (i - r) % n
            _, t = ch.download(f"{key_prefix}/part/{i}/{src}", new_request=True)
        if chunks is not None:
            reduced_chunks[i] = _reduce_chunks(chunks, i, n)
        red_up_end[i] = ch.upload(f"{key_prefix}/red/{i}", chunk_b, ready=t,
                                  value=reduced_chunks[i], new_request=True)

    # all-gather: pull the other reduced chunks as they surface
    ends = []
    for i, ch in enumerate(channels):
        t = red_up_end[i]
        for r in range(1, n):
            src = (i + r) % n
            _, t = ch.download(f"{key_prefix}/red/{src}", new_request=True)
        ends.append(max(t, red_up_end[i]))

    _cleanup(store, key_prefix, n)
    reduced = None if chunks is None else torch.cat(reduced_chunks)
    return reduced, ends
