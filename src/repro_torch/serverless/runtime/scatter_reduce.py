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

Numerics: the per-worker gradient vectors are fp32 tensors that stay on
their device.  ``torch.tensor_split`` cuts the same chunk sizes as
``np.array_split``, and :func:`ring_reduce` adds the partials in the JAX
package's order, so given the same vectors the reduction is bit-equal to
the JAX function's; every worker receives the same reduced chunks.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

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
