"""Ring collectives and the in-graph collectives of the rank mesh
(``repro.core.collectives`` in torch).

The paper's insight is that LambdaML's 3-phase scatter-reduce leaves the
uplink idle while downloading and vice versa (eq (1): 3s/w - 2s/(nw)); its
pipelined schedule drives both directions at once (eq (2): 2s/w).  On a
mesh of ranks the same resource is a full-duplex link: a *unidirectional*
ring reduce-scatter/all-gather (the LambdaML-equivalent baseline) moves
N(D-1)/D bytes through one direction serially; the *bidirectional* ring
splits every chunk in half and runs two opposing rings at once, each step's
sends of both rings issued together.  The rings are built from
point-to-point sends (``dist.batch_isend_irecv``), as JAX builds them from
``ppermute``, with the same chunk ownership and the same order of
additions; a library reduce-scatter or all-gather would be neither
schedule.

Transport: every operation goes through gloo.  NCCL refuses two ranks on
one card and gloo's point-to-point ops take host buffers, so a CUDA tensor
is moved through a host copy in one helper (:func:`_to_wire` /
:func:`_from_wire`); the additions of the rings stay on the tensor's own
device.  :data:`STATS` counts each category's calls, seconds and payload
bytes on this rank.

In-graph collectives (:func:`psum`, :func:`all_to_all`) are
``torch.autograd.Function``\\ s.  ``psum``'s backward is again a psum over
the same group: the mesh path differentiates a *lane-local* loss (each tp
lane holds its share of the CE), exactly as JAX under ``check_vma=False``
transposes psum to psum.  The EP all-to-all's backward is the reverse
all-to-all.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


# ----------------------------------------------------------------- mesh groups
def tp_groups(stages: int, tp: int) -> list[list[int]]:
    """Sub-groups of the 'model' axis: index m = stage*tp + t."""
    return [[s * tp + t for t in range(tp)] for s in range(stages)]


def stage_peers(stages: int, tp: int) -> list[list[int]]:
    """Groups of model indices holding the same tp slice across stages."""
    return [[s * tp + t for s in range(stages)] for t in range(tp)]


def pipeline_perm(stages: int, tp: int) -> list[tuple[int, int]]:
    """(src, dst) pairs moving activations stage s -> s+1 (no wraparound)."""
    return [(s * tp + t, (s + 1) * tp + t) for s in range(stages - 1) for t in range(tp)]


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis (or sub-axis) of the rank mesh as this rank sees it: the
    global ranks along it in axis order, this rank's position, and the gloo
    subgroup (None for an axis of one)."""

    ranks: Tuple[int, ...]
    index: int
    group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return len(self.ranks)


# ------------------------------------------------------------------ transport
TRANSPORT = "gloo, host-staged"

#: per category: calls, seconds (host clock around the operation, host
#: copies included) and payload bytes this rank sent or reduced
STATS: dict = defaultdict(lambda: {"calls": 0, "seconds": 0.0, "bytes": 0})


def reset_stats() -> None:
    STATS.clear()


def stats() -> dict:
    return {k: dict(v) for k, v in sorted(STATS.items())}


def _count(kind: str, t0: float, nbytes: int) -> None:
    s = STATS[kind]
    s["calls"] += 1
    s["seconds"] += time.perf_counter() - t0
    s["bytes"] += nbytes


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """The host buffer gloo sends from: ``t`` itself on the CPU (contiguous),
    a host copy of a CUDA tensor."""
    t = t.contiguous()
    return t.cpu() if t.is_cuda else t


def _from_wire(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A received host buffer on ``like``'s device."""
    return buf.to(like.device, non_blocking=False) if like.is_cuda else buf


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(x: torch.Tensor, axis: Axis, op=dist.ReduceOp.SUM, *,
               kind: str = "psum") -> torch.Tensor:
    """Sum (or ``op``) of ``x`` over ``axis``, as a new tensor on x's device.
    gloo's all-reduce leaves the same bits on every member."""
    if axis.size == 1:
        return x
    t0 = time.perf_counter()
    buf = _to_wire(x)
    if buf is x or buf.data_ptr() == x.data_ptr():
        buf = buf.clone()
    dist.all_reduce(buf, op=op, group=axis.group)
    out = _from_wire(buf, x)
    _count(kind, t0, _nbytes(buf))
    return out


def exchange(sends: Sequence[Tuple[torch.Tensor, int, int]],
             recvs: Sequence[Tuple[torch.Tensor, int, int]], *, group=None,
             kind: str = "p2p") -> List[torch.Tensor]:
    """One round of point-to-point transfers: each ``(tensor, peer, tag)``
    of ``sends`` goes to global rank ``peer``; each ``(like, peer, tag)`` of
    ``recvs`` receives a tensor shaped like ``like`` from ``peer``, returned
    on like's device in order.  All are posted at once and waited for;
    transfers between one pair of ranks are told apart by their tags."""
    t0 = time.perf_counter()
    ops, bufs, nbytes = [], [], 0
    for t, peer, tag in sends:
        w = _to_wire(t)
        nbytes += _nbytes(w)
        ops.append(dist.P2POp(dist.isend, w, peer, group, tag))
    for like, peer, tag in recvs:
        b = torch.empty(like.shape, dtype=like.dtype)
        bufs.append(b)
        ops.append(dist.P2POp(dist.irecv, b, peer, group, tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = [_from_wire(b, like) for b, (like, _, _) in zip(bufs, recvs)]
    _count(kind, t0, nbytes)
    return out


def send(t: torch.Tensor, peer: int, *, tag: int = 0):
    """Post ``t`` to global rank ``peer`` on the world group; returns the
    pending work and its host buffer (keep both until :func:`wait_sends`)."""
    t0 = time.perf_counter()
    w = _to_wire(t)
    work = dist.isend(w, peer, tag=tag)
    _count("p2p", t0, _nbytes(w))
    return work, w


def wait_sends(pending: list) -> None:
    t0 = time.perf_counter()
    for work, _ in pending:
        work.wait()
    pending.clear()
    STATS["p2p"]["seconds"] += time.perf_counter() - t0


def recv(shape, dtype, device, peer: int, *, tag: int = 0) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` from global rank ``peer``, on
    ``device``."""
    t0 = time.perf_counter()
    b = torch.empty(shape, dtype=dtype)
    dist.recv(b, peer, tag=tag)
    out = b.to(device) if torch.device(device).type == "cuda" else b
    STATS["p2p"]["seconds"] += time.perf_counter() - t0
    return out


# ------------------------------------------------------------- ring primitives
def _ring_steps(rings, axis: Axis, *, kind: str):
    """Run the rings of ``rings`` (each ``(state, sgn, step_fn)``) together:
    every step each ring sends its buffer to ``index + sgn`` and receives
    from ``index - sgn``, all rings' transfers of a step in one batch, then
    ``step_fn(k, received)`` gives the ring's next buffer."""
    D, idx = axis.size, axis.index
    bufs = [r[0] for r in rings]
    for k in range(D - 1):
        sends = [(b, axis.ranks[(idx + sgn) % D], j)
                 for j, (b, (_, sgn, _)) in enumerate(zip(bufs, rings))]
        recvs = [(b, axis.ranks[(idx - sgn) % D], j)
                 for j, (b, (_, sgn, _)) in enumerate(zip(bufs, rings))]
        got = exchange(sends, recvs, group=axis.group, kind=kind)
        bufs = [fn(k, g) for g, (_, _, fn) in zip(got, rings)]
    return bufs


def _rs_ring(x: torch.Tensor, D: int, idx: int, reverse: bool):
    """The ring state of a reduce-scatter of x [D*c, ...]: rightward
    (reverse False), the packet for chunk i starts at rank i+1 and arrives
    at i after D-1 hops, each hop adding the local copy."""
    chunks = x.reshape(D, x.shape[0] // D, *x.shape[1:])
    sgn = -1 if reverse else 1

    def step(k, buf):
        return buf + chunks[(idx - sgn * (2 + k)) % D]

    return chunks[(idx - sgn) % D], sgn, step


def _ag_ring(x: torch.Tensor, out: torch.Tensor, D: int, idx: int, reverse: bool):
    """The ring state of an all-gather of x [c, ...] into out [D, c, ...]:
    each rank receives from ``index + sgn``, so after k steps it holds chunk
    ``index + k*sgn``."""
    sgn = -1 if reverse else 1
    out[idx] = x

    def step(k, cur):
        out[(idx + sgn * (k + 1)) % D] = cur
        return cur

    # the all-gather's packets travel against the ring's sgn
    return x, -sgn, step


def _check_rs(x: torch.Tensor, D: int) -> None:
    if x.shape[0] % D:
        raise ValueError(f"leading dim {x.shape[0]} is not a multiple of the axis size {D}")


def ring_reduce_scatter(x: torch.Tensor, axis: Axis, *, bidirectional: bool = True) -> torch.Tensor:
    """Reduce-scatter along ``axis``; leading dim divided by the axis size.
    Rank i receives the canonical chunk x[i*c:(i+1)*c] summed over ranks.

    bidirectional=True is the FuncPipe-analog schedule: each half of every
    chunk travels in the opposite ring direction in the same step, so both
    link directions carry payload.  False = the LambdaML-equivalent
    single-direction ring.  Both give the SAME canonical chunk layout (each
    chunk is split within its leading dim)."""
    D, idx = axis.size, axis.index
    if D == 1:
        return x
    _check_rs(x, D)
    c = x.shape[0] // D
    if not bidirectional or c % 2:
        (out,) = _ring_steps([_rs_ring(x, D, idx, False)], axis, kind="ring_rs")
        return out
    chunks = x.reshape(D, c, *x.shape[1:])
    lo = chunks[:, : c // 2].reshape(D * c // 2, *x.shape[1:])
    hi = chunks[:, c // 2:].reshape(D * c // 2, *x.shape[1:])
    a, b = _ring_steps([_rs_ring(lo, D, idx, False), _rs_ring(hi, D, idx, True)], axis,
                       kind="ring_rs")
    return torch.cat([a, b], dim=0)


def ring_all_gather(x: torch.Tensor, axis: Axis, *, bidirectional: bool = True) -> torch.Tensor:
    """All-gather along ``axis``; leading dim multiplied by the axis size.
    Canonical layout: output[i*c:(i+1)*c] == rank i's input."""
    D, idx = axis.size, axis.index
    if D == 1:
        return x
    c = x.shape[0]
    if not bidirectional or c % 2:
        out = x.new_empty((D, *x.shape))
        _ring_steps([_ag_ring(x, out, D, idx, False)], axis, kind="ring_ag")
        return out.reshape(D * c, *x.shape[1:])
    a = x.new_empty((D, c // 2, *x.shape[1:]))
    b = x.new_empty((D, c - c // 2, *x.shape[1:]))
    _ring_steps([_ag_ring(x[: c // 2], a, D, idx, False),
                 _ag_ring(x[c // 2:], b, D, idx, True)], axis, kind="ring_ag")
    return torch.cat([a, b], dim=1).reshape(D * c, *x.shape[1:])


# --------------------------------------------------- in-graph (autograd) ops
class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, kind):
        ctx.axis, ctx.kind = axis, kind
        return all_reduce(x, axis, kind=kind)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.axis, kind=ctx.kind), None, None


def psum(x: torch.Tensor, axis: Axis, *, kind: str = "psum_tp") -> torch.Tensor:
    """Differentiable sum over ``axis``; its backward is a psum too (the
    transpose JAX takes under ``check_vma=False``)."""
    if axis.size == 1:
        return x
    return _Psum.apply(x, axis, kind)


def _a2a(x: torch.Tensor, axis: Axis, back: bool) -> torch.Tensor:
    """JAX's tiled ``all_to_all`` over ``axis``.  Forward: x [E, C, d] ->
    [E/D, C*D, d] (split experts, concatenate capacity); back: the reverse."""
    D = axis.size
    t0 = time.perf_counter()
    if back:
        E_l, CD, d = x.shape
        send_ = x.reshape(E_l, D, CD // D, d).transpose(0, 1)
    else:
        E, C, d = x.shape
        send_ = x.reshape(D, E // D, C, d)
    w = _to_wire(send_)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=axis.group)
    got = _from_wire(out, x)          # got[j] = rank j's block for this rank
    _count("a2a_ep", t0, _nbytes(w))
    if back:
        return got.reshape(D * got.shape[1], got.shape[2], got.shape[3])
    return got.transpose(0, 1).reshape(got.shape[1], D * got.shape[2], got.shape[3])


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, back):
        ctx.axis, ctx.back = axis, back
        return _a2a(x, axis, back)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g.contiguous(), ctx.axis, not ctx.back), None, None


def all_to_all(x: torch.Tensor, axis: Axis, *, back: bool = False) -> torch.Tensor:
    """Expert-parallel exchange (differentiable): the forward direction when
    ``back`` is False, its inverse when True."""
    if axis.size == 1:
        return x
    return _AllToAll.apply(x, axis, back)


# ------------------------------------------------------------ analytic timing
@dataclasses.dataclass(frozen=True)
class CollectiveCost:
    bytes_on_link: float   # bytes through the busiest link direction
    steps: int             # ring steps (latency term)


def reduce_scatter_cost(nbytes: float, d: int, bidirectional: bool) -> CollectiveCost:
    if d <= 1:
        return CollectiveCost(0.0, 0)
    per_dir = nbytes * (d - 1) / d
    if bidirectional:
        return CollectiveCost(per_dir / 2, d - 1)
    return CollectiveCost(per_dir, d - 1)


def all_gather_cost(nbytes: float, d: int, bidirectional: bool) -> CollectiveCost:
    return reduce_scatter_cost(nbytes, d, bidirectional)


def all_reduce_cost(nbytes: float, d: int, bidirectional: bool) -> CollectiveCost:
    rs = reduce_scatter_cost(nbytes, d, bidirectional)
    return CollectiveCost(rs.bytes_on_link * 2, rs.steps * 2)
