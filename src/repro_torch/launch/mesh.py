"""The rank mesh: the SPMD runtime of the mesh path (``repro.launch.mesh``
in torch, which builds a ``jax.make_mesh``).

A mesh of ``pods x data x model`` ranks, each a process of its own spawned
by :func:`run_mesh`.  Rank ``(pod, d, m)`` is ``(pod*data + d)*model + m``,
the row-major order of ``jax.make_mesh`` on CPU devices, so a layout
compares index for index with the JAX package's.  The model index ``m`` is
``stage*tensor + lane``.  Each rank builds the gloo subgroups it takes part
in: its tp group (one stage's lanes), its kv-share group (GQA lanes that
replicate one KV head), its data ring, its whole model axis, its pod axis,
and the sequence-shard axis (pod x data) of long-context decode.

Ranks meet through a ``FileStore`` in a temporary directory (never a fixed
TCP port), and every group has a timeout (:data:`TIMEOUT_S`), so a hang
fails the launch rather than the caller's clock.  A rank that raises makes
:func:`run_mesh` kill the others and raise with that rank's traceback.
On a card every rank runs on ``cuda:(rank % device_count)`` with its own
CUDA context (four ranks may share one H100); ``device="cpu"`` asks for
the CPU.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.collectives import Axis

TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class MeshShape:
    data: int
    model: int
    pods: int = 1
    tensor: int = 1
    kv_heads: int = 0        # the arch's KV heads (kv-share groups when < tensor)

    @property
    def world(self) -> int:
        return self.pods * self.data * self.model

    @property
    def stages(self) -> int:
        return self.model // self.tensor

    def coords(self, rank: int) -> Tuple[int, int, int]:
        """(pod, d, m) of a global rank."""
        m = rank % self.model
        d = (rank // self.model) % self.data
        return rank // (self.model * self.data), d, m

    def rank_of(self, pod: int, d: int, m: int) -> int:
        return (pod * self.data + d) * self.model + m


@dataclasses.dataclass
class RankMesh:
    """One rank's view of the mesh: its coordinates, its device and its
    axes (:class:`~repro_torch.core.collectives.Axis`)."""

    shape: MeshShape
    rank: int
    device: torch.device
    axes: Dict[str, Axis]

    @property
    def pod(self) -> int:
        return self.shape.coords(self.rank)[0]

    @property
    def d(self) -> int:
        return self.shape.coords(self.rank)[1]

    @property
    def m(self) -> int:
        return self.shape.coords(self.rank)[2]

    @property
    def stage(self) -> int:
        return self.m // self.shape.tensor

    @property
    def lane(self) -> int:
        return self.m % self.shape.tensor

    def peer(self, stage: int) -> int:
        """The global rank of stage ``stage`` on this rank's lane, pod and
        data index (the pipeline's neighbour)."""
        return self.shape.rank_of(self.pod, self.d, stage * self.shape.tensor + self.lane)


def _axis_groups(shape: MeshShape) -> Dict[str, list]:
    """Every group of every axis, as lists of global ranks in axis order:
    the order in which each rank must create them."""
    P, D, M, tp = shape.pods, shape.data, shape.model, shape.tensor
    S = M // tp
    r = shape.rank_of
    out: Dict[str, list] = {
        "tp": [[r(p, d, s * tp + t) for t in range(tp)]
               for p in range(P) for d in range(D) for s in range(S)],
        "data": [[r(p, d, m) for d in range(D)] for p in range(P) for m in range(M)],
        "model": [[r(p, d, m) for m in range(M)] for p in range(P) for d in range(D)],
        "pod": [[r(p, d, m) for p in range(P)] for d in range(D) for m in range(M)],
        "seq": [[r(p, d, m) for p in range(P) for d in range(D)] for m in range(M)],
    }
    if tp > 1 and 0 < shape.kv_heads < tp:
        share = tp // shape.kv_heads
        out["kvshare"] = [[r(p, d, s * tp + g * share + u) for u in range(share)]
                          for p in range(P) for d in range(D) for s in range(S)
                          for g in range(shape.kv_heads)]
    return out


def _build_axes(shape: MeshShape, rank: int) -> Dict[str, Axis]:
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    axes = {"world": Axis(tuple(range(shape.world)), rank, None)}
    for name, groups in _axis_groups(shape).items():
        for ranks in groups:
            # every rank creates every group (gloo's rule), keeping its own
            pg = dist.new_group(ranks, timeout=timeout) if len(ranks) > 1 else None
            if rank in ranks:
                axes[name] = Axis(tuple(ranks), ranks.index(rank), pg)
    return axes


def _rank_main(rank: int, world: int, store_path: str, device: str, jobs_path: str,
               results) -> None:
    try:
        # gloo resolves this host's name for its pairs; a sandbox without a
        # resolvable name still has the loopback device
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        # deterministic cuBLAS (use_deterministic_algorithms below) needs a
        # fixed workspace, set before the rank's CUDA context exists
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        # one intra-op thread: the ranks share the host's cores
        torch.set_num_threads(1)
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.use_deterministic_algorithms(True)
        else:
            dev = torch.device("cpu")
        timeout = datetime.timedelta(seconds=TIMEOUT_S)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world, timeout=timeout)
        try:
            with open(jobs_path, "rb") as f:
                jobs = pickle.load(f)
            outs = []
            for fn, shape, args in jobs:
                mesh = RankMesh(shape, rank, dev, _build_axes(shape, rank))
                outs.append(fn(mesh, *args))
            results.put((rank, "ok", outs))
        finally:
            dist.destroy_process_group()
    except BaseException:
        # the parent re-raises it with this traceback and stops the others
        results.put((rank, "error", traceback.format_exc()))
        raise


class RankError(RuntimeError):
    """A rank of :func:`run_mesh` raised; the message holds its traceback."""


def run_jobs(jobs: Sequence[Tuple[Callable, MeshShape, tuple]], *,
             device: str = "cuda") -> List[list]:
    """Spawn one world of ranks and run the jobs ``(fn, shape, args)`` in
    it one after the other, each ``fn(mesh, *args)`` on a mesh of its own
    shape (every shape of the world's size; each job builds its groups).
    Returns each job's results in rank order.  ``fn`` must be importable by
    module path (the ranks are spawned); the jobs are pickled once, into a
    file every rank reads (a spawned child's arguments would go through its
    pipe while the parent waits for it to start).  On a card the kernels
    are built here first, so the ranks load the finished libraries.  If a
    rank raises, the others are killed and :class:`RankError` carries that
    rank's traceback."""
    world = jobs[0][1].world
    if any(shape.world != world for _, shape, _ in jobs):
        raise ValueError("the jobs' meshes differ in size")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available; "
                               "pass device='cpu' to run on the CPU")
        from repro_torch.kernels import build as kernel_build

        kernel_build.build_all()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_mesh_") as tmp:
        store, jobs_path = os.path.join(tmp, "store"), os.path.join(tmp, "jobs.pkl")
        with open(jobs_path, "wb") as f:
            pickle.dump(list(jobs), f, protocol=pickle.HIGHEST_PROTOCOL)
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, store, dev.type, jobs_path, results),
                             daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        out: Dict[int, Any] = {}
        wait = 30 * TIMEOUT_S
        try:
            while len(out) < world:
                try:
                    rank, status, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and not p.is_alive()]
                    if dead:
                        raise RankError(f"rank {dead[0]} exited with code "
                                        f"{procs[dead[0]].exitcode} and no result")
                    wait -= 1.0
                    if wait <= 0:
                        raise RankError(f"ranks {sorted(set(range(world)) - set(out))} "
                                        "gave no result in time")
                    continue
                if status == "error":
                    raise RankError(f"rank {rank} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(timeout=TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=10)
            results.close()
    return [[out[r][j] for r in range(world)] for j in range(len(jobs))]


def run_mesh(fn: Callable, shape: MeshShape, *args: Any, device: str = "cuda") -> list:
    """Spawn ``shape.world`` ranks, run ``fn(mesh, *args)`` in each and
    return the ranks' results in rank order (:func:`run_jobs` with one
    job)."""
    return run_jobs([(fn, shape, args)], device=device)[0]
