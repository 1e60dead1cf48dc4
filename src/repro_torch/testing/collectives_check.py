"""Ring collectives on a gloo world of ranks (``repro.testing.
collectives_check`` in torch).

    python -m repro_torch.testing.collectives_check [--ranks 8] [--device cpu]

On JAX's shapes, every rank's ring reduce-scatter (uni- and bidirectional)
against the exact chunk sums, its ring all-gather against the gathered
inputs, and a reduce-scatter then all-gather of the halved shard (the ZeRO
update's shape) against the halved sums.  Each rank draws its input from
its own seed with numpy; the sums are formed in float64.  Exits nonzero
past 1e-5 (1e-4 for the composition).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.core import collectives as cc
from repro_torch.launch.mesh import MeshShape, run_mesh


def shapes(D: int) -> list:
    """JAX's cases: the local leading dim a multiple of D."""
    return [(D * D * 2,), (D * D * 2, 6), (D * D, 3, 5), (D * D * 3,)]


def _inputs(shape, D: int, seed: int = 0) -> np.ndarray:
    """[D, *shape]: rank i's input at index i."""
    return np.random.default_rng(seed).standard_normal((D, *shape)).astype(np.float32)


def rank_check(mesh, device: str) -> dict:
    """One rank's errors on every case, over the whole data axis, and its
    reduce-scatter outputs of the first case (``"rs"``, by ``bidi``)."""
    axis = mesh.axes["data"]
    D, i = axis.size, axis.index
    errs = {"rs": {}}
    for n, shape in enumerate(shapes(D)):
        xs = _inputs(shape, D)
        x = torch.from_numpy(xs[i]).to(device)
        want_rs = xs.astype(np.float64).sum(0).reshape(D, -1, *shape[1:])[i]
        for bi in (False, True):
            rs = cc.ring_reduce_scatter(x, axis, bidirectional=bi).cpu().numpy()
            ag = cc.ring_all_gather(x, axis, bidirectional=bi).cpu().numpy()
            want_ag = xs.reshape(D * shape[0], *shape[1:])
            errs[f"{shape}/bidi={bi}"] = (float(np.max(np.abs(rs - want_rs))),
                                          float(np.max(np.abs(ag - want_ag))))
            if n == 0:
                errs["rs"][bi] = rs
    xs = _inputs((D * 32,), D, seed=1)
    x = torch.from_numpy(xs[i]).to(device)
    shard = cc.ring_reduce_scatter(x, axis, bidirectional=True)
    got = cc.ring_all_gather(shard * 0.5, axis, bidirectional=True).cpu().numpy()
    want = 0.5 * xs.astype(np.float64).sum(0)
    errs["compose"] = float(np.max(np.abs(got - want)))
    return errs


def run(ranks: int = 8, device: str = "cpu") -> bool:
    results = run_mesh(rank_check, MeshShape(data=ranks, model=1), device,
                       device=device)
    ok = True
    for key in results[0]:
        if key == "rs":
            continue
        if key == "compose":
            e = max(r[key] for r in results)
            print(f"compose_err={e:.1e}")
            ok &= e < 1e-4
            continue
        e1 = max(r[key][0] for r in results)
        e2 = max(r[key][1] for r in results)
        print(f"{key} rs_err={e1:.1e} ag_err={e2:.1e}")
        ok &= e1 < 1e-5 and e2 < 1e-5
    # analytic costs: bidi halves link bytes
    c_uni = cc.reduce_scatter_cost(1e9, 16, False)
    c_bi = cc.reduce_scatter_cost(1e9, 16, True)
    ok &= abs(c_bi.bytes_on_link * 2 - c_uni.bytes_on_link) < 1.0
    return ok


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="ring collectives on a gloo world")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cpu")
    a = ap.parse_args()
    sys.exit(0 if run(a.ranks, a.device) else 1)
