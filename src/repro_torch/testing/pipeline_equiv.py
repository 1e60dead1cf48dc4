"""Mesh equivalence check: the pipelined train step on a gloo world of
ranks == the single-process step (``repro.testing.pipeline_equiv`` in
torch).

    python -m repro_torch.testing.pipeline_equiv [arch] [stages] [tensor] [n_layers]

Spawns ``8 = data x stages x tensor`` ranks on the CPU, takes one AdamW
step of the reduced arch on the mesh and holds its loss (2e-4) and every
rank's updated parameters (1e-2) against :func:`reference_step` laid out
the same way.  MoE archs run with capacity ``n_experts`` (no drops under
either grouping) and no load-balance loss (an expectation over the routing
group, which differs between micro-batches and the full batch), as in the
JAX package's check.  Exits nonzero on a mismatch.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core import sharding
from repro_torch.core.plan import PipelinePlan, make_plan
from repro_torch.data.synthetic import make_batch
from repro_torch.launch.mesh import MeshShape, run_mesh
from repro_torch.models import registry
from repro_torch.models.common import dtype_of, tree_leaves, tree_map
from repro_torch.optim import AdamW, Optimizer
from repro_torch.train.train_step import local_batch, make_train_state, make_train_step

WORLD = 8


def equiv_config(arch_id: str, stages: int, tensor: int,
                 n_layers: Optional[int] = None) -> ArchConfig:
    """The reduced arch of the check, with JAX's MoE overrides."""
    cfg = get_config(arch_id).reduced()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts), router_aux_weight=0.0))
    return dataclasses.replace(cfg, stages=stages, tensor=tensor)


def mesh_shape(cfg: ArchConfig, plan: PipelinePlan) -> MeshShape:
    return MeshShape(data=plan.data, model=plan.model_axis, pods=plan.pods,
                     tensor=plan.tensor, kv_heads=cfg.n_kv_heads)


def reference_step(cfg: ArchConfig, base_params: dict, batch: dict, optimizer: Optimizer,
                   step_idx: int = 0):
    """Plain single-process step with fp32 masters (the ZeRO path's math):
    ``registry.loss_fn`` and its gradients, then ``optimizer.update`` on
    each leaf from a fresh state -> (new params, loss, metrics)."""
    params = tree_map(lambda a: a.detach().clone().requires_grad_(True), base_params)
    loss, metrics = registry.loss_fn(cfg, params, batch)
    loss.backward()

    def upd(p):
        master = p.detach().float()
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        new_m, _ = optimizer.update(g.float(), master, optimizer.init_state(master), step_idx)
        return new_m.to(p.dtype)

    with torch.no_grad():
        new = tree_map(upd, params)
    return new, float(loss), {k: float(v) for k, v in metrics.items()}


def _to_numpy(tree):
    return tree_map(lambda t: t.detach().float().cpu().numpy(), tree)


def rank_train(mesh, cfg: ArchConfig, plan: PipelinePlan, base_np: dict, batches_np: list,
               optimizer: Optimizer, bidirectional: bool, use_kernels: bool) -> dict:
    """One rank of the check: its state from the base parameters (numpy,
    the registry layout), one step per batch -> the metrics of each step and
    the rank's parameters (numpy, fp32)."""
    dev = mesh.device
    dtype = dtype_of(cfg.param_dtype)
    base = registry.params_from_jax(base_np, device=dev, dtype=dtype)
    params, opt = make_train_state(cfg, plan, mesh, base, optimizer)
    del base
    step = make_train_step(cfg, plan, mesh, optimizer, bidirectional=bidirectional,
                           use_kernels=use_kernels)
    metrics = []
    for k, b in enumerate(batches_np):
        batch = local_batch({n: torch.from_numpy(v).to(dev) for n, v in b.items()}, plan, mesh)
        params, opt, m = step(params, opt, batch, k)
        metrics.append(m)
    return {"rank": mesh.rank, "d": mesh.d, "m": mesh.m, "metrics": metrics,
            "params": _to_numpy(params)}


def mesh_train(cfg: ArchConfig, plan: PipelinePlan, base_np: dict, batches_np: list,
               optimizer: Optimizer, *, bidirectional: bool = True, use_kernels: bool = False,
               device: str = "cpu") -> list:
    """Every rank's :func:`rank_train` result, in rank order."""
    return run_mesh(rank_train, mesh_shape(cfg, plan), cfg, plan, base_np, batches_np,
                    optimizer, bidirectional, use_kernels, device=device)


def worst_param_err(cfg: ArchConfig, plan: PipelinePlan, results: list, want_layout: dict):
    """(path, max |err|) over every rank's parameters against the laid-out
    ``want_layout`` (numpy), each rank against its own view."""
    worst = ("", 0.0)
    want_t = tree_map(torch.from_numpy, want_layout)
    for r in results:
        want = sharding.local_layout(cfg, plan, want_t, d=r["d"], m=r["m"])
        got_l = tree_leaves(r["params"])
        for i, (a, b) in enumerate(zip(got_l, tree_leaves(want))):
            e = float(np.max(np.abs(a - b.float().numpy()))) if a.size else 0.0
            if e > worst[1]:
                worst = (f"rank {r['rank']} leaf {i}", e)
    return worst


def run(arch_id="phi3-mini-3.8b", stages=4, tensor=1, n_layers=None, bidirectional=True,
        seed=0, tol=2e-4) -> bool:
    model_ax = stages * tensor
    data_ax = WORLD // model_ax
    cfg = equiv_config(arch_id, stages, tensor, n_layers)
    shape = InputShape("equiv", 64, 8, "train")
    plan = make_plan(cfg, shape, data=data_ax, model=model_ax, microbatches=2, remat="tick")
    base = registry.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    batch = make_batch(cfg, shape, seed=seed, device="cpu")
    optimizer = AdamW(lr=1e-2)

    results = mesh_train(cfg, plan, _to_numpy(base), [_to_numpy(batch)], optimizer,
                         bidirectional=bidirectional)
    ref_new, ref_loss, _ = reference_step(cfg, base, batch, optimizer)
    want = _to_numpy(sharding.to_pipeline_layout(cfg, plan, ref_new))
    loss = results[0]["metrics"][0]["loss"]
    loss_err = abs(loss - ref_loss)
    worst = worst_param_err(cfg, plan, results, want)
    print(f"[pipeline_equiv] {arch_id} stages={stages} tp={tensor} loss={loss:.5f} "
          f"ref={ref_loss:.5f} loss_err={loss_err:.2e} worst_param={worst[0]} "
          f"err={worst[1]:.2e}")
    return loss_err < tol and worst[1] < tol * 50


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="pipeline-vs-monolithic check on a gloo world")
    ap.add_argument("arch", nargs="?", default="phi3-mini-3.8b")
    ap.add_argument("stages", nargs="?", type=int, default=4)
    ap.add_argument("tensor", nargs="?", type=int, default=1)
    ap.add_argument("n_layers", nargs="?", type=int, default=None)
    a = ap.parse_args()
    sys.exit(0 if run(a.arch, a.stages, a.tensor, a.n_layers) else 1)
