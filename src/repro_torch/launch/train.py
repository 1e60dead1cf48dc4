"""Training launcher: rank mesh + plan + pipelined train loop
(``repro.launch.train`` in torch).

Spawns ``pods x data x model`` ranks (``launch.mesh``), each on
``cuda:(rank % device_count)`` unless ``--device cpu`` is given, e.g.:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch phi3-mini-3.8b --reduced --data 2 --model 4 --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch train --arch phi3-mini-3.8b --reduced \\
        --data 2 --model 2 --steps 2 --device cpu

The plan is the config's (stages x tensor) factorization, overridable with
``--stages`` / ``--tensor`` / ``--microbatches``.  ``--plan auto`` asks
``core.tpu_planner`` for the best (stages x tp x mu x remat) factorization
instead, on the chip of :func:`plan_chip`: an H100 whose 80 GB are divided
among the ranks that share it (all ranks on the CPU's one "card" with
``--device cpu``).  Each rank checkpoints its own state through the
Function-Manager policy every ``--ckpt-every`` steps, to
``<--ckpt>.rank<r>``.  Rank 0 prints one line a step.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import List, Optional

import torch

from repro_torch.checkpoint import FunctionManager
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import collectives as cc
from repro_torch.core import tpu_planner
from repro_torch.core.plan import make_plan
from repro_torch.data.synthetic import make_batch
from repro_torch.launch.mesh import MeshShape, run_mesh
from repro_torch.launch.roofline import ChipSpec, h100
from repro_torch.models import registry
from repro_torch.optim import AdamW
from repro_torch.train.train_step import local_batch, make_train_state, make_train_step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch train",
                                 description="pipelined mesh training on spawned ranks")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--shape", default=None, help="named input shape or none")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--data", type=int, default=16)
    ap.add_argument("--model", type=int, default=16)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--plan", default="config", choices=["config", "auto"])
    ap.add_argument("--stages", type=int, default=None)
    ap.add_argument("--tensor", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--uni-ring", action="store_true",
                    help="LambdaML-analog unidirectional ring sync")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train.msgpack"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where every rank runs (cuda unless the CPU is asked for)")
    return ap


def _train_rank(mesh, cfg, plan, shape: InputShape, args) -> Optional[List[float]]:
    """One rank's loop: the base parameters from seed 0 on the rank's device
    (every rank draws the same), its slice and optimizer shard, one step a
    batch; rank 0 prints and returns the losses."""
    dev = mesh.device
    base = registry.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    optimizer = AdamW(lr=args.lr)
    params, opt = make_train_state(cfg, plan, mesh, base, optimizer)
    del base
    step_fn = make_train_step(cfg, plan, mesh, optimizer, bidirectional=not args.uni_ring,
                              use_kernels=True)
    fm = FunctionManager(f"{args.ckpt}.rank{mesh.rank}")
    losses = []
    for i in range(args.steps):
        batch = make_batch(cfg, shape, step=i, device="cpu")
        batch = local_batch({k: v.to(dev) for k, v in batch.items()}, plan, mesh)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch, i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        losses.append(metrics["loss"])
        if mesh.rank == 0:
            print(f"step {i:4d} loss={metrics['loss']:.4f} ce={metrics['ce']:.4f} "
                  f"({time.perf_counter() - t0:.2f}s)", flush=True)
        if (i + 1) % args.ckpt_every == 0 or fm.should_checkpoint():
            fm.checkpoint_and_restart((params, opt), i + 1)
            if mesh.rank == 0:
                print(f"  checkpointed -> {args.ckpt}.rank<r>", flush=True)
    return losses if mesh.rank == 0 else None


def plan_chip(world: int, device: str) -> ChipSpec:
    """The chip ``--plan auto`` plans for: an H100 whose memory is divided
    among the ranks that share a card (``world / device_count`` rounded up;
    every rank shares the one "card" on the CPU)."""
    cards = torch.cuda.device_count() if device == "cuda" else 1
    return h100(-(-world // max(1, cards)))


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = INPUT_SHAPES[args.shape] if args.shape else InputShape("cli", args.seq,
                                                                   args.batch, "train")
    overrides = {}
    if args.plan == "auto":
        chip = plan_chip(args.pods * args.data * args.model, args.device)
        best = tpu_planner.solve(cfg, shape, data=args.data, model=args.model,
                                 pods=args.pods, chip=chip)
        if not best:
            raise SystemExit(f"error: no plan fits {chip.hbm_bytes:.3g} bytes a rank "
                             f"({chip.name})")
        p = best[0].plan
        overrides = dict(stages=p.stages, tensor=p.tensor, microbatches=p.microbatches,
                         remat=p.remat)
        print(f"[plan auto] S={p.stages} tp={p.tensor} mu={p.microbatches} "
              f"remat={p.remat} (est {best[0].t_step_est*1e3:.1f} ms/step)", flush=True)
    for k in ("stages", "tensor", "microbatches"):
        if getattr(args, k) is not None:
            overrides[k] = getattr(args, k)
    if "stages" in overrides or "tensor" in overrides:
        cfg = dataclasses.replace(cfg, stages=overrides.get("stages", cfg.stages),
                                  tensor=overrides.get("tensor", cfg.tensor))
    plan = make_plan(cfg, shape, data=args.data, model=args.model, pods=args.pods, **overrides)
    print(f"plan: stages={plan.stages} tensor={plan.tensor} mu={plan.microbatches} "
          f"ep={plan.ep} remat={plan.remat} ranks={plan.world} device={args.device} "
          f"transport={cc.TRANSPORT}", flush=True)
    mesh = MeshShape(data=plan.data, model=plan.model_axis, pods=plan.pods,
                     tensor=plan.tensor, kv_heads=cfg.n_kv_heads)
    run_mesh(_train_rank, mesh, cfg, plan, shape, args, device=args.device)
    print("done.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
