"""Shape-only dry run of every (architecture x input shape) on the production
meshes (``repro.launch.dryrun`` in torch).

The JAX package lowers and compiles each combination on 512 fake XLA
devices and records the compiler's memory and cost analysis beside the
analytic roofline.  No torch program is compiled for a mesh, so this dry run
spawns no ranks, allocates nothing and touches no CUDA state.  For one
(arch x shape x mesh) it records, from shapes alone:

* the plan ``make_plan`` gives on the 16x16 (or 2x16x16) mesh;
* ``memory.argument_bytes``: one rank's parameters, optimizer state (AdamW:
  fp32 master, m and v of its ZeRO-1 shard) and batch, plus its caches for
  decode, from the shapes the port holds equal to the JAX package's
  (``core.sharding.abstract_layout_shapes``, ``train.train_step.
  _master_shape``, ``train.serve_step.cache_specs``, ``data.specs``), with
  ``core.tpu_planner._hbm_estimate`` beside it; the compiler's output, temp
  and peak bytes are ``null`` (no compiler was asked);
* ``roofline``: the analytic roofline (``launch.roofline``) with the JAX
  package's constants, as JAX's dry run;
* ``roofline_counted`` in place of XLA's cost analysis: the FLOPs that
  ``torch.utils.flop_counter.FlopCounterMode`` counts in the busiest stage's
  plain forward (its layers and the head) of one micro-batch, run under a
  fake-tensor mode on the CPU device (so ``kernels.ops`` takes the plain
  versions), scaled by the passes and micro-batches as the analytic model
  scales its own.  Families whose forward has data-dependent shapes or a
  per-token Python loop get ``null`` and the reason.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape train_4k
    PYTHONPATH=src python -m repro_torch dryrun --all --both-meshes [--out DIR]

``--all`` covers the ten ``ARCH_IDS`` and bert-large (reachable through
``get_config``): 11 archs x 4 shapes on each mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import traceback
from contextlib import contextmanager
from typing import Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import ATTN, GLOBAL_WINDOW, MAMBA, MLSTM, SLSTM
from repro_torch.core import sharding, tpu_planner
from repro_torch.core.plan import make_plan
from repro_torch.data.specs import input_specs
from repro_torch.launch import roofline as rl
from repro_torch.models import common as model_common
from repro_torch.models.common import tree_leaves
from repro_torch.optim import AdamW
from repro_torch.train import serve_step as srv
from repro_torch.train import train_step as ts

#: the dry run's records; ``.gitignore`` lists it
DEFAULT_OUT = os.path.join("build", "dryrun")
ARCHS = ARCH_IDS + ["bert-large"]
#: (pods, data, model) of the production meshes
MESHES = {False: (1, 16, 16), True: (2, 16, 16)}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def argument_bytes(cfg, shape, plan) -> dict:
    """One rank's inputs to its step, by part, from shapes alone (every rank
    of a mesh holds the same shapes); the optimizer is the JAX dry run's,
    AdamW."""
    optimizer = AdamW(lr=1e-4)
    layout = sharding.abstract_layout_shapes(cfg, plan)
    specs = sharding.model_pspecs(cfg)
    out = {"params": 0, "optimizer": 0, "batch": 0, "caches": 0}

    def rank_numel(t, tps) -> int:   # a laid-out leaf's share on one rank
        if tps is None:
            return t.numel()
        n = t.numel() // plan.model_axis
        return n // plan.ep if tps.ep and plan.ep > 1 else n

    pairs = [(layout[k], None) for k in layout if k != "layers"]
    pairs += list(zip(tree_leaves(layout["layers"]), tree_leaves(specs["layers"])))
    syncs = ts.grad_sync_tree(cfg, plan)
    sync_of = [syncs[k] for k in layout if k != "layers"] + tree_leaves(syncs["layers"])
    for (t, tps), gs in zip(pairs, sync_of):
        n = rank_numel(t, tps)
        out["params"] += n * t.element_size()
        if shape.kind != "train":
            continue
        # the global master is (rows, data, c), a rank keeping one [c] chunk,
        # or, for an EP leaf, the leaf's own shape, sharded as the leaf is
        master = ts._master_shape(tuple(t.shape), t.numel(), gs, plan)
        m_t = torch.empty(master[-1] if gs.data_rs else n, dtype=torch.float32, device="meta")
        out["optimizer"] += _nbytes(m_t) + sum(
            _nbytes(v) for v in optimizer.init_state(m_t).values())
    split = 1 if plan.seq_shards > 1 else plan.pods * plan.data
    out["batch"] = sum(_nbytes(v) // split for v in input_specs(cfg, shape).values())
    if shape.kind == "decode":
        # [model_axis, ppstage, B, ...]: the batch split over (pods x) data,
        # or replicated with the global-attention KV's capacity split instead
        for spec, cache in zip(cfg.period, srv.cache_specs(cfg, plan, shape)):
            seq_kv = spec.mixer == ATTN and spec.window == GLOBAL_WINDOW
            for name in cache._fields:
                shards = split
                if plan.seq_shards > 1:
                    shards = plan.seq_shards if seq_kv and name in ("k", "v") else 1
                out["caches"] += _nbytes(getattr(cache, name)) // (plan.model_axis * shards)
    out["total"] = sum(out.values())
    return out


# ------------------------------------------------------------- counted FLOPs
def count_null_reason(cfg) -> Optional[str]:
    """Why the plain forward of ``cfg`` cannot be counted on fake tensors
    (None if it can)."""
    mixers = {s.mixer for s in cfg.period}
    why = []
    if cfg.moe is not None:
        why.append("MoE: the expert slots are integer counts computed from the "
                   "routing, a data-dependent shape")
    if MAMBA in mixers:
        why.append("Mamba: the selective scan is a Python loop over the tokens")
    if mixers & {SLSTM, MLSTM}:
        why.append("xLSTM: the sLSTM is a Python loop over the tokens")
    return "; ".join(why) or None


@contextmanager
def _fake_tensors():
    """A fake-tensor mode whose tensors do not outlive it: the rope
    frequencies that ``models.common`` caches by device are set aside and
    put back."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    saved = dict(model_common._FREQS)
    model_common._FREQS.clear()
    try:
        with FakeTensorMode():
            yield
    finally:
        model_common._FREQS.clear()
        model_common._FREQS.update(saved)


def stage_forward_flops(cfg, shape, plan) -> Tuple[int, int, int]:
    """(FLOPs, micro-batch rows, layers) of the busiest stage's plain
    forward of one micro-batch: its ``ppstage`` periods' layers (the real
    ones) and the head, counted by ``FlopCounterMode``; a decode step reads
    caches of the rank's capacity (``S / seq_shards``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import registry

    layers = min(plan.ppstage * cfg.period_len, cfg.n_layers)
    stage = dataclasses.replace(cfg, n_layers=layers)
    B_local = shape.global_batch if plan.seq_shards > 1 else max(
        1, shape.global_batch // (plan.pods * plan.data))
    mb = max(1, B_local // plan.microbatches)
    with _fake_tensors():
        params = registry.init_params(stage, torch.Generator(), device="cpu")
        with FlopCounterMode(display=False) as fc:
            if shape.kind == "decode":
                caches = registry.init_decode_caches(stage, mb, shape.seq_len // plan.seq_shards,
                                                     device="cpu")
                registry.decode_step(stage, params, caches,
                                     torch.zeros((mb, 1), dtype=torch.int32), use_kernels=True)
            else:
                batch = {k: torch.zeros((mb, *v.shape[1:]), dtype=v.dtype)
                         for k, v in input_specs(stage, shape).items()}
                if shape.kind == "train":
                    registry.loss_fn(stage, params, batch, use_kernels=True)
                else:
                    registry.forward(stage, params, batch, use_kernels=True)
    return int(fc.get_total_flops()), mb, layers


def counted_roofline(cfg, shape, plan, analytic: rl.Roofline) -> dict:
    """The busiest stage's counted forward scaled to one rank's step (x
    micro-batches, x passes: 3 + 1 under remat for training, / tensor
    lanes), as a roofline whose memory and collective terms are the
    analytic ones."""
    fwd, mb, layers = stage_forward_flops(cfg, shape, plan)
    passes = 1.0
    if shape.kind == "train":
        passes = 3.0 + (1.0 if plan.remat in ("tick", "layer") else 0.0)
    flops = fwd * plan.microbatches * passes / plan.tensor
    r = dataclasses.replace(analytic, flops=flops)
    return {"stage_forward_flops": fwd, "microbatch_rows": mb, "stage_layers": layers,
            "passes": passes, "flops_over_analytic": flops / analytic.flops,
            **r.as_dict()}


# ------------------------------------------------------------------ records
def dry_combo(arch_id: str, shape_name: str, *, multi_pod: bool = False,
              verbose: bool = True) -> dict:
    """The record of one combination (``lower_combo``'s, from shapes), its
    roofline on the JAX package's constants (``roofline.V5E``)."""
    cfg = get_config(arch_id)
    shape = INPUT_SHAPES[shape_name]
    if not cfg.supports_shape(shape_name):
        return {"arch": arch_id, "shape": shape_name, "status": "skip",
                "reason": "encoder has no decode step" if cfg.is_encoder
                else "full-attention arch: 500k decode infeasible (DESIGN.md)"}
    pods, data, model = MESHES[multi_pod]
    plan = make_plan(cfg, shape, data=data, model=model, pods=pods)
    chips = pods * data * model
    analytic = rl.analytic_roofline(cfg, shape, plan)
    mf = rl.model_flops(cfg, shape)
    args = argument_bytes(cfg, shape, plan)
    reason = count_null_reason(cfg)
    record = {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": f"{pods}x{data}x{model}" if pods > 1 else f"{data}x{model}",
        "status": "ok",
        "chip": analytic.chip.name,
        "plan": {"stages": plan.stages, "tensor": plan.tensor,
                 "microbatches": plan.microbatches, "ep": plan.ep,
                 "seq_shards": plan.seq_shards, "remat": plan.remat,
                 "bidirectional": True},
        "memory": {
            "argument_bytes": args["total"],
            "argument_bytes_by_part": {k: v for k, v in args.items() if k != "total"},
            "output_bytes": None,
            "temp_bytes": None,
            "peak_bytes": None,
            "hbm_estimate": tpu_planner._hbm_estimate(cfg, shape, plan),
        },
        "roofline": analytic.as_dict(),
        "roofline_counted": None if reason else counted_roofline(cfg, shape, plan, analytic),
        "model_flops_global": mf,
        "model_flops_per_chip": mf / chips,
        "useful_flops_ratio": (mf / chips) / analytic.flops if analytic.flops else None,
    }
    if reason:
        record["roofline_counted_reason"] = reason
    if verbose:
        print(f"[dryrun] {arch_id} x {shape_name} mesh={record['mesh']} "
              f"argument_bytes={args['total']} "
              f"hbm_estimate={record['memory']['hbm_estimate']:.4g} "
              f"bottleneck={analytic.bottleneck} "
              f"t=(c{analytic.t_compute*1e3:.1f} m{analytic.t_memory*1e3:.1f} "
              f"x{analytic.t_collective*1e3:.1f})ms", flush=True)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch dryrun",
                                 description="shape-only dry run on the production meshes")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for mp in meshes:
        for a in archs:
            for s in shapes:
                tag = f"{a}_{s}_{'2x16x16' if mp else '16x16'}".replace("/", "-")
                try:
                    rec = dry_combo(a, s, multi_pod=mp)
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    rec = {"arch": a, "shape": s, "status": "fail",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=2)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
