"""Distributed train step: the pipeline's forward and backward ticks, the
paper's scatter-reduce gradient synchronization and a ZeRO-1 sharded
optimizer (``repro.train.train_step`` in torch), run by every rank of the
mesh on its own leaves.

Per leaf (see ``core.sharding.grad_sync_specs``):
  1. tp sync (replicated / kv-shared slices) over the tp or kv-share group,
     or over the whole model axis for the globally replicated leaves,
  2. psum over 'pod' (pure DP between pods),
  3. reduce-scatter over 'data' with the uni- or bi-directional ring
     (paper eq (1) vs eq (2): ``bidirectional=True`` is FuncPipe's schedule),
  4. fp32 master update on the local 1/D shard,
  5. ring all-gather of the updated (param-dtype) parameters.
MoE expert leaves skip 3 and 5: expert parallelism already localizes their
gradients.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import collectives as cc
from repro_torch.core import sharding
from repro_torch.core.pipeline import pipeline_train_loss
from repro_torch.core.plan import PipelinePlan
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import Optimizer


def _rs_chunk(n: int, d: int) -> int:
    return -(-n // d)


def grad_sync_tree(cfg: ArchConfig, plan: PipelinePlan) -> dict:
    """grad_sync_specs extended with the globally replicated leaves:
    tp_mode 'model' marks leaves replicated across the whole model axis."""
    syncs = sharding.grad_sync_specs(cfg, plan)
    glob = sharding.GradSync(data_rs=True, tp_mode="model")
    out = {"embed": glob, "final_norm": glob, "layers": syncs["layers"]}
    if not cfg.tie_embeddings:
        out["head"] = glob
    return out


# ------------------------------------------------------------------ opt state
def _master_shape(p_shape, p_size, gs: sharding.GradSync, plan: PipelinePlan):
    """The *global* master shape of a laid-out leaf (JAX's): (rows, data, c)
    where every rank's shard is one [c] row chunk, or the leaf's own shape
    for an EP leaf."""
    if not gs.data_rs:
        return tuple(p_shape)
    rows = 1 if gs.tp_mode == "model" else p_shape[0]
    c = _rs_chunk(p_size // rows, plan.data)
    return (rows, plan.data, c)


def _is_opt(x) -> bool:
    return isinstance(x, dict) and "master" in x


def init_opt_state(cfg: ArchConfig, plan: PipelinePlan, optimizer: Optimizer, params: dict,
                   *, d: int) -> dict:
    """This rank's optimizer state from its parameters (``local_params``):
    for each leaf the fp32 master shard ``[c]`` of data index ``d`` (the
    flattened leaf padded to ``data * c``), or the whole fp32 leaf for an EP
    leaf, with the optimizer's own state beside it."""
    def one(gs: sharding.GradSync, p: torch.Tensor) -> dict:
        if gs.data_rs:
            c = _rs_chunk(p.numel(), plan.data)
            flat = p.detach().float().reshape(-1)
            flat = torch.nn.functional.pad(flat, (0, plan.data * c - flat.numel()))
            master = flat[d * c:(d + 1) * c].clone()
        else:
            master = p.detach().float().clone()
        return {"master": master, **optimizer.init_state(master)}

    return tree_map(one, grad_sync_tree(cfg, plan), params)


def local_batch(batch: dict, plan: PipelinePlan, mesh) -> dict:
    """This rank's rows of a global batch (JAX's ``batch_pspecs``): the
    batch dim split over (pod x) data, or the whole batch when it is
    replicated (sequence-sharded decode)."""
    if plan.seq_shards > 1:
        return dict(batch)
    n = plan.pods * plan.data
    k = mesh.pod * plan.data + mesh.d
    out = {}
    for name, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch of {v.shape[0]} does not split over {n} data shards")
        b = v.shape[0] // n
        out[name] = v[k * b:(k + 1) * b]
    return out


def _apply_updates(cfg, plan, mesh, optimizer, grads, params, opt, syncs, step, *,
                   bidirectional: bool):
    """This rank's gradient sync + ZeRO-1 update.  The differentiated loss
    is the rank's *local* share (``pipeline_train_loss``), so every sync is
    a plain SUM of distinct contributions: lane-partitioned CE makes the tp
    lanes sum to the full gradient for replicated leaves too."""
    axes = mesh.axes

    def one(gs: sharding.GradSync, g, p, st):
        g = g.float()
        if gs.tp_mode == "all" and plan.tensor > 1:
            g = cc.all_reduce(g, axes["tp"], kind="psum_tp_grads")
        elif gs.tp_mode == "kvshare" and "kvshare" in axes:
            g = cc.all_reduce(g, axes["kvshare"], kind="psum_tp_grads")
        elif gs.tp_mode == "model":
            g = cc.all_reduce(g, axes["model"], kind="psum_model")
        if plan.pods > 1:
            g = cc.all_reduce(g, axes["pod"], kind="psum_pod")
        rest = {k: v for k, v in st.items() if k != "master"}
        if not gs.data_rs:
            new_m, new_st = optimizer.update(g, st["master"], rest, step)
            return new_m.to(p.dtype), {"master": new_m, **new_st}
        flat = g.reshape(-1)
        c = st["master"].shape[0]
        pad = plan.data * c - flat.shape[0]
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        gsh = cc.ring_reduce_scatter(flat, axes["data"], bidirectional=bidirectional)
        new_m, new_st = optimizer.update(gsh, st["master"], rest, step)
        new_flat = cc.ring_all_gather(new_m.to(p.dtype), axes["data"],
                                      bidirectional=bidirectional)
        if pad:
            new_flat = new_flat[:-pad]
        return new_flat.reshape(p.shape), {"master": new_m, **new_st}

    flat_s = tree_leaves(syncs)
    flat_g, flat_p = tree_leaves(grads), tree_leaves(params)
    flat_o = tree_leaves(opt, is_leaf=_is_opt)
    outs = [one(s, g, p, o) for s, g, p, o in zip(flat_s, flat_g, flat_p, flat_o)]
    return (tree_unflatten(params, [a for a, _ in outs]),
            tree_unflatten(opt, [b for _, b in outs], is_leaf=_is_opt))


def make_train_step(cfg: ArchConfig, plan: PipelinePlan, mesh, optimizer: Optimizer, *,
                    bidirectional: bool = True, use_kernels: bool = False) -> Callable:
    """This rank's step ``(params, opt_state, batch_local, step) -> (params,
    opt_state, metrics)``: the pipeline's ticks, then the sync and update.
    ``batch_local`` is the rank's rows (:func:`local_batch`)."""
    syncs = grad_sync_tree(cfg, plan)
    mask = sharding.layer_mask_array(cfg, plan)[mesh.m]

    def step(params, opt_state, batch, step_idx: int):
        for p in tree_leaves(params):
            p.requires_grad_(True)
            p.grad = None
        metrics = pipeline_train_loss(cfg, plan, mesh, params, mask, batch,
                                      use_kernels=use_kernels)
        grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                         params)
        with torch.no_grad():
            params = tree_map(lambda p: p.detach(), params)
            new_params, new_opt = _apply_updates(cfg, plan, mesh, optimizer, grads, params,
                                                 opt_state, syncs, step_idx,
                                                 bidirectional=bidirectional)
        return new_params, new_opt, metrics

    return step


def make_train_state(cfg: ArchConfig, plan: PipelinePlan, mesh, base_params: dict,
                     optimizer: Optimizer) -> Tuple[dict, dict]:
    """This rank's parameters and optimizer state from the base (registry
    layout) parameters."""
    params = sharding.local_params(cfg, plan, base_params, d=mesh.d, m=mesh.m)
    params = tree_map(lambda a: a.to(mesh.device), params)
    return params, init_opt_state(cfg, plan, optimizer, params, d=mesh.d)
