"""Mesh serving equivalence: pipelined prefill and decode on a gloo world of
ranks == the single-process prefill and decode (``repro.testing.
serve_equiv`` in torch).

    python -m repro_torch.testing.serve_equiv [arch] [stages] [tensor] [seq_shards]

Spawns ``8 = data x stages x tensor`` ranks on the CPU and holds the
prefill logits and ``n_decode`` decode steps' logits (2e-3) against
``registry.prefill`` and ``registry.decode_step``.  With ``seq_shards`` > 1
(a batch of one, smaller than the data axis) the global layers' KV is
sharded over the data axis and decode starts from empty caches, since
prefill is not sharded.  Exits nonzero on a mismatch.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core import sharding
from repro_torch.core.plan import PipelinePlan, make_plan
from repro_torch.launch.mesh import run_mesh
from repro_torch.models import registry
from repro_torch.models.common import dtype_of, tree_map
from repro_torch.testing.pipeline_equiv import WORLD, mesh_shape
from repro_torch.train import serve_step as srv
from repro_torch.train.train_step import local_batch

S_PRE = 64


def serve_config(arch_id: str, stages: int, tensor: int) -> ArchConfig:
    """The reduced arch of the check, MoE capacity ``n_experts``."""
    cfg = get_config(arch_id).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    return dataclasses.replace(cfg, stages=stages, tensor=tensor)


def serve_plan(cfg: ArchConfig, stages: int, tensor: int, seq_shards: int,
               n_decode: int) -> tuple:
    """(plan, decode shape, global batch) of the check, as JAX's builds them."""
    model_ax = stages * tensor
    B = 1 if seq_shards > 1 else 8
    dshape = InputShape("serve_equiv", S_PRE + n_decode, B, "decode")
    plan = make_plan(cfg, dshape, data=WORLD // model_ax, model=model_ax, microbatches=1)
    if seq_shards > 1 and plan.seq_shards != plan.data:
        raise ValueError(f"expected the KV sharded over the data axis: {plan}")
    return plan, dshape, B


def rank_serve(mesh, cfg: ArchConfig, plan: PipelinePlan, dshape: InputShape, base_np: dict,
               toks: np.ndarray, n_decode: int, use_kernels: bool = False) -> dict:
    """One rank: prefill the first ``S_PRE`` tokens (or start from empty
    caches when the KV is sequence-sharded), then decode ``n_decode``
    tokens -> the rank's logits (numpy) of each step."""
    dev = mesh.device
    base = registry.params_from_jax(base_np, device=dev, dtype=dtype_of(cfg.param_dtype))
    params = sharding.local_params(cfg, plan, base, d=mesh.d, m=mesh.m)
    del base
    toks_t = local_batch({"t": torch.from_numpy(toks).to(dev)}, plan, mesh)["t"]
    decode = srv.make_decode_step(cfg, plan, mesh, use_kernels=use_kernels)
    out = {"rank": mesh.rank, "d": mesh.d, "m": mesh.m, "prefill": None, "decode": []}
    if plan.seq_shards > 1:
        caches = srv.init_caches(cfg, plan, dshape, device=dev)
        first = 0
    else:
        prefill = srv.make_prefill_step(cfg, plan, mesh, capacity=dshape.seq_len)
        logits, caches = prefill(params, {"tokens": toks_t[:, :S_PRE]})
        out["prefill"] = logits.numpy(force=True)
        first = S_PRE
    for t in range(first, first + n_decode):
        logits, caches = decode(params, caches, toks_t[:, t:t + 1])
        out["decode"].append(logits.float().numpy(force=True))
    return out


def gather_rows(results: list, plan: PipelinePlan, key: str):
    """The global logits of ``key`` from the ranks of model index 0, rows
    in data order (every data rank's copy when the batch is replicated)."""
    ranks = sorted((r for r in results if r["m"] == 0), key=lambda r: r["d"])
    if plan.seq_shards > 1:
        return ranks[0][key]
    if key == "prefill":
        return np.concatenate([r[key] for r in ranks], axis=0)
    return [np.concatenate([r[key][i] for r in ranks], axis=0)
            for i in range(len(ranks[0][key]))]


def run(arch_id="phi3-mini-3.8b", stages=4, tensor=1, seq_shards=1, n_decode=6, seed=0,
        tol=2e-3) -> bool:
    cfg = serve_config(arch_id, stages, tensor)
    plan, dshape, B = serve_plan(cfg, stages, tensor, seq_shards, n_decode)
    base = registry.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, dshape.seq_len),
                                                dtype=np.int32)
    results = run_mesh(rank_serve, mesh_shape(cfg, plan), cfg, plan, dshape,
                       tree_map(lambda t: t.numpy(), base), toks, n_decode, device="cpu")

    tt = torch.from_numpy(toks)
    ref_steps, e_pre = [], 0.0
    with torch.no_grad():
        if plan.seq_shards > 1:
            caches = registry.init_decode_caches(cfg, B, dshape.seq_len, device="cpu")
            first = 0
        else:
            ref_pre, caches = registry.prefill(cfg, base, {"tokens": tt[:, :S_PRE]},
                                               capacity=dshape.seq_len)
            e_pre = float(np.max(np.abs(gather_rows(results, plan, "prefill") - ref_pre.numpy())))
            first = S_PRE
        for t in range(first, first + n_decode):
            lg, caches = registry.decode_step(cfg, base, caches, tt[:, t:t + 1])
            ref_steps.append(lg.float().numpy())
    got = gather_rows(results, plan, "decode")
    e_dec = max(float(np.max(np.abs(a - b))) for a, b in zip(got, ref_steps))
    print(f"[serve_equiv] {arch_id} stages={stages} tp={tensor} seq_shards={plan.seq_shards} "
          f"prefill_err={e_pre:.2e} decode_err={e_dec:.2e}")
    return e_pre < tol and e_dec < tol


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="serve pipeline equivalence on a gloo world")
    ap.add_argument("arch", nargs="?", default="phi3-mini-3.8b")
    ap.add_argument("stages", nargs="?", type=int, default=4)
    ap.add_argument("tensor", nargs="?", type=int, default=1)
    ap.add_argument("seq_shards", nargs="?", type=int, default=1)
    a = ap.parse_args()
    sys.exit(0 if run(a.arch, a.stages, a.tensor, a.seq_shards) else 1)
