"""Serving steps on the rank mesh: pipelined prefill and single-token decode
(``repro.train.serve_step`` in torch).

Cache layout mirrors the parameter layout: globally every cache leaf is
``[model_axis, ppstage, B, ...]`` (:func:`cache_specs`), and a rank keeps
``[ppstage, B_local, ...]`` (:func:`init_caches`).  For a batch smaller than
the data axis (``long_500k``: global batch 1) the batch is replicated and
the *capacity* dim of the global-attention KV leaves is sharded over
(pod x) data instead (flash-decode partial-softmax combination).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ATTN, GLOBAL_WINDOW, ArchConfig, InputShape
from repro_torch.core import sharding
from repro_torch.core.pipeline import (
    _abstract_stage_caches,
    pipeline_decode_step,
    pipeline_prefill,
)
from repro_torch.core.plan import PipelinePlan
from repro_torch.models.common import dtype_of, tree_map


def _local_batch_size(plan: PipelinePlan, B: int) -> int:
    return B if plan.seq_shards > 1 else B // (plan.pods * plan.data)


def cache_specs(cfg: ArchConfig, plan: PipelinePlan, shape: InputShape):
    """The global cache tree ``[model_axis, ppstage, B, ...]`` as ``meta``
    tensors, the capacity of sequence-sharded global-attention KV counted
    whole."""
    B, dtype = shape.global_batch, dtype_of(cfg.param_dtype)
    local = _abstract_stage_caches(cfg, plan, _local_batch_size(plan, B), shape.seq_len,
                                   dtype, "meta")
    out = []
    for spec, pos_cache in zip(cfg.period, local):
        leaves = {}
        for name in pos_cache._fields:
            shp = list(getattr(pos_cache, name).shape)     # [pp, B_local, ...]
            shp[1] = B
            if (plan.seq_shards > 1 and spec.mixer == ATTN and spec.window == GLOBAL_WINDOW
                    and name in ("k", "v")):
                shp[3] *= plan.seq_shards                  # [pp,B,kv,C,hd] -> global C
            leaves[name] = torch.empty((plan.model_axis, *shp),
                                       dtype=getattr(pos_cache, name).dtype, device="meta")
        out.append(type(pos_cache)(**leaves))
    return tuple(out)


def init_caches(cfg: ArchConfig, plan: PipelinePlan, shape: InputShape, *, device) -> tuple:
    """This rank's zero caches ``[ppstage, B_local, ...]`` for decoding from
    scratch (every leaf zero, as JAX's ``init_caches``)."""
    local = _abstract_stage_caches(cfg, plan, _local_batch_size(plan, shape.global_batch),
                                   shape.seq_len, dtype_of(cfg.param_dtype), device)
    return tree_map(torch.zeros_like, local)


def make_decode_step(cfg: ArchConfig, plan: PipelinePlan, mesh, *,
                     use_kernels: bool = False) -> Callable:
    """This rank's ``(params, caches, tokens_local) -> (logits, caches)``;
    the caches are updated in place.  With ``use_kernels`` the attention
    layers whose KV is not sequence-sharded decode on
    ``ops.decode_attention``."""
    mask = sharding.layer_mask_array(cfg, plan)[mesh.m]

    def step(params, caches, tokens):
        return pipeline_decode_step(cfg, plan, mesh, params, mask, caches, tokens,
                                    use_kernels=use_kernels)

    return step


def make_prefill_step(cfg: ArchConfig, plan: PipelinePlan, mesh, *,
                      capacity: Optional[int] = None) -> Callable:
    """This rank's ``(params, batch_local) -> (last-position logits,
    caches)``, the caches padded to ``capacity`` (default: the prompt)."""
    mask = sharding.layer_mask_array(cfg, plan)[mesh.m]

    def step(params, batch):
        return pipeline_prefill(cfg, plan, mesh, params, mask, batch, capacity=capacity)

    return step
