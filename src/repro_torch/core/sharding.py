"""Parameter layout for the pipelined rank mesh (``repro.core.sharding`` in
torch).

Global layout of every layer leaf: ``[model_axis, ppstage, *sliced_dims]``
where index ``m = stage*tp + t`` holds (pipeline stage ``stage``, tensor
slice ``t``); rank ``(pod, d, m)`` keeps index ``m`` (:func:`local_params`).
MoE expert leaves carry an extra expert dim sharded over ``data`` (expert
parallelism).  Embedding / head / final norm are replicated.  Where the JAX
package attaches ``PartitionSpec``\\ s and lets ``shard_map`` slice,
:func:`local_params` slices one rank's view itself.

``TPSpec`` annotations mirror the init_* param structures:
  repl          -- copied across tp members
  slice(dim)    -- dim divided contiguously by tp (column/row parallel)
  heads(dim,hd) -- dim is heads*hd; sliced by whole heads, and *replicated*
                   when there are fewer KV heads than tp members (GQA)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import (
    ATTN,
    DENSE_FF,
    MAMBA,
    MLSTM,
    NO_FF,
    ArchConfig,
    LayerSpec,
)
from repro_torch.core.plan import PipelinePlan
from repro_torch.models.common import tree_map


@dataclass(frozen=True)
class TPSpec:
    mode: str = "repl"            # repl | slice | heads
    dim: int = -1                 # sliced dim (negative = from the end)
    unit: int = 1                 # head_dim for mode="heads"
    heads: int = 0                # total heads for mode="heads"
    ep: bool = False              # expert dim 0 sharded over 'data'
    # gradient sync over tp members required (kv replication / full repl):
    sync_tp: bool = False

    def local_dim_size(self, full: int, tp: int) -> int:
        if self.mode == "repl":
            return full
        if self.mode == "slice":
            if full % tp:
                raise ValueError(f"dim {full} does not split into {tp} slices")
            return full // tp
        # heads
        if self.heads >= tp:
            if self.heads % tp:
                raise ValueError(f"{self.heads} heads do not split into {tp} slices")
            return (self.heads // tp) * self.unit
        return self.unit  # one (replicated) kv head per member


REPL = TPSpec("repl", sync_tp=True)


def _is_spec(x) -> bool:
    return isinstance(x, TPSpec)


def attn_pspecs(cfg: ArchConfig, replicate: bool = False) -> dict:
    if replicate:
        keys = ["wq", "wk", "wv", "wo"] + (["bq", "bk", "bv"] if cfg.qkv_bias else [])
        keys += ["q_norm", "k_norm"] if cfg.qk_norm else []
        return {k: REPL for k in keys}
    kvh = TPSpec("heads", -1, cfg.hd, cfg.n_kv_heads, sync_tp=True)
    p = {"wq": TPSpec("slice", -1), "wk": kvh, "wv": kvh, "wo": TPSpec("slice", 0)}
    if cfg.qkv_bias:
        p["bq"] = TPSpec("slice", 0)
        p["bk"] = dataclasses.replace(kvh, dim=0)
        p["bv"] = dataclasses.replace(kvh, dim=0)
    if cfg.qk_norm:
        p["q_norm"] = REPL
        p["k_norm"] = REPL
    return p


def mlp_pspecs(cfg: ArchConfig) -> dict:
    return {"w_gate": TPSpec("slice", 1), "w_up": TPSpec("slice", 1),
            "w_down": TPSpec("slice", 0)}


def moe_pspecs(cfg: ArchConfig) -> dict:
    return {"router": REPL, "w_gate": TPSpec("slice", 2, ep=True),
            "w_up": TPSpec("slice", 2, ep=True), "w_down": TPSpec("slice", 1, ep=True)}


def mamba_pspecs(cfg: ArchConfig) -> dict:
    return {"w_in_x": TPSpec("slice", 1), "w_in_z": TPSpec("slice", 1),
            "conv_w": TPSpec("slice", 1), "conv_b": TPSpec("slice", 0),
            "w_xproj": TPSpec("slice", 0), "w_dt": TPSpec("slice", 1),
            "b_dt": TPSpec("slice", 0), "A_log": TPSpec("slice", 0),
            "D": TPSpec("slice", 0), "w_out": TPSpec("slice", 0)}


def xlstm_pspecs(cfg: ArchConfig, kind: str) -> dict:
    # the recurrent matrices couple the full width: run TP-replicated
    if kind == MLSTM:
        keys = ["w_up", "w_z", "conv_w", "conv_b", "wq", "wk", "wv",
                "w_if", "b_i", "b_f", "out_norm", "w_down"]
    else:
        keys = ["w_gates", "r_gates", "b_gates", "out_norm", "w_up_ff", "w_down_ff"]
    return {k: REPL for k in keys}


def layer_pspecs(cfg: ArchConfig, spec: LayerSpec) -> dict:
    p: dict = {"norm1": REPL}
    if spec.mixer == ATTN:
        p["mixer"] = attn_pspecs(cfg)
    elif spec.mixer == MAMBA:
        p["mixer"] = mamba_pspecs(cfg)
    else:
        p["mixer"] = xlstm_pspecs(cfg, spec.mixer)
    if spec.ff != NO_FF:
        p["norm2"] = REPL
        p["ff"] = mlp_pspecs(cfg) if spec.ff == DENSE_FF else moe_pspecs(cfg)
    return p


def model_pspecs(cfg: ArchConfig) -> dict:
    """TPSpec tree matching ``registry.init_params``'s structure."""
    out = {"embed": REPL, "final_norm": REPL,
           "layers": tuple(layer_pspecs(cfg, s) for s in cfg.period)}
    if not cfg.tie_embeddings:
        out["head"] = REPL
    return out


# ----------------------------------------------------------------- layout ops
def _slice_bounds(ts: TPSpec, full: int, tp: int, t: int) -> tuple[int, int]:
    """start, size of member t's slice of a dim of length ``full``."""
    if ts.mode == "slice":
        sz = full // tp
        return t * sz, sz
    # heads
    if ts.heads >= tp:
        per = ts.heads // tp
        return t * per * ts.unit, per * ts.unit
    # replicate kv heads: member t uses head index t * heads // tp
    h = t * ts.heads // tp
    return h * ts.unit, ts.unit


def _padded(leaf: torch.Tensor, plan: PipelinePlan) -> torch.Tensor:
    pad = plan.n_instances - leaf.shape[0]
    if pad:
        leaf = torch.cat([leaf, leaf.new_zeros((pad, *leaf.shape[1:]))], dim=0)
    return leaf


def stage_lane_leaf(leaf: torch.Tensor, ts: TPSpec, plan: PipelinePlan, stage: int,
                    lane: int) -> torch.Tensor:
    """[n_periods, *dims] -> (stage, lane)'s [ppstage, *tp_sliced_dims]: the
    padded instances of the stage, the lane's slice (a view where it can)."""
    pp = plan.ppstage
    leaf = _padded(leaf, plan)[stage * pp:(stage + 1) * pp]
    if ts.mode == "repl" or plan.tensor == 1:
        return leaf
    dim = ts.dim % (leaf.ndim - 1) + 1
    st, sz = _slice_bounds(ts, leaf.shape[dim], plan.tensor, lane)
    return leaf.narrow(dim, st, sz)


def layout_leaf(leaf: torch.Tensor, ts: TPSpec, plan: PipelinePlan) -> torch.Tensor:
    """[n_periods, *dims] -> [model_axis, ppstage, *tp_sliced_dims]."""
    return torch.stack([stage_lane_leaf(leaf, ts, plan, s, t)
                        for s in range(plan.stages) for t in range(plan.tensor)])


def to_pipeline_layout(cfg: ArchConfig, plan: PipelinePlan, params: dict) -> dict:
    specs = model_pspecs(cfg)
    out = dict(params)
    out["layers"] = tree_map(lambda ts, leaf: layout_leaf(leaf, ts, plan),
                             specs["layers"], params["layers"])
    return out


def _ep_slice(leaf: torch.Tensor, plan: PipelinePlan, d: int) -> torch.Tensor:
    """An expert leaf [ppstage, E, ...] -> data index d's experts."""
    E = leaf.shape[1]
    if E % plan.data:
        raise ValueError(f"{E} experts do not shard over a data axis of {plan.data}")
    n = E // plan.data
    return leaf[:, d * n:(d + 1) * n]


def local_params(cfg: ArchConfig, plan: PipelinePlan, params: dict, *, d: int,
                 m: int) -> dict:
    """Rank ``(·, d, m)``'s parameters from the base (unlaid-out) tree: every
    layer leaf its ``[ppstage, *sliced]`` view of ``layout[m]`` (the expert
    dim cut to data index d's experts under expert parallelism), the
    replicated leaves whole.  Each leaf is a fresh contiguous tensor."""
    specs = model_pspecs(cfg)
    stage, lane = divmod(m, plan.tensor)

    def one(ts: TPSpec, leaf: torch.Tensor) -> torch.Tensor:
        out = stage_lane_leaf(leaf, ts, plan, stage, lane)
        if ts.ep and plan.ep > 1:
            out = _ep_slice(out, plan, d)
        return out.contiguous().clone()

    out = {k: v.clone() for k, v in params.items() if k != "layers"}
    out["layers"] = tree_map(one, specs["layers"], params["layers"])
    return out


def local_layout(cfg: ArchConfig, plan: PipelinePlan, layout: dict, *, d: int,
                 m: int) -> dict:
    """Rank ``(·, d, m)``'s view of an already laid-out tree (what
    ``shard_map`` hands a device in the JAX package): ``layout[m]`` of every
    layer leaf (experts cut to data index d), the rest whole."""
    specs = model_pspecs(cfg)

    def one(ts: TPSpec, leaf: torch.Tensor) -> torch.Tensor:
        out = leaf[m]
        return _ep_slice(out, plan, d) if ts.ep and plan.ep > 1 else out

    out = {k: v for k, v in layout.items() if k != "layers"}
    out["layers"] = tree_map(one, specs["layers"], layout["layers"])
    return out


def abstract_layout_shapes(cfg: ArchConfig, plan: PipelinePlan) -> dict:
    """The laid-out parameters as ``meta`` tensors (shapes and dtypes),
    without materializing anything: ``registry.init_params`` runs under a
    fake-tensor mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.registry import init_params

    with FakeTensorMode():
        base = init_params(cfg, torch.Generator(), device="cpu")
    meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), base)
    specs = model_pspecs(cfg)

    def lay(ts: TPSpec, t: torch.Tensor) -> torch.Tensor:
        dims = list(t.shape[1:])
        if ts.mode != "repl" and plan.tensor > 1:
            j = ts.dim % len(dims)
            dims[j] = ts.local_dim_size(dims[j], plan.tensor)
        return torch.empty((plan.model_axis, plan.ppstage, *dims), dtype=t.dtype,
                           device="meta")

    out = {k: v for k, v in meta.items() if k != "layers"}
    out["layers"] = tree_map(lay, specs["layers"], meta["layers"])
    return out


@dataclass(frozen=True)
class GradSync:
    data_rs: bool = True       # reduce-scatter over 'data' (False for EP leaves)
    tp_mode: str = "none"      # none | all (replicated) | kvshare (GQA kv repl)


def grad_sync_specs(cfg: ArchConfig, plan: PipelinePlan) -> dict:
    """Per-leaf sync requirements for the update step (``train.train_step``)."""

    def sync(ts: TPSpec) -> GradSync:
        tp_mode = "none"
        if plan.tensor > 1:
            if ts.mode == "repl":
                tp_mode = "all"
            elif ts.mode == "heads" and ts.heads < plan.tensor:
                tp_mode = "kvshare"
        return GradSync(data_rs=not (ts.ep and plan.ep > 1), tp_mode=tp_mode)

    return tree_map(sync, model_pspecs(cfg))


def layer_mask_array(cfg: ArchConfig, plan: PipelinePlan) -> np.ndarray:
    """[model_axis, ppstage, period_len] bool: real (non-padding) layers."""
    S, tp = plan.stages, plan.tensor
    idx = np.arange(plan.n_instances * cfg.period_len).reshape(S, plan.ppstage,
                                                               cfg.period_len)
    mask = idx < cfg.n_layers
    return np.broadcast_to(mask[:, None], (S, tp, plan.ppstage, cfg.period_len)).reshape(
        S * tp, plan.ppstage, cfg.period_len)
