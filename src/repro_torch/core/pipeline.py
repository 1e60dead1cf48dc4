"""GPipe-style pipeline parallelism on the rank mesh: the paper's §3.2
training pipeline (``repro.core.pipeline`` in torch).

The ``model`` axis factors into (stages x tensor).  Every rank holds its
stage's tp slice of the layers (``core.sharding.local_params``: each layer
leaf ``[ppstage, *sliced]``).  JAX runs a ``lax.scan`` over ticks with
``ppermute`` and lets ``jax.grad`` reverse it.  Per-rank autograd cannot
do that: a rank whose received activation is not used (stage 0 always
embeds) would never run the backward node that returns its peer's
gradient.  So the schedule is written out:

* forward ticks: each stage takes micro-batch i (embedding it on stage 0,
  receiving it from stage s-1 otherwise), runs its layers and sends the
  output to stage s+1; with ``remat`` "tick" a micro-batch's stage compute
  runs under ``torch.utils.checkpoint`` (only its input is kept), with
  "layer" each period instance does;
* backward ticks, micro-batches in reverse: the last stage seeds the
  gradient from its lane's share of the CE, the others receive it from
  stage s+1; ``torch.autograd.backward`` runs the stage's backward and the
  input's gradient goes to stage s-1.

Ticks that JAX computes and masks are skipped.  Validity depends only on
the stage, so every tp lane and data rank of a stage skips the same ticks.
Each rank's autograd engine issues the backward psums and EP all-to-alls
on its own: the ranks of a stage build the same graph, and the branches
that depend on the rank (the embedding, the CE lane, the head) hold no
collective, so the groups' calls stay matched.  A lane that owns no CE
chunk of a micro-batch still runs its backward, with a zero seed.

The loss normalisation is JAX's: the CE divided by ``mu*data*pods``, the
router's aux loss by that and ``tp`` (each lane computes it whole).

Serving (:func:`pipeline_prefill`, :func:`pipeline_decode_step`) runs the
forward ticks alone; the last stage's logits are summed over the model
axis and divided by ``tp``, and the caches are per rank
``[ppstage, B_local, ...]``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, GLOBAL_WINDOW, MAMBA, MLSTM, SLSTM, ArchConfig
from repro_torch.core import collectives as cc
from repro_torch.core.plan import PipelinePlan
from repro_torch.models import attention, mamba, registry, xlstm
from repro_torch.models.common import ParallelCtx, dtype_of, rms_norm, tree_map
from repro_torch.models.transformer import (
    period_forward,
    scan_decode,
    scan_forward,
    scan_prefill,
)

CE_CHUNK = 512


# ------------------------------------------------------------------- contexts
def make_ctx(plan: PipelinePlan, mesh) -> ParallelCtx:
    """Collective hooks for model code, bound to this rank's groups."""
    hooks = {}
    if plan.tensor > 1:
        hooks["psum_tp"] = functools.partial(cc.psum, axis=mesh.axes["tp"], kind="psum_tp")
    if plan.ep > 1:
        # [E, C, d] -> [E/ep, C*ep, d] and back, over the data axis
        data = mesh.axes["data"]
        hooks["ep_all_to_all"] = functools.partial(cc.all_to_all, axis=data)
        hooks["ep_all_to_all_back"] = functools.partial(cc.all_to_all, axis=data, back=True)
    if plan.seq_shards > 1:
        seq = mesh.axes["seq"]
        hooks["psum_seq"] = functools.partial(cc.all_reduce, axis=seq, kind="psum_seq")
        hooks["pmax_seq"] = functools.partial(cc.all_reduce, axis=seq, op=dist.ReduceOp.MAX,
                                              kind="psum_seq")
        hooks["seq_index"] = seq.index   # pod * data + d
    return ParallelCtx(tp_size=plan.tensor, dp_size=plan.data, seq_shards=plan.seq_shards,
                       **hooks)


def _get_mb(tree: dict, i: int, mb: int) -> dict:
    return {k: v[i * mb:(i + 1) * mb] for k, v in tree.items()}


def _embed(cfg: ArchConfig, params, batch_mb) -> torch.Tensor:
    return registry.embed_inputs(cfg, params, batch_mb).to(dtype_of(cfg.param_dtype))


def _ce_chunk(h: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = (h @ head_w.T).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum(logz - gold)


def _chunked_ce(h: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor, shift: bool,
                tp: int = 1, tp_index: int = 0) -> torch.Tensor:
    """Mean CE without materializing full [S, V] logits.  h [mb,S,d].

    With tensor parallelism the sequence chunks are partitioned round-robin
    over the tp lanes (lane t takes the chunks with index % tp == t), so the
    loss, and hence the gradient seeds, are computed exactly once per data
    shard; the sum over lanes is the full mean CE.  A lane with no chunk
    returns a zero that no gradient flows through.  Each chunk's logits are
    recomputed in the backward (``jax.checkpoint`` on JAX's scan body)."""
    if shift:
        h = h[:, :-1]
        labels = labels[:, 1:]
    mb, S, _ = h.shape
    C = min(CE_CHUNK, S)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(-(-S // C)):
        if i % tp != tp_index:
            continue
        hc, lc = h[:, i * C:(i + 1) * C], labels[:, i * C:(i + 1) * C]
        if torch.is_grad_enabled():
            total = total + checkpoint(_ce_chunk, hc, head_w, lc, use_reentrant=False)
        else:
            total = total + _ce_chunk(hc, head_w, lc)
    return total / (mb * S)


def _head(cfg: ArchConfig, params) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["head"]


# ------------------------------------------------------------------- training
def _stage_fn(cfg, plan, ctx, layers, mask, positions, use_kernels):
    """The stage's compute on one micro-batch: x -> (x, aux or None)."""
    if plan.remat == "layer":
        def run(x):
            auxs = []
            for i in range(len(mask)):
                pp = tree_map(lambda a: a[i], layers)
                x, aux = checkpoint(period_forward, pp, x, mask[i], cfg=cfg,
                                    positions=positions, ctx=ctx, use_kernels=use_kernels,
                                    use_reentrant=False)
                if aux is not None:
                    auxs.append(aux)
            return x, (torch.stack(auxs).sum() if auxs else None)
        return run

    def run(x):
        return scan_forward(layers, x, mask, cfg=cfg, positions=positions, ctx=ctx,
                            use_kernels=use_kernels)
    if plan.remat == "tick":
        return lambda x: checkpoint(run, x, use_reentrant=False)
    return run


def pipeline_train_loss(cfg: ArchConfig, plan: PipelinePlan, mesh, params, mask_local,
                        batch_local: dict, *, use_kernels: bool = False) -> dict:
    """One training step's forward and backward ticks on this rank.

    ``params`` are the rank's leaves (requiring grad); ``mask_local``
    [ppstage, period_len] bool; ``batch_local`` leaves [B_local, ...].
    The gradients of this rank's *local* share of the loss accumulate in
    the params' ``.grad`` (JAX's ``total_local``: no psum in the grad
    path).  Returns {"ce", "aux", "loss"}, summed over the mesh."""
    S_eff, tp, mu = plan.stages, plan.tensor, plan.microbatches
    ctx = make_ctx(plan, mesh)
    stage, lane, dev = mesh.stage, mesh.lane, mesh.device
    B_local = next(iter(batch_local.values())).shape[0]
    if B_local % mu:
        raise ValueError(f"local batch {B_local} does not split into {mu} micro-batches")
    mb = B_local // mu
    seq = batch_local["labels"].shape[1]
    positions = torch.arange(seq, dtype=torch.int32, device=dev)
    dtype = dtype_of(cfg.param_dtype)
    act_shape = (mb, seq, cfg.d_model)
    shift = cfg.causal and not cfg.is_encoder
    dp_norm = mu * plan.data * plan.pods
    stage_fn = _stage_fn(cfg, plan, ctx, params["layers"], mask_local, positions, use_kernels)

    # forward ticks
    pending, saved = [], []
    for i in range(mu):
        batch_mb = _get_mb(batch_local, i, mb)
        if stage == 0:
            x_in = _embed(cfg, params, batch_mb)
        else:
            x_in = cc.recv(act_shape, dtype, dev, mesh.peer(stage - 1), tag=i)
            x_in.requires_grad_(True)
        out, aux = stage_fn(x_in)
        if stage < S_eff - 1:
            pending.append(cc.send(out.detach(), mesh.peer(stage + 1), tag=i))
        saved.append((x_in, out, aux, batch_mb["labels"]))
    cc.wait_sends(pending)

    # backward ticks, micro-batches in reverse
    ce_sum = torch.zeros((), dtype=torch.float32, device=dev)
    aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
    aux_seed = 1.0 / (dp_norm * tp)
    for i in reversed(range(mu)):
        x_in, out, aux, labels = saved[i]
        saved[i] = None
        if stage == S_eff - 1:
            h = out.detach().requires_grad_(True)
            hn = rms_norm(h, params["final_norm"], cfg.norm_eps)
            ce = _chunked_ce(hn, _head(cfg, params), labels, shift, tp=tp, tp_index=lane)
            ce_sum = ce_sum + ce.detach()
            if ce.requires_grad:
                (ce / dp_norm).backward()
            g = h.grad if h.grad is not None else torch.zeros_like(out)
        else:
            g = cc.recv(act_shape, dtype, dev, mesh.peer(stage + 1), tag=mu + i)
        roots, seeds = [out], [g]
        if aux is not None:
            aux_sum = aux_sum + aux.detach()
            roots.append(aux)
            seeds.append(torch.full_like(aux, aux_seed))
        torch.autograd.backward(roots, seeds)
        if stage > 0:
            pending.append(cc.send(x_in.grad, mesh.peer(stage - 1), tag=mu + i))
    cc.wait_sends(pending)

    local = torch.stack([ce_sum / dp_norm, aux_sum / (dp_norm * tp)])
    ce_mean, aux_mean = cc.all_reduce(local, mesh.axes["world"], kind="metrics").tolist()
    return {"ce": ce_mean, "aux": aux_mean, "loss": ce_mean + aux_mean}


# -------------------------------------------------------------------- serving
def _logits_psum(logits: torch.Tensor, plan: PipelinePlan, mesh) -> torch.Tensor:
    """The last stage's logits to every rank: summed over the model axis
    (zeros elsewhere, tp copies there), divided by tp."""
    return cc.all_reduce(logits, mesh.axes["model"], kind="psum_logits") / plan.tensor


@torch.no_grad()
def pipeline_decode_step(cfg: ArchConfig, plan: PipelinePlan, mesh, params, mask_local,
                         caches_local, tokens_local: torch.Tensor, *,
                         use_kernels: bool = False):
    """One decode tick for B_local sequences, pipelined over micro-batches.
    ``caches_local`` leaves [ppstage, B_local, ...] are updated in place.
    Returns (logits [B_local, 1, V] on every rank, caches)."""
    S_eff, mu = plan.stages, plan.microbatches
    ctx = make_ctx(plan, mesh)
    stage, dev = mesh.stage, mesh.device
    B_local = tokens_local.shape[0]
    if B_local % mu:
        raise ValueError(f"local batch {B_local} does not split into {mu} micro-batches")
    mb = B_local // mu
    dtype = dtype_of(cfg.param_dtype)
    head_w = _head(cfg, params)
    logits = torch.zeros((B_local, 1, head_w.shape[0]), dtype=torch.float32, device=dev)
    pending = []
    for i in range(mu):
        if stage == 0:
            x = params["embed"][tokens_local[i * mb:(i + 1) * mb].long()].to(dtype)
        else:
            x = cc.recv((mb, 1, cfg.d_model), dtype, dev, mesh.peer(stage - 1), tag=i)
        mb_caches = tree_map(lambda a: a[:, i * mb:(i + 1) * mb], caches_local)
        x, _ = scan_decode(params["layers"], x, mb_caches, mask_local, cfg=cfg, ctx=ctx,
                           use_kernels=use_kernels)
        if stage < S_eff - 1:
            pending.append(cc.send(x, mesh.peer(stage + 1), tag=i))
        else:
            hn = rms_norm(x, params["final_norm"], cfg.norm_eps)
            logits[i * mb:(i + 1) * mb] = (hn @ head_w.T).float()
    cc.wait_sends(pending)
    return _logits_psum(logits, plan, mesh), caches_local


@torch.no_grad()
def pipeline_prefill(cfg: ArchConfig, plan: PipelinePlan, mesh, params, mask_local,
                     batch_local: dict, *, capacity: Optional[int] = None):
    """Pipelined prefill: returns (last-position logits [B_local, 1, V] on
    every rank, caches with leaves [ppstage, B_local, ...])."""
    if plan.seq_shards != 1:
        raise ValueError("seq-sharded (long-context) serving is decode-only; prefill a "
                         "sharded cache by resharding an unsharded prefill")
    S_eff, mu = plan.stages, plan.microbatches
    ctx = make_ctx(plan, mesh)
    stage, dev = mesh.stage, mesh.device
    B_local = next(iter(batch_local.values())).shape[0]
    if B_local % mu:
        raise ValueError(f"local batch {B_local} does not split into {mu} micro-batches")
    mb = B_local // mu
    seq = (batch_local["frames"] if cfg.frontend == "audio" else batch_local["tokens"]).shape[1]
    positions = torch.arange(seq, dtype=torch.int32, device=dev)
    dtype = dtype_of(cfg.param_dtype)
    head_w = _head(cfg, params)
    cap = capacity if capacity is not None else seq
    caches = _abstract_stage_caches(cfg, plan, B_local, cap, dtype, dev)
    logits = torch.zeros((B_local, 1, head_w.shape[0]), dtype=torch.float32, device=dev)
    pending = []
    for i in range(mu):
        if stage == 0:
            x = _embed(cfg, params, _get_mb(batch_local, i, mb))
        else:
            x = cc.recv((mb, seq, cfg.d_model), dtype, dev, mesh.peer(stage - 1), tag=i)
        x, mb_caches = scan_prefill(params["layers"], x, mask_local, cfg=cfg,
                                    positions=positions, ctx=ctx, capacity=cap)
        tree_map(lambda full, new: full[:, i * mb:(i + 1) * mb].copy_(new), caches, mb_caches)
        if stage < S_eff - 1:
            pending.append(cc.send(x, mesh.peer(stage + 1), tag=i))
        else:
            hn = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
            logits[i * mb:(i + 1) * mb] = (hn @ head_w.T).float()
    cc.wait_sends(pending)
    return _logits_psum(logits, plan, mesh), caches


def _abstract_stage_caches(cfg: ArchConfig, plan: PipelinePlan, B_local: int, s_ctx: int,
                           dtype, device):
    """Zero per-stage cache buffers [ppstage, B_local, ...] with tp-sliced
    kv heads / d_inner, the leaves ``period_decode`` expects (``device=
    "meta"`` gives the shapes alone)."""
    tp, n = plan.tensor, plan.ppstage
    kv_local = max(1, cfg.n_kv_heads // tp) if tp > 1 else cfg.n_kv_heads

    def one(spec):
        if spec.mixer == ATTN:
            capn = attention.cache_capacity(
                spec, s_ctx, plan.seq_shards if spec.window == GLOBAL_WINDOW else 1)
            return attention.init_kv_cache(n, B_local, kv_local, capn, cfg.hd, dtype, device)
        if spec.mixer == MAMBA:
            di = cfg.mamba.d_inner(cfg.d_model) // tp
            return mamba.init_mamba_cache(n, B_local, cfg, dtype, device, di=di)
        if spec.mixer == MLSTM:  # tp-replicated
            return xlstm.init_mlstm_cache(n, B_local, cfg, dtype, device)
        if spec.mixer == SLSTM:
            return xlstm.init_slstm_cache(n, B_local, cfg, dtype, device)
        raise ValueError(spec.mixer)

    return tuple(one(spec) for spec in cfg.period)
