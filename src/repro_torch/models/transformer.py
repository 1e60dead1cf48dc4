"""Layer / period assembly (``repro.models.transformer`` in torch).

A *layer* = pre-norm mixer (+ residual) then pre-norm FFN (+ residual); a
*period* is the arch's repeating block list.  The JAX package runs a
``lax.scan`` over period instances; :func:`scan_forward`,
:func:`scan_prefill` and :func:`scan_decode` are the port's loops over the
same stacked parameters, shared by the monolithic entry points
(``registry``) and the pipelined stage workers (``serverless.runtime.
worker``, ``serving.worker``) so both run the same math.  The training
forwards return ``(x, aux)``, the MoE router's auxiliary loss summed over
the layers as JAX's scan sums it; ``aux`` is None where no layer has a
router (a zero in JAX), so a dense model adds nothing to its loss graph.
Every function takes the mesh's collective hooks as ``ctx`` (``LOCAL_CTX``,
all identities, by default); the mesh path (``core.pipeline``) runs the
same functions on a rank's slices of the stacked parameters.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import MAMBA, MLSTM, MOE_FF, NO_FF, SLSTM
from repro_torch.models import attention, mamba, mlp, moe, xlstm
from repro_torch.models.common import LOCAL_CTX, ParallelCtx, rms_norm, tree_map


def _repl_ctx(ctx: ParallelCtx) -> ParallelCtx:
    """xLSTM mixers run TP-replicated (``core.sharding.xlstm_pspecs``): their
    outputs are already complete on every lane, so the row-parallel psum
    hook must be the identity for them."""
    if ctx.tp_size == 1:
        return ctx
    return dataclasses.replace(ctx, psum_tp=lambda x: x)


def _ff(p, x, *, cfg, spec, gate, ctx=LOCAL_CTX, use_kernels=False):
    """The pre-norm FFN and its residual -> (x, router aux or None)."""
    if spec.ff == NO_FF:
        return x, None
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if spec.ff == MOE_FF:
        ff, aux = moe.moe_forward(p["ff"], h, cfg=cfg, ctx=ctx)
        return x + gate * ff, aux * gate
    return x + gate * mlp.mlp_forward(p["ff"], h, ctx=ctx, use_kernels=use_kernels), None


def _add(total, aux):
    if aux is None:
        return total
    return aux if total is None else total + aux


# --------------------------------------------------------------------- forward
def layer_forward(p, x, active, *, cfg, spec, positions, ctx=LOCAL_CTX, use_kernels=False):
    """One training layer -> (x, aux); ``active`` False (a padding layer) is
    the identity, with a zero aux."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer == MAMBA:
        mix = mamba.mamba_forward(p["mixer"], h, cfg=cfg, ctx=ctx)
    elif spec.mixer == MLSTM:
        mix = xlstm.mlstm_forward(p["mixer"], h, cfg=cfg, ctx=_repl_ctx(ctx))
    elif spec.mixer == SLSTM:
        mix = xlstm.slstm_forward(p["mixer"], h, cfg=cfg, ctx=_repl_ctx(ctx))
    else:
        mix = attention.attn_forward(p["mixer"], h, cfg=cfg, spec=spec, positions=positions,
                                     ctx=ctx, use_kernels=use_kernels)
    gate = float(active)
    x = x + gate * mix
    return _ff(p, x, cfg=cfg, spec=spec, gate=gate, ctx=ctx, use_kernels=use_kernels)


def period_forward(period_params, x, active, *, cfg, positions, ctx=LOCAL_CTX,
                   use_kernels=False):
    aux = None
    for j, spec in enumerate(cfg.period):
        x, a = layer_forward(period_params[j], x, bool(active[j]), cfg=cfg, spec=spec,
                             positions=positions, ctx=ctx, use_kernels=use_kernels)
        aux = _add(aux, a)
    return x, aux


# ---------------------------------------------------------------------- decode
def layer_decode(p, x, cache, active, *, cfg, spec, ctx=LOCAL_CTX, use_kernels=False):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    # the decoders update the cache in place, so a padding layer (active
    # False) decodes into a copy and its own cache stays as it was
    own = cache if active else tree_map(torch.clone, cache)
    if spec.mixer == MAMBA:
        mix, new_cache = mamba.mamba_decode(p["mixer"], h, own, cfg=cfg, ctx=ctx)
    elif spec.mixer == MLSTM:
        mix, new_cache = xlstm.mlstm_decode(p["mixer"], h, own, cfg=cfg, ctx=_repl_ctx(ctx))
    elif spec.mixer == SLSTM:
        mix, new_cache = xlstm.slstm_decode(p["mixer"], h, own, cfg=cfg, ctx=_repl_ctx(ctx))
    else:
        mix, new_cache = attention.attn_decode(p["mixer"], h, own, cfg=cfg, spec=spec,
                                               ctx=ctx, use_kernels=use_kernels)
    gate = float(active)
    x = x + gate * mix
    new_cache = new_cache if active else cache  # jnp.where(active, new, old)
    return _ff(p, x, cfg=cfg, spec=spec, gate=gate, ctx=ctx)[0], new_cache


def period_decode(period_params, x, caches, active, *, cfg, ctx=LOCAL_CTX, use_kernels=False):
    new_caches = []
    for j, spec in enumerate(cfg.period):
        x, c = layer_decode(period_params[j], x, caches[j], bool(active[j]),
                            cfg=cfg, spec=spec, ctx=ctx, use_kernels=use_kernels)
        new_caches.append(c)
    return x, tuple(new_caches)


# --------------------------------------------------------------------- prefill
def layer_prefill(p, x, active, *, cfg, spec, positions, ctx=LOCAL_CTX, capacity=None):
    """Forward + cache construction (serving prefill)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer == MAMBA:
        mix, cache = mamba.mamba_forward(p["mixer"], h, cfg=cfg, ctx=ctx, return_state=True)
    elif spec.mixer == MLSTM:
        mix, cache = xlstm.mlstm_forward(p["mixer"], h, cfg=cfg, ctx=_repl_ctx(ctx),
                                         return_state=True)
    elif spec.mixer == SLSTM:
        mix, cache = xlstm.slstm_forward(p["mixer"], h, cfg=cfg, ctx=_repl_ctx(ctx),
                                         return_state=True)
    else:
        mix, cache = attention.attn_prefill(p["mixer"], h, cfg=cfg, spec=spec,
                                            positions=positions, ctx=ctx, capacity=capacity)
    gate = float(active)
    x = x + gate * mix
    return _ff(p, x, cfg=cfg, spec=spec, gate=gate, ctx=ctx)[0], cache


def period_prefill(period_params, x, active, *, cfg, positions, ctx=LOCAL_CTX, capacity=None):
    caches = []
    for j, spec in enumerate(cfg.period):
        x, c = layer_prefill(period_params[j], x, bool(active[j]), cfg=cfg,
                             spec=spec, positions=positions, ctx=ctx, capacity=capacity)
        caches.append(c)
    return x, tuple(caches)


# ------------------------------------------------ loops over period instances
def scan_forward(layers, x, mask, *, cfg, positions, ctx=LOCAL_CTX, use_kernels=False):
    """The training forward through every stacked period instance of
    ``layers`` in order (``mask`` [n_instances, period_len]) -> (x, aux):
    the instances' aux losses summed as ``jnp.sum`` of the scan's, or None
    when no layer routes."""
    auxs = []
    for i in range(len(mask)):
        pp = tree_map(lambda a: a[i], layers)
        x, aux = period_forward(pp, x, mask[i], cfg=cfg, positions=positions, ctx=ctx,
                                use_kernels=use_kernels)
        if aux is not None:
            auxs.append(aux)
    return x, (torch.stack(auxs).sum() if auxs else None)


def scan_prefill(layers, x, mask, *, cfg, positions, ctx=LOCAL_CTX, capacity=None):
    """Prefill every stacked period instance of ``layers`` in order; the
    caches come back stacked over instances (axis 0), as the scan's do."""
    per_instance = []
    for i in range(len(mask)):
        pp = tree_map(lambda a: a[i], layers)
        x, cs = period_prefill(pp, x, mask[i], cfg=cfg, positions=positions, ctx=ctx,
                               capacity=capacity)
        per_instance.append(cs)
    return x, tree_map(lambda *xs: torch.stack(xs), *per_instance)


def scan_decode(layers, x, caches, mask, *, cfg, ctx=LOCAL_CTX, use_kernels=False):
    """One-token decode through every stacked instance.  Each instance's
    cache is a view into the stacked ``caches``, which are updated in
    place and returned."""
    for i in range(len(mask)):
        pp = tree_map(lambda a: a[i], layers)
        cs = tree_map(lambda a: a[i], caches)
        x, _ = period_decode(pp, x, cs, mask[i], cfg=cfg, ctx=ctx, use_kernels=use_kernels)
    return x, caches
