"""Layer / period assembly for serving (``repro.models.transformer`` in torch).

A *layer* = pre-norm mixer (+ residual) then pre-norm FFN (+ residual); a
*period* is the arch's repeating block list.  The JAX package runs a
``lax.scan`` over period instances; :func:`scan_prefill` and
:func:`scan_decode` are the port's loops over the same stacked parameters,
shared by the monolithic entry points (``registry``) and the pipelined
stage workers (``serving.worker``) so both run the same math.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN, DENSE_FF, NO_FF, OTHER_FAMILIES
from repro_torch.models import attention, mlp
from repro_torch.models.common import rms_norm, tree_map


def _check(spec) -> None:
    if spec.mixer != ATTN or spec.ff not in (DENSE_FF, NO_FF):
        raise NotImplementedError(f"{spec.mixer}/{spec.ff} layers: {OTHER_FAMILIES}")


def _ff(p, x, *, cfg, spec, gate):
    if spec.ff == NO_FF:
        return x
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + gate * mlp.mlp_forward(p["ff"], h)


# ---------------------------------------------------------------------- decode
def layer_decode(p, x, cache, active, *, cfg, spec, use_kernels=False):
    _check(spec)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    # attn_decode updates the cache in place, so a padding layer (active
    # False) decodes into a copy and its own cache stays as it was
    mix, new_cache = attention.attn_decode(
        p["mixer"], h, cache if active else tree_map(torch.clone, cache),
        cfg=cfg, spec=spec, use_kernels=use_kernels)
    gate = float(active)
    x = x + gate * mix
    new_cache = new_cache if active else cache  # jnp.where(active, new, old)
    return _ff(p, x, cfg=cfg, spec=spec, gate=gate), new_cache


def period_decode(period_params, x, caches, active, *, cfg, use_kernels=False):
    new_caches = []
    for j, spec in enumerate(cfg.period):
        x, c = layer_decode(period_params[j], x, caches[j], bool(active[j]),
                            cfg=cfg, spec=spec, use_kernels=use_kernels)
        new_caches.append(c)
    return x, tuple(new_caches)


# --------------------------------------------------------------------- prefill
def layer_prefill(p, x, active, *, cfg, spec, positions, capacity=None):
    """Forward + cache construction (serving prefill)."""
    _check(spec)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    mix, cache = attention.attn_prefill(p["mixer"], h, cfg=cfg, spec=spec,
                                        positions=positions, capacity=capacity)
    gate = float(active)
    x = x + gate * mix
    return _ff(p, x, cfg=cfg, spec=spec, gate=gate), cache


def period_prefill(period_params, x, active, *, cfg, positions, capacity=None):
    caches = []
    for j, spec in enumerate(cfg.period):
        x, c = layer_prefill(period_params[j], x, bool(active[j]), cfg=cfg,
                             spec=spec, positions=positions, capacity=capacity)
        caches.append(c)
    return x, tuple(caches)


# ------------------------------------------------ loops over period instances
def scan_prefill(layers, x, mask, *, cfg, positions, capacity=None):
    """Prefill every stacked period instance of ``layers`` in order; the
    caches come back stacked over instances (axis 0), as the scan's do."""
    per_instance = []
    for i in range(len(mask)):
        pp = tree_map(lambda a: a[i], layers)
        x, cs = period_prefill(pp, x, mask[i], cfg=cfg, positions=positions,
                               capacity=capacity)
        per_instance.append(cs)
    return x, tree_map(lambda *xs: torch.stack(xs), *per_instance)


def scan_decode(layers, x, caches, mask, *, cfg, use_kernels=False):
    """One-token decode through every stacked instance.  Each instance's
    cache is a view into the stacked ``caches``, which are updated in
    place and returned."""
    for i in range(len(mask)):
        pp = tree_map(lambda a: a[i], layers)
        cs = tree_map(lambda a: a[i], caches)
        x, _ = period_decode(pp, x, cs, mask[i], cfg=cfg, use_kernels=use_kernels)
    return x, caches
