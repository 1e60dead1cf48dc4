"""Model construction and single-device serving entry points
(``repro.models.registry`` in torch).

Parameter layout, as in the JAX package: ``params['layers']`` is a tuple
over period positions; each leaf is stacked over *period instances* on
axis 0.  ``active_mask(cfg)`` marks padding layers to identity.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ATTN, DENSE_FF, NO_FF, OTHER_FAMILIES, ArchConfig
from repro_torch.models import attention, mlp
from repro_torch.models.common import (
    dense_init,
    dtype_of,
    init_norm,
    resolve_device,
    rms_norm,
)
from repro_torch.models.transformer import scan_decode, scan_prefill


def active_mask(cfg: ArchConfig, n_instances: Optional[int] = None) -> np.ndarray:
    """bool [n_instances, period_len]: layer (p, j) is a real layer."""
    P = n_instances if n_instances is not None else cfg.n_periods
    idx = np.arange(P * cfg.period_len).reshape(P, cfg.period_len)
    return idx < cfg.n_layers


def init_params(cfg: ArchConfig, generator: torch.Generator, *, device="cuda",
                n_instances: Optional[int] = None) -> dict:
    """Stacked parameters on ``device``, drawn from ``generator`` (which
    must live there), at the JAX package's layout and scales
    (``n_instances`` >= ``cfg.n_periods`` adds padding instances, masked to
    identity).  The bits come from torch, not from ``jax.random``."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params asked on {dev}")
    dev = generator.device
    dtype = dtype_of(cfg.param_dtype)
    P = n_instances if n_instances is not None else cfg.n_periods
    layers = []
    for spec in cfg.period:
        if spec.mixer != ATTN or spec.ff not in (DENSE_FF, NO_FF):
            raise NotImplementedError(
                f"{spec.mixer}/{spec.ff} layers: {OTHER_FAMILIES}")
        p = {"norm1": init_norm(cfg.d_model, dtype, dev, P),
             "mixer": attention.init_attn_params(generator, cfg, dtype, P)}
        if spec.ff == DENSE_FF:
            p["norm2"] = init_norm(cfg.d_model, dtype, dev, P)
            p["ff"] = mlp.init_mlp_params(generator, cfg, dtype, P)
        layers.append(p)
    params = {
        "embed": dense_init(generator, (cfg.vocab_size, cfg.d_model), dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "layers": tuple(layers),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, (cfg.vocab_size, cfg.d_model), dtype)
    return params


def _to_torch(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: torch has no numpy bridge
        t = torch.tensor(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.tensor(a)         # a copy: the caller's arrays stay untouched
    return t.to(device=device, dtype=dtype)


def params_from_jax(tree, *, device="cuda", dtype: Optional[torch.dtype] = None):
    """The JAX package's parameter tree (its leaves handed over as numpy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``) as the port's tree,
    on ``device``, optionally cast to ``dtype``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=dev, dtype=dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(params_from_jax(v, device=dev, dtype=dtype) for v in tree)
    return _to_torch(tree, dev, dtype)


def _logits(cfg: ArchConfig, params, h: torch.Tensor) -> torch.Tensor:
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return h @ head.T


def embed_tokens(cfg: ArchConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    if cfg.frontend != "none":
        raise NotImplementedError(f"frontend {cfg.frontend!r}: {OTHER_FAMILIES}")
    return params["embed"][tokens.long()]


# -------------------------------------------------------------------- serving
def init_decode_caches(cfg: ArchConfig, batch: int, s_ctx: int, *,
                       device="cuda", dtype: Optional[torch.dtype] = None):
    """Cache tree: tuple over period positions; leaves stacked [P, ...].
    ``device="meta"`` gives the shapes without allocating."""
    dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
    dtype = dtype or dtype_of(cfg.param_dtype)
    caches = []
    for spec in cfg.period:
        if spec.mixer != ATTN:
            raise NotImplementedError(f"{spec.mixer} caches: {OTHER_FAMILIES}")
        caches.append(attention.init_kv_cache(
            cfg.n_periods, batch, cfg.n_kv_heads, attention.cache_capacity(spec, s_ctx),
            cfg.hd, dtype, dev))
    return tuple(caches)


def decode_step(cfg: ArchConfig, params, caches, tokens: torch.Tensor, *,
                use_kernels: bool = False):
    """One-token decode -> (logits [B,1,V], caches updated in place)."""
    h = embed_tokens(cfg, params, tokens)
    h, caches = scan_decode(params["layers"], h, caches, active_mask(cfg), cfg=cfg,
                            use_kernels=use_kernels)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, h), caches


def prefill(cfg: ArchConfig, params, batch: dict, *, capacity: Optional[int] = None):
    """Prefill -> (last-position logits [B,1,V], caches)."""
    h = embed_tokens(cfg, params, batch["tokens"])
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    h, caches = scan_prefill(params["layers"], h, active_mask(cfg), cfg=cfg,
                             positions=positions, capacity=capacity)
    h_last = rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, h_last), caches
