"""Model construction and single-device entry points, training and serving
(``repro.models.registry`` in torch).

Parameter layout, as in the JAX package: ``params['layers']`` is a tuple
over period positions; each leaf is stacked over *period instances* on
axis 0.  ``active_mask(cfg)`` marks padding layers to identity.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ATTN, MAMBA, MLSTM, MOE_FF, NO_FF, SLSTM, ArchConfig
from repro_torch.models import attention, mamba, mlp, moe, xlstm
from repro_torch.models.common import (
    dense_init,
    dtype_of,
    init_norm,
    resolve_device,
    rms_norm,
    softmax_cross_entropy,
)
from repro_torch.models.transformer import scan_decode, scan_forward, scan_prefill


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
    init_mixers = {ATTN: attention.init_attn_params, MAMBA: mamba.init_mamba_params,
                   MLSTM: xlstm.init_mlstm_params, SLSTM: xlstm.init_slstm_params}
    layers = []
    for spec in cfg.period:
        init_mixer = init_mixers[spec.mixer]
        p = {"norm1": init_norm(cfg.d_model, dtype, dev, P),
             "mixer": init_mixer(generator, cfg, dtype, P)}
        if spec.ff != NO_FF:
            init_ff = moe.init_moe_params if spec.ff == MOE_FF else mlp.init_mlp_params
            p["norm2"] = init_norm(cfg.d_model, dtype, dev, P)
            p["ff"] = init_ff(generator, cfg, dtype, P)
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


class _EmbedLookup(torch.autograd.Function):
    """``weight[ids]`` for a low-precision table, its gradient rows summed in
    fp32 and rounded once.  Autograd's own gradient of the lookup (an
    ``index_put_`` with ``accumulate``) adds a row's duplicates one by one
    in the table's dtype: in bf16 a frequent token's row stalls (1,600
    duplicates of one token, as a Zipf batch of 8 x 1024 holds, lose ~60%
    of their sum), so two correct computations that group the tokens
    differently (a mesh's micro-batches, one whole batch) disagreed by 39%
    of the table's largest entry after an SGD step."""

    @staticmethod
    def forward(ctx, weight, ids):
        ctx.save_for_backward(ids)
        ctx.shape, ctx.dtype = weight.shape, weight.dtype
        return weight[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        rows, inv = torch.unique(ids.reshape(-1), return_inverse=True)
        acc = torch.zeros((rows.numel(), g.shape[-1]), dtype=torch.float32, device=g.device)
        acc.index_put_((inv,), g.reshape(-1, g.shape[-1]).float(), accumulate=True)
        grad = torch.zeros(ctx.shape, dtype=ctx.dtype, device=g.device)
        grad[rows] = acc.to(ctx.dtype)
        return grad, None


def embed_tokens(cfg: ArchConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids [B, S] -> [B, S, d] (decode takes tokens with any frontend).
    An fp32 table takes autograd's own gradient (fp32 sums); a bf16 one sums
    its gradient rows in fp32 (:class:`_EmbedLookup`)."""
    table, ids = params["embed"], tokens.long()
    if table.dtype == torch.float32 or not (torch.is_grad_enabled() and table.requires_grad):
        return table[ids]
    return _EmbedLookup.apply(table, ids)


def embed_inputs(cfg: ArchConfig, params, batch: dict) -> torch.Tensor:
    """Token/frame/VLM embedding -> [B, S, d]: audio frames cast to the
    params' dtype; for vision, the patch embeddings replace the first
    ``n_frontend_tokens`` positions of the token embedding."""
    if cfg.frontend == "audio":
        return batch["frames"].to(dtype_of(cfg.param_dtype))
    h = embed_tokens(cfg, params, batch["tokens"])
    if cfg.frontend == "vision":
        n_img = cfg.n_frontend_tokens
        img = batch["image_embeds"].to(h.dtype)  # [B, n_img, d]
        h = torch.cat([img, h[:, n_img:]], dim=1)
    return h


# ------------------------------------------------------------------- training
def forward(cfg: ArchConfig, params, batch: dict, *, use_kernels: bool = False):
    """Full forward -> (hidden [B,S,d] after the final norm, aux scalar): the
    MoE routers' auxiliary loss, a float32 zero for a model without one."""
    h = embed_inputs(cfg, params, batch)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    h, aux = scan_forward(params["layers"], h, active_mask(cfg), cfg=cfg,
                          positions=positions, use_kernels=use_kernels)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, aux


def loss_fn(cfg: ArchConfig, params, batch: dict, *, use_kernels: bool = False):
    """Mean next-token (decoder) or masked-prediction (encoder) CE ->
    (total, {"ce", "aux"})."""
    h, aux = forward(cfg, params, batch, use_kernels=use_kernels)
    logits = _logits(cfg, params, h)
    labels = batch["labels"]
    if cfg.causal and not cfg.is_encoder:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    loss = torch.mean(softmax_cross_entropy(logits, labels))
    return loss + aux, {"ce": loss, "aux": aux}


# -------------------------------------------------------------------- serving
def init_decode_caches(cfg: ArchConfig, batch: int, s_ctx: int, *,
                       device="cuda", dtype: Optional[torch.dtype] = None):
    """Cache tree: tuple over period positions; leaves stacked [P, ...]:
    ``KVCache`` for attention layers, ``MambaCache``, ``MLSTMCache`` and
    ``SLSTMCache`` for the others.  ``device="meta"`` gives the shapes
    without allocating."""
    dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
    dtype = dtype or dtype_of(cfg.param_dtype)
    caches = []
    for spec in cfg.period:
        if spec.mixer == MAMBA:
            caches.append(mamba.init_mamba_cache(cfg.n_periods, batch, cfg, dtype, dev))
        elif spec.mixer == MLSTM:
            caches.append(xlstm.init_mlstm_cache(cfg.n_periods, batch, cfg, dtype, dev))
        elif spec.mixer == SLSTM:
            caches.append(xlstm.init_slstm_cache(cfg.n_periods, batch, cfg, dtype, dev))
        else:
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
    h = embed_inputs(cfg, params, batch)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    h, caches = scan_prefill(params["layers"], h, active_mask(cfg), cfg=cfg,
                             positions=positions, capacity=capacity)
    h_last = rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, h_last), caches
