"""Grouped-query attention with RoPE and KV caches (``repro.models.attention``
in torch): the serving slice's prefill and one-token decode.

Decode supports the JAX package's two cache layouts:
  * append cache [B, Hkv, S_ctx, hd] (global-attention layers);
  * rolling-window ring [B, Hkv, W, hd] with a monotone write cursor
    (sliding-window layers).
Sequence-sharded caches (the mesh path's long-context decode) are not
ported.

One deliberate difference: :func:`attn_decode` writes the new token's K/V
and advances the cursor *in place* and returns the same cache, where the
JAX function returns a new cache.  A functional update would copy the whole
cache of every layer on every token.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models.common import apply_rope, dense_init

BLOCKWISE_THRESHOLD = 4_096  # the JAX package's O(S*block) attention from here on
BLOCKWISE = ("prompts of >= 4096 tokens use the blockwise attention, not ported "
             "yet: ROADMAP port queue item 1 (training slice)")


# ------------------------------------------------------------------ parameters
def init_attn_params(gen: torch.Generator, cfg: ArchConfig, dtype, n: int) -> dict:
    """Attention weights of ``n`` stacked layer instances."""
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": dense_init(gen, (n, d, cfg.n_heads * hd), dtype),
        "wk": dense_init(gen, (n, d, cfg.n_kv_heads * hd), dtype),
        "wv": dense_init(gen, (n, d, cfg.n_kv_heads * hd), dtype),
        "wo": dense_init(gen, (n, cfg.n_heads * hd, d), dtype,
                         scale=0.02 / max(1, cfg.n_layers) ** 0.5),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((n, width * hd), dtype=dtype, device=gen.device)
    return p


def _project_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """x [B,S,d] -> q [B,S,Hq,hd], k/v [B,S,Hkv,hd]."""
    hd = cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, S = x.shape[0], x.shape[1]
    return q.reshape(B, S, -1, hd), k.reshape(B, S, -1, hd), v.reshape(B, S, -1, hd)


def _repeat_kv(k: torch.Tensor, n_rep: int, dim: int = 2) -> torch.Tensor:
    return k if n_rep == 1 else torch.repeat_interleave(k, n_rep, dim=dim)


# --------------------------------------------------------------------- caching
class KVCache(NamedTuple):
    k: torch.Tensor       # [B, Hkv, C, hd]; C = S_ctx (global) or window (local)
    v: torch.Tensor
    cursor: torch.Tensor  # [B] int32: tokens already written (uniform across B)

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


def init_kv_cache(n: int, batch: int, n_kv: int, capacity: int, hd: int, dtype,
                  device) -> KVCache:
    """Empty caches of ``n`` layer instances, stacked on axis 0."""
    return KVCache(
        k=torch.zeros((n, batch, n_kv, capacity, hd), dtype=dtype, device=device),
        v=torch.zeros((n, batch, n_kv, capacity, hd), dtype=dtype, device=device),
        cursor=torch.zeros((n, batch), dtype=torch.int32, device=device),
    )


def cache_capacity(spec: LayerSpec, s_ctx: int) -> int:
    """Cache capacity of a layer: the rolling window for local layers, the
    whole serving context for global ones."""
    if spec.window:
        return min(spec.window, s_ctx)
    return s_ctx


# --------------------------------------------------------------------- prefill
def attn_prefill(p: dict, x: torch.Tensor, *, cfg: ArchConfig, spec: LayerSpec,
                 positions: torch.Tensor, capacity: Optional[int] = None):
    """Full-sequence forward that also returns the KV cache for decoding.
    Window layers keep only the trailing ``window`` keys (ring layout with the
    cursor at S % W so subsequent decode writes continue the ring).  Global
    layers pad the cache out to ``capacity`` (the serving context length) so
    decode has room to append."""
    hd = cfg.hd
    B, S, _ = x.shape
    if S >= BLOCKWISE_THRESHOLD:
        raise NotImplementedError(BLOCKWISE)
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    n_rep = q.shape[2] // k.shape[2]
    kk, vv = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() / hd**0.5
    if cfg.causal:
        allow = positions[None, :] <= positions[:, None]
        if spec.window:
            allow &= positions[None, :] > (positions[:, None] - spec.window)
        scores = torch.where(allow[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vv)
    y = out.reshape(B, S, -1) @ p["wo"]

    kc = k.transpose(1, 2)  # [B,Hkv,S,hd]
    vc = v.transpose(1, 2)
    if spec.window and spec.window <= S:
        W = spec.window
        # ring layout: token at global pos p sits in slot p % W
        tail_start = S - W
        shift = tail_start % W
        kc = torch.roll(kc[:, :, tail_start:], shift, dims=2)
        vc = torch.roll(vc[:, :, tail_start:], shift, dims=2)
    elif spec.window:  # S < window: ring slots 0..S-1, pad to ring capacity
        tcap = min(spec.window, capacity) if capacity is not None else spec.window
        if tcap > S:
            kc = F.pad(kc, (0, 0, 0, tcap - S))
            vc = F.pad(vc, (0, 0, 0, tcap - S))
    elif capacity is not None and capacity > S:
        kc = F.pad(kc, (0, 0, 0, capacity - S))
        vc = F.pad(vc, (0, 0, 0, capacity - S))
    cache = KVCache(k=kc.contiguous(), v=vc.contiguous(),
                    cursor=torch.full((B,), S, dtype=torch.int32, device=x.device))
    return y, cache


# ---------------------------------------------------------------------- decode
def attn_decode(p: dict, x: torch.Tensor, cache: KVCache, *, cfg: ArchConfig,
                spec: LayerSpec, use_kernels: bool = False):
    """One-token decode.  x: [B,1,d].  Returns (out [B,1,d], cache), the
    cache updated in place.  The position stays on the device: the write
    slot and the kernel's ``length`` are tensors, never host integers."""
    from repro_torch.kernels import ops as kops

    hd = cfg.hd
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, cfg)  # q [B,1,Hq,hd]
    pos = cache.cursor[0]  # global position of the incoming token (uniform)
    posv = pos.expand(B, 1)
    q = apply_rope(q, posv, cfg.rope_theta)
    k_new = apply_rope(k_new, posv, cfg.rope_theta)

    C = cache.capacity
    # rolling ring-buffer slot for windowed layers; plain append otherwise
    # (unwindowed capacity == S_ctx covers all tokens)
    slot = torch.remainder(pos, C) if spec.window else torch.clamp(pos, max=C - 1)
    slot = slot.reshape(1).long()
    cache.k.index_copy_(2, slot, k_new.transpose(1, 2))
    cache.v.index_copy_(2, slot, v_new.transpose(1, 2))

    if use_kernels and kops.decode_attention_capable(
            n_q_heads=q.shape[2], n_kv_heads=cache.k.shape[1], capacity=C,
            window=spec.window):
        # flash-decode kernel: one query token against the append cache;
        # `valid = slots <= pos` is exactly `length = pos + 1`
        o = kops.decode_attention(q[:, 0], cache.k, cache.v, (pos + 1).reshape(1))
        out = o.reshape(B, 1, -1) @ p["wo"]
    else:
        slots = torch.arange(C, dtype=torch.int32, device=x.device)
        if spec.window:
            valid = (slots <= pos) | (pos >= C)  # ring fully valid once wrapped
        else:
            valid = slots <= pos
        n_rep = q.shape[2] // cache.k.shape[1]
        kk = _repeat_kv(cache.k, n_rep, dim=1)  # [B, Hq, C, hd]
        vv = _repeat_kv(cache.v, n_rep, dim=1)
        scores = torch.einsum("bqhd,bhcd->bhqc", q, kk).float() / hd**0.5
        scores = torch.where(valid[None, None, None, :], scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqc,bhcd->bhqd", probs, vv.float()).to(x.dtype)
        out = o.transpose(1, 2).reshape(B, 1, -1) @ p["wo"]  # [B,1,Hq*hd] @ wo
    cache.cursor.add_(1)
    return out, cache
