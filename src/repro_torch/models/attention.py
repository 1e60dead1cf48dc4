"""Grouped-query attention with RoPE and KV caches (``repro.models.attention``
in torch): the training forward, prefill and one-token decode.

The training forward's plain path is the JAX package's: a score einsum in
the activations' dtype, then an fp32 softmax; from 4096 tokens on, the
blockwise online-softmax attention.  ``use_kernels=True`` routes it through
``kernels.ops.flash_attention`` (the CUDA kernel on a card, its plain
version on the CPU).

Decode supports the JAX package's two cache layouts:
  * append cache [B, Hkv, S_ctx, hd] (global-attention layers);
  * rolling-window ring [B, Hkv, W, hd] with a monotone write cursor
    (sliding-window layers).
For a long context the mesh path shards a global layer's cache over the
``data`` axis (``ctx.seq_shards`` > 1): each rank holds every
``seq_shards``-th position, and the partial softmaxes are combined with
``ctx.pmax_seq`` / ``ctx.psum_seq``.  ``ctx.psum_tp`` reduces the
row-parallel output projection under tensor parallelism; the local head
counts come from the (possibly sliced) weights.

One deliberate difference: :func:`attn_decode` writes the new token's K/V
and advances the cursor *in place* and returns the same cache, where the
JAX function returns a new cache.  A functional update would copy the whole
cache of every layer on every token.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GLOBAL_WINDOW, ArchConfig, LayerSpec
from repro_torch.models.common import (
    LOCAL_CTX,
    ParallelCtx,
    apply_rope,
    dense_init,
    init_norm,
    rms_norm,
)

BLOCKWISE_THRESHOLD = 4_096  # O(S*block) attention at and above this length
Q_BLOCK = 512
K_BLOCK = 1024


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
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = init_norm(hd, dtype, gen.device, n)
    return p


def _project_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """x [B,S,d] -> q [B,S,Hq,hd], k/v [B,S,Hkv,hd]; with ``qk_norm``, q and
    k RMS-normed over the head dim (before RoPE, as in JAX)."""
    hd = cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, S = x.shape[0], x.shape[1]
    q, k, v = q.reshape(B, S, -1, hd), k.reshape(B, S, -1, hd), v.reshape(B, S, -1, hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


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


def cache_capacity(spec: LayerSpec, s_ctx: int, seq_shards: int = 1) -> int:
    """Cache capacity of a layer on one rank: the rolling window for local
    layers, a 1/seq_shards slice of the serving context for (possibly
    sharded) global ones."""
    if spec.window:
        return min(spec.window, s_ctx)
    if s_ctx % seq_shards:
        raise ValueError(f"context {s_ctx} does not split into {seq_shards} shards")
    return s_ctx // seq_shards


# ------------------------------------------------------- blockwise (flash) path
def _blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         positions: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    """Online-softmax attention over (q-block, k-block) tiles in fp32, the
    plain twin of the flash kernel.  q [B,S,Hq,hd], k/v [B,S,Hkv,hd].
    Sliding-window layers read only the in-window keys of each q block, so
    their work scales with S*window rather than S^2."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    QB = min(Q_BLOCK, S)
    if S % QB:
        raise ValueError(f"sequence {S} is not a multiple of the q block {QB}")
    nqb = S // QB
    qg = q.reshape(B, S, Hkv, G, hd).float() * hd**-0.5
    kf, vf = k.float(), v.float()
    outs = []

    if window:
        # pad keys by the window so each q block sees exactly [qs-W, qs+QB)
        W = window
        kp = torch.nn.functional.pad(kf, (0, 0, 0, 0, W, 0))
        vp = torch.nn.functional.pad(vf, (0, 0, 0, 0, W, 0))
        pp = torch.nn.functional.pad(positions, (W, 0), value=-1)
        for i in range(nqb):
            qs = i * QB
            qb = qg[:, qs:qs + QB]
            qpos = positions[qs:qs + QB]
            kb, vb, kpos = kp[:, qs:qs + W + QB], vp[:, qs:qs + W + QB], pp[qs:qs + W + QB]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb)
            allow = (kpos[None, :] <= qpos[:, None]) & (
                kpos[None, :] > qpos[:, None] - W) & (kpos >= 0)[None, :]
            s = torch.where(allow, s, -1e30)
            p = torch.softmax(s, dim=-1)
            outs.append(torch.einsum("bhgqk,bkhd->bqhgd", p, vb))
        return torch.cat(outs, dim=1).reshape(B, S, Hq, hd).to(q.dtype)

    KB = min(K_BLOCK, S)
    if S % KB:
        raise ValueError(f"sequence {S} is not a multiple of the k block {KB}")
    for i in range(nqb):
        qs = i * QB
        qb = qg[:, qs:qs + QB]
        qpos = positions[qs:qs + QB]
        m = torch.full((B, Hkv, G, QB), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Hkv, G, QB), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hkv, G, QB, hd), dtype=torch.float32, device=q.device)
        for j in range(S // KB):
            ks = j * KB
            kb, vb, kpos = kf[:, ks:ks + KB], vf[:, ks:ks + KB], positions[ks:ks + KB]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb)
            if causal:
                s = torch.where(kpos[None, :] <= qpos[:, None], s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]       # [B,Hkv,G,QB,hd]
        outs.append(o.permute(0, 3, 1, 2, 4))                 # [B,QB,Hkv,G,hd]
    return torch.cat(outs, dim=1).reshape(B, S, Hq, hd).to(q.dtype)


def _dense_attention(q, k, v, positions, *, cfg: ArchConfig, spec: LayerSpec):
    """The plain path below the blockwise threshold: scores in the
    activations' dtype, fp32 softmax cast back, then the value product."""
    hd = cfg.hd
    n_rep = q.shape[2] // k.shape[2]
    kk, vv = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() / hd**0.5
    if cfg.causal:
        allow = positions[None, :] <= positions[:, None]
        if spec.window:
            allow &= positions[None, :] > (positions[:, None] - spec.window)
        scores = torch.where(allow[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vv)


# ---------------------------------------------------------------- full forward
def attn_forward(p: dict, x: torch.Tensor, *, cfg: ArchConfig, spec: LayerSpec,
                 positions: torch.Tensor, ctx: ParallelCtx = LOCAL_CTX,
                 use_kernels: bool = False) -> torch.Tensor:
    """Training attention over the full sequence.  x: [B,S,d].  With
    ``use_kernels`` the attention core is ``ops.flash_attention``, which
    assumes ``positions == arange(S)`` as the Pallas path does."""
    from repro_torch.kernels import ops as kops

    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if use_kernels:
        out = kops.flash_attention(q, k, v, causal=cfg.causal, window=spec.window)
    elif x.shape[1] >= BLOCKWISE_THRESHOLD:
        out = _blockwise_attention(q, k, v, positions, cfg.causal,
                                   spec.window if cfg.causal else 0)
    else:
        out = _dense_attention(q, k, v, positions, cfg=cfg, spec=spec)
    B, S = x.shape[0], x.shape[1]
    return ctx.psum_tp(out.reshape(B, S, -1) @ p["wo"])


# --------------------------------------------------------------------- prefill
def attn_prefill(p: dict, x: torch.Tensor, *, cfg: ArchConfig, spec: LayerSpec,
                 positions: torch.Tensor, ctx: ParallelCtx = LOCAL_CTX,
                 capacity: Optional[int] = None):
    """Full-sequence forward that also returns the KV cache for decoding.
    Window layers keep only the trailing ``window`` keys (ring layout with the
    cursor at S % W so subsequent decode writes continue the ring).  Global
    layers pad the cache out to ``capacity`` (the serving context length) so
    decode has room to append."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if S >= BLOCKWISE_THRESHOLD:
        out = _blockwise_attention(q, k, v, positions, cfg.causal, spec.window)
    else:
        out = _dense_attention(q, k, v, positions, cfg=cfg, spec=spec)
    y = ctx.psum_tp(out.reshape(B, S, -1) @ p["wo"])

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
                spec: LayerSpec, ctx: ParallelCtx = LOCAL_CTX, use_kernels: bool = False):
    """One-token decode.  x: [B,1,d].  Returns (out [B,1,d], cache), the
    cache updated in place.  The position stays on the device: the write
    slot and the kernel's ``length`` are tensors, never host integers.

    A global layer with ``ctx.seq_shards`` > 1 holds a 1/n slice of the KV
    sequence: the token at global position ``pos`` is written by shard
    ``pos % n`` at slot ``pos // n`` (round robin keeps the shards balanced
    during decode), and the shards' partial attention outputs are combined
    with a (max, sum-exp)-stable ``pmax_seq`` / ``psum_seq``."""
    from repro_torch.kernels import ops as kops

    hd = cfg.hd
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, cfg)  # q [B,1,Hq,hd]
    pos = cache.cursor[0]  # global position of the incoming token (uniform)
    posv = pos.expand(B, 1)
    q = apply_rope(q, posv, cfg.rope_theta)
    k_new = apply_rope(k_new, posv, cfg.rope_theta)

    C = cache.capacity
    slots = torch.arange(C, dtype=torch.int32, device=x.device)
    sharded = spec.window == GLOBAL_WINDOW and ctx.seq_shards > 1
    if sharded:
        n, me = ctx.seq_shards, ctx.seq_index
        is_mine = torch.remainder(pos, n) == me
        slot = torch.where(is_mine, torch.div(pos, n, rounding_mode="floor"),
                           torch.zeros_like(pos)).reshape(1).long()
        # a shard that does not own the token writes its slot 0 back unchanged
        for buf, new in ((cache.k, k_new), (cache.v, v_new)):
            buf.index_copy_(2, slot, torch.where(is_mine, new.transpose(1, 2),
                                                 buf.index_select(2, slot)))
        # shard me holds the slots s with global position s * n + me <= pos
        valid = slots * n + me <= pos
    else:
        # rolling ring-buffer slot for windowed layers; plain append otherwise
        # (unwindowed capacity == S_ctx covers all tokens)
        slot = torch.remainder(pos, C) if spec.window else torch.clamp(pos, max=C - 1)
        slot = slot.reshape(1).long()
        cache.k.index_copy_(2, slot, k_new.transpose(1, 2))
        cache.v.index_copy_(2, slot, v_new.transpose(1, 2))
        if spec.window:
            valid = (slots <= pos) | (pos >= C)  # ring fully valid once wrapped
        else:
            valid = slots <= pos

    if use_kernels and not sharded and kops.decode_attention_capable(
            n_q_heads=q.shape[2], n_kv_heads=cache.k.shape[1], capacity=C,
            window=spec.window, seq_shards=ctx.seq_shards):
        # flash-decode kernel: one query token against the append cache;
        # `valid = slots <= pos` is exactly `length = pos + 1`
        o = kops.decode_attention(q[:, 0], cache.k, cache.v, (pos + 1).reshape(1))
        out = o.reshape(B, 1, -1)
    else:
        n_rep = q.shape[2] // cache.k.shape[1]
        kk = _repeat_kv(cache.k, n_rep, dim=1)  # [B, Hq, C, hd]
        vv = _repeat_kv(cache.v, n_rep, dim=1)
        scores = torch.einsum("bqhd,bhcd->bhqc", q, kk).float() / hd**0.5
        scores = torch.where(valid[None, None, None, :], scores, -1e30)
        if sharded:
            m = scores.amax(dim=-1)                                   # [B,H,1]
            if ctx.pmax_seq is not None:
                m = ctx.pmax_seq(m)
            e = torch.exp(scores - m[..., None])
            num = ctx.psum_seq(torch.einsum("bhqc,bhcd->bhqd", e, vv.float()))
            den = ctx.psum_seq(e.sum(dim=-1))
            o = (num / den[..., None]).to(x.dtype)                     # [B,H,1,hd]
        else:
            probs = torch.softmax(scores, dim=-1)
            o = torch.einsum("bhqc,bhcd->bhqd", probs, vv.float()).to(x.dtype)
        out = o.transpose(1, 2).reshape(B, 1, -1)  # [B,1,Hq*hd]
    cache.cursor.add_(1)
    return ctx.psum_tp(out @ p["wo"]), cache
