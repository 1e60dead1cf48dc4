"""xLSTM blocks (``repro.models.xlstm`` in torch): the mLSTM (matrix memory,
parallel within a chunk) and the sLSTM (scalar memory, a sequential
recurrence), following arXiv:2405.04517.

Training and prefill run the mLSTM chunkwise, as the JAX package does: the
stabilized quadratic form inside chunks of ``MLSTM_CHUNK`` positions and the
(C, n, m) state carried from chunk to chunk, here by a Python loop where
JAX runs ``lax.scan``.  Under autograd each chunk runs in
``torch.utils.checkpoint``, as JAX's chunk body runs in ``jax.checkpoint``.
The sLSTM's gates read h_{t-1}, so it steps the sequence one position at a
time, as JAX's ``lax.scan`` does; it carries its own post-up-projection FFN
(hence ``ff=NO_FF`` in the arch config).  The state's ``h`` is rounded to
the activations' dtype each step and the recurrence reads that rounded
value, while the block's output is the fp32 ``h`` cast once after the loop,
as in JAX.  Both are plain PyTorch, as they are plain JAX in the reference
(no Pallas kernel).

Decode is the one-token recurrence of each.  As :func:`attention.attn_decode`
does, :func:`mlstm_decode` and :func:`slstm_decode` write the new state into
the cache they are given and return that cache (the JAX functions return
new ones).  The JAX package's GELU is ``jax.nn.gelu``'s default, the tanh
approximation.

On the mesh both run TP-replicated (their recurrent matrices couple the full
width): ``models.transformer`` hands them a context whose ``psum_tp`` is the
identity, so the mLSTM's row-parallel hook after ``w_down`` sums nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import LOCAL_CTX, ParallelCtx, dense_init, rms_norm

MLSTM_CHUNK = 256


def _m_dims(cfg: ArchConfig):
    return int(cfg.d_model * cfg.xlstm.m_proj_factor), cfg.n_heads


def _scaled_down(t: torch.Tensor, dh: int) -> torch.Tensor:
    """``t / dh**0.5`` with the constant in t's dtype, as JAX's weakly typed
    scalar is: in bf16 the divisor is itself rounded to bf16."""
    return t / torch.full((), dh ** 0.5, dtype=t.dtype, device=t.device)


# ======================================================================= mLSTM
def init_mlstm_params(gen: torch.Generator, cfg: ArchConfig, dtype, n: int) -> dict:
    """mLSTM weights of ``n`` stacked layer instances."""
    d = cfg.d_model
    di, H = _m_dims(cfg)
    dev = gen.device
    return {
        "w_up": dense_init(gen, (n, d, di), dtype),
        "w_z": dense_init(gen, (n, d, di), dtype),
        "conv_w": dense_init(gen, (n, cfg.xlstm.conv_kernel, di), dtype, scale=0.1),
        "conv_b": torch.zeros((n, di), dtype=dtype, device=dev),
        "wq": dense_init(gen, (n, di, di), dtype),
        "wk": dense_init(gen, (n, di, di), dtype),
        "wv": dense_init(gen, (n, di, di), dtype),
        "w_if": dense_init(gen, (n, di, 2 * H), dtype),
        "b_i": torch.zeros((n, H), dtype=dtype, device=dev),
        "b_f": torch.full((n, H), 3.0, dtype=dtype, device=dev),  # toward remembering
        "out_norm": torch.zeros((n, di), dtype=dtype, device=dev),
        "w_down": dense_init(gen, (n, di, d), dtype, scale=0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def _conv1d(xc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over seq.  xc [B,S,di]; w [k, di]."""
    k, S = w.shape[0], xc.shape[1]
    pad = F.pad(xc, (0, 0, k - 1, 0))
    return sum(pad[:, i:i + S, :] * w[i] for i in range(k)) + b


def _mlstm_qkvgates(p: dict, x: torch.Tensor):
    """x [B,S,d] -> q, k, v [B,S,H,dh] (x's dtype), u and z [B,S,di], the
    gates' log_i and log_f [B,S,H] (fp32)."""
    u = x @ p["w_up"]
    z = x @ p["w_z"]
    uc = F.silu(_conv1d(u, p["conv_w"], p["conv_b"]))
    di, H = u.shape[-1], p["b_i"].shape[0]
    dh = di // H
    B, S = x.shape[0], x.shape[1]
    q = (uc @ p["wq"]).reshape(B, S, H, dh)
    k = _scaled_down((uc @ p["wk"]).reshape(B, S, H, dh), dh)
    v = (u @ p["wv"]).reshape(B, S, H, dh)
    gates = (u @ p["w_if"]).float()  # [B,S,2H]
    log_i = gates[..., :H] + p["b_i"].float()
    log_f = F.logsigmoid(gates[..., H:] + p["b_f"].float())
    return q, k, v, u, z, log_i, log_f


def _mlstm_chunk(C_prev, n_prev, m_prev, qc, kc, vc, ic, fc):
    """One chunk of the stabilized mLSTM (fp32): the carried state
    (C [B,H,dh,dh], n [B,H,dh], m [B,H]) and the chunk's q/k/v [B,Q,H,dh]
    and gates [B,Q,H] -> (C, n, m at the chunk's end, h [B,Q,H,dh])."""
    Q = qc.shape[1]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=qc.device).tril()
    Fc = torch.cumsum(fc, dim=1)                            # [B,Q,H] log-forget in chunk
    # intra-chunk decay D[t,s] = F_t - F_s + i_s  (s <= t)
    D = Fc[:, :, None, :] - Fc[:, None, :, :] + ic[:, None, :, :]
    D = torch.where(tri[None, :, :, None], D, float("-inf"))
    m_intra = torch.amax(D, dim=2)                          # [B,Q,H]
    m_inter = Fc + m_prev[:, None, :]                       # carried-state scale
    m_t = torch.maximum(m_intra, m_inter)
    a = torch.exp(D - m_t[:, :, None, :])                   # [B,t,s,H]
    w = a * torch.einsum("bthd,bshd->btsh", qc, kc)
    num = torch.einsum("btsh,bshd->bthd", w, vc)
    den_intra = torch.sum(w, dim=2)                         # [B,t,H]
    scale = torch.exp(m_inter - m_t)
    num = num + scale[..., None] * torch.einsum("bthk,bhkv->bthv", qc, C_prev)
    den = den_intra + scale * torch.einsum("bthk,bhk->bth", qc, n_prev)
    den = torch.maximum(torch.abs(den), torch.exp(-m_t))
    h = num / den[..., None]
    # ----- state to the next chunk
    F_tot = Fc[:, -1]                                       # [B,H]
    g = F_tot[:, None, :] - Fc + ic                         # decay of k_s to chunk end
    m_state = torch.maximum(torch.amax(g, dim=1), F_tot + m_prev)
    gw = torch.exp(g - m_state[:, None, :])                 # [B,Q,H]
    decay = torch.exp(F_tot + m_prev - m_state)
    C_new = decay[..., None, None] * C_prev + torch.einsum("bsh,bshk,bshv->bhkv", gw, kc, vc)
    n_new = decay[..., None] * n_prev + torch.einsum("bsh,bshk->bhk", gw, kc)
    return C_new, n_new, m_state, h


def mlstm_forward(p: dict, x: torch.Tensor, *, cfg: ArchConfig, ctx: ParallelCtx = LOCAL_CTX,
                  return_state: bool = False):
    """Chunkwise-parallel stabilized mLSTM: x [B,S,d] -> [B,S,d] (+
    MLSTMCache when ``return_state``, for prefill).  S must be a multiple of
    ``MLSTM_CHUNK`` or shorter than it."""
    B, S, _ = x.shape
    q, k, v, u, z, log_i, log_f = _mlstm_qkvgates(p, x)
    H, dh = q.shape[2], q.shape[3]
    Q = min(MLSTM_CHUNK, S)
    if S % Q:
        raise ValueError(f"seq {S} not a multiple of mLSTM chunk {Q}")
    qf, kf, vf = q.float(), k.float(), v.float()
    dev = x.device
    C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=dev)
    m = torch.full((B, H), -1e30, dtype=torch.float32, device=dev)
    hs = []
    for i in range(S // Q):
        chunk = [t[:, i * Q:(i + 1) * Q] for t in (qf, kf, vf, log_i, log_f)]
        if torch.is_grad_enabled():
            C, n, m, h = checkpoint(_mlstm_chunk, C, n, m, *chunk, use_reentrant=False)
        else:
            C, n, m, h = _mlstm_chunk(C, n, m, *chunk)
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(B, S, -1).to(x.dtype)
    h = rms_norm(h, p["out_norm"], cfg.norm_eps) * F.silu(z)
    out = ctx.psum_tp(h @ p["w_down"])
    if return_state:
        kc = cfg.xlstm.conv_kernel - 1
        return out, MLSTMCache(C=C, n=n, m=m, conv=u[:, S - kc:, :].contiguous())
    return out


class MLSTMCache(NamedTuple):
    C: torch.Tensor     # [B,H,dk,dv] fp32
    n: torch.Tensor     # [B,H,dk] fp32
    m: torch.Tensor     # [B,H] fp32
    conv: torch.Tensor  # [B,k-1,di] trailing up-projections


def init_mlstm_cache(n: int, batch: int, cfg: ArchConfig, dtype, device) -> MLSTMCache:
    """Empty caches of ``n`` layer instances, stacked on axis 0."""
    di, H = _m_dims(cfg)
    dh = di // H
    return MLSTMCache(
        C=torch.zeros((n, batch, H, dh, dh), dtype=torch.float32, device=device),
        n=torch.zeros((n, batch, H, dh), dtype=torch.float32, device=device),
        m=torch.full((n, batch, H), -1e30, dtype=torch.float32, device=device),
        conv=torch.zeros((n, batch, cfg.xlstm.conv_kernel - 1, di), dtype=dtype,
                         device=device),
    )


def mlstm_decode(p: dict, x: torch.Tensor, cache: MLSTMCache, *, cfg: ArchConfig,
                 ctx: ParallelCtx = LOCAL_CTX):
    """x [B,1,d] -> ([B,1,d], cache), the cache updated in place."""
    B = x.shape[0]
    u = x @ p["w_up"]  # [B,1,di]
    z = x @ p["w_z"]
    hist = torch.cat([cache.conv, u], dim=1)
    uc = F.silu(torch.einsum("bkd,kd->bd", hist, p["conv_w"]) + p["conv_b"])  # [B,di]
    di, H = u.shape[-1], p["b_i"].shape[0]
    dh = di // H
    q = (uc @ p["wq"]).reshape(B, H, dh).float()
    k = _scaled_down(uc @ p["wk"], dh).reshape(B, H, dh).float()
    v = (u[:, 0] @ p["wv"]).reshape(B, H, dh).float()
    gates = (u[:, 0] @ p["w_if"]).float()
    log_i = gates[:, :H] + p["b_i"].float()
    log_f = F.logsigmoid(gates[:, H:] + p["b_f"].float())

    m_new = torch.maximum(log_f + cache.m, log_i)  # [B,H]
    fdec = torch.exp(log_f + cache.m - m_new)
    iinc = torch.exp(log_i - m_new)
    C = fdec[..., None, None] * cache.C + iinc[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = fdec[..., None] * cache.n + iinc[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", C, q)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, q)), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, 1, di).to(x.dtype)
    h = rms_norm(h, p["out_norm"], cfg.norm_eps) * F.silu(z)
    out = ctx.psum_tp(h @ p["w_down"])
    cache.C.copy_(C)
    cache.n.copy_(n)
    cache.m.copy_(m_new)
    cache.conv.copy_(hist[:, 1:])
    return out, cache


# ======================================================================= sLSTM
def _s_dims(cfg: ArchConfig):
    d, H = cfg.d_model, cfg.n_heads
    return d, H, d // H, int(d * cfg.xlstm.s_proj_factor)


def init_slstm_params(gen: torch.Generator, cfg: ArchConfig, dtype, n: int) -> dict:
    """sLSTM weights (and its FFN's) of ``n`` stacked layer instances."""
    d, H, dh, f_ff = _s_dims(cfg)
    dev = gen.device
    return {
        "w_gates": dense_init(gen, (n, d, 4 * d), dtype),
        "r_gates": dense_init(gen, (n, H, dh, 4 * dh), dtype, scale=dh ** -0.5),
        "b_gates": torch.zeros((n, 4 * d), dtype=dtype, device=dev),
        "out_norm": torch.zeros((n, d), dtype=dtype, device=dev),
        "w_up_ff": dense_init(gen, (n, d, f_ff), dtype),
        "w_down_ff": dense_init(gen, (n, f_ff, d), dtype,
                                scale=0.02 / max(1, cfg.n_layers) ** 0.5),
    }


class SLSTMCache(NamedTuple):
    c: torch.Tensor  # [B,H,dh] fp32
    n: torch.Tensor
    m: torch.Tensor
    h: torch.Tensor  # [B,H,dh] in the activations' dtype


def init_slstm_cache(n: int, batch: int, cfg: ArchConfig, dtype, device) -> SLSTMCache:
    """Empty caches of ``n`` layer instances, stacked on axis 0."""
    _, H, dh, _ = _s_dims(cfg)
    shape = (n, batch, H, dh)
    return SLSTMCache(
        c=torch.zeros(shape, dtype=torch.float32, device=device),
        n=torch.zeros(shape, dtype=torch.float32, device=device),
        m=torch.full(shape, -1e30, dtype=torch.float32, device=device),
        h=torch.zeros(shape, dtype=dtype, device=device),
    )


def _slstm_cell(r_gates: torch.Tensor, xg: torch.Tensor, state: SLSTMCache,
                one: torch.Tensor):
    """One step: the recurrent matrix [H,dh,4dh] and the step's input
    contribution [B,H,4dh], both fp32 -> (the next state, h [B,H,dh] in
    fp32).  ``one`` is a float32 1 on the device (n's floor)."""
    dh = state.h.shape[2]
    # xg + h_{t-1} R per head, as one batched product over the heads
    g = torch.baddbmm(xg.transpose(0, 1), state.h.float().transpose(0, 1),
                      r_gates).transpose(0, 1)  # [B,H,4dh]
    zt, it, ft, ot = torch.split(g, dh, dim=-1)
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + state.m, it)
    fdec = torch.exp(log_f + state.m - m_new)
    iinc = torch.exp(it - m_new)
    c = fdec * state.c + iinc * torch.tanh(zt)
    # maximum, not clamp: an exact tie (the first step's n) splits its
    # gradient in half, as jnp.maximum's does
    n = torch.maximum(fdec * state.n + iinc, one)
    h = torch.sigmoid(ot) * c / n
    return SLSTMCache(c=c, n=n, m=m_new, h=h.to(state.h.dtype)), h


def _slstm_ffn(p: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = rms_norm(h, p["out_norm"], cfg.norm_eps)
    return F.gelu(h @ p["w_up_ff"], approximate="tanh") @ p["w_down_ff"]


def slstm_forward(p: dict, x: torch.Tensor, *, cfg: ArchConfig, ctx: ParallelCtx = LOCAL_CTX,
                  return_state: bool = False):
    """The sLSTM stepped over the sequence, then its FFN.  x [B,S,d] ->
    [B,S,d] (+ the final SLSTMCache when ``return_state``)."""
    B, S, d = x.shape
    H = cfg.n_heads
    # the casts are made once, outside the loop: the recurrent matrix's
    # gradient then sums over the steps in fp32 and is cast back once
    xg = (x @ p["w_gates"] + p["b_gates"]).float().reshape(B, S, H, 4 * d // H)
    r_gates = p["r_gates"].float()
    one = torch.ones((), dtype=torch.float32, device=x.device)
    state = SLSTMCache(*(a[0] for a in init_slstm_cache(1, B, cfg, x.dtype, x.device)))
    hs = []
    for t in range(S):
        state, h = _slstm_cell(r_gates, xg[:, t], state, one)
        hs.append(h)
    ff = _slstm_ffn(p, torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype), cfg)
    if return_state:
        return ff, state
    return ff


def slstm_decode(p: dict, x: torch.Tensor, cache: SLSTMCache, *, cfg: ArchConfig,
                 ctx: ParallelCtx = LOCAL_CTX):
    """x [B,1,d] -> ([B,1,d], cache), the cache updated in place."""
    B, _, d = x.shape
    xg = (x[:, 0] @ p["w_gates"] + p["b_gates"]).float().reshape(B, cfg.n_heads, -1)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    st, h = _slstm_cell(p["r_gates"].float(), xg, cache, one)
    ff = _slstm_ffn(p, h.reshape(B, 1, d).to(x.dtype), cfg)
    for old, new in zip(cache, st):
        old.copy_(new)
    return ff, cache
