"""Selective state-space (Mamba) mixer (``repro.models.mamba`` in torch).

Training and prefill run the JAX package's *chunked* selective scan: chunks
of ``CHUNK`` steps, each carrying the state ``h`` [B, d_inner, d_state] from
the last.  Inside a chunk JAX runs ``jax.lax.associative_scan``; the port
steps the recurrence ``h_t = abar_t * h_{t-1} + bx_t`` one position at a
time (the same sums, in the recurrence's own order rather than the
associative scan's tree) and reads ``y_t = h_t . C_t`` at each step, so the
[B, CHUNK, d_inner, d_state] states are never kept.  Under autograd each
chunk runs in ``torch.utils.checkpoint``, as JAX's chunk body runs in
``jax.checkpoint``: only a chunk's inputs are saved, and its steps are
recomputed in the backward.  The scan is plain PyTorch, as it is plain JAX
in the reference (no Pallas kernel).

Under tensor parallelism the d_inner axis is sliced; the (delta, B, C)
projection ``w_xproj`` and the output projection ``w_out`` are row-parallel
(``ctx.psum_tp``).

Decode is the one-token recurrence.  As :func:`attention.attn_decode` does,
:func:`mamba_decode` writes the new conv window and state into the cache it
is given and returns that cache (the JAX function returns a new one).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import LOCAL_CTX, ParallelCtx, dense_init

CHUNK = 256


def dt_rank(cfg: ArchConfig) -> int:
    return -(-cfg.d_model // 16)


def init_mamba_params(gen: torch.Generator, cfg: ArchConfig, dtype, n: int) -> dict:
    """Mamba weights of ``n`` stacked layer instances."""
    mc = cfg.mamba
    d = cfg.d_model
    di = mc.d_inner(d)
    r = dt_rank(cfg)
    N = mc.d_state
    dev = gen.device
    # S4D-real initialization of A
    a_init = torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(n, di, 1)
    return {
        "w_in_x": dense_init(gen, (n, d, di), dtype),
        "w_in_z": dense_init(gen, (n, d, di), dtype),
        "conv_w": dense_init(gen, (n, mc.d_conv, di), dtype, scale=0.1),
        "conv_b": torch.zeros((n, di), dtype=dtype, device=dev),
        "w_xproj": dense_init(gen, (n, di, r + 2 * N), dtype),
        "w_dt": dense_init(gen, (n, r, di), dtype, scale=r ** -0.5),
        "b_dt": torch.full((n, di), -4.6, dtype=dtype, device=dev),  # softplus^-1(0.01)
        "A_log": torch.log(a_init).to(dtype),
        "D": torch.ones((n, di), dtype=dtype, device=dev),
        "w_out": dense_init(gen, (n, di, d), dtype, scale=0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def _ssm_inputs(p: dict, xc: torch.Tensor, cfg: ArchConfig, ctx: ParallelCtx):
    """xc [B,S,di_local] -> delta [B,S,di_local], Bc/Cc [B,S,N]."""
    r, N = dt_rank(cfg), cfg.mamba.d_state
    dbc = ctx.psum_tp(xc @ p["w_xproj"])  # row-parallel partial sums
    d_raw, b_c, c_c = torch.split(dbc, [r, N, N], dim=-1)
    delta = F.softplus(d_raw @ p["w_dt"] + p["b_dt"])
    return delta, b_c, c_c


def _conv1d(xc: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over seq.  xc [B,S,di]; conv_w [k, di]."""
    k, S = conv_w.shape[0], xc.shape[1]
    pad = F.pad(xc, (0, 0, k - 1, 0))
    return sum(pad[:, i:i + S, :] * conv_w[i] for i in range(k)) + conv_b


def _chunk(h0, xq, dq, bq, cq, A, D):
    """One chunk of the scan (fp32): -> (h at its last step, y [B,q,di])."""
    abar = torch.exp(dq[..., None] * A)                      # [B,q,di,N]
    bx = (dq * xq)[..., None] * bq[:, :, None, :]            # [B,q,di,N]
    h, ys = h0, []
    for t in range(xq.shape[1]):
        h = abar[:, t] * h + bx[:, t]
        ys.append((h * cq[:, t, None, :]).sum(-1))
    return h, torch.stack(ys, dim=1) + D * xq


def selective_scan(xc, delta, b_c, c_c, A, D):
    """The chunked scan over S steps from a zero state: (y [B,S,di] fp32,
    the last state [B,di,N] fp32)."""
    B, S, di = xc.shape
    q = min(CHUNK, S)
    if S % q:
        raise ValueError(f"seq {S} not a multiple of chunk {q}")
    h = torch.zeros((B, di, A.shape[-1]), dtype=torch.float32, device=xc.device)
    xs = [t.float() for t in (xc, delta, b_c, c_c)]
    ys = []
    for i in range(S // q):
        chunk = [t[:, i * q:(i + 1) * q] for t in xs]
        if torch.is_grad_enabled():
            h, y = checkpoint(_chunk, h, *chunk, A, D, use_reentrant=False)
        else:
            h, y = _chunk(h, *chunk, A, D)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def mamba_forward(p: dict, x: torch.Tensor, *, cfg: ArchConfig, ctx: ParallelCtx = LOCAL_CTX,
                  return_state: bool = False):
    """x [B,S,d] -> [B,S,d] (+ MambaCache when ``return_state``, for
    prefill).  S must be a multiple of CHUNK or < CHUNK."""
    S = x.shape[1]
    xr = x @ p["w_in_x"]  # raw pre-conv activations (tail feeds the decode conv state)
    z = x @ p["w_in_z"]
    xc = F.silu(_conv1d(xr, p["conv_w"], p["conv_b"]))
    delta, b_c, c_c = _ssm_inputs(p, xc, cfg, ctx)
    A = -torch.exp(p["A_log"].float())  # [di, N]
    y, h_last = selective_scan(xc, delta, b_c, c_c, A, p["D"].float())
    out = ctx.psum_tp((y.to(x.dtype) * F.silu(z)) @ p["w_out"])
    if return_state:
        kc = cfg.mamba.d_conv - 1
        return out, MambaCache(conv=xr[:, S - kc:, :].contiguous(), h=h_last)
    return out


# ----------------------------------------------------------------------- decode
class MambaCache(NamedTuple):
    conv: torch.Tensor  # [B, d_conv-1, di] trailing inputs
    h: torch.Tensor     # [B, di, N] fp32 state


def init_mamba_cache(n: int, batch: int, cfg: ArchConfig, dtype, device,
                     di: Optional[int] = None) -> MambaCache:
    """Empty caches of ``n`` layer instances, stacked on axis 0; ``di`` is a
    tensor-parallel rank's slice of d_inner (all of it by default)."""
    mc = cfg.mamba
    di = mc.d_inner(cfg.d_model) if di is None else di
    return MambaCache(
        conv=torch.zeros((n, batch, mc.d_conv - 1, di), dtype=dtype, device=device),
        h=torch.zeros((n, batch, di, mc.d_state), dtype=torch.float32, device=device),
    )


def mamba_decode(p: dict, x: torch.Tensor, cache: MambaCache, *, cfg: ArchConfig,
                 ctx: ParallelCtx = LOCAL_CTX):
    """x [B,1,d] -> ([B,1,d], cache), the cache updated in place."""
    xc = x @ p["w_in_x"]  # [B,1,di]
    z = x @ p["w_in_z"]
    hist = torch.cat([cache.conv, xc], dim=1)  # [B, k, di]
    conv_out = torch.einsum("bkd,kd->bd", hist, p["conv_w"]) + p["conv_b"]
    xc1 = F.silu(conv_out)[:, None, :]  # [B,1,di]
    delta, b_c, c_c = _ssm_inputs(p, xc1, cfg, ctx)
    A = -torch.exp(p["A_log"].float())
    abar = torch.exp(delta[:, 0, :, None].float() * A)  # [B,di,N]
    bx = (delta[:, 0] * xc1[:, 0]).float()[..., None] * b_c[:, 0, None, :].float()
    h = abar * cache.h + bx
    y = (h * c_c[:, 0, None, :].float()).sum(-1)
    y = y + p["D"].float() * xc1[:, 0].float()
    out = ctx.psum_tp((y[:, None, :].to(x.dtype) * F.silu(z)) @ p["w_out"])
    cache.conv.copy_(hist[:, 1:])
    cache.h.copy_(h)
    return out, cache
