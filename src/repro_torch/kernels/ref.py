"""Plain PyTorch versions of the kernels (``repro.kernels.ref`` in torch).

They are what the CPU runs, what the tests hold against the JAX oracles, and
what ``chip_smoke.py`` holds each CUDA kernel against on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def flash_attention_ref(
    q: torch.Tensor,   # [B, S, Hq, hd]
    k: torch.Tensor,   # [B, S, Hkv, hd]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Full-sequence GQA attention at the Pallas kernel's arithmetic: q
    scaled by hd^-0.5 in fp32, fp32 scores and softmax, masked scores at
    -1e30, output cast to q's dtype; positions are ``arange(S)``.  Autograd
    through it is the plain backward."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    pos = torch.arange(S, device=q.device)
    qg = (q.float() * hd**-0.5).reshape(B, S, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if causal:
        allow = pos[None, :] <= pos[:, None]
        if window:
            allow &= pos[None, :] > (pos[:, None] - window)
        s = torch.where(allow, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, S, Hq, hd).to(q.dtype)


def swiglu_ref(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """x [T, d] @ {w_gate, w_up} [d, f] -> silu(x wg) * (x wu), in fp32,
    cast to x's dtype."""
    xf = x.float()
    g = xf @ w_gate.float()
    u = xf @ w_up.float()
    return (F.silu(g) * u).to(x.dtype)


def swiglu_bwd_ref(x, w_gate, w_up, dout):
    """The swiglu backward kernel's function: g and u recomputed in fp32,
    then dg = dout * u * silu'(g) and du = dout * silu(g) in x's dtype (the
    chain rule's three matrix products follow it in ``kernels.swiglu``)."""
    xf = x.float()
    g, u = xf @ w_gate.float(), xf @ w_up.float()
    sig = torch.sigmoid(g)
    dy = dout.float()
    return (dy * u * sig * (1 + g * (1 - sig))).to(x.dtype), (dy * g * sig).to(x.dtype)


def decode_attention_ref(
    q: torch.Tensor,        # [B, Hq, hd] one new token per sequence
    k_cache: torch.Tensor,  # [B, Hkv, C, hd]
    v_cache: torch.Tensor,
    length,                 # [] or [B] (int or tensor): number of valid slots
) -> torch.Tensor:
    B, Hq, hd = q.shape
    Hkv, C = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    length = torch.as_tensor(length, device=q.device).reshape(-1).expand(B)
    qg = (q.float() * hd**-0.5).reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bhcd->bhgc", qg, k_cache.float())
    valid = torch.arange(C, device=q.device)[None, :] < length[:, None]  # [B, C]
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgc,bhcd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, hd).to(q.dtype)


def flat_update_ref_(opt, grad: torch.Tensor, state: dict, param, rows, *, step: int,
                     replicas: int = 1) -> None:
    """The optimizer step over a stage's flat state, in place: the plain
    version of ``kernels.adamw`` (``opt`` an ``AdamW``), and the update of
    any other optimizer.  For each leaf of ``rows`` ((gradient offset, state
    offset, count)), its slice of ``grad`` divided by ``replicas`` (as the
    engine divided the reduced gradient), then ``opt.update`` on views of
    the flat buffers of ``state`` (``master`` and the optimizer's own),
    whose new tensors are copied back into the views, the new masters also
    into ``param`` (cast to its dtype; None where the parameters are the
    fp32 masters)."""
    for g_off, s_off, n in rows:
        g = grad[g_off:g_off + n]
        if replicas > 1:
            g = g / replicas
        views = {k: buf[s_off:s_off + n] for k, buf in state.items()}
        master = views.pop("master")
        new_master, new = opt.update(g, master, views, step)
        for k, t in new.items():
            views[k].copy_(t)
        master.copy_(new_master)
        if param is not None:
            param[s_off:s_off + n].copy_(new_master)
