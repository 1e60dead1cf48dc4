"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch
(``repro.models.moe`` in torch).

The JAX function scatters the routed tokens into an [E, C, d] buffer with a
float scatter-add into unique slots (plus one overflow row for the dropped
ones) and gathers them back.  The port computes the same slots from integer
counts and moves rows with gathers alone, forward and backward
(:class:`_RowGather`): a row of one buffer lands in at most one row of the
other, so each direction is the other's gather, with no atomics and the
same bits on every run.  The router adds the load-balance aux loss and the
z-loss, as in JAX.

Routing picks the top ``k`` experts with a stable descending sort, so equal
probabilities take the lower expert index first, as ``jax.lax.top_k``
does (``torch.topk`` promises no order on ties).  On the mesh the expert
buffer crosses the ``data`` axis by ``ctx.ep_all_to_all`` before the
experts and back after them (expert parallelism), and ``ctx.psum_tp`` sums
the tensor-parallel d_ff slices of the experts' outputs, as in JAX.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoECfg
from repro_torch.models.common import LOCAL_CTX, ParallelCtx, dense_init


def init_moe_params(gen: torch.Generator, cfg: ArchConfig, dtype, n: int) -> dict:
    """Router and expert weights of ``n`` stacked layer instances."""
    mc = cfg.moe
    d, f, e = cfg.d_model, mc.d_ff_expert, mc.n_experts
    return {
        "router": dense_init(gen, (n, d, e), dtype),
        "w_gate": dense_init(gen, (n, e, d, f), dtype),
        "w_up": dense_init(gen, (n, e, d, f), dtype),
        "w_down": dense_init(gen, (n, e, f, d), dtype,
                             scale=0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def capacity(n_tokens: int, mc: MoECfg) -> int:
    c = int(n_tokens * mc.top_k * mc.capacity_factor / mc.n_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``cat([x, zero row])[idx]``: index ``len(x)`` reads a zero row."""
    pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return pad.index_select(0, idx)


class _RowGather(torch.autograd.Function):
    """``out[i] = x[fwd[i]]`` (``fwd[i] == len(x)``: a zero row), where the
    rows of ``out`` that read one row of ``x`` are the ``fold`` entries
    ``bwd[j * fold : (j + 1) * fold]`` (``len(out)`` where fewer), so the
    gradient is a gather and a sum over ``fold`` too, with no scatter."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, fold):
        ctx.save_for_backward(bwd)
        ctx.fold = fold
        return _gather_rows(x, fwd)

    @staticmethod
    def backward(ctx, g):
        (bwd,) = ctx.saved_tensors
        rows = _gather_rows(g, bwd)
        if ctx.fold > 1:
            rows = rows.reshape(-1, ctx.fold, g.shape[1]).sum(1)
        return rows, None, None, None


def route(p: dict, tokens: torch.Tensor, mc: MoECfg):
    """tokens [T, d] -> (gates [T, k] fp32, sel [T, k] int64, aux fp32): the
    router's softmax, its top ``k`` (ties to the lower index), gates
    renormalised over the k, and the load-balance + z aux loss."""
    E, k = mc.n_experts, mc.top_k
    logits = (tokens @ p["router"]).float()                     # [T, E]
    probs = torch.softmax(logits, dim=-1)
    sel = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    onehot = F.one_hot(sel, E).float()                          # [T, k, E]
    gates = (probs[:, None, :] * onehot).sum(-1)                # exact: one term
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    frac_routed = onehot.sum(1).mean(0)
    mean_prob = probs.mean(0)
    lb_loss = E * torch.sum(frac_routed * mean_prob)
    z_loss = 1e-3 * torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return gates, sel, mc.router_aux_weight * lb_loss + z_loss


def slots(sel: torch.Tensor, E: int, C: int):
    """Token-major slots within each expert, from integer counts.
    Returns (dispatch [T*k]: the buffer row ``e * C + slot`` of each routed
    (token, choice), ``E * C`` when the expert is full; source [E*C]: the
    flat (token, choice) each buffer row holds, ``T * k`` when empty)."""
    flat = sel.reshape(-1)                                      # [T*k]
    n = flat.numel()
    onehot = F.one_hot(flat, E)                                 # int64 [T*k, E]
    before = (torch.cumsum(onehot, 0) - onehot).gather(1, flat[:, None])[:, 0]
    keep = before < C
    dispatch = torch.where(keep, flat * C + before, torch.full_like(flat, E * C))
    # the kept entries of expert e are its first C in flat order: the stable
    # sort by expert lists them from each expert's start
    order = torch.sort(flat, stable=True).indices
    counts = onehot.sum(0)
    starts = torch.cumsum(counts, 0) - counts
    c = torch.arange(C, device=sel.device)
    at = torch.clamp(starts[:, None] + c[None, :], max=n - 1)
    source = torch.where(c[None, :] < counts[:, None], order[at], torch.full_like(at, n))
    return dispatch, keep, source.reshape(-1)


def experts(p: dict, expert_in: torch.Tensor) -> torch.Tensor:
    """The expert FFNs, batched over experts: [E, C, d] -> [E, C, d]."""
    h = F.silu(torch.bmm(expert_in, p["w_gate"])) * torch.bmm(expert_in, p["w_up"])
    return torch.bmm(h, p["w_down"])


def dispatch(tokens: torch.Tensor, k: int, dispatch_idx, source, E: int, C: int):
    """[T, d] -> the expert buffer [E, C, d]; row (e, c) holds the token of
    flat entry ``source[e*C + c]`` (token ``source // k``), zeros when empty.
    A token's gradient is the sum of its k rows', as through JAX's
    ``repeat``."""
    d = tokens.shape[1]
    return _RowGather.apply(tokens, source // k, dispatch_idx, k).reshape(E, C, d)


def combine(expert_out: torch.Tensor, gates, keep, dispatch_idx, source, T: int, k: int):
    """The gated sum over each token's k experts; a dropped choice adds 0."""
    d = expert_out.shape[-1]
    gathered = _RowGather.apply(expert_out.reshape(-1, d), dispatch_idx, source, 1)
    weights = (gates.reshape(T * k) * keep).to(gathered.dtype)
    return torch.sum((gathered * weights[:, None]).reshape(T, k, d), dim=1)


def moe_forward(p: dict, x: torch.Tensor, *, cfg: ArchConfig,
                ctx: ParallelCtx = LOCAL_CTX) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (out [B, S, d], aux_loss fp32 scalar)."""
    mc = cfg.moe
    B, S, d = x.shape
    T, k, E = B * S, mc.top_k, mc.n_experts
    C = capacity(T, mc)
    tokens = x.reshape(T, d)
    gates, sel, aux = route(p, tokens, mc)
    dispatch_idx, keep, source = slots(sel, E, C)
    expert_in = dispatch(tokens, k, dispatch_idx, source, E, C)
    # expert parallelism: [E, C, d] -> [E_local, C * ep, d] and back
    if ctx.ep_all_to_all is not None:
        expert_in = ctx.ep_all_to_all(expert_in)
    expert_out = ctx.psum_tp(experts(p, expert_in))  # row-parallel d_ff slices
    if ctx.ep_all_to_all_back is not None:
        expert_out = ctx.ep_all_to_all_back(expert_out)
    out = combine(expert_out, gates, keep, dispatch_idx, source, T, k)
    return out.reshape(B, S, d), aux
