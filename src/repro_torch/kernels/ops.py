"""Kernel dispatch (``repro.kernels.ops`` in torch).

A tensor on the CPU goes to the plain PyTorch version; a CUDA tensor goes to
the hand-written kernel, which launches or raises (there is no fallback).
``impl="ref"`` forces the plain version on any device, for comparisons.
"""
from __future__ import annotations

from repro_torch.kernels import adamw as _aw
from repro_torch.kernels import build as _build
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import swiglu as _sg

IMPLS = ("auto", "ref")


def _plain(impl: str, t) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    return impl == "ref" or t.device.type == "cpu"


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    impl: str = "auto"):
    """q [B,S,Hq,hd], k/v [B,S,Hkv,hd] -> [B,S,Hq,hd], differentiable.  The
    kernel takes no positions and assumes ``arange(S)``, as the Pallas path
    does; so does the plain version."""
    if _plain(impl, q):
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def swiglu(x, w_gate, w_up, *, impl: str = "auto"):
    """silu(x @ w_gate) * (x @ w_up) over the last axis of x, differentiable.
    The kernel takes any number of rows."""
    orig = x.shape
    x2 = x.reshape(-1, orig[-1])
    if _plain(impl, x):
        out = _ref.swiglu_ref(x2, w_gate, w_up)
    else:
        out = _sg.swiglu(x2, w_gate, w_up)
    return out.reshape(*orig[:-1], w_gate.shape[1])


def decode_attention(q, k_cache, v_cache, length, *, impl: str = "auto"):
    if _plain(impl, q):
        return _ref.decode_attention_ref(q, k_cache, v_cache, length)
    return _da.decode_attention(q, k_cache, v_cache, length)


def adamw_(opt, grad, state, param, table, *, step: int, replicas: int = 1,
           impl: str = "auto") -> None:
    """One ``AdamW`` step (``opt``) of a stage's leaves, in place: ``grad``
    the flat fp32 gradient summed over ``replicas``, ``state`` the flat fp32
    ``master``, ``m`` and ``v``, ``param`` the flat parameters written from
    the new masters (None where they are the fp32 masters), ``table`` a
    ``kernels.adamw.LeafTable``.  The kernel and the plain version give the
    same bits; the plain version (``impl="ref"``) steps any optimizer, its
    ``state`` the master and the optimizer's own buffers."""
    if _plain(impl, grad):
        _ref.flat_update_ref_(opt, grad, state, param, table.rows, step=step,
                              replicas=replicas)
    else:
        _aw.adamw_(opt, grad, state, param, table, step=step, replicas=replicas)


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts`, backward
    launches apart; flash attention's and swiglu's also by route
    (``flash_attention_wgmma``, ``swiglu_bwd_simt``, ...)."""
    with _build.COUNT_LOCK:
        counts = {"decode_attention": _da.LAUNCHES, "adamw": _aw.LAUNCHES}
        for name, mod in (("flash_attention", _fa), ("swiglu", _sg)):
            counts[name] = sum(mod.LAUNCHES.values())
            counts[f"{name}_bwd"] = sum(mod.BWD_LAUNCHES.values())
            for way in mod.ROUTES:
                counts[f"{name}_{way}"] = mod.LAUNCHES[way]
                counts[f"{name}_bwd_{way}"] = mod.BWD_LAUNCHES[way]
    return counts


def reset_launch_counts() -> None:
    with _build.COUNT_LOCK:
        _da.LAUNCHES = 0
        _aw.LAUNCHES = 0
        for mod in (_fa, _sg):
            mod.LAUNCHES = dict.fromkeys(mod.ROUTES, 0)
            mod.BWD_LAUNCHES = dict.fromkeys(mod.ROUTES, 0)


def decode_attention_capable(*, n_q_heads: int, n_kv_heads: int,
                             capacity: int, window: int = 0,
                             seq_shards: int = 1) -> bool:
    """Shape-capability probe for the flash-decode kernel: the plain
    append-cache layout only — no rolling-window ring validity, no
    sequence-sharded partial softmax — and whole-group query heads.  Unlike
    the Pallas kernel's grid, the split-K kernel takes any capacity: its
    last chunk may be short (jamba serves 1024 + 16 slots).  Callers take
    the plain path when this returns False, so ``use_kernels`` is safe to
    pass for any layer."""
    if window or seq_shards > 1:
        return False
    return n_kv_heads > 0 and n_q_heads % n_kv_heads == 0 and capacity > 0
