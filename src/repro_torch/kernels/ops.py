"""Kernel dispatch (``repro.kernels.ops`` in torch).

A tensor on the CPU goes to the plain PyTorch version; a CUDA tensor goes to
the hand-written kernel, which launches or raises (there is no fallback).
``impl="ref"`` forces the plain version on any device, for comparisons.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import ref as _ref

IMPLS = ("auto", "ref")


def decode_attention(q, k_cache, v_cache, length, *, impl: str = "auto"):
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "ref" or q.device.type == "cpu":
        return _ref.decode_attention_ref(q, k_cache, v_cache, length)
    return _da.decode_attention(q, k_cache, v_cache, length)


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {"decode_attention": _da.LAUNCHES}


def reset_launch_counts() -> None:
    _da.LAUNCHES = 0


def decode_attention_capable(*, n_q_heads: int, n_kv_heads: int,
                             capacity: int, window: int = 0,
                             seq_shards: int = 1) -> bool:
    """Shape-capability probe for the flash-decode kernel: the Pallas path
    covers the plain append-cache layout only — no rolling-window ring
    validity, no sequence-sharded partial softmax — and needs whole-group
    query heads plus a cache capacity the grid can tile (C % c_block == 0
    with c_block = min(512, C)).  Callers fall back to the jnp path when
    this returns False, so ``use_pallas`` is safe to pass for any layer."""
    if window or seq_shards > 1:
        return False
    if n_kv_heads <= 0 or n_q_heads % n_kv_heads:
        return False
    return capacity <= 512 or capacity % 512 == 0
