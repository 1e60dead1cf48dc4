"""CUDA flash-decode for Hopper, split-K: bind and launch.

The kernels (``csrc/decode_attention.cu``) replace the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention``.  ``kernels.build``
compiles them for ``sm_90a`` on first use and binds them with ``ctypes``.
A call is two launches: a split pass, whose blocks each take a chunk of the
cache and write a partial softmax to a workspace, and a merge pass.  The
chunk is chosen here from the cache's capacity alone (:func:`split_chunk`):
never from ``length``, which stays on the device, nor from the batch or the
card, so a sequence's output bits do not depend on what shares its batch.
The query heads a block takes are the CUDA source's rule
(``repro_decode_attention_heads``).

``LAUNCHES`` counts calls that launched the kernels (one per call, and
nothing else), so a run can show that its decode path went through them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build

HEAD_DIMS = (64, 96, 128, 256)
#: cache slots a split-pass block takes: at the serving shape (B 4, 32 kv
#: heads, C 1024) 8 chunks, 1024 blocks, ~8 an SM of an H100
SPLIT_SLOTS = 128

#: number of calls since the last reset (see ``kernels.ops``)
LAUNCHES = 0


def build():
    """Compile (if needed) and load the kernel library; idempotent."""
    P, I, F = _build.P, _build.I, _build.F
    return _build.load("decode_attention", {
        "repro_decode_attention": [P] * 6 + [I] * 7 + [F, P],
        "repro_decode_attention_heads": [I] * 3})


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def split_chunk(C: int) -> int:
    """Cache slots a split-pass block takes, from the capacity C alone."""
    return min(SPLIT_SLOTS, C)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: q [B, Hq, hd], k/v cache [B, Hkv, C, hd] on one
    CUDA device, ``length`` one int32 on that device (slots ``>= length``
    are masked; the decode path always has ``length >= 1``).  Returns
    [B, Hq, hd] in q's dtype."""
    global LAUNCHES
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"expected q [B,Hq,hd] and k/v [B,Hkv,C,hd], got {tuple(q.shape)}, "
            f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, Hq, hd = q.shape
    Bk, Hkv, C, hdk = k_cache.shape
    if Bk != B or hdk != hd or Hkv <= 0 or Hq % Hkv:
        raise ValueError(
            f"q {tuple(q.shape)} does not match cache {tuple(k_cache.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(
            f"dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}: expected one "
            "of float32, bfloat16 for all three")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("q, k_cache and v_cache must be 16-byte aligned (16-byte loads)")
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k_cache, v_cache, length)):
        raise ValueError("q, k_cache, v_cache and length must be on one CUDA device")
    if length.dtype != torch.int32 or length.numel() != 1:
        raise ValueError(f"length must be one int32, got {length.dtype} "
                         f"with {length.numel()} elements")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous() and length.is_contiguous()):
        raise ValueError("q, k_cache, v_cache and length must be contiguous")
    lib = build()
    chunk = split_chunk(C)
    splits = -(-C // chunk)
    out = torch.empty_like(q)
    ws = torch.empty(B * Hq * splits * (2 + hd), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            length.data_ptr(), out.data_ptr(), ws.data_ptr(), B, Hkv, Hq // Hkv, C, hd,
            _DTYPES[q.dtype], chunk, hd ** -0.5, _build.stream_of(q))
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    with _build.COUNT_LOCK:
        LAUNCHES += 1
    return out
