"""CUDA flash-decode for Hopper: bind and launch.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention``.  ``kernels.build``
compiles it for ``sm_90a`` on first use and binds it with ``ctypes``.

``LAUNCHES`` counts the kernel's launches (and nothing else), so a run can
show that its decode path went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build

HEAD_DIMS = (64, 96, 128, 256)

#: number of kernel launches since the last reset (see ``kernels.ops``)
LAUNCHES = 0


def build():
    """Compile (if needed) and load the kernel library; idempotent."""
    return _build.load("decode_attention", {
        "repro_decode_attention": [_build.P] * 5 + [_build.I] * 6 + [_build.F, _build.P]})


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            length.data_ptr(), out.data_ptr(), B, Hkv, Hq // Hkv, C, hd,
            _DTYPES[q.dtype], hd ** -0.5, _build.stream_of(q))
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
