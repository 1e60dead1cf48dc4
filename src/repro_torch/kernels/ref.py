"""Plain PyTorch versions of the kernels (``repro.kernels.ref`` in torch).

They are what the CPU runs, what the tests hold against the JAX oracles, and
what ``chip_smoke.py`` holds each CUDA kernel against on the card.
"""
from __future__ import annotations

import torch


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
