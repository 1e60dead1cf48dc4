"""SwiGLU feed-forward (``repro.models.mlp`` in torch): column-parallel gate
and up, row-parallel down (``ctx.psum_tp``).  ``use_kernels=True`` fuses the
gate and up products through ``kernels.ops.swiglu`` (the CUDA kernel on a
card, its plain version on the CPU)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import LOCAL_CTX, ParallelCtx, dense_init


def init_mlp_params(gen: torch.Generator, cfg: ArchConfig, dtype, n: int) -> dict:
    """FFN weights of ``n`` stacked layer instances."""
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(gen, (n, d, f), dtype),
        "w_up": dense_init(gen, (n, d, f), dtype),
        "w_down": dense_init(gen, (n, f, d), dtype,
                             scale=0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def mlp_forward(p: dict, x: torch.Tensor, *, ctx: ParallelCtx = LOCAL_CTX,
                use_kernels: bool = False) -> torch.Tensor:
    if use_kernels:
        from repro_torch.kernels import ops as kops

        h = kops.swiglu(x, p["w_gate"], p["w_up"])
    else:
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return ctx.psum_tp(h @ p["w_down"])
