"""SwiGLU feed-forward (``repro.models.mlp`` in torch), plain path only: the
serving path never fuses it.  The fused ``swiglu`` kernel comes with the
training slice (ROADMAP port queue item 1)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import dense_init


def init_mlp_params(gen: torch.Generator, cfg: ArchConfig, dtype, n: int) -> dict:
    """FFN weights of ``n`` stacked layer instances."""
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(gen, (n, d, f), dtype),
        "w_up": dense_init(gen, (n, d, f), dtype),
        "w_down": dense_init(gen, (n, f, d), dtype,
                             scale=0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def mlp_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
