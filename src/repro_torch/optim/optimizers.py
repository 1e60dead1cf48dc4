"""Optimizers (``repro.optim.optimizers`` in torch): per leaf, in fp32, on
the master weights the stage workers keep.  Each update is functional (new
tensors), as the JAX package's is."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


class Optimizer:
    def init_state(self, master: torch.Tensor) -> dict:  # pragma: no cover
        raise NotImplementedError

    def update(self, g: torch.Tensor, master: torch.Tensor, state: dict,
               step: int) -> Tuple[torch.Tensor, dict]:  # pragma: no cover
        raise NotImplementedError


@dataclass(frozen=True)
class SGD(Optimizer):
    lr: float = 0.01
    momentum: float = 0.9

    def init_state(self, master):
        return {"mu": torch.zeros_like(master)}

    def update(self, g, master, state, step):
        g = g.float()
        mu = self.momentum * state["mu"] + g
        return master - self.lr * mu, {"mu": mu}


@dataclass(frozen=True)
class AdamW(Optimizer):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init_state(self, master):
        return {"m": torch.zeros_like(master), "v": torch.zeros_like(master)}

    def update(self, g, master, state, step):
        g = g.float()
        # bias correction at step + 1, computed in fp32 as the JAX package does
        t = torch.tensor(float(step), dtype=torch.float32) + 1.0
        m = self.b1 * state["m"] + (1 - self.b1) * g
        v = self.b2 * state["v"] + (1 - self.b2) * torch.square(g)
        mhat = m / (1 - self.b1 ** t)     # a 0-dim CPU tensor: no copy to the card
        vhat = v / (1 - self.b2 ** t)
        upd = mhat / (torch.sqrt(vhat) + self.eps) + self.weight_decay * master
        return master - self.lr * upd, {"m": m, "v": v}
