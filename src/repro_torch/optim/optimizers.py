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

    def bias_corrections(self, step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``1 - b1 ** t`` and ``1 - b2 ** t`` at t = step + 1, computed in
        fp32 as the JAX package does: 0-dim CPU tensors, so dividing a
        tensor on the card by one copies nothing to it."""
        t = torch.tensor(float(step), dtype=torch.float32) + 1.0
        return 1 - self.b1 ** t, 1 - self.b2 ** t

    def update(self, g, master, state, step):
        g = g.float()
        bc1, bc2 = self.bias_corrections(step)
        m = self.b1 * state["m"] + (1 - self.b1) * g
        v = self.b2 * state["v"] + (1 - self.b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        upd = mhat / (torch.sqrt(vhat) + self.eps) + self.weight_decay * master
        return master - self.lr * upd, {"m": m, "v": v}
