"""Layer profiles and stage boundaries (the parts of
``repro.core.partition`` that serving needs, copied exactly).

A *partition* is the boundary vector x ∈ {0,1}^(L-1): x[i] == 1 iff the
model is cut between profile layer i and i+1.  Stages are the contiguous
runs.  Layer merging and measured (calibrated) profiles are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


def stages_of(x: Sequence[int]) -> List[Tuple[int, int]]:
    """[(lo, hi)] inclusive layer ranges of each stage."""
    lo = 0
    out = []
    for i, xi in enumerate(x):
        if xi:
            out.append((lo, i))
            lo = i + 1
    out.append((lo, len(x)))
    return out


@dataclass(frozen=True)
class LayerProfile:
    """Per-layer quantities (paper Table 2).  Sizes in bytes, times in
    seconds, indexed by memory option j for the compute times."""

    name: str
    param_bytes: float          # s_i
    act_bytes: float            # a_i  (per micro-batch)
    out_bytes: float            # o_i  (per micro-batch)
    grad_out_bytes: float       # g_i  (per micro-batch, bwd boundary)
    fwd_time: Tuple[float, ...]   # T_fc^{i,j}
    bwd_time: Tuple[float, ...]   # T_bc^{i,j}


@dataclass(frozen=True)
class ModelProfile:
    name: str
    layers: Tuple[LayerProfile, ...]   # analytic: the port builds no measured ones

    @property
    def L(self) -> int:
        return len(self.layers)

    def arrays(self):
        """Per-layer quantity arrays, built once per profile and cached
        (read-only)."""
        cached = self.__dict__.get("_arrays_cache")
        if cached is not None:
            return cached
        ls = self.layers
        cached = {
            "s": np.array([l.param_bytes for l in ls]),
            "a": np.array([l.act_bytes for l in ls]),
            "o": np.array([l.out_bytes for l in ls]),
            "g": np.array([l.grad_out_bytes for l in ls]),
            "Tf": np.array([l.fwd_time for l in ls]),   # [L, J]
            "Tb": np.array([l.bwd_time for l in ls]),
        }
        for arr in cached.values():
            arr.setflags(write=False)
        object.__setattr__(self, "_arrays_cache", cached)
        return cached
