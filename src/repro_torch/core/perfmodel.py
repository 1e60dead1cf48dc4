"""Per-(layer, memory-option) cost tables (the parts of
``repro.core.perfmodel`` that serving needs, copied exactly so emulated
clocks agree with the JAX package's to the bit).  The eq (6)/(7) closed
forms and the batched planner kernel are not ported."""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from repro_torch.core.partition import ModelProfile
from repro_torch.serverless.platform import Platform


@dataclass(frozen=True)
class Config:
    """A co-optimization decision: partition boundaries x (len L-1, {0,1}),
    data-parallel degree d, and per-layer memory option index z (len L,
    constant within a stage)."""

    x: tuple
    d: int
    z: tuple  # memory option INDEX per layer


@dataclass(frozen=True)
class PerfTables:
    """Per-(layer, memory-option) tables for one (profile, platform) pair."""

    L: int
    J: int
    t_lat: float
    base_memory: float
    price_per_gb_s: float
    mem_opts: np.ndarray        # [J] bytes
    W: np.ndarray               # [J] per-function bandwidth
    Tf_beta: np.ndarray         # [L, J] beta * forward compute time
    Tb_beta: np.ndarray         # [L, J] beta * backward compute time
    s: np.ndarray               # [L] parameter bytes
    a: np.ndarray               # [L] activation bytes per micro-batch
    o: np.ndarray               # [L] forward boundary bytes
    g: np.ndarray               # [L] backward boundary bytes
    monotone: bool


@functools.lru_cache(maxsize=256)
def perf_tables(profile: ModelProfile, platform: Platform) -> PerfTables:
    arr = profile.arrays()
    opts = np.array(platform.memory_options, dtype=np.float64)
    if not np.all(np.diff(opts) > 0):
        raise ValueError(
            f"platform {platform.name!r} memory_options must be strictly "
            "ascending")
    W = np.array([platform.bandwidth(mo) for mo in platform.memory_options],
                 dtype=np.float64)
    Tf_beta = platform.contention_beta * arr["Tf"].astype(np.float64)
    Tb_beta = platform.contention_beta * arr["Tb"].astype(np.float64)
    mem_opts = opts
    monotone = bool(
        np.all(np.diff(W) >= 0)
        and np.all(np.diff(Tf_beta, axis=1) <= 0)
        and np.all(np.diff(Tb_beta, axis=1) <= 0)
    )
    for t in (W, Tf_beta, Tb_beta, mem_opts):
        t.setflags(write=False)
    return PerfTables(
        L=profile.L, J=len(platform.memory_options),
        t_lat=platform.storage_latency, base_memory=float(platform.base_memory),
        price_per_gb_s=platform.price_per_gb_s, mem_opts=mem_opts, W=W,
        Tf_beta=Tf_beta, Tb_beta=Tb_beta,
        s=arr["s"], a=arr["a"], o=arr["o"], g=arr["g"], monotone=monotone,
    )
