"""Per-stage cost terms of a FuncPipe configuration (``stage_aggregates``, the
bandwidth model and ``unpack_plan_args`` of ``repro.serverless.simulator``,
copied exactly: the emulated backend charges these on its virtual clocks).
The discrete-event simulator ``simulate_funcpipe`` is not ported yet: ROADMAP
port queue item 4."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.partition import ModelProfile, stages_of
from repro_torch.core.perfmodel import Config, perf_tables
from repro_torch.serverless.platform import Platform


def bandwidth_contention(n_workers: int, knee: int = 16, exp: float = 0.25) -> float:
    """Per-worker bandwidth multiplier: platforms co-locate functions, so
    per-function bandwidth degrades past ~``knee`` concurrent workers
    (paper §5.4 observation)."""
    if n_workers <= knee:
        return 1.0
    return (knee / n_workers) ** exp


def storage_capped_bw(platform: Platform, w: float, n_workers: int) -> float:
    """§5.7: storage services that cap TOTAL concurrent bandwidth give each of
    n workers at most cap/n.  AWS S3 is modeled uncapped (paper §5.1)."""
    cap = platform.storage_total_bandwidth
    if cap is None or n_workers <= 0:
        return w
    return min(w, cap / n_workers)


def effective_bandwidth(
    platform: Platform, mem: int, n_workers: int, *, contention: bool = False
) -> float:
    """Per-worker storage bandwidth under §5.4 contention + §5.7 caps."""
    w = platform.bandwidth(mem)
    if contention:
        w *= bandwidth_contention(n_workers)
    return storage_capped_bw(platform, w, n_workers)


@dataclass(frozen=True)
class StageAggregates:
    """Per-stage cost terms of a FuncPipe configuration."""

    S: int                    # number of pipeline stages
    mu: int                   # micro-batches per worker
    d: int                    # data-parallel degree
    n_workers: int            # S * d
    t_lat: float              # storage latency
    t_fc: np.ndarray          # [S] forward compute per micro-batch
    t_bc: np.ndarray          # [S] backward compute per micro-batch
    w: np.ndarray             # [S] effective per-worker storage bandwidth
    out_b: np.ndarray         # [S] forward boundary bytes (stage output)
    grad_b: np.ndarray        # [S] backward boundary bytes (grad at stage lo)
    s_stage: np.ndarray       # [S] parameter bytes per stage
    mem: np.ndarray           # [S] allocated function memory (bytes)
    t_up_f: np.ndarray        # [S] fwd boundary upload time (stage s -> store)
    t_dn_f: np.ndarray        # [S] fwd boundary download time (store -> stage s)
    t_up_b: np.ndarray        # [S] bwd boundary upload time
    t_dn_b: np.ndarray        # [S] bwd boundary download time


def stage_aggregates(
    profile: ModelProfile,
    platform: Platform,
    config: Config,
    total_micro_batches: int,
    *,
    contention: bool = False,
) -> StageAggregates:
    tables = perf_tables(profile, platform)
    x = np.asarray(config.x)
    d = config.d
    mu = max(1, total_micro_batches // d)
    stages = stages_of(x)
    S = len(stages)
    z = np.asarray(config.z)
    t_lat = tables.t_lat
    L = tables.L
    los = np.array([lo for lo, _ in stages])
    his = np.array([hi for _, hi in stages])

    n_workers = S * d

    lidx = np.arange(L)
    t_fc = np.add.reduceat(tables.Tf_beta[lidx, z], los)
    t_bc = np.add.reduceat(tables.Tb_beta[lidx, z], los)
    w = np.array([
        effective_bandwidth(platform, platform.memory_options[z[lo]], n_workers,
                            contention=contention)
        for lo in los
    ])
    out_b = tables.o[his]                                          # fwd boundary
    grad_b = tables.g[los]                                         # bwd boundary
    s_stage = np.add.reduceat(tables.s, los)
    mem = tables.mem_opts[z[los]]

    t_up_f = out_b / w + t_lat      # stage s uploads its output
    t_dn_f = np.empty(S)
    t_dn_f[1:] = out_b[:-1] / w[1:] + t_lat
    t_dn_f[0] = 0.0
    t_up_b = grad_b / w + t_lat     # stage s uploads grad toward s-1
    t_dn_b = np.empty(S)
    t_dn_b[:-1] = grad_b[1:] / w[:-1] + t_lat
    t_dn_b[-1] = 0.0
    return StageAggregates(
        S=S, mu=mu, d=d, n_workers=n_workers, t_lat=t_lat,
        t_fc=t_fc, t_bc=t_bc, w=w, out_b=out_b, grad_b=grad_b,
        s_stage=s_stage, mem=mem,
        t_up_f=t_up_f, t_dn_f=t_dn_f, t_up_b=t_up_b, t_dn_b=t_dn_b,
    )


def unpack_plan_args(fn_name, profile, platform, config, total_micro_batches,
                     pipelined_sync):
    """The DeploymentPlan front door of ``runtime.run_plan``: a plan as the
    first argument is resolved (profile rebuilt and fingerprint-checked) and
    its recorded sync algorithm used unless ``pipelined_sync`` overrides it.
    Mixing a plan with explicit platform/config/M is rejected."""
    if not isinstance(profile, ModelProfile):
        if not hasattr(profile, "resolve"):
            raise TypeError(
                f"{fn_name} takes (profile, platform, config, M) or a "
                f"DeploymentPlan as first argument, got {type(profile).__name__}")
        if platform is not None or config is not None \
                or total_micro_batches is not None:
            raise ValueError(
                f"{fn_name}(plan, ...) takes no platform/config/"
                "total_micro_batches: they are recorded in the plan")
        rp = profile.resolve()
        if pipelined_sync is None:
            pipelined_sync = rp.pipelined_sync
        profile, platform, config = rp.profile, rp.platform, rp.config
        total_micro_batches = rp.total_micro_batches
    if pipelined_sync is None:
        pipelined_sync = True
    return profile, platform, config, total_micro_batches, pipelined_sync
