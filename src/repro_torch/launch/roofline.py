"""Roofline terms of one (arch x shape x plan) on the rank mesh
(``repro.launch.roofline`` in torch).

Three terms per rank, each over a rate of the chip (:class:`ChipSpec`):

    compute    = FLOPs / peak FLOP/s
    memory     = HBM bytes / HBM B/s
    collective = bytes through one link direction / link B/s

The JAX package fixes the rates as module globals (a TPU v5e); here they
are an argument, with two instances: :data:`V5E` (the JAX package's
constants, with which every number equals JAX's bit for bit) and
:func:`h100` (one NVIDIA H100 80GB HBM3 at a 700 W power limit: 989e12
bf16 FLOP/s and 3.35e12 B/s, NVIDIA's data sheet; 80e9 bytes of HBM shared
by the ranks on the card; and, as the "link", the host-staged gloo rate
measured between four ranks sharing one card, 847 MB of ring
reduce-scatter in 2.24 s, ``chip_smoke.py``'s ``train_mesh``).

:func:`analytic_roofline` and :func:`model_flops` are JAX's first-principles
model, every expression in JAX's order.  JAX's HLO half (``analyze``,
``parse_collectives``, ``computation_multipliers``) reads the text of an
XLA-compiled program; no torch program produces one, so those functions
have no input here.  In their place :func:`issued_roofline` builds a
:class:`Roofline` from the collectives a rank actually issued
(``core.collectives.stats()``), each category mapped onto JAX's collective
kinds and link bytes (:data:`ISSUED_KINDS`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping

from repro_torch.configs.base import ATTN, GLOBAL_WINDOW, MAMBA, MLSTM, MOE_FF


@dataclass(frozen=True)
class ChipSpec:
    """The rates one rank's roofline divides by, and the device memory one
    rank may plan for (``core.tpu_planner``'s feasibility bound)."""

    name: str
    peak_flops: float      # FLOP/s in the model's dtype
    hbm_bw: float          # device memory bytes/s
    link_bw: float         # bytes/s through one link direction
    hbm_bytes: float       # device memory bytes of one rank


#: the JAX package's constants (``src/repro/launch/roofline.py:22-24`` and
#: ``src/repro/core/tpu_planner.py:26``)
V5E = ChipSpec("TPU v5e (the JAX package's constants)", 197e12, 819e9, 50e9, 16e9)

#: host-staged gloo between ranks that share one H100: 847 MB of ring
#: reduce-scatter in 2.24 s (NVIDIA H100 80GB HBM3, 700 W)
H100_SAME_CARD_GLOO_BW = 847e6 / 2.24


def h100(ranks_per_card: int = 1) -> ChipSpec:
    """One NVIDIA H100 80GB HBM3 at its 700 W power limit, its 80e9 bytes
    divided among the ``ranks_per_card`` ranks that share it."""
    return ChipSpec(f"NVIDIA H100 80GB HBM3, 700 W, {ranks_per_card} rank(s) a card",
                    989e12, 3.35e12, H100_SAME_CARD_GLOO_BW, 80e9 / ranks_per_card)


@dataclass
class CollectiveOp:
    kind: str
    result_bytes: float
    group_size: int
    trip_mult: float = 1.0  # while-loop trip multiplier (scan bodies)

    @property
    def link_bytes(self) -> float:
        """Bytes through one link direction per chip, ring schedules."""
        g = max(1, self.group_size)
        if self.kind == "collective-permute":
            return float(self.result_bytes)  # point-to-point, no groups
        if g == 1:
            return 0.0
        if self.kind == "all-gather":
            # result = gathered size; each chip receives (g-1)/g of it
            return self.result_bytes * (g - 1) / g
        if self.kind == "reduce-scatter":
            # result = shard; input g*shard moves (g-1) shard-hops
            return self.result_bytes * (g - 1)
        if self.kind == "all-reduce":
            return 2 * self.result_bytes * (g - 1) / g
        if self.kind == "all-to-all":
            return self.result_bytes * (g - 1) / g
        return float(self.result_bytes)

    @property
    def weighted_link_bytes(self) -> float:
        return self.link_bytes * self.trip_mult


@dataclass
class Roofline:
    flops: float                  # per-rank flops
    hbm_bytes: float              # per-rank bytes accessed
    link_bytes: float             # per-rank bytes through a link direction
    collective_counts: Dict[str, int] = field(default_factory=dict)
    collective_bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    bubble_factor: float = 1.0    # GPipe fill/drain: (mu + S - 1) / mu
    chip: ChipSpec = V5E

    @property
    def t_compute(self) -> float:
        return self.flops / self.chip.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.chip.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.link_bytes / self.chip.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_step_est(self) -> float:
        """Wall-time estimate: busy compute stretched by the pipeline bubble,
        plus non-overlapped collectives (the memory term assumed overlapped
        with compute)."""
        return max(self.t_compute, self.t_memory) * self.bubble_factor + self.t_collective

    def as_dict(self) -> dict:
        """JAX's record (the chip is not part of it: see :attr:`chip`)."""
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "link_bytes": self.link_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bubble_factor": self.bubble_factor,
            "t_step_est_s": self.t_step_est,
            "bottleneck": self.bottleneck,
            "collective_counts": self.collective_counts,
            "collective_bytes_by_kind": self.collective_bytes_by_kind,
        }


# --------------------------------------------------------------- analytic model
def analytic_roofline(cfg, shape, plan, *, bidirectional: bool = True,
                      chip: ChipSpec = V5E) -> Roofline:
    """First-principles per-rank roofline for one (arch x shape x plan).

    FLOPs: 2*N_active per token forward (+2x backward, +1x remat recompute),
    plus attention's O(S*ctx) term per layer kind.  HBM bytes: weight reads
    per micro-batch pass, activation traffic, KV-cache reads (decode), and
    optimizer state read/write (train).  Collective bytes: pipeline permutes,
    grad reduce-scatter + param all-gather over data, EP all-to-alls, TP
    psums.  It has no term for the model-axis psum of the globally
    replicated leaves (embedding, head), which the JAX package's step and
    the port's issue too.
    """
    chips = plan.pods * plan.data * plan.model_axis
    P_BYTES = 2 if cfg.param_dtype == "bfloat16" else 4
    N_active = cfg.active_param_count()
    N_total = cfg.param_count()
    d = cfg.d_model
    S = shape.seq_len
    B = shape.global_batch
    train = shape.kind == "train"
    decode = shape.kind == "decode"

    # ---------- matmul flops per token (2*N_active) + attention extra
    def attn_extra_flops_per_layer(tokens_ctx):
        # QK^T + PV: 4 * Hq * hd * ctx per token
        return 4.0 * cfg.n_heads * cfg.hd * tokens_ctx

    extra = 0.0
    for i in range(cfg.n_layers):
        spec = cfg.layer_spec(i)
        if spec.mixer == ATTN:
            if decode:
                ctx = min(S, spec.window) if spec.window else S
            else:
                ctx = min(S, spec.window) if spec.window else S / 2  # causal avg
            extra += attn_extra_flops_per_layer(ctx)
        elif spec.mixer == MLSTM:
            extra += attn_extra_flops_per_layer(256)  # chunk-local quadratic
        elif spec.mixer == MAMBA:
            extra += 10.0 * cfg.mamba.d_inner(d) * cfg.mamba.d_state
    n_tokens = B * S if not decode else B
    fwd = (2.0 * N_active + extra) * n_tokens
    if train:
        remat = 1.0 if plan.remat in ("tick", "layer") else 0.0
        flops_global = fwd * (3.0 + remat)
    else:
        flops_global = fwd
    flops_chip = flops_global / chips

    # ---------- HBM bytes per rank
    # params per rank: dense split over (stages x tensor); experts also over EP
    moe_params = 0.0
    if cfg.moe is not None:
        n_moe = sum(1 for i in range(cfg.n_layers) if cfg.layer_spec(i).ff == MOE_FF)
        moe_params = n_moe * cfg.moe.n_experts * 3 * d * cfg.moe.d_ff_expert
    dense_params = N_total - moe_params
    params_chip = (dense_params / (plan.stages * plan.tensor)
                   + moe_params / (plan.stages * plan.tensor * plan.ep)) * P_BYTES

    mb_local = (B // (plan.pods * plan.data)) if plan.seq_shards == 1 else B // plan.pods
    n_mb = plan.microbatches
    passes = (3.0 if train else 1.0)  # fwd+bwd(+update) vs fwd
    weight_traffic = params_chip * n_mb * passes
    act_traffic = (6.0 * mb_local * S * d * P_BYTES * (cfg.n_layers / max(1, plan.stages))
                   * passes / max(1, plan.tensor))
    kv_traffic = 0.0
    if decode:
        for i in range(cfg.n_layers):
            spec = cfg.layer_spec(i)
            if spec.mixer == ATTN:
                ctx = min(S, spec.window) if spec.window else S // plan.seq_shards
                kv_local = (max(1, cfg.n_kv_heads // plan.tensor) if plan.tensor > 1
                            else cfg.n_kv_heads)
                kv_traffic += ((mb_local if plan.seq_shards == 1 else B // plan.pods)
                               * 2 * kv_local * ctx * cfg.hd * P_BYTES)
        kv_traffic /= max(1, plan.stages)
    opt_traffic = 0.0
    if train:
        # m, v, master read and written in fp32, ZeRO-sharded
        opt_traffic = (params_chip / P_BYTES) * 4 * 3 * 2 / plan.data
    hbm_chip = weight_traffic + act_traffic + kv_traffic + opt_traffic

    # ---------- collective bytes per rank (link-direction bytes)
    coll = {}
    act_bytes_mb = ((mb_local // max(1, n_mb)) * S * d * P_BYTES if not decode
                    else (mb_local // max(1, n_mb)) * d * P_BYTES)
    # pipeline permutes: each micro-batch crosses S_eff-1 boundaries (the
    # backward sends the gradients back)
    hops = (plan.stages - 1) * n_mb * (2.0 if train else 1.0)
    coll["collective-permute"] = hops * act_bytes_mb / max(1, plan.stages)  # per-rank share
    # bidirectional rings drive both link directions -> half the wall bytes
    ring = 0.5 if bidirectional else 1.0
    if train:
        g_bytes = params_chip * 2  # fp32 grads of bf16 params
        coll["reduce-scatter"] = ring * g_bytes * (plan.data - 1) / plan.data
        coll["all-gather"] = ring * params_chip * (plan.data - 1) / plan.data
        if plan.pods > 1:
            coll["all-reduce"] = ring * 2 * g_bytes * (plan.pods - 1) / plan.pods
    if cfg.moe is not None and plan.ep > 1:
        n_moe_stage = (sum(1 for i in range(cfg.n_layers) if cfg.layer_spec(i).ff == MOE_FF)
                       / max(1, plan.stages))
        a2a = 2 * n_moe_stage * n_mb * act_bytes_mb * (3.0 if train else 1.0)
        coll["all-to-all"] = a2a * (plan.data - 1) / plan.data
    if plan.tensor > 1:
        # row-parallel psums: ~2 per layer per micro-batch pass
        n_layer_stage = cfg.n_layers / max(1, plan.stages)
        coll["all-reduce"] = coll.get("all-reduce", 0.0) + (
            2 * n_layer_stage * n_mb * act_bytes_mb * passes
            * 2 * (plan.tensor - 1) / plan.tensor
        )
    if plan.seq_shards > 1:
        # flash-decode partial-softmax psum per global-attn layer
        n_glob = sum(1 for i in range(cfg.n_layers)
                     if cfg.layer_spec(i).mixer == ATTN
                     and cfg.layer_spec(i).window == GLOBAL_WINDOW)
        part = B * cfg.n_heads * (cfg.hd + 2) * 4
        coll["all-reduce"] = coll.get("all-reduce", 0.0) + (
            2 * (n_glob / max(1, plan.stages)) * part * (plan.data - 1) / plan.data
        )
    link = float(sum(coll.values()))
    bubble = (plan.microbatches + plan.stages - 1) / plan.microbatches
    return Roofline(flops=flops_chip, hbm_bytes=hbm_chip, link_bytes=link,
                    collective_counts={k: 1 for k in coll},
                    collective_bytes_by_kind=coll,
                    bubble_factor=bubble, chip=chip)


def model_flops(cfg, shape, *, backward: bool = True) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE); decode: per token."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


# ------------------------------------------------------ the issued collectives
#: ``core.collectives.stats()`` category -> (JAX's collective kind, the mesh
#: axis its group spans; None for point-to-point).  The rings are built from
#: point-to-point sends, so a category's bytes are what this rank sent; a
#: psum's are its payload, once a call.  ``psum_tp_grads`` of a GQA leaf
#: whose KV heads are shared by fewer lanes runs over the smaller kv-share
#: group and is counted at the tp group's size.
ISSUED_KINDS = {
    "ring_rs": ("reduce-scatter", "data"),
    "ring_ag": ("all-gather", "data"),
    "psum_tp": ("all-reduce", "tp"),
    "psum_tp_grads": ("all-reduce", "tp"),
    "psum_model": ("all-reduce", "model"),
    "psum_pod": ("all-reduce", "pod"),
    "psum_seq": ("all-reduce", "seq"),
    "psum_logits": ("all-reduce", "model"),
    "metrics": ("all-reduce", "world"),
    "p2p": ("collective-permute", None),
    "a2a_ep": ("all-to-all", "data"),
}


def issued_roofline(stats: Mapping[str, Mapping], axis_sizes: Mapping[str, int], *,
                    flops: float = 0.0, hbm_bytes: float = 0.0, bubble_factor: float = 1.0,
                    bidirectional: bool = True, chip: ChipSpec = V5E) -> Roofline:
    """The port's counterpart of JAX's ``analyze``: a :class:`Roofline`
    whose collective term is what one rank issued, given its
    ``core.collectives.stats()`` and ``axis_sizes`` (each mesh axis name to
    its size, ``{name: axis.size for name, axis in mesh.axes.items()}``; a
    missing axis is one rank wide).  Each category becomes one
    :class:`CollectiveOp` whose result bytes make its ``link_bytes`` the
    bytes the rank moved through its links:

    * a ring reduce-scatter sends (g-1) shards: result = bytes / (g-1);
    * a ring all-gather sends (g-1) of its g shards: result = bytes g/(g-1);
    * a psum moves 2 (g-1)/g of its payload; an all-to-all (g-1)/g of its
      send buffer; a point-to-point send its bytes.

    Bytes are summed by kind as JAX's ``analyze`` sums its parsed
    operations, the rings' halved when ``bidirectional`` as
    :func:`analytic_roofline` halves them; counts are the calls.  The
    compute and memory terms are the caller's (``analyze`` reads them from
    XLA's cost analysis, which a torch program has not)."""
    ring = 0.5 if bidirectional else 1.0
    counts: Dict[str, int] = {}
    by_kind: Dict[str, float] = {}
    for cat, rec in stats.items():
        kind, axis = ISSUED_KINDS[cat]
        g = 1 if axis is None else axis_sizes.get(axis, 1)
        nbytes = float(rec["bytes"])
        if kind == "reduce-scatter" and g > 1:
            nbytes = nbytes / (g - 1)
        elif kind == "all-gather" and g > 1:
            nbytes = nbytes * g / (g - 1)
        op = CollectiveOp(kind=kind, result_bytes=nbytes, group_size=g)
        b = op.link_bytes * (ring if kind in ("reduce-scatter", "all-gather") else 1.0)
        counts[kind] = counts.get(kind, 0) + int(rec["calls"])
        by_kind[kind] = by_kind.get(kind, 0.0) + b
    return Roofline(flops=flops, hbm_bytes=hbm_bytes, link_bytes=float(sum(by_kind.values())),
                    collective_counts=counts, collective_bytes_by_kind=by_kind,
                    bubble_factor=bubble_factor, chip=chip)
