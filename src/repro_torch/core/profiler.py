"""Model Profiler (paper Fig 2, startup component ③); ``repro.core.profiler``
for the port, copied exactly so plans resolve to the same fingerprint.

The per-layer tables are synthesized analytically: FLOPs-derived compute
times under the platform's memory->vCPU scaling, plus parameter /
activation / boundary sizes, for the paper's four evaluation models (Table
1) and for the ported architectures.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import MOE_FF, ArchConfig
from repro_torch.core.partition import LayerProfile, ModelProfile
from repro_torch.serverless.platform import MB, Platform

F32 = 4  # training payloads are fp32 on CPU serverless


def _times(platform: Platform, fwd_flops: float):
    fwd = tuple(platform.compute_time(fwd_flops, m) for m in platform.memory_options)
    bwd = tuple(2.0 * t for t in fwd)
    return fwd, bwd


def _layer(platform, name, params_b, act_b, out_b, grad_b, fwd_flops):
    fwd, bwd = _times(platform, fwd_flops)
    return LayerProfile(
        name=name, param_bytes=params_b, act_bytes=act_b, out_bytes=out_b,
        grad_out_bytes=grad_b, fwd_time=fwd, bwd_time=bwd,
    )


# ----------------------------------------------------------- paper's models
# Table 1: (param_MB, act_MB_per_sample); FLOPs calibrated so AmoebaNet-D36
# computation matches Fig 1(a) (~6 s/iteration).
_PAPER_MODELS = {
    "resnet101": dict(params=170 * MB, act=198 * MB, n_layers=35, kind="cnn"),
    "amoebanet-d18": dict(params=476 * MB, act=432 * MB, n_layers=20, kind="cnn"),
    "amoebanet-d36": dict(params=900 * MB, act=697 * MB, n_layers=38, kind="cnn"),
    "bert-large": dict(params=1153 * MB, act=263 * MB, n_layers=26, kind="bert"),
}
_CNN_FLOPS_PER_PARAM_SAMPLE = 240.0   # conv spatial reuse
_BERT_FLOPS_PER_PARAM_SAMPLE = 256.0  # 2 * seq(128)


def paper_model_profile(name: str, platform: Platform,
                        micro_batch: int = 4) -> ModelProfile:
    spec = _PAPER_MODELS[name]
    L = spec["n_layers"]
    P_total, A_total = spec["params"], spec["act"]
    if spec["kind"] == "cnn":
        # params grow with depth, activations shrink (stride-2 reductions)
        depth = np.arange(L)
        pw = np.exp(depth / L * 1.6)          # ~5x growth first->last
        aw = np.exp(-depth / L * 2.2)         # ~9x shrink
        kf = _CNN_FLOPS_PER_PARAM_SAMPLE
    else:
        # embedding-heavy first layer, uniform encoder blocks
        pw = np.ones(L)
        pw[0] = 3.0
        pw[-1] = 0.3
        aw = np.ones(L)
        kf = _BERT_FLOPS_PER_PARAM_SAMPLE
    pw = pw / pw.sum()
    aw = aw / aw.sum()
    layers = []
    for i in range(L):
        p_b = P_total * pw[i]
        a_b = A_total * aw[i] * micro_batch
        out_b = a_b * 0.5                      # boundary tensor ~ half the act
        flops = kf * (p_b / F32) * micro_batch
        if spec["kind"] == "cnn" and i == 0:
            flops *= 3.0                       # stem convs are FLOP-heavy
        layers.append(_layer(platform, f"L{i}", p_b, a_b, out_b, out_b, flops))
    return ModelProfile(name=name, layers=tuple(layers))


# -------------------------------------------------- assigned-arch bridge
def arch_model_profile(cfg: ArchConfig, platform: Platform, *, seq: int = 512,
                       micro_batch: int = 1) -> ModelProfile:
    """Layer table for one of the assigned architectures (fp32 serverless)."""
    d = cfg.d_model
    layers = []
    act_per_layer = 6 * seq * d * F32 * micro_batch  # residual+mixer+ff buffers
    out_b = seq * d * F32 * micro_batch
    # embedding "layer"
    emb_b = cfg.vocab_size * d * F32
    layers.append(_layer(platform, "embed", emb_b, out_b, out_b, out_b,
                         2 * seq * d * micro_batch))
    n_emb_tables = 1 if cfg.tie_embeddings else 2
    per_layer_params = max(
        0.0, cfg.param_count() * F32 - n_emb_tables * emb_b) / cfg.n_layers
    for i in range(cfg.n_layers):
        spec = cfg.layer_spec(i)
        p_b = per_layer_params
        flops_params = p_b / F32
        if spec.ff == MOE_FF and cfg.moe is not None:
            # only top_k experts touched per token
            frac = cfg.active_param_count() / cfg.param_count()
            flops_params *= frac
        flops = 6 * flops_params * seq * micro_batch / 3  # fwd ~ 2*N*D
        layers.append(_layer(platform, f"layer{i}", p_b, act_per_layer, out_b,
                             out_b, flops))
    # lm head
    layers.append(_layer(platform, "head", emb_b, out_b, out_b, out_b,
                         2 * cfg.vocab_size * d * seq * micro_batch / 1000))
    return ModelProfile(name=cfg.name, layers=tuple(layers))


_SPELLINGS = ("reduced", "layers")


def arch_config(model: str) -> ArchConfig:
    """ArchConfig of an arch id, its reduced spelling
    ``<arch>@reduced[<n_layers>]``, or ``<arch>@layers<n_layers>``: the
    config at full width cut to its first ``n_layers`` layers (the port's
    own spelling, for a model that one card holds only in part; the JAX
    package does not know it).  The paper's Table 1 models are analytic
    layer tables with no runnable layers, so they have none."""
    from repro_torch.configs import ARCH_IDS, get_config

    base, _, spec = model.partition("@")
    if base not in ARCH_IDS or (spec and not spec.startswith(_SPELLINGS)):
        raise KeyError(
            f"{model!r} is not an arch id the port runs ({sorted(ARCH_IDS)}; "
            "reduced spelling: <arch>@reduced[<L>], full width cut: "
            "<arch>@layers<L>); the paper's Table 1 models are analytic-only")
    cfg = get_config(base)
    if spec:
        kind = "layers" if spec.startswith("layers") else "reduced"
        if kind == "reduced":
            cfg = cfg.reduced()
        depth = spec[len(kind):]
        if depth or kind == "layers":
            try:
                cfg = dataclasses.replace(cfg, n_layers=int(depth))
            except ValueError:
                raise KeyError(
                    f"malformed {kind}-arch spec {model!r}: depth "
                    f"{depth!r} is not an integer") from None
    return cfg


# ------------------------------------------------------- unified resolution
def known_models():
    """All model ids the profiler can resolve (paper models + arch ids)."""
    from repro_torch.configs import ARCH_IDS

    return sorted(_PAPER_MODELS) + sorted(ARCH_IDS)


def resolve_profile(model: str, platform: Platform, *, seq=None,
                    micro_batch=None) -> ModelProfile:
    """One front door from a model id to its layer profile, as
    ``DeploymentPlan.resolve`` replays it.

    Accepts the paper's Table 1 models, the ported arch ids and their
    spellings ``<arch>@reduced[<n_layers>]`` and ``<arch>@layers<n_layers>``
    (:func:`arch_config`); ``None`` keeps each
    family's own default (paper: micro_batch=4; arch: seq=512,
    micro_batch=1)."""
    if model in _PAPER_MODELS:
        return paper_model_profile(model, platform,
                                   micro_batch=4 if micro_batch is None else micro_batch)
    from repro_torch.configs import ARCH_IDS

    base, _, spec = model.partition("@")
    if base not in ARCH_IDS or (spec and not spec.startswith(_SPELLINGS)):
        raise KeyError(
            f"unknown model {model!r}; known models: {known_models()} "
            "(reduced spelling: <arch>@reduced[<L>])")
    return arch_model_profile(arch_config(model), platform,
                              seq=512 if seq is None else seq,
                              micro_batch=1 if micro_batch is None else micro_batch)
