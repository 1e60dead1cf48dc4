"""Analytic layer profiles of the ported architectures (the arch-id part of
``repro.core.profiler``, copied exactly so plans resolve to the same
fingerprint).  The paper's Table 1 models are not ported."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import MOE_FF, ArchConfig
from repro_torch.core.partition import LayerProfile, ModelProfile
from repro_torch.serverless.platform import Platform

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
        if cfg.layer_spec(i).ff == MOE_FF:
            raise NotImplementedError(
                "MoE profiles: not ported yet: ROADMAP port queue item 6 "
                "(other model families)")
        p_b = per_layer_params
        flops = 6 * (p_b / F32) * seq * micro_batch / 3  # fwd ~ 2*N*D
        layers.append(_layer(platform, f"layer{i}", p_b, act_per_layer, out_b,
                             out_b, flops))
    # lm head
    layers.append(_layer(platform, "head", emb_b, out_b, out_b, out_b,
                         2 * cfg.vocab_size * d * seq * micro_batch / 1000))
    return ModelProfile(name=cfg.name, layers=tuple(layers))


def arch_config(model: str) -> ArchConfig:
    """ArchConfig of an arch id or its reduced spelling
    ``<arch>@reduced[<n_layers>]``."""
    from repro_torch.configs import ARCH_IDS, get_config

    base, _, spec = model.partition("@")
    if base not in ARCH_IDS or (spec and not spec.startswith("reduced")):
        raise KeyError(
            f"unknown model {model!r}; the port knows {sorted(ARCH_IDS)} "
            "(reduced spelling: <arch>@reduced[<L>]); the paper's Table 1 "
            "models and the other archs are not ported yet: ROADMAP port "
            "queue item 6 (other model families)")
    cfg = get_config(base)
    if spec:
        cfg = cfg.reduced()
        depth = spec[len("reduced"):]
        if depth:
            try:
                cfg = dataclasses.replace(cfg, n_layers=int(depth))
            except ValueError:
                raise KeyError(
                    f"malformed reduced-arch spec {model!r}: depth "
                    f"{depth!r} is not an integer") from None
    return cfg


def resolve_profile(model: str, platform: Platform, *, seq=None,
                    micro_batch=None) -> ModelProfile:
    """Model id -> layer profile, as ``DeploymentPlan.resolve`` replays it
    (arch defaults: seq=512, micro_batch=1)."""
    return arch_model_profile(arch_config(model), platform,
                              seq=512 if seq is None else seq,
                              micro_batch=1 if micro_batch is None else micro_batch)
