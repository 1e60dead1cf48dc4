"""Shape and dtype records of every model input (``repro.data.specs`` in
torch): tensors on the ``meta`` device, which carry a shape and a dtype and
allocate nothing."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, InputShape


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape, *,
                global_batch: Optional[int] = None) -> dict:
    """The batch of ``shape.kind`` as ``meta`` tensors: {"tokens", "labels"}
    [B, S] int32 for training (audio: "frames" [B, S, d] fp32; vision adds
    "image_embeds" [B, n_frontend_tokens, d] fp32), the same without labels
    for prefill, and {"tokens"} [B, 1] for decode (the caches are made
    apart, by ``train.serve_step.init_caches``)."""
    B = global_batch if global_batch is not None else shape.global_batch
    S = shape.seq_len
    i32, f32 = torch.int32, torch.float32
    if shape.kind not in ("train", "prefill", "decode"):
        raise ValueError(shape.kind)
    if shape.kind == "decode":
        return {"tokens": _spec((B, 1), i32)}
    labels = {"labels": _spec((B, S), i32)} if shape.kind == "train" else {}
    if cfg.frontend == "audio":
        return {"frames": _spec((B, S, cfg.d_model), f32), **labels}
    specs = {"tokens": _spec((B, S), i32)}
    if cfg.frontend == "vision":
        specs["image_embeds"] = _spec((B, cfg.n_frontend_tokens, cfg.d_model), f32)
    return {**specs, **labels}
