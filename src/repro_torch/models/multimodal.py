"""Modality frontend stubs (``repro.models.multimodal`` in torch).

[audio] hubert-xlarge: the mel-spectrogram + conv feature encoder is stubbed;
a batch carries frame embeddings [B, S, d_model] drawn from a seeded
generator, plus codebook labels in [0, vocab).

[vlm] internvl2-26b: the InternViT encoder + MLP projector are stubbed; a
batch carries patch embeddings [B, n_patches, d_model] that the language
model consumes in its leading positions.

Both are 0.1 x N(0, 1) in fp32, the JAX package's law; the bits come from
``torch.Generator``, not ``jax.random``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig


def synth_audio_frames(gen: torch.Generator, cfg: ArchConfig, batch: int,
                       seq: int) -> torch.Tensor:
    """Stub for the wav2vec2/HuBERT conv feature extractor's output."""
    return 0.1 * torch.randn((batch, seq, cfg.d_model), generator=gen, device=gen.device,
                             dtype=torch.float32)


def synth_patch_embeds(gen: torch.Generator, cfg: ArchConfig, batch: int) -> torch.Tensor:
    """Stub for the ViT patch/projector output (``n_frontend_tokens`` patches)."""
    return 0.1 * torch.randn((batch, cfg.n_frontend_tokens, cfg.d_model), generator=gen,
                             device=gen.device, dtype=torch.float32)
