"""Deterministic synthetic batches (``repro.data.synthetic`` in torch).

A batch is a pure function of (seed, step, shard), so every data-parallel
worker can regenerate its own shard with no host coordination: the global
batch is [global_batch, seq] and shard w of n takes rows [w*B/n, (w+1)*B/n).
Training tokens follow the JAX package's Zipf(1.2) unigram law, prefill and
decode tokens are uniform, and the frontends' frame and patch embeddings
come from ``models.multimodal``; all are drawn from one ``torch.Generator``
in the order JAX splits its keys.  The distributions match ``jax.random``'s,
the bits do not, so parity tests feed both packages batches made by one of
them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import multimodal
from repro_torch.models.common import resolve_device

ZIPF_S = 1.2  # token unigram skew: a learnable signal


def zipf_probs(vocab: int, device=None) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    p = ranks ** -ZIPF_S
    return (p / p.sum()).float()


def sample_tokens(gen: torch.Generator, shape, vocab: int) -> torch.Tensor:
    n = int(np.prod(shape))
    idx = torch.multinomial(zipf_probs(vocab, gen.device), n, replacement=True,
                            generator=gen)
    return idx.reshape(tuple(shape)).to(torch.int32)


def make_batch(cfg: ArchConfig, shape: InputShape, *, seed: int = 0, step: int = 0,
               shard: int = 0, n_shards: int = 1, global_batch: Optional[int] = None,
               seq_len: Optional[int] = None, device="cuda") -> dict:
    """A batch of ``shape.kind``, as the JAX package's:

    * ``"train"``: {"tokens", "labels"} [B, S] int32 (labels are the tokens:
      the next-token objective shifts them; an encoder predicts them in
      place), plus "image_embeds" [B, n_frontend_tokens, d] for vision; for
      audio {"frames" [B, S, d] fp32, "labels"};
    * ``"prefill"``: uniform {"tokens"} (+ "image_embeds"), or {"frames"};
    * ``"decode"``: uniform {"tokens"} [B, 1]."""
    B_g = global_batch if global_batch is not None else shape.global_batch
    S = seq_len if seq_len is not None else shape.seq_len
    if B_g % n_shards:
        raise ValueError(f"global batch {B_g} does not split into {n_shards} shards")
    B = B_g // n_shards
    dev = resolve_device(device)
    key = int(np.random.SeedSequence([seed, step, shard]).generate_state(1)[0])
    gen = torch.Generator(device=dev).manual_seed(key)

    def uniform(shape_):
        return torch.randint(0, cfg.vocab_size, shape_, generator=gen, device=dev,
                             dtype=torch.int32)

    if shape.kind == "train":
        if cfg.frontend == "audio":
            frames = multimodal.synth_audio_frames(gen, cfg, B, S)
            return {"frames": frames, "labels": sample_tokens(gen, (B, S), cfg.vocab_size)}
        tokens = sample_tokens(gen, (B, S), cfg.vocab_size)
        batch = {"tokens": tokens, "labels": tokens}
        if cfg.frontend == "vision":
            batch["image_embeds"] = multimodal.synth_patch_embeds(gen, cfg, B)
        return batch
    if shape.kind == "prefill":
        if cfg.frontend == "audio":
            return {"frames": multimodal.synth_audio_frames(gen, cfg, B, S)}
        batch = {"tokens": uniform((B, S))}
        if cfg.frontend == "vision":
            batch["image_embeds"] = multimodal.synth_patch_embeds(gen, cfg, B)
        return batch
    if shape.kind == "decode":
        return {"tokens": uniform((B, 1))}
    raise ValueError(shape.kind)
