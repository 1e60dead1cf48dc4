"""Seeds, batches and weights of a run, made on the device from ``--seed``.

The token law is a frozen copy of ``repro_torch.data.synthetic``'s training
batches: Zipf(1.2) unigrams over the vocabulary, drawn with
``torch.multinomial`` from a generator seeded by ``(seed, step, shard)``.
The program is given these batches and never makes its own.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable

import numpy as np
import torch

WEIGHTS_STREAM = 2**31 - 1     # the key of the weights' generator, apart from every step's


def seed_key(*parts: int) -> int:
    """A 32-bit generator seed from whole numbers of any size."""
    return int(np.random.SeedSequence([int(p) for p in parts]).generate_state(1)[0])


def zipf_probs(vocab: int, s: float, device) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    p = ranks ** -s
    return (p / p.sum()).float()


def token_batch(traffic: dict, vocab: int, rows: int, *, seed: int, step: int,
                device) -> torch.Tensor:
    """Step ``step``'s global batch of token ids, int32 [rows, seq]."""
    law = traffic["tokens"]
    if law["law"] != "zipf":
        raise ValueError(f"token law {law['law']!r}")
    gen = torch.Generator(device=device).manual_seed(seed_key(seed, step, 0))
    n = rows * traffic["seq"]
    idx = torch.multinomial(zipf_probs(vocab, law["s"], device), n, replacement=True,
                            generator=gen)
    return idx.reshape(rows, traffic["seq"]).to(torch.int32)


def make_weights(specs: Iterable[tuple], seed: int, device,
                 dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every leaf of ``specs`` ((name, shape, scale), scale 0 a zero leaf)
    from one normal draw on the device, scaled, then cast to ``dtype`` in one
    call: leaves are views of one buffer."""
    specs = list(specs)
    drawn = [(n, s, c) for n, s, c in specs if c]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(seed_key(seed, WEIGHTS_STREAM))
    buf = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    views, off = {}, 0
    for name, shape, scale in drawn:
        n = math.prod(shape)
        buf[off:off + n].mul_(scale)
        views[name] = (off, n, shape)
        off += n
    buf = buf.to(dtype)
    out = {}
    for name, shape, scale in specs:
        if scale:
            o, n, shp = views[name]
            out[name] = buf[o:o + n].view(shp)
        else:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
    return out
