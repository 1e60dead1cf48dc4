"""One pipeline stage's serving math: partitioned prefill + one-token decode
(``repro.serving.worker`` for the port).

:class:`ServeStageWorker` owns a contiguous run of period instances (plus
possibly the embedding and/or the head) and runs the same per-instance
loops (``transformer.scan_prefill`` / ``scan_decode``) as the monolithic
``registry.prefill`` / ``registry.decode_step``; the split only chains the
hidden state across stages through the object store, so on one device the
pipelined tokens are bit-identical to the monolithic loop's.  Inputs and
outputs stay tensors on the worker's device.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import registry
from repro_torch.models.common import rms_norm, tree_map
from repro_torch.models.transformer import scan_decode, scan_prefill
from repro_torch.serverless.runtime.worker import StageSpan


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocab of the last position -> int32 [B, 1], the first
    maximum on ties (as ``np.argmax``); the single sampling rule of the
    pipelined engine and the monolithic reference loop."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32).reshape(-1, 1)


class ServeStageWorker:
    """Stage ``span`` of ``cfg``, serving prefill + decode requests.

    ``prefill(x_in)`` takes token ids ([B, S] int) when the stage owns the
    embedding, else the upstream hidden state [B, S, d]; it returns
    ``(out, caches)`` where ``out`` is the next stage's input (or the
    last-position logits on the head stage) and ``caches`` the stage's
    decode caches (None when the stage owns no layers).  ``decode(caches,
    x_in)`` is the one-token analog; it updates ``caches`` in place.
    """

    def __init__(self, cfg: ArchConfig, span: StageSpan, full_params: dict, *,
                 s_ctx: int, use_kernels: bool = False):
        if cfg.frontend != "none":
            raise NotImplementedError(
                f"pipelined serving supports token frontends only, "
                f"got frontend={cfg.frontend!r}")
        if cfg.tie_embeddings and span.n_stages > 1:
            raise NotImplementedError(
                "tied embeddings cannot be split across serving stages "
                "(embed and head live in different workers)")
        self.cfg = cfg
        self.span = span
        self.s_ctx = int(s_ctx)
        self.use_kernels = bool(use_kernels)
        self.has_layers = span.inst_hi > span.inst_lo

        p: dict = {}
        if span.owns_embed or cfg.tie_embeddings:
            p["embed"] = full_params["embed"]
        if span.owns_head:
            p["final_norm"] = full_params["final_norm"]
            if not cfg.tie_embeddings:
                p["head"] = full_params["head"]
        if self.has_layers:
            p["layers"] = tree_map(lambda a: a[span.inst_lo:span.inst_hi],
                                   full_params["layers"])
        self.params = p
        self.mask = (registry.active_mask(cfg)[span.inst_lo:span.inst_hi]
                     if self.has_layers else None)

    def _embed(self, x_in):
        if self.span.owns_embed:
            return registry.embed_tokens(self.cfg, self.params, x_in)
        return x_in

    def _head(self, h):
        h = rms_norm(h, self.params["final_norm"], self.cfg.norm_eps)
        head = (self.params["embed"] if self.cfg.tie_embeddings
                else self.params["head"])
        return h @ head.T

    def prefill(self, x_in) -> Tuple[torch.Tensor, Optional[Any]]:
        h = self._embed(x_in)
        positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
        caches = None
        if self.has_layers:
            h, caches = scan_prefill(self.params["layers"], h, self.mask,
                                     cfg=self.cfg, positions=positions,
                                     capacity=self.s_ctx)
        if self.span.owns_head:
            # matches registry.prefill: norm + logits on the last position
            return self._head(h[:, -1:]), caches
        return h, caches

    def decode(self, caches, x_in) -> Tuple[torch.Tensor, Optional[Any]]:
        h = self._embed(x_in)
        if self.has_layers:
            h, caches = scan_decode(self.params["layers"], h, caches, self.mask,
                                    cfg=self.cfg, use_kernels=self.use_kernels)
        if self.span.owns_head:
            return self._head(h), caches
        return h, caches
