"""Serverless stage workers: the training forward and backward of a layer
range (``repro.serverless.runtime.worker`` for the port).

A :class:`StageWorker` owns the contiguous slice of the model that the
planner assigned to one pipeline stage: a range of period instances plus,
for the boundary stages, the embedding table or the final norm and LM head.
It runs the monolithic ``registry.loss_fn`` math split at the stage
boundaries: ``embed_inputs`` -> ``scan_forward`` -> ``rms_norm`` + CE.

Autograd stands in for ``jax.vjp``.  By default the forward keeps its graph
(the residuals) until that micro-batch's backward, which is what the
paper's activation-memory term ``mu * a_i`` accounts for; ``remat=True``
keeps only the inputs and recomputes the forward inside the backward.  Each
micro-batch's parameter gradients come from ``torch.autograd.grad`` in the
parameter dtype, are cast to fp32 and added to an fp32 accumulator (never
``.grad`` in bf16), so the arithmetic is the JAX worker's.  The
accumulator is one flat vector in ``jax.tree.flatten`` order, each leaf's
gradient added into its slice, so ``grad_vector`` hands it to the storage
scatter-reduce without a copy and a bf16 gradient is never held in fp32
twice.  A stage with MoE layers also returns its routers' aux loss, whose
cotangent is ``1/mu`` on every stage (the last stage's CE gets the same
seed).

The worker owns its state as flat buffers, updated in place: the fp32
masters and the optimizer's moments (``opt_state``'s ``master``, ``m``,
``v``, each leaf a view) and the parameters (``params``, views of a buffer
of their own dtype; fp32 parameters are the masters).  Every leaf starts on
a multiple of 8 elements, so each parameter is 16-byte aligned for the
kernels' TMA loads.  ``apply_update`` divides the reduced gradient by the
stage's ``replicas`` and steps the optimizer over the whole stage through
``ops.adamw_``: on a card with ``use_kernels`` and ``AdamW`` one launch of
the AdamW kernel (``kernels.adamw``), else the per-leaf functional update
copied into the views (``impl="ref"``), which gives the same bits.

``use_kernels=True`` routes every attention layer through the flash
attention kernel and every dense FFN through the swiglu kernel, forward and
backward, and AdamW's step through its kernel, when the worker's device is a
card.

Under a running ``torch.profiler`` the forward, backward and update run in
the ranges ``funcpipe/fwd``, ``funcpipe/bwd`` and ``funcpipe/optimizer``
(``repro_torch.obs.ranges``).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.partition import stages_of
from repro_torch.kernels import ops
from repro_torch.kernels.adamw import LeafTable
from repro_torch.models import registry
from repro_torch.models.common import (
    resolve_device,
    rms_norm,
    softmax_cross_entropy,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.models.transformer import scan_forward
from repro_torch.obs.ranges import BWD, FWD, OPTIMIZER, ranged
from repro_torch.optim.optimizers import AdamW

#: every leaf of a worker's flat state starts on a multiple of this many
#: elements: 32 bytes of fp32, 16 of bf16 (TMA's alignment)
LEAF_ALIGN = 8


@dataclass(frozen=True)
class StageSpan:
    """What pipeline stage ``index`` of ``n_stages`` owns."""

    index: int
    n_stages: int
    inst_lo: int          # first owned period instance
    inst_hi: int          # one past the last owned instance (may equal lo)
    owns_embed: bool
    owns_head: bool


def stage_instance_ranges(cfg: ArchConfig, x) -> List[StageSpan]:
    """Map profile-layer cuts ``x`` (over ``arch_model_profile``'s
    ``[embed, layers..., head]`` table) to period-instance spans."""
    L = len(x) + 1
    expect = cfg.n_layers + 2
    if L != expect:
        raise ValueError(
            f"partition is over {L} profile layers but arch {cfg.name!r} "
            f"profiles to {expect} ([embed] + {cfg.n_layers} layers + [head])")
    plen = cfg.period_len
    spans = []
    stages = stages_of(tuple(x))
    for s, (lo, hi) in enumerate(stages):
        lo_l = max(lo, 1) - 1          # first model layer in the stage
        hi_l = min(hi, cfg.n_layers) - 1   # last model layer (inclusive)
        if lo_l > hi_l:                # embed-only or head-only stage
            inst_lo = inst_hi = 0 if lo == 0 else cfg.n_periods
        else:
            if lo_l % plen != 0:
                raise ValueError(
                    f"stage {s} starts mid-period (layer {lo_l}, period_len={plen}); "
                    "numeric execution needs period-aligned cuts")
            if hi_l != cfg.n_layers - 1 and (hi_l + 1) % plen != 0:
                raise ValueError(
                    f"stage {s} ends mid-period (layer {hi_l}, period_len={plen}); "
                    "numeric execution needs period-aligned cuts")
            inst_lo = lo_l // plen
            inst_hi = -(-(hi_l + 1) // plen)
        spans.append(StageSpan(
            index=s, n_stages=len(stages), inst_lo=inst_lo, inst_hi=inst_hi,
            owns_embed=(lo == 0), owns_head=(hi == L - 1),
        ))
    return spans


def stage_layers(span: StageSpan, layers):
    """Stage ``span``'s period instances of ``layers``: the whole model's
    stacked layers (sliced here) or already the stage's own, as
    :func:`stage_share` ships them to a worker process.  (A stack of the
    stage's own instances is shorter than ``inst_hi`` unless the stage
    starts at instance 0, where slicing leaves it whole.)"""
    lead = tree_leaves(layers)[0].shape[0]
    own = span.inst_hi - span.inst_lo
    if lead >= span.inst_hi:
        return tree_map(lambda a: a[span.inst_lo:span.inst_hi], layers)
    if lead == own:
        return layers
    raise ValueError(f"layers stack {lead} instances: neither the model's "
                     f"(at least {span.inst_hi}) nor stage {span.index}'s {own}")


def stage_share(cfg: ArchConfig, span: StageSpan, full_params: dict) -> dict:
    """The entries of ``full_params`` (``registry.init_params`` layout) that
    a training or serving worker of stage ``span`` reads, its layers sliced:
    what a worker in another process is shipped."""
    out: Dict[str, Any] = {}
    if span.owns_embed or cfg.tie_embeddings:
        out["embed"] = full_params["embed"]
    if span.owns_head:
        out["final_norm"] = full_params["final_norm"]
        if not cfg.tie_embeddings:
            out["head"] = full_params["head"]
    if span.inst_hi > span.inst_lo:
        out["layers"] = stage_layers(span, full_params["layers"])
    return out


def _value(aux) -> float:
    """The host value of a stage's aux loss (a stage without a router has
    none: 0.0, as JAX's zero)."""
    return 0.0 if aux is None else float(aux.detach())


def _structure(tree):
    return tree_map(lambda _: None, tree)


class StageWorker:
    """One serverless function: params + optimizer state for a stage span,
    one of the stage's ``replicas``."""

    def __init__(self, cfg: ArchConfig, span: StageSpan, full_params: dict, *,
                 mu: int, replicas: int, optimizer, remat: bool = False,
                 use_kernels: bool = False, device="cuda"):
        if cfg.frontend != "none":
            raise NotImplementedError(
                "runtime numeric execution covers token-LM archs; "
                f"frontend={cfg.frontend!r} is not wired up")
        if cfg.tie_embeddings and span.n_stages > 1:
            raise NotImplementedError(
                "tied embeddings span two stages; untie or use a single stage")
        self.cfg = cfg
        self.span = span
        self.mu = mu
        self.replicas = replicas
        self.optimizer = optimizer
        self.remat = remat
        self.use_kernels = use_kernels
        self.device = resolve_device(device)

        p: Dict[str, Any] = {}
        if span.owns_embed:
            p["embed"] = full_params["embed"]
        if span.owns_head:
            p["final_norm"] = full_params["final_norm"]
            if not cfg.tie_embeddings:
                p["head"] = full_params["head"]
        if span.inst_hi > span.inst_lo:
            p["layers"] = stage_layers(span, full_params["layers"])
            self.mask = registry.active_mask(cfg)[span.inst_lo:span.inst_hi]
        else:
            self.mask = None
        leaves = tree_leaves(p)
        dtypes = {a.dtype for a in leaves}
        if len(dtypes) > 1:
            raise ValueError(f"stage {span.index}'s params mix dtypes {sorted(map(str, dtypes))}")
        shapes = [tuple(a.shape) for a in leaves]
        self._sizes = [a.numel() for a in leaves]
        self.grad_nbytes = float(sum(self._sizes)) * 4  # fp32 sync payload
        offsets, total = [], 0
        for n in self._sizes:
            offsets.append(total)
            total += -(-n // LEAF_ALIGN) * LEAF_ALIGN
        grad_offsets = [0, *itertools.accumulate(self._sizes)][:-1]
        self._table = LeafTable(zip(grad_offsets, offsets, self._sizes), self.device)

        def views(buf):
            return [buf[o:o + n].view(shape)
                    for o, n, shape in zip(offsets, self._sizes, shapes)]

        # fp32 masters + optimizer state, flat (replicas hold identical
        # copies); the worker's own copy of its params, so an update in
        # place touches neither the caller's tensors nor another replica's
        master = torch.zeros(total, dtype=torch.float32, device=self.device)
        self._state = {"master": master, **optimizer.init_state(master)}
        for dst, src in zip(views(master), leaves):
            dst.copy_(src)
        dtype = dtypes.pop() if dtypes else torch.float32
        self._params = None
        if dtype != torch.float32:
            self._params = torch.zeros(total, dtype=dtype, device=self.device)
            for dst, src in zip(views(self._params), leaves):
                dst.copy_(src)
        by_key = {k: views(buf) for k, buf in self._state.items()}
        self.params = tree_unflatten(p, views(master if self._params is None else self._params))
        self.opt_state = tree_unflatten(
            p, [{k: by_key[k][i] for k in self._state} for i in range(len(leaves))])
        # AdamW on a card with the kernels: one launch a step
        self._kernel = (use_kernels and self.device.type == "cuda"
                        and type(optimizer) is AdamW)

        self._saved: Dict[int, Any] = {}
        self._grad_flat: Optional[torch.Tensor] = None   # fp32 [sum(_sizes)]

    # ------------------------------------------------------------- stage math
    def _stage_fn(self, params, x, batch_mb):
        """The stage's math -> (out, aux): the boundary activation or, on the
        last stage, the micro-batch CE; aux is the stage's MoE router loss
        (None without a router)."""
        cfg = self.cfg
        aux = None
        if self.span.owns_embed:
            x = registry.embed_inputs(cfg, params, batch_mb)
        if self.mask is not None:
            positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
            x, aux = scan_forward(params["layers"], x, self.mask, cfg=cfg,
                                  positions=positions, use_kernels=self.use_kernels)
        if self.span.owns_head:
            h = rms_norm(x, params["final_norm"], cfg.norm_eps)
            head_w = params["embed"] if cfg.tie_embeddings else params["head"]
            logits = h @ head_w.T
            labels = batch_mb["labels"]
            if cfg.causal and not cfg.is_encoder:
                logits = logits[:, :-1]
                labels = labels[:, 1:]
            return torch.mean(softmax_cross_entropy(logits, labels)), aux
        return x, aux

    def _graph(self, x_in, batch_mb):
        """Run the stage with autograd on: (param leaves, input, out, aux)."""
        leaves = [a.detach().requires_grad_() for a in tree_leaves(self.params)]
        params = tree_unflatten(self.params, leaves)
        x = None
        if not self.span.owns_embed:
            x = x_in.detach().requires_grad_()
        with torch.enable_grad():
            out, aux = self._stage_fn(params, x, batch_mb)
        return leaves, x, out, aux

    def _batch(self, batch_mb):
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch_mb.items()}

    # ---------------------------------------------------------------- fwd/bwd
    @ranged(FWD)
    def forward(self, m: int, x_in, batch_mb) -> Tuple[torch.Tensor, float]:
        """Run the stage on micro-batch ``m``.  Returns (output, aux): the
        boundary activation, or the micro-batch CE on the last stage; aux is
        the stage's MoE router loss (0.0 for a stage without a router)."""
        batch_mb = self._batch(batch_mb)
        if self.remat:
            with torch.no_grad():
                out, aux = self._stage_fn(self.params, x_in, batch_mb)
            self._saved[m] = (x_in, batch_mb)
            return out, _value(aux)
        leaves, x, out, aux = self._graph(x_in, batch_mb)
        self._saved[m] = (leaves, x, out, aux)      # the residuals, until backward
        return out.detach(), _value(aux)

    @ranged(BWD)
    def backward(self, m: int, g_out) -> Optional[torch.Tensor]:
        """Backward of micro-batch ``m``.  ``g_out`` is the cotangent from
        stage s+1 (ignored on the last stage, which seeds its CE with
        ``1/mu``); the stage's aux is seeded with ``1/mu`` on every stage,
        as the JAX worker seeds it.  Returns the cotangent for stage s-1
        (None on stage 0)."""
        saved = self._saved.pop(m)
        leaves, x, out, aux = self._graph(*saved) if self.remat else saved
        inv_mu = torch.full((), 1.0 / self.mu, dtype=torch.float32, device=out.device)
        outs, seeds = [out], [inv_mu if self.span.owns_head else g_out]
        if aux is not None:
            outs.append(aux)
            seeds.append(inv_mu)
        inputs = leaves + ([x] if x is not None else [])
        grads = torch.autograd.grad(outs, inputs, grad_outputs=seeds, allow_unused=True)
        first = self._grad_flat is None
        if first:
            self._grad_flat = torch.empty(sum(self._sizes), dtype=torch.float32,
                                          device=self.device)
        # the first micro-batch's gradient cast into its slice, later ones
        # added in fp32 (the cast is exact: g.float() then an fp32 add)
        for acc, g in zip(torch.split(self._grad_flat, self._sizes), grads):
            if g is None:
                if first:
                    acc.zero_()
            elif first:
                acc.copy_(g.reshape(-1))
            else:
                acc.add_(g.reshape(-1))
        return grads[-1] if x is not None else None

    # ------------------------------------------------------------ checkpoints
    def export_state(self) -> dict:
        """The stage's persistent state: params + fp32 masters + optimizer
        moments.  Saved graphs and gradient accumulators are per step."""
        return {"params": self.params, "opt_state": self.opt_state}

    def state_like(self) -> dict:
        """The state a checkpoint restores into (its layout and device)."""
        return self.export_state()

    def load_state(self, state: dict) -> None:
        """Restore from :meth:`export_state` at a step boundary, copying
        into the worker's buffers; clears every transient accumulator."""
        for key in ("params", "opt_state"):
            if _structure(state[key]) != _structure(getattr(self, key)):
                raise ValueError(
                    f"checkpointed stage state does not match stage {self.span.index}")
        pairs = [(dst, torch.as_tensor(src)) for key in ("params", "opt_state")
                 for dst, src in zip(tree_leaves(getattr(self, key)), tree_leaves(state[key]))]
        for dst, src in pairs:
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"checkpointed leaf {tuple(src.shape)} {src.dtype} does not match "
                    f"stage {self.span.index}'s {tuple(dst.shape)} {dst.dtype}")
        for dst, src in pairs:
            dst.copy_(src)
        self._saved.clear()
        self._grad_flat = None

    # ------------------------------------------------------------------- sync
    def grad_vector(self) -> torch.Tensor:
        """Accumulated stage gradient, flattened fp32 in ``jax.tree.flatten``
        order on the worker's device (the scatter-reduce payload): the
        accumulator itself, handed over, so a stage never holds its gradient
        twice."""
        if self._grad_flat is None:
            raise RuntimeError("backward() must run first")
        vec, self._grad_flat = self._grad_flat, None
        return vec

    @ranged(OPTIMIZER)
    def apply_update(self, reduced: torch.Tensor, step: int) -> None:
        """Optimizer step, in place, from the flat fp32 gradient summed over
        the stage's replicas (divided by ``replicas`` here)."""
        if reduced.numel() != sum(self._sizes):
            raise ValueError(f"gradient of {reduced.numel()} values for "
                             f"{sum(self._sizes)} parameters")
        grad = reduced.to(self.device)
        self._grad_flat = None
        ops.adamw_(self.optimizer, grad, self._state, self._params, self._table,
                   step=step, replicas=self.replicas, impl="auto" if self._kernel else "ref")


def assemble_params(cfg: ArchConfig, workers: List[StageWorker]) -> dict:
    """Monolithic ``registry.init_params``-layout params from one replica's
    stage workers."""
    out: Dict[str, Any] = {}
    layer_parts = [w.params["layers"] for w in workers if "layers" in w.params]
    if layer_parts:
        out["layers"] = tree_map(lambda *parts: torch.cat(parts, dim=0), *layer_parts)
    for w in workers:
        if w.span.owns_embed:
            out["embed"] = w.params["embed"]
        if w.span.owns_head:
            out["final_norm"] = w.params["final_norm"]
            if not cfg.tie_embeddings:
                out["head"] = w.params["head"]
    return out
