"""Shared model building blocks (``repro.models.common`` in torch).

Plain functions on tensors.  The layer functions are shape driven: they
take possibly tensor-parallel sliced parameters and a :class:`ParallelCtx`
whose hooks are the mesh's collectives; with the default ``LOCAL_CTX`` every
hook is the identity and they are ordinary single-device modules.  Where the JAX package uses ``jax.tree`` over
parameter and cache pytrees, the port uses :func:`tree_map` and
:func:`tree_leaves` below, which flatten the same containers (dicts in
sorted key order, tuples and named tuples in order) so leaf order carries
over.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch


# --------------------------------------------------------------------- context
def _identity(x):
    return x


@dataclasses.dataclass
class ParallelCtx:
    """Collective hooks.  Defaults are single-device no-ops.

    tp_size / psum_tp: tensor parallelism within a pipeline stage (the tp
                       group of the rank mesh's ``model`` axis).
    dp_size / ep_all_to_all: expert parallelism over the ``data`` axis.
    seq_shards / psum_seq / pmax_seq: KV sequence sharding over ``data`` for
                       long-context decode (partial-softmax combination);
                       seq_index is this rank's shard.
    """

    tp_size: int = 1
    dp_size: int = 1
    seq_shards: int = 1
    psum_tp: Callable[[Any], Any] = _identity
    ep_all_to_all: Optional[Callable[[Any], Any]] = None  # split/concat experts
    ep_all_to_all_back: Optional[Callable[[Any], Any]] = None
    psum_seq: Callable[[Any], Any] = _identity
    pmax_seq: Optional[Callable[[Any], Any]] = None
    seq_index: int = 0


LOCAL_CTX = ParallelCtx()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA is the default everywhere;
    asking for it without a card raises (the port never falls back to the
    CPU on its own — the caller asks for ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    return dev


def dtype_of(name: str) -> torch.dtype:
    """torch dtype of an ``ArchConfig.param_dtype`` string."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


# ----------------------------------------------------------------------- trees
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``jax.tree.map`` over dicts, tuples and named tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None) -> list:
    """``jax.tree.leaves``: dict keys in sorted order, tuples in order;
    ``is_leaf`` stops the descent as ``jax.tree``'s argument does."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, tuple):
        return [leaf for x in tree for leaf in tree_leaves(x, is_leaf)]
    return [tree]


def tree_unflatten(like: Any, leaves, is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in :func:`tree_leaves`
    order (``jax.tree.unflatten`` with ``like``'s structure)."""
    it = iter(leaves)

    def build(t):
        if is_leaf is not None and is_leaf(t):
            return next(it)
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, tuple):
            return tuple(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has places for")
    return out


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------- layers
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def init_norm(d: int, dtype, device, n: int) -> torch.Tensor:
    """``n`` stacked norm scales (zeros: the norm multiplies by 1 + scale)."""
    return torch.zeros((n, d), dtype=dtype, device=device)


def dense_init(gen: torch.Generator, shape, dtype, scale: float = 0.02) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in fp32 from ``gen`` (on gen's device), then
    cast — the JAX package's scales; the bits come from torch."""
    return (scale * torch.randn(shape, generator=gen, device=gen.device,
                                dtype=torch.float32)).to(dtype)


# ------------------------------------------------------------------------ rope
def rope_frequencies(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))


_FREQS: dict = {}


def _device_frequencies(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_frequencies`` on ``device``, copied there once: a copy from
    host memory in every layer would synchronise the host with the card."""
    key = (hd, theta, device)
    if key not in _FREQS:
        _FREQS[key] = torch.from_numpy(rope_frequencies(hd, theta)).to(device)
    return _FREQS[key]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, hd]; positions: broadcastable to [..., seq].
    Split-half rotation in fp32."""
    hd = x.shape[-1]
    freqs = _device_frequencies(hd, theta, x.device)  # [hd/2]
    angles = positions[..., :, None].float() * freqs  # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]  # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- cross entropy
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits [..., V] upcast to fp32; labels int [...] -> per-token loss [...]."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold
