"""Checkpointing: the Function Manager's checkpoint/restart analog (§3.1 ⑧)
(``repro.checkpoint.ckpt`` for the port).

Serverless functions time out (15 min on Lambda); the paper's Function
Manager checkpoints to storage and relaunches workers.  A stage's
param/optimizer tree is serialized in the JAX package's wire format: a
msgpack map ``{"step", "treedef", "leaves"}`` whose leaves are ``.npy``
buffers, the treedef rendered as ``str(jax.tree.flatten(tree)[1])``
renders it.  For fp32 and integer leaves the bytes equal the JAX
package's, so a blob packed by either package restores in the other and
the engine charges the same ``len(blob)`` upload bytes.  A bf16 leaf is
written as the JAX package writes one (descr ``'<V2'``, the raw 2-byte
payload) and restores into a bf16 target here.

Two surfaces:

* file checkpoints (``save_checkpoint``/``restore_checkpoint``): atomic
  tmp-then-rename writes, so a crash mid-write never corrupts the previous
  checkpoint;
* byte-level ``pack_state``/``unpack_state``: the same wire format without
  the file, which the engine puts into the object store under ``ckpt/...``.

Restores validate the leaf count, the recorded treedef string, shapes and
dtypes, and raise :class:`CheckpointError` on any mismatch.  A restore reads
each leaf's payload in place (a view of the blob) and copies it once, onto
the device of the target leaf: a full-width stage's state is gigabytes.
"""
from __future__ import annotations

import ast
import io
import os
import struct
import time
import warnings
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """A checkpoint payload is malformed or does not match the structure it
    is being restored into (treedef / leaf count / shape / dtype)."""


# ------------------------------------------------------------------ msgpack
# The subset of msgpack that checkpoints use, encoded as msgpack-python's
# ``packb(..., use_bin_type=True)`` encodes it: maps, arrays, ints, str and
# bin; anything else is refused.

def _pack_int(v: int, out: List[bytes]) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -32 <= v < 0:
        out.append(struct.pack("b", v))
    elif v >= 0:
        for tag, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < lim:
                out.append(struct.pack(">B", tag) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int {v} does not fit msgpack's uint64")
    else:
        for tag, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                              (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                out.append(struct.pack(">B", tag) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int {v} does not fit msgpack's int64")


def _pack_len(n: int, fix: Optional[Tuple[int, int]], tags, out: List[bytes]) -> None:
    """A length header: the fix form ``(base, limit)`` when ``n`` fits, else
    the smallest of ``tags`` ((tag, struct fmt, limit) ...)."""
    if fix is not None and n < fix[1]:
        out.append(struct.pack("B", fix[0] | n))
        return
    for tag, fmt, lim in tags:
        if n < lim:
            out.append(struct.pack(">B", tag) + struct.pack(fmt, n))
            return
    raise OverflowError(f"msgpack length {n} too large")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARR = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))


def _pack(obj: Any, out: List[Any]) -> None:
    if isinstance(obj, int) and not isinstance(obj, bool):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), (0xA0, 32), _STR, out)
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _pack_len(memoryview(obj).nbytes, None, _BIN, out)
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), (0x90, 16), _ARR, out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), (0x80, 16), _MAP, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def msgpack_pack(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the subset above; a
    bin payload is copied once, into the result."""
    out: List[Any] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack payload")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _unpack(r: _Reader) -> Any:
    tag = r.unpack(">B")
    if tag < 0x80:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if 0x80 <= tag <= 0x8F:
        return _unpack_map(r, tag & 0x0F)
    if 0x90 <= tag <= 0x9F:
        return [_unpack(r) for _ in range(tag & 0x0F)]
    if 0xA0 <= tag <= 0xBF:
        return str(r.take(tag & 0x1F), "utf-8")
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if tag in ints:
        return r.unpack(ints[tag])
    lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
            0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
    if tag not in lens:
        raise ValueError(f"unsupported msgpack type byte 0x{tag:02x}")
    n = r.unpack(lens[tag])
    if tag in (0xD9, 0xDA, 0xDB):
        return str(r.take(n), "utf-8")
    if tag in (0xC4, 0xC5, 0xC6):
        return r.take(n)                 # bin: a view of the payload, no copy
    if tag in (0xDC, 0xDD):
        return [_unpack(r) for _ in range(n)]
    return _unpack_map(r, n)


def _unpack_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def msgpack_unpack(blob) -> Any:
    """Decode one msgpack object filling ``blob``; bin values come back as
    memoryviews into ``blob`` (no copy)."""
    r = _Reader(memoryview(blob).cast("B"))
    obj = _unpack(r)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of extra data after the payload")
    return obj


# ------------------------------------------------------------------ treedef
def _render(tree: Any) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_render(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_render(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_render(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def treedef_str(tree: Any) -> str:
    """``str(jax.tree.flatten(tree)[1])`` for trees of dicts (sorted keys),
    lists, tuples, None and leaves."""
    return f"PyTreeDef({_render(tree)})"


def _flatten(tree: Any) -> list:
    """Leaves in ``jax.tree.flatten`` order (None is a node, not a leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]


# ---------------------------------------------------------------------- npy
_BF16_DESCR = "<V2"     # how numpy's save writes an ml_dtypes bfloat16 array


def _npy_name(dtype: torch.dtype) -> str:
    return "bfloat16" if dtype == torch.bfloat16 else str(dtype).removeprefix("torch.")


def _npy_buffers(leaf) -> Tuple[bytes, Any]:
    """A leaf's ``np.save`` header and a buffer of its C-order bytes."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        shape = tuple(t.shape)
        if t.dtype == torch.bfloat16:
            descr = _BF16_DESCR
            data = t.view(torch.int16).numpy()
        else:
            data = t.numpy()
            descr = np.lib.format.dtype_to_descr(data.dtype)
    else:
        data = np.asarray(leaf)
        if not data.flags.c_contiguous:
            buf = io.BytesIO()          # np.save's own layout (Fortran order)
            np.save(buf, data, allow_pickle=False)
            return buf.getvalue(), memoryview(b"")
        shape, descr = tuple(data.shape), np.lib.format.dtype_to_descr(data.dtype)
    head = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        head, {"descr": descr, "fortran_order": False, "shape": shape})
    return head.getvalue(), memoryview(data.reshape(-1)).cast("B")


def _read_npy(buf: memoryview) -> Tuple[str, tuple, memoryview]:
    """(descr, shape, payload view) of one ``.npy`` buffer."""
    if bytes(buf[:6]) != b"\x93NUMPY":
        raise ValueError("missing the .npy magic string")
    major = buf[6]
    if major == 1:
        hlen, start = struct.unpack("<H", buf[8:10])[0], 10
    elif major in (2, 3):
        hlen, start = struct.unpack("<I", buf[8:12])[0], 12
    else:
        raise ValueError(f"unsupported .npy version {major}")
    header = ast.literal_eval(str(buf[start:start + hlen], "latin1"))
    if not isinstance(header, dict) or not {"descr", "shape", "fortran_order"} <= set(header):
        raise ValueError(f"unsupported .npy header {header!r}")
    return (header["descr"], tuple(header["shape"]), bool(header["fortran_order"]),
            buf[start + hlen:])


def _torch_dtype_of(descr) -> Tuple[Optional[torch.dtype], str]:
    """The torch dtype and the numpy name of an npy descr."""
    if descr in (_BF16_DESCR, "|V2"):
        return torch.bfloat16, "bfloat16"
    nd = np.dtype(descr)
    if nd.byteorder == ">":
        return None, str(nd)
    try:
        return torch.from_numpy(np.zeros(0, nd)).dtype, str(nd)
    except TypeError:
        return None, str(nd)


def _target_of(leaf) -> Tuple[tuple, Optional[torch.dtype], str, Any]:
    """(shape, torch dtype, dtype name, device) of a restore target leaf."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype, _npy_name(leaf.dtype), leaf.device
    arr = np.asarray(leaf)
    dt, name = _torch_dtype_of(np.lib.format.dtype_to_descr(arr.dtype))
    return tuple(arr.shape), dt, name, torch.device("cpu")


# ------------------------------------------------------------ wire format
def pack_state(tree: Any, *, step: int = 0) -> bytes:
    """Serialize a tree of tensors (or arrays) to the checkpoint wire format:
    what ``save_checkpoint`` writes to disk and the engine puts under
    ``ckpt/...`` store keys."""
    leaves = _flatten(tree)
    # msgpack's map, written by hand so each leaf's npy header and data go
    # into the blob as two buffers: a leaf is copied once, by the join
    out: List[Any] = []
    _pack_len(3, (0x80, 16), _MAP, out)
    for key, value in (("step", int(step)), ("treedef", treedef_str(tree))):
        _pack(key, out)
        _pack(value, out)
    _pack("leaves", out)
    _pack_len(len(leaves), (0x90, 16), _ARR, out)
    for leaf in leaves:
        head, data = _npy_buffers(leaf)
        _pack_len(len(head) + data.nbytes, None, _BIN, out)
        out += [head, data]
    return b"".join(out)


def unpack_state(blob, like: Any) -> Tuple[Any, int]:
    """Deserialize :func:`pack_state` bytes (either package's) into the
    structure of ``like``, validating treedef, leaf count, shapes and dtypes.
    Each leaf comes back as a tensor on the device of ``like``'s leaf (CPU
    for array targets).  Returns ``(tree, step)``; raises
    :class:`CheckpointError` on any mismatch."""
    try:
        payload = msgpack_unpack(blob)
    except Exception as e:
        raise CheckpointError(f"checkpoint payload is not valid msgpack "
                              f"({type(e).__name__}: {e})") from e
    if not isinstance(payload, dict) or "leaves" not in payload:
        raise CheckpointError("checkpoint payload missing 'leaves'")
    leaves = _flatten(like)
    want_def = treedef_str(like)
    got_def = payload.get("treedef")
    if got_def != want_def:
        raise CheckpointError(
            f"checkpoint treedef does not match the restore target:\n"
            f"  checkpoint: {got_def}\n  target:     {want_def}")
    if len(payload["leaves"]) != len(leaves):
        raise CheckpointError(
            f"checkpoint has {len(payload['leaves'])} leaves, restore "
            f"target has {len(leaves)}")
    out = []
    for i, (buf, ref) in enumerate(zip(payload["leaves"], leaves)):
        try:
            descr, shape, fortran, data = _read_npy(memoryview(buf))
            dtype, name = _torch_dtype_of(descr)
        except Exception as e:
            raise CheckpointError(
                f"checkpoint leaf {i} is not a valid npy buffer "
                f"({type(e).__name__}: {e})") from e
        want_shape, want_dtype, want_name, device = _target_of(ref)
        if shape != want_shape:
            raise CheckpointError(
                f"checkpoint leaf {i} shape {shape} != target shape {want_shape}")
        if dtype is None or dtype != want_dtype:
            raise CheckpointError(
                f"checkpoint leaf {i} dtype {name} != target dtype {want_name}")
        n = int(np.prod(shape, dtype=np.int64))
        itemsize = torch.empty((), dtype=dtype).element_size()
        if data.nbytes != n * itemsize:
            raise CheckpointError(
                f"checkpoint leaf {i} holds {data.nbytes} bytes of data for "
                f"{n} elements of {name}")
        with warnings.catch_warnings():
            # a read-only view of the blob: the copy below is the only one
            warnings.simplefilter("ignore", UserWarning)
            view = (torch.frombuffer(data, dtype=dtype, count=n) if n
                    else torch.empty(0, dtype=dtype))
        # a Fortran-order buffer holds the transpose in C order
        view = (view.reshape(shape[::-1]).permute(*reversed(range(len(shape))))
                if fortran else view.reshape(shape))
        out.append(view.to(device, copy=True))
    return _unflatten_like(like, iter(out)), int(payload.get("step", 0))


def _unflatten_like(node: Any, it) -> Any:
    """``node``'s structure with its leaves taken from ``it`` in
    :func:`_flatten` order.  (Recursion through a module function, not a
    closure: a closure that refers to itself is a reference cycle, which
    would keep the restored leaves alive until the garbage collector ran.)"""
    if node is None:
        return None
    if isinstance(node, dict):          # leaves are in sorted-key order
        return {k: _unflatten_like(node[k], it) for k in sorted(node)}
    if isinstance(node, list):
        return [_unflatten_like(v, it) for v in node]
    if isinstance(node, tuple):
        return tuple(_unflatten_like(v, it) for v in node)
    return next(it)


# -------------------------------------------------------------------- files
def save_checkpoint(path: str, tree: Any, *, step: int = 0) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = pack_state(tree, step=step)
    # atomic publish: a crash between write and replace leaves a stray .tmp
    # but never a torn checkpoint at `path`
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def restore_checkpoint(path: str, like: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (treedef/shapes/dtypes
    validated; :class:`CheckpointError` on mismatch or corruption)."""
    with open(path, "rb") as f:
        blob = f.read()
    return unpack_state(blob, like)


class FunctionManager:
    """Periodic checkpoint/restart policy: the paper restarts workers before
    the 15-minute Lambda timeout.

    Two clocks, same policy: the wall-clock form (``lifetime`` seconds) and
    a step-based form (``lifetime_steps``, used by the engine, whose
    substrate may run on a virtual clock): ``should_restart(steps_since_
    launch)`` says when the engine must checkpoint and relaunch to stay
    under the platform's cap with margin ``safety``."""

    def __init__(self, path: str = "", *, lifetime: float = 15 * 60.0,
                 safety: float = 0.9, lifetime_steps: Optional[int] = None):
        self.path = path
        self.lifetime = lifetime
        self.safety = safety
        self.lifetime_steps = lifetime_steps
        self.started = time.monotonic()
        self.restarts = 0

    def should_checkpoint(self) -> bool:
        return (time.monotonic() - self.started) >= self.lifetime * self.safety

    def should_restart(self, steps_since_launch: int) -> bool:
        """Restart once the next step might cross the cap's safety margin;
        ``max(1, ...)`` guarantees progress under a one-step cap."""
        if self.lifetime_steps is None:
            return False
        budget = max(1, int(self.lifetime_steps * self.safety))
        return steps_since_launch >= budget

    def checkpoint_and_restart(self, tree: Any, step: int) -> None:
        save_checkpoint(self.path, tree, step=step)
        self.restarted()

    def restarted(self) -> None:
        """Record a relaunch (resets both lifetime clocks)."""
        self.started = time.monotonic()
        self.restarts += 1


__all__ = ["CheckpointError", "FunctionManager", "msgpack_pack", "msgpack_unpack",
           "pack_state", "restore_checkpoint", "save_checkpoint", "treedef_str",
           "unpack_state"]
