"""CUDA AdamW over a stage worker's flat fp32 state: bind and launch.

The kernel (``csrc/adamw.cu``) replaces no TPU kernel: it is
``optim.AdamW.update`` followed by the cast to the parameters' dtype, for
every leaf of a stage, in one in-place pass over the flat master, m and v
buffers that ``serverless.runtime.worker.StageWorker`` owns.  Its bits equal
the plain path's on the card (``kernels.ref.flat_update_ref_``): the step's
constants are float32 values computed here as PyTorch's kernels compute
them (see the source's note).

``LAUNCHES`` counts launches, one per call, so a run can show that its
optimizer steps went through the kernel.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build as _build
from repro_torch.optim.optimizers import AdamW

#: launches since the last reset (see ``kernels.ops``)
LAUNCHES = 0


class LeafTable:
    """Where each leaf of a stage lies: its first element in the unpadded
    gradient vector, its first element in the padded flat state, and its
    element count.  Held on the host (``rows``, for the plain path and the
    checks) and as an int64 [L, 3] tensor on the state's device
    (``device_rows``, which the kernel reads), made once."""

    def __init__(self, rows: Iterable[Tuple[int, int, int]], device):
        self.rows = tuple((int(g), int(s), int(n)) for g, s, n in rows)
        self.device_rows = torch.tensor(self.rows, dtype=torch.int64).reshape(-1, 3).to(device)
        self.grad_numel = max((g + n for g, _, n in self.rows), default=0)
        self.state_numel = max((s + n for _, s, n in self.rows), default=0)


def build():
    """Compile (if needed) and load the kernel library; idempotent."""
    P, I, F = _build.P, _build.I, _build.F
    return _build.load("adamw", {"repro_adamw": [P, I] + [P] * 5 + [F] * 10 + [P]})


def step_constants(opt, step: int, replicas: int) -> Tuple[float, ...]:
    """The kernel's float32 constants for ``opt`` (an ``AdamW``) at
    ``step``: 1/d, b1, 1 - b1, b2, 1 - b2, the reciprocals of the two bias
    corrections, eps, weight decay and lr.  A Python scalar reaches PyTorch's
    kernels as a double rounded to float32 (so ``1 - b1`` is taken in
    double); a division by a CPU scalar is a multiplication by its float32
    reciprocal."""
    f32 = np.float32
    bc1, bc2 = opt.bias_corrections(step)
    return tuple(float(x) for x in (
        f32(1.0) / f32(replicas), f32(opt.b1), f32(1 - opt.b1), f32(opt.b2), f32(1 - opt.b2),
        f32(1.0) / f32(bc1.item()), f32(1.0) / f32(bc2.item()),
        f32(opt.eps), f32(opt.weight_decay), f32(opt.lr)))


def adamw_(opt, grad: torch.Tensor, state: Dict[str, torch.Tensor],
           param: Optional[torch.Tensor], table: LeafTable, *, step: int,
           replicas: int = 1) -> None:
    """Launch the kernel: ``grad`` the reduced fp32 gradient (summed over
    ``replicas``), ``state`` the flat fp32 ``master``, ``m`` and ``v``
    updated in place, ``param`` the flat bf16 parameters written from the
    new masters (None where the parameters are the fp32 masters), all
    contiguous on one CUDA device, the state and param 16-byte aligned;
    ``table`` their leaves, each state offset a multiple of 4."""
    global LAUNCHES
    if type(opt) is not AdamW:
        raise TypeError(f"the kernel steps AdamW, not {type(opt).__name__}")
    if set(state) != {"master", "m", "v"}:
        raise ValueError(f"state keys {sorted(state)}: expected master, m, v")
    bufs = [state["master"], state["m"], state["v"]]
    if any(t.dtype != torch.float32 for t in [grad, *bufs]):
        raise ValueError("grad, master, m and v must be float32")
    if param is not None and param.dtype != torch.bfloat16:
        raise ValueError(f"param dtype {param.dtype}: the kernel writes bfloat16 "
                         "(fp32 parameters are the masters: pass None)")
    n_state = bufs[0].numel()
    if any(b.numel() != n_state for b in bufs[1:]) or (
            param is not None and param.numel() != n_state):
        raise ValueError("master, m, v and param must have one length")
    if table.grad_numel > grad.numel() or table.state_numel > n_state:
        raise ValueError(f"leaf table reaches {table.grad_numel} gradient and "
                         f"{table.state_numel} state elements; have {grad.numel()} "
                         f"and {n_state}")
    if any(s % 4 for _, s, _ in table.rows):
        raise ValueError("every leaf's state offset must be a multiple of 4")
    dev = grad.device
    tensors = [grad, *bufs, table.device_rows] + ([] if param is None else [param])
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("grad, state, param and the leaf table must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("grad, state, param and the leaf table must be contiguous")
    if any(t.data_ptr() % 16 for t in bufs + ([] if param is None else [param])):
        raise ValueError("master, m, v and param must be 16-byte aligned (16-byte loads)")
    lib = build()
    # an operator's range around the launch: torch.profiler links a kernel
    # to the innermost operator open at its launch, and a user range such
    # as funcpipe/optimizer is none (torch's compiler marks its own kernels'
    # launches the same way)
    with torch.cuda.device(dev), torch._C._profiler._RecordFunctionFast("repro_torch::adamw"):
        err = lib.repro_adamw(
            table.device_rows.data_ptr(), len(table.rows), grad.data_ptr(),
            *(b.data_ptr() for b in bufs), None if param is None else param.data_ptr(),
            *step_constants(opt, step, replicas), _build.stream_of(grad))
    if err != 0:
        raise RuntimeError(f"adamw launch failed: cudaError {err}")
    with _build.COUNT_LOCK:
        LAUNCHES += 1
