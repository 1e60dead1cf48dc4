"""CUDA fused SwiGLU for Hopper, forward and backward: bind and launch.

The kernels (``csrc/swiglu.cu``) replace the Pallas TPU kernel
``repro.kernels.swiglu.swiglu`` and give it the backward the Pallas kernel
lacks.  :func:`swiglu` is the differentiable entry: a
``torch.autograd.Function`` whose forward launches the fused dual-product
kernel and whose backward launches the backward kernel (g and u recomputed
tile by tile, epilogue ``dg``/``du``), then leaves the three plain matrix
products of the chain rule to ``torch.matmul``.

Each direction has three kernels, and :func:`route` picks one before the
launch from the dtype, the shape and the pointers: ``"wgmma"`` (bf16 on the
tensor cores, fed by TMA), ``"tf32x3"`` (fp32 on the tensor cores, three
TF32 products for each fp32 product, after a split pass into hi and lo
planes) or ``"simt"`` (FMAs on the CUDA cores, for shapes and pointers the
other two cannot take).  ``LAUNCHES`` and ``BWD_LAUNCHES`` count the forward
and backward launches by route, one per call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

ROUTES = ("wgmma", "tf32x3", "simt")
#: launches since the last reset (see ``kernels.ops``), by route
LAUNCHES = dict.fromkeys(ROUTES, 0)
BWD_LAUNCHES = dict.fromkeys(ROUTES, 0)


def build():
    """Compile (if needed) and load the kernel library; idempotent."""
    P, I = _build.P, _build.I
    return _build.load("swiglu", {
        "repro_swiglu_fwd": [P] * 4 + [I] * 4 + [P],
        "repro_swiglu_bwd": [P] * 6 + [I] * 4 + [P],
        "repro_swiglu_wgmma_fwd": [P] * 4 + [I] * 3 + [P],
        "repro_swiglu_wgmma_bwd": [P] * 6 + [I] * 3 + [P],
        "repro_swiglu_wgmma_products": [P] * 5 + [I] * 3 + [P],
        "repro_swiglu_wgmma_smem_bytes": [],
        "repro_swiglu_tf32x3_fwd": [P] * 5 + [I] * 3 + [P],
        "repro_swiglu_tf32x3_bwd": [P] * 7 + [I] * 3 + [P],
        "repro_swiglu_tf32x3_products": [P] * 6 + [I] * 3 + [P],
        "repro_swiglu_tf32x3_split": [P] * 4 + [I] * 3 + [P],
        "repro_swiglu_tf32x3_smem_bytes": [],
    })


def route(dtype: torch.dtype, d: int, f: int, *ptrs: int) -> str:
    """The kernel a call takes, decided before its launch: with every
    pointer 16-byte aligned and rows of a multiple of 16 bytes (TMA's rules:
    global strides multiples of 16 bytes, base addresses 16-byte aligned),
    ``"wgmma"`` for bf16 with d and f multiples of 8 and ``"tf32x3"`` for
    fp32 with d and f multiples of 4; ``"simt"`` for everything else."""
    if all(p % 16 == 0 for p in ptrs):
        if dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0:
            return "wgmma"
        if dtype == torch.float32 and d % 4 == 0 and f % 4 == 0:
            return "tf32x3"
    return "simt"


def workspace(T: int, d: int, f: int, device) -> torch.Tensor:
    """The tf32x3 route's split planes for one call: x's hi and lo [T, d],
    then w_gate's and w_up's hi and lo transposed, [f, d] each."""
    return torch.empty(2 * T * d + 4 * f * d, dtype=torch.float32, device=device)


def _check(x, w_gate, w_up, *rest) -> None:
    if x.dim() != 2 or w_gate.dim() != 2 or w_up.shape != w_gate.shape \
            or w_gate.shape[0] != x.shape[1]:
        raise ValueError(f"expected x [T,d] and w_gate/w_up [d,f], got {tuple(x.shape)}, "
                         f"{tuple(w_gate.shape)}, {tuple(w_up.shape)}")
    if x.shape[0] == 0:
        raise ValueError("swiglu needs at least one row")
    tensors = (x, w_gate, w_up, *rest)
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise ValueError(f"dtypes {[str(t.dtype) for t in tensors]}: expected one of "
                         "float32, bfloat16 for all")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("swiglu's tensors must be contiguous")
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("swiglu's tensors must be on one CUDA device")


def swiglu_fwd(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: x [T,d], w_gate/w_up [d,f] -> [T,f]."""
    _check(x, w_gate, w_up)
    (T, d), f = x.shape, w_gate.shape[1]
    lib = build()
    out = torch.empty((T, f), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), out.data_ptr())
    way = route(x.dtype, d, f, *ptrs)
    with torch.cuda.device(x.device):
        if way == "wgmma":
            err = lib.repro_swiglu_wgmma_fwd(*ptrs, T, d, f, _build.stream_of(x))
        elif way == "tf32x3":
            ws = workspace(T, d, f, x.device)
            err = lib.repro_swiglu_tf32x3_fwd(*ptrs, ws.data_ptr(), T, d, f, _build.stream_of(x))
        else:
            err = lib.repro_swiglu_fwd(*ptrs, T, d, f, _DTYPES[x.dtype], _build.stream_of(x))
    if err != 0:
        raise RuntimeError(f"swiglu forward launch ({way}) failed: cudaError {err}")
    _build.count_launch(LAUNCHES, way)
    return out


def swiglu_bwd(x, w_gate, w_up, dout):
    """Launch the backward kernel -> (dg, du), each [T,f] in x's dtype."""
    _check(x, w_gate, w_up, dout)
    (T, d), f = x.shape, w_gate.shape[1]
    if dout.shape != (T, f):
        raise ValueError(f"dout {tuple(dout.shape)} != ({T}, {f})")
    lib = build()
    dg = torch.empty_like(dout)
    du = torch.empty_like(dout)
    ptrs = (x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), dout.data_ptr(),
            dg.data_ptr(), du.data_ptr())
    way = route(x.dtype, d, f, *ptrs)
    with torch.cuda.device(x.device):
        if way == "wgmma":
            err = lib.repro_swiglu_wgmma_bwd(*ptrs, T, d, f, _build.stream_of(x))
        elif way == "tf32x3":
            ws = workspace(T, d, f, x.device)
            err = lib.repro_swiglu_tf32x3_bwd(*ptrs, ws.data_ptr(), T, d, f, _build.stream_of(x))
        else:
            err = lib.repro_swiglu_bwd(*ptrs, T, d, f, _DTYPES[x.dtype], _build.stream_of(x))
    if err != 0:
        raise RuntimeError(f"swiglu backward launch ({way}) failed: cudaError {err}")
    _build.count_launch(BWD_LAUNCHES, way)
    return dg, du


class SwiGLU(torch.autograd.Function):
    """The kernel pair as one differentiable op; g and u are recomputed in
    the backward, never stored."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up):
        ctx.save_for_backward(x, w_gate, w_up)
        return swiglu_fwd(x, w_gate, w_up)

    @staticmethod
    def backward(ctx, dout):
        x, w_gate, w_up = ctx.saved_tensors
        dg, du = swiglu_bwd(x, w_gate, w_up, dout.contiguous())
        dx = dwg = dwu = None
        if ctx.needs_input_grad[0]:
            dx = dg @ w_gate.T + du @ w_up.T
        if ctx.needs_input_grad[1]:
            dwg = x.T @ dg
        if ctx.needs_input_grad[2]:
            dwu = x.T @ du
        return dx, dwg, dwu


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """Differentiable fused SwiGLU on one CUDA device: x [T,d] -> [T,f]."""
    return SwiGLU.apply(x, w_gate, w_up)
