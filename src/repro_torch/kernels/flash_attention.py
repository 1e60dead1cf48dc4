"""CUDA flash attention for Hopper, forward and backward: bind and launch.

The kernels (``csrc/flash_attention.cu``) replace the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention`` and give it the backward
the Pallas kernel lacks.  :func:`flash_attention` is the differentiable
entry: a ``torch.autograd.Function`` whose forward launches the forward
kernel (output and row log-sum-exp) and whose backward launches the
backward kernels.  Positions are ``arange(S)``, as on the Pallas path.

Each direction has three routes, and :func:`route` picks one before the
launch from the dtype, the head dim and the pointers: ``"wgmma"`` (tensor
cores fed by TMA, bf16 at every head dim), ``"tf32x3"`` (fp32, each product
as three TF32 products that hold fp32's accuracy: through ``mma.sync`` at hd
64-128, through ``wgmma`` at hd 256 after a split pass into hi and lo planes
held in a per-call :func:`workspace`) or ``"simt"`` (fp32 FMAs on the CUDA
cores, for misaligned tensors).
``LAUNCHES`` and ``BWD_LAUNCHES`` count the forward and backward launches by
route (one backward call launches all its passes from one C call).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build

HEAD_DIMS = (64, 80, 96, 128, 256)
TF32X3_HEAD_DIMS = (64, 80, 96, 128, 256)
#: the hd-256 tf32x3 kernels' transposed planes round S up to this (``x3w::kPad``)
TF32X3_PAD = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

ROUTES = ("wgmma", "tf32x3", "simt")
#: launches since the last reset (see ``kernels.ops``), by route
LAUNCHES = dict.fromkeys(ROUTES, 0)
BWD_LAUNCHES = dict.fromkeys(ROUTES, 0)


def build():
    """Compile (if needed) and load the kernel library; idempotent."""
    P, I, F = _build.P, _build.I, _build.F
    return _build.load("flash_attention", {
        "repro_flash_attention_fwd": [P] * 5 + [I] * 8 + [F, P],
        "repro_flash_attention_bwd": [P] * 10 + [I] * 8 + [F, P],
        "repro_flash_wgmma_fwd": [P] * 5 + [I] * 7 + [F, P],
        "repro_flash_wgmma_bwd": [P] * 11 + [I] * 7 + [F, P],
        "repro_flash_wgmma_probe": [P] * 5 + [I] * 2 + [P],
        "repro_flash_wgmma_smem_bytes": [I] * 2,
        "repro_flash_tf32x3_fwd": [P] * 6 + [I] * 7 + [F, P],
        "repro_flash_tf32x3_bwd": [P] * 11 + [I] * 7 + [F, P],
        "repro_flash_tf32x3_probe": [P] * 5 + [I, P],
        "repro_flash_tf32x3_hd256_probe": [P] * 8,
        "repro_flash_tf32x3_smem_bytes": [I] * 2,
    })


def route(dtype: torch.dtype, hd: int, *ptrs: int) -> str:
    """The kernel a call takes, decided before its launch.  With every
    pointer 16-byte aligned: ``"wgmma"`` for bf16 at any of ``HEAD_DIMS``
    (TMA's rules: base addresses 16-byte aligned; the row strides
    ``H * hd * 2`` bytes are multiples of 16 at these head dims),
    ``"tf32x3"`` for fp32 at any of ``TF32X3_HEAD_DIMS`` (16-byte loads;
    at hd 256 the split pass's 16-byte loads).  ``"simt"`` for misaligned
    tensors."""
    if all(p % 16 == 0 for p in ptrs):
        if dtype == torch.bfloat16:
            return "wgmma"
        if hd in TF32X3_HEAD_DIMS:
            return "tf32x3"
    return "simt"


def workspace(B: int, S: int, Hq: int, Hkv: int, hd: int, *, backward: bool,
              device) -> torch.Tensor:
    """The split planes of one tf32x3 call at hd 256 (hi and lo of each),
    natural ones [B, S, H, hd] first, then transposed ones [B, H, hd, S_pad]
    with S_pad = S rounded up to ``TF32X3_PAD``: forward Q, K and V^T;
    backward Q, dO, K, V, Q^T, dO^T and K^T.  Empty below hd 256, where the
    planes live in shared memory."""
    if hd != 256:
        return torch.empty(0, dtype=torch.float32, device=device)
    s_pad = -(-S // TF32X3_PAD) * TF32X3_PAD
    nq, nk = B * S * Hq * hd, B * S * Hkv * hd
    nqt, nkt = B * Hq * hd * s_pad, B * Hkv * hd * s_pad
    n = 4 * nq + 4 * nk + 4 * nqt + 2 * nkt if backward else 2 * nq + 2 * nk + 2 * nkt
    return torch.empty(n, dtype=torch.float32, device=device)


def _check(q, k, v, *rest) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected q [B,S,Hq,hd] and k/v [B,S,Hkv,hd], got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, hd = q.shape
    Bk, Sk, Hkv, hdk = k.shape
    if (Bk, Sk, hdk) != (B, S, hd) or Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v)):
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: expected one of "
                         "float32, bfloat16 for all three")
    tensors = (q, k, v, *rest)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention's tensors must be contiguous")
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("flash_attention's tensors must be on one CUDA device")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0):
    """Launch the forward kernel: q [B,S,Hq,hd], k/v [B,S,Hkv,hd] ->
    (o like q, lse [B,Hq,S] fp32)."""
    _check(q, k, v)
    B, S, Hq, hd = q.shape
    lib = build()
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr())
    way = route(q.dtype, hd, *ptrs)
    args = (B, S, Hq, k.shape[2], hd)
    with torch.cuda.device(q.device):
        if way == "wgmma":
            err = lib.repro_flash_wgmma_fwd(*ptrs, *args, int(causal), int(window), hd ** -0.5,
                                            _build.stream_of(q))
        elif way == "tf32x3":
            ws = workspace(*args, backward=False, device=q.device)
            err = lib.repro_flash_tf32x3_fwd(*ptrs, ws.data_ptr(), *args, int(causal),
                                             int(window), hd ** -0.5, _build.stream_of(q))
        else:
            err = lib.repro_flash_attention_fwd(*ptrs, *args, _DTYPES[q.dtype], int(causal),
                                                int(window), hd ** -0.5, _build.stream_of(q))
    if err != 0:
        raise RuntimeError(f"flash_attention forward launch ({way}) failed: cudaError {err}")
    _build.count_launch(LAUNCHES, way)
    return o, lse


def key_means(k: torch.Tensor) -> torch.Tensor:
    """The keys' mean over the sequence, [B, Hkv, hd] in k's dtype: the
    wgmma and simt dQ passes take dq = scale * sum_j dS_ij (k_j - c) for
    this c.
    That is the same gradient (sum_j dS_ij is zero in exact arithmetic, for
    any c), but with D = rowsum(dO O) from the rounded O and dS rounded to
    bf16 the sum is not zero, and on keys that share a large common
    component (bert-large's deeper layers at init) the uncentred product
    cost dq 4% of its largest value, as much as SDPA's flash backend; a c
    close to the keys removes that term.  One batched product with 1/S
    weights (a reduction over the middle axis took ~0.03 ms at [2, 1024,
    32, 96] on an H100)."""
    B, S = k.shape[0], k.shape[1]
    w = torch.full((B, 1, S), 1.0 / S, dtype=k.dtype, device=k.device)
    return torch.bmm(w, k.reshape(B, S, -1)).view(B, k.shape[2], k.shape[3])


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True, window: int = 0):
    """Launch the backward kernels -> (dq, dk, dv).  On the wgmma and simt
    routes dq is taken against the keys less their mean (:func:`key_means`),
    which changes no gradient but dq's rounding."""
    _check(q, k, v, o, lse, do)
    B, S, Hq, hd = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do {tuple(do.shape)} "
                         f"{do.dtype} must match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, Hq, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [B,Hq,S] float32, got {tuple(lse.shape)} {lse.dtype}")
    lib = build()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr())
    outs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    way = route(q.dtype, hd, *ins, *outs)
    args = (B, S, Hq, k.shape[2], hd)
    with torch.cuda.device(q.device):
        if way != "simt":
            # D = rowsum(dO * O), written by the first of the three passes
            delta = torch.empty_like(lse)
            extra = ()
            if way == "wgmma":
                kmean = key_means(k)
                extra = (kmean.data_ptr(),)
            if way == "tf32x3":
                ws = workspace(*args, backward=True, device=q.device)
                extra = (ws.data_ptr(),)
            err = getattr(lib, f"repro_flash_{way}_bwd")(
                *ins, delta.data_ptr(), *outs, *extra, *args, int(causal), int(window),
                hd ** -0.5, _build.stream_of(q))
        else:
            kmean = key_means(k)
            err = lib.repro_flash_attention_bwd(*ins, *outs, kmean.data_ptr(), *args,
                                                _DTYPES[q.dtype], int(causal), int(window),
                                                hd ** -0.5, _build.stream_of(q))
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch ({way}) failed: cudaError {err}")
    _build.count_launch(BWD_LAUNCHES, way)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The kernel pair as one differentiable op; the backward recomputes P
    from the saved row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Differentiable flash attention on one CUDA device (positions
    ``arange(S)``); output like q."""
    return FlashAttention.apply(q, k, v, bool(causal), int(window))
