"""Operations and bytes of a training step and of the kernels' calls,
counted from shapes: the rules every family's ``step_flops`` and every
kernel's ``count`` (``kernels/``) follow.

``model_flops`` is a frozen copy of ``repro_torch.launch.roofline.
model_flops``' training arithmetic, 6 N D.  A family's ``step_flops``
refines it as a step's model FLOPs: N counts only the parameters that enter
a matmul (the layers' projections and the head, not the embedding lookup or
the norms), and attention adds its query-key pairs as the mask allows them
(``pairs``), 4 x pairs x head dim a head forward, 3 x that forward and
backward.  Recompute is not counted.

A kernel call's operations and bytes are what the algorithm needs: each
input byte read once, each output byte written once, the backward's
products without a recompute of the forward's (flash's backward: dV, dP,
dQ, dK; swiglu's: dx through both weights and both weight gradients).
"""
from __future__ import annotations

BF16 = 2
FP32 = 4


def pairs(seq: int, causal: bool) -> int:
    """Query-key pairs of one row of one head as the mask allows them."""
    return seq * (seq + 1) // 2 if causal else seq * seq


def model_flops(n_params: float, tokens: float) -> float:
    """6 N D: forward and backward of N parameters over D tokens."""
    return 6.0 * n_params * tokens


def flash_call(B: int, S: int, H: int, Hkv: int, hd: int, causal: bool,
               elem: int = BF16) -> dict:
    """One flash attention call, forward and backward: operations and bytes."""
    fwd_ops = 4.0 * pairs(S, causal) * H * hd * B
    q = B * S * H * hd * elem
    kv = B * S * Hkv * hd * elem
    lse = B * H * S * FP32
    fwd_bytes = q + 2 * kv + q + lse                  # q, k, v in; o, lse out
    bwd_bytes = 3 * q + 2 * kv + lse + q + 2 * kv     # q, o, do, k, v, lse in; dq, dk, dv out
    return {"fwd_ops": fwd_ops, "bwd_ops": 2.0 * fwd_ops,
            "fwd_bytes": float(fwd_bytes), "bwd_bytes": float(bwd_bytes)}


def swiglu_call(T: int, d: int, f: int, elem: int = BF16) -> dict:
    """One swiglu call (x [T,d], two weights [d,f] -> [T,f]), forward and
    backward: operations and bytes."""
    fwd_ops = 4.0 * T * d * f
    x, w, h = T * d * elem, d * f * elem, T * f * elem
    return {"fwd_ops": fwd_ops, "bwd_ops": 2.0 * fwd_ops,
            "fwd_bytes": float(x + 2 * w + h),
            "bwd_bytes": float(x + 2 * w + h + x + 2 * w)}  # x, wg, wu, dh in; dx, dwg, dwu out


def least_seconds(ops: float, nbytes: float, peak: dict) -> float:
    """The roofline's least time: the larger of operations over the peak
    rate and bytes over the memory bandwidth."""
    return max(ops / peak["bf16_flops"], nbytes / peak["hbm_bytes_per_s"])
