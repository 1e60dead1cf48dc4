#!/usr/bin/env python3
"""How far the bf16 flash backward's gradients lie from float64 on the
encoders' main path, beside its plain version's and SDPA's.

    python3 tools/flash_grad_errors.py

Runs ``chip_smoke.py``'s ``train_bert`` (bert-large, 24 layers, 2 stages x
2 replicas) and ``train_hubert`` (hubert-xlarge, 48 layers) with their
call checks on, keeps the inputs and cotangent of flash calls 1, 6, 12, 13,
24 and 48 of the first step, and gives for each the max |error| of dq, dk
and dv over the largest float64 gradient: the port's kernel
(``ops.flash_attention``), its plain version (``impl="ref"``: fp32 inside,
one rounding at the end) and ``scaled_dot_product_attention`` pinned to its
flash backend and on its default dispatch.  Prints one JSON line a call, a
line with the card's name and power limit, and the phases' own lines.  Needs
one CUDA card.
"""
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402

KEPT = (1, 6, 12, 13, 24, 48)


class KeepingChecker(smoke.CallChecker):
    """``CallChecker`` that also keeps the inputs and cotangent of the flash
    calls numbered in ``KEPT``."""

    cases: list = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.n_flash = 0

    def flash_attention(self, q, k, v, *, causal=True, window=0, impl="auto"):
        out = super().flash_attention(q, k, v, causal=causal, window=window, impl=impl)
        self.n_flash += 1
        if out.requires_grad and self.n_flash in KEPT:
            case = {"index": self.n_flash, "causal": causal,
                    **{n: t.detach().clone() for n, t in (("q", q), ("k", k), ("v", v))}}
            out.register_hook(lambda g, case=case: case.__setitem__("do", g.detach().clone()))
            KeepingChecker.cases.append(case)
        return out


def _grads(fn, q, k, v, do):
    ts = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fn(*ts)
    return torch.autograd.grad(out, ts, do.to(out.dtype))


def _float64(q, k, v, causal):
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, S, Hkv, Hq // Hkv, hd) * hd ** -0.5, k)
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool, device=q.device).tril(), -torch.inf)
    return torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, -1), v).reshape(B, S, Hq, hd)


def _sdpa(backend, causal):
    from torch.nn.attention import sdpa_kernel

    def fn(q, k, v):
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        G = qh.shape[1] // kh.shape[1]
        kh, vh = (t.repeat_interleave(G, dim=1) for t in (kh, vh))
        if backend is None:
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal).transpose(1, 2)
        with sdpa_kernel(backend):
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal).transpose(1, 2)
    return fn


def report(model: str) -> None:
    from torch.nn.attention import SDPBackend

    for case in KeepingChecker.cases:
        q, k, v, do, causal = (case[n] for n in ("q", "k", "v", "do", "causal"))
        ref = _grads(lambda a, b, c: _float64(a, b, c, causal), q.double(), k.double(),
                     v.double(), do.double())
        ways = {"kernel": lambda a, b, c: smoke.ops.flash_attention(a, b, c, causal=causal),
                "plain": lambda a, b, c: smoke.ops.flash_attention(a, b, c, causal=causal,
                                                                   impl="ref"),
                "sdpa_flash": _sdpa(SDPBackend.FLASH_ATTENTION, causal),
                "sdpa_default": _sdpa(None, causal)}
        got = {name: _grads(fn, q, k, v, do) for name, fn in ways.items()}
        row = {"model": model, "call": case["index"], "shape": list(q.shape), "causal": causal}
        for i, name in enumerate(("dq", "dk", "dv")):
            top = float(ref[i].abs().max())
            row[name] = {"max_abs_float64": top} | {
                way: float((g[i].double() - ref[i]).abs().max()) / top for way, g in got.items()}
        print(json.dumps(row), flush=True)
    KeepingChecker.cases = []


def main() -> None:
    smi = smoke.phase_device()
    smoke.phase_build()
    smoke.CallChecker = KeepingChecker
    smoke.phase_train_bert(smi)
    report("bert-large")
    smoke.phase_train_hubert(smi)
    report("hubert-xlarge")
    print(smi, flush=True)


if __name__ == "__main__":
    main()
