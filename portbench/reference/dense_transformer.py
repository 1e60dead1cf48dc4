"""Plain PyTorch reference of the dense transformer family: a pre-norm stack
of RMSNorm, multi-head attention with RoPE (causal or unmasked) and a SwiGLU
FFN, an RMSNorm and an untied head, trained with AdamW on fp32 parameters.

It follows the configuration file alone.  Every tensor is float32 and every
matmul runs with TF32 off (``precision="fp32"``).  ``precision="fp8"`` is
the control: each matmul's operands, and the embedding table, rounded to
float8 (e4m3 forward, e5m2 gradients) with a per-tensor scale, the rest
unchanged.  The batch is taken in blocks of rows, its gradient summed in
fp32, so the sizes that are timed fit beside nothing else on the card.

The parameter layout is the stacked one the weights are made in
(``leaves``): per-layer leaves carry the layer on axis 0.  Readings name
each layer's slice ``<leaf>#<layer>``.

What the harness reads of a family's reference: ``sizes``, ``leaves``,
``train``, ``step_flops`` (a step's model FLOPs by ``flops.py``'s rules)
and ``TINY`` (the configuration keys a CPU test sets to shrink a cell).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench import flops

FP8_FWD = torch.float8_e4m3fn
FP8_BWD = torch.float8_e5m2
#: the widths and depth a CPU test runs a cell of this family at
TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4, head_dim=16,
            intermediate_size=128, num_hidden_layers=2, vocab_size=256)


def sizes(cfg: dict) -> dict:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return {
        "d": d, "H": H, "Hkv": cfg.get("num_key_value_heads", H),
        "hd": cfg.get("head_dim", d // H), "f": cfg["intermediate_size"],
        "L": cfg["num_hidden_layers"], "V": cfg["vocab_size"],
        "eps": cfg.get("rms_norm_eps", cfg.get("layer_norm_eps")),
        "theta": cfg["rope_theta"], "causal": cfg["causal"],
        "shift": cfg["objective"] == "next_token",
    }


def leaves(cfg: dict) -> List[tuple]:
    """(dotted name, shape, init scale) of every parameter, in the stacked
    layout; scale 0 is a zero-initialised norm scale."""
    z = sizes(cfg)
    d, H, Hkv, hd, f, L, V = (z[k] for k in ("d", "H", "Hkv", "hd", "f", "L", "V"))
    out_scale = 0.02 / math.sqrt(max(1, L))
    return [
        ("embed", (V, d), 0.02),
        ("final_norm", (d,), 0.0),
        ("head", (V, d), 0.02),
        ("layers.0.norm1", (L, d), 0.0),
        ("layers.0.mixer.wq", (L, d, H * hd), 0.02),
        ("layers.0.mixer.wk", (L, d, Hkv * hd), 0.02),
        ("layers.0.mixer.wv", (L, d, Hkv * hd), 0.02),
        ("layers.0.mixer.wo", (L, H * hd, d), out_scale),
        ("layers.0.norm2", (L, d), 0.0),
        ("layers.0.ff.w_gate", (L, d, f), 0.02),
        ("layers.0.ff.w_up", (L, d, f), 0.02),
        ("layers.0.ff.w_down", (L, f, d), out_scale),
    ]


def matmul_params(z: dict) -> int:
    """Parameters that enter a matmul: the layers' projections and the head."""
    d, H, Hkv, hd, f, L, V = (z[k] for k in ("d", "H", "Hkv", "hd", "f", "L", "V"))
    per_layer = d * H * hd + 2 * d * Hkv * hd + H * hd * d + 3 * d * f
    return L * per_layer + V * d


def step_flops(cfg: dict, rows: int, seq: int) -> float:
    """Model FLOPs of one training step over ``rows`` rows of ``seq`` tokens."""
    z = sizes(cfg)
    attn_fwd = 4.0 * flops.pairs(seq, z["causal"]) * z["H"] * z["hd"] * rows * z["L"]
    return flops.model_flops(matmul_params(z), rows * seq) + 3.0 * attn_fwd


def stacked(name: str) -> bool:
    return name.startswith("layers.")


def per_layer_norms(name: str, t: torch.Tensor) -> Dict[str, float]:
    """The norm of each layer's slice of a stacked leaf (or of the leaf)."""
    if not stacked(name):
        return {name: float(torch.linalg.vector_norm(t, dtype=torch.float64))}
    n = torch.linalg.vector_norm(t.reshape(t.shape[0], -1), dim=1, dtype=torch.float64)
    return {f"{name}#{i}": float(v) for i, v in enumerate(n.tolist())}


# ------------------------------------------------------------------ the control
def _q(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` with a per-tensor scale, back in fp32."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q(a, FP8_FWD), _q(b, FP8_FWD)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _q(g, FP8_BWD)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def _mm(a, b, precision: str):
    return a @ b if precision == "fp32" else _Fp8Matmul.apply(a, b)


# -------------------------------------------------------------------- the model
def _rms(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + w)


def _rope(x, theta):
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, causal, precision):
    """q [B,S,H,hd], k/v [B,S,Hkv,hd] -> [B,S,H*hd]."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    if rep > 1:
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))          # [B,H,S,hd]
    s = _mm(q, k.transpose(-1, -2), precision) / math.sqrt(hd)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    o = _mm(torch.softmax(s, dim=-1), v, precision)
    return o.transpose(1, 2).reshape(B, S, H * hd)


def _loss_sum(z, p, tokens, precision):
    """Summed cross entropy of one block of rows."""
    B, S = tokens.shape
    table = p["embed"]
    if precision != "fp32":
        table = table + (_q(table, FP8_FWD) - table).detach()
    x = table[tokens.long()]
    for i in range(z["L"]):
        h = _rms(x, p["layers.0.norm1"][i], z["eps"])
        q = _mm(h, p["layers.0.mixer.wq"][i], precision).reshape(B, S, z["H"], z["hd"])
        k = _mm(h, p["layers.0.mixer.wk"][i], precision).reshape(B, S, z["Hkv"], z["hd"])
        v = _mm(h, p["layers.0.mixer.wv"][i], precision).reshape(B, S, z["Hkv"], z["hd"])
        q, k = _rope(q, z["theta"]), _rope(k, z["theta"])
        a = _attention(q, k, v, z["causal"], precision)
        x = x + _mm(a, p["layers.0.mixer.wo"][i], precision)
        h = _rms(x, p["layers.0.norm2"][i], z["eps"])
        g = _mm(h, p["layers.0.ff.w_gate"][i], precision)
        u = _mm(h, p["layers.0.ff.w_up"][i], precision)
        x = x + _mm(torch.nn.functional.silu(g) * u, p["layers.0.ff.w_down"][i], precision)
    h = _rms(x, p["final_norm"], z["eps"])
    logits = _mm(h, p["head"].T, precision)
    labels = tokens.long()
    if z["shift"]:
        logits, labels = logits[:, :-1], labels[:, 1:]
    return torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                             labels.reshape(-1), reduction="sum")


def train(cfg: dict, weights: Dict[str, torch.Tensor], batches: List[torch.Tensor],
          opt: dict, *, rows_per_block: int, precision: str = "fp32") -> dict:
    """Train ``len(batches)`` AdamW steps from ``weights`` (the stacked
    leaves as made, any dtype) on token batches [rows, seq].  Returns each
    step's mean loss, the first step's gradient norm of each layer's leaf,
    and the norm of each leaf's change after the last step."""
    if precision not in ("fp32", "fp8"):
        raise ValueError(precision)
    z = sizes(cfg)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        p = {n: w.float().clone().requires_grad_() for n, w in weights.items()}
        m = {n: torch.zeros_like(t) for n, t in p.items()}
        v = {n: torch.zeros_like(t) for n, t in p.items()}
        b1, b2, eps, lr, wd = (opt[k] for k in ("b1", "b2", "eps", "lr", "weight_decay"))
        losses, grad_norms = [], {}
        for step, tokens in enumerate(batches):
            rows, S = tokens.shape
            count = rows * (S - 1 if z["shift"] else S)
            total = torch.zeros((), dtype=torch.float64, device=tokens.device)
            for lo in range(0, rows, rows_per_block):
                loss = _loss_sum(z, p, tokens[lo:lo + rows_per_block], precision) / count
                loss.backward()
                total += loss.detach().double()
            losses.append(float(total))
            with torch.no_grad():
                if step == 0:
                    for n, t in p.items():
                        grad_norms.update(per_layer_norms(n, t.grad))
                t_ = step + 1
                for n, t in p.items():
                    g = t.grad
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    upd = (m[n] / (1 - b1 ** t_)) / (torch.sqrt(v[n] / (1 - b2 ** t_)) + eps)
                    t.sub_(lr * (upd + wd * t))
                    t.grad = None
        del m, v
        change_norms = {}
        with torch.no_grad():
            for n, t in p.items():
                change_norms.update(per_layer_norms(n, t - weights[n].float()))
        return {"losses": losses, "grad_norms": grad_norms, "change_norms": change_norms}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
