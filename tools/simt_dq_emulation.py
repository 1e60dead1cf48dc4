"""The simt flash backward's dQ arithmetic emulated in float64 on the CPU,
with and without the keys'-mean correction.

    python3 tools/simt_dq_emulation.py

At bert-large's attention shape [4, 512, 16 heads, 64] with no mask, q, k
and v sharing a common component per head (``chip_smoke.py``'s
``_simt_dq_correction`` draws the same distribution on the card), the
CUDA-core dQ pass keeps dS in fp32 but takes D = rowsum(dO O) from the
bf16-rounded output, so each row's sum of dS is not zero; times the keys'
common component that term reaches dq.  Prints one JSON line: max |dq -
dq_exact| over max |dq_exact| for the uncorrected product and for the one
less (sum_j dS_ij) times the keys' mean (rounded to bf16, as
``kernels.flash_attention.key_means`` gives it).
"""
import json

import torch

B, S, H, HD = 4, 512, 16, 64


def main() -> None:
    g = torch.Generator().manual_seed(7)

    def rows():
        common = torch.randn(1, 1, H, HD, generator=g)
        return (0.6 * common + 0.3 * torch.randn(B, S, H, HD, generator=g)).to(torch.bfloat16)

    q, k, v = rows(), rows(), rows()
    do = (1e-3 * torch.randn(B, S, H, HD, generator=g)).to(torch.bfloat16)
    scale = HD ** -0.5
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    p = torch.softmax(torch.einsum("bshd,bthd->bhst", qd, kd) * scale, -1)
    o = torch.einsum("bhst,bthd->bshd", p, vd)
    dp = torch.einsum("bshd,bthd->bhst", dod, vd)

    def ds_of(o_used):
        D = (dod * o_used).sum(-1).transpose(1, 2)[..., None]
        return p * (dp - D)

    want = torch.einsum("bhst,bthd->bshd", ds_of(o), kd) * scale
    ds = ds_of(o.to(torch.bfloat16).double())        # D from the rounded output
    c = k.double().mean(1).to(torch.bfloat16).double()   # [B, H, HD]
    plain = torch.einsum("bhst,bthd->bshd", ds, kd) * scale
    fixed = plain - (ds.sum(-1)[..., None] * c[:, :, None, :]).transpose(1, 2) * scale
    top = float(want.abs().max())
    print(json.dumps({"shape": [B, S, H, H, HD], "causal": False,
                      "dq_err_over_max_uncorrected": float((plain - want).abs().max()) / top,
                      "dq_err_over_max_corrected": float((fixed - want).abs().max()) / top}))


if __name__ == "__main__":
    main()
