#!/usr/bin/env python3
"""A/B of flash-attention kernel builds in one call on the card.

    python3 tools/flash_ab.py '{"before": ["old/flash_attention.cu"],
                                "after": ["src/repro_torch/kernels/csrc/flash_attention.cu", "-DX=1"]}'

Each entry names a ``flash_attention.cu`` (and extra ``nvcc`` flags).  All are
built at once with the port's flags, into ``build/ab/``, and swapped in turn
under ``kernels.flash_attention``'s wrappers.  Per build: the tf32x3 kernels'
registers and spills; fp32 parity with the plain version at the training
shape, qwen2.5-14b's GQA shape, a ragged window and a non-causal hd-80 case
(2e-5 outputs, 1e-4 gradients); the forward and backward at the training
shape [2,1024,32,96] causal fp32, timed in the order A, B, ..., B, A as
``chip_smoke.py`` times them; and device ms by kernel.  Needs one CUDA card.
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import build as kb  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CHECKS = [smoke.FLASH_TRAIN, (1, 1024, 40, 8, 128, True, 0), (1, 200, 4, 4, 64, True, 48),
          (2, 128, 4, 4, 80, False, 0)]


def build_all(variants: dict) -> dict:
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [kb._nvcc(), *kb.NVCC_FLAGS, *flags, "-I", str(kb.CSRC), "-o", str(out_dir / f"{name}.so"),
         src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, *flags) in variants.items()}
    spec = {}
    kb.load = lambda name, functions, restype=ctypes.c_int: spec.update(functions)
    fa.build()   # records the entry points' argument types
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(name, "build failed", log[-3000:], flush=True)
            continue
        print(name, json.dumps([(r["entry"], r["registers"], r["spill_bytes"])
                                for r in smoke._kernel_reports(log) if "tf32x3" in r["entry"]]))
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn, argtypes in spec.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_all(json.loads(sys.argv[1]))
    fa.build = None   # each build below is handed to the wrappers in turn

    def use(name):
        fa.build = lambda: libs[name]

    gen = torch.Generator(device="cuda").manual_seed(5)
    for name in libs:
        use(name)
        for B, S, Hq, Hkv, hd, causal, window in CHECKS:
            q, do = (torch.randn(B, S, Hq, hd, generator=gen, device="cuda") for _ in range(2))
            k, v = (torch.randn(B, S, Hkv, hd, generator=gen, device="cuda") for _ in range(2))
            out, grads = smoke._fwd_bwd(lambda a, b, c: fa.flash_attention(
                a, b, c, causal=causal, window=window), (q, k, v), do)
            ref, refs = smoke._fwd_bwd(lambda a, b, c: ops.flash_attention(
                a, b, c, causal=causal, window=window, impl="ref"), (q, k, v), do)
            errs = [float((out - ref).abs().max())] + [float((g - r).abs().max())
                                                       for g, r in zip(grads, refs)]
            ok = errs[0] <= 2e-5 and all(torch.allclose(g, r, rtol=1e-4, atol=1e-4)
                                         for g, r in zip(grads, refs))
            print(name, [B, S, Hq, Hkv, hd, window], "ok" if ok else "FAIL",
                  ["%.2e" % e for e in errs], flush=True)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    B, S, H, _, hd, _, _ = smoke.FLASH_TRAIN
    q, k, v, do = (torch.randn(B, S, H, hd, generator=gen, device="cuda") for _ in range(4))
    times = {name: {"fwd_ms": [], "bwd_ms": []} for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        use(name)
        o, lse = fa.flash_attention_fwd(q, k, v)
        times[name]["fwd_ms"].append(smoke._time_ms(lambda: fa.flash_attention_fwd(q, k, v), flush))
        times[name]["bwd_ms"].append(smoke._time_ms(
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, do), flush))
    for name in libs:
        use(name)
        o, lse = fa.flash_attention_fwd(q, k, v)
        per = smoke._device_ms_by_kernel(lambda: (fa.flash_attention_fwd(q, k, v),
                                                  fa.flash_attention_bwd(q, k, v, o, lse, do)),
                                         flush)
        print(name, json.dumps(times[name]), "device_ms", json.dumps(per), flush=True)


if __name__ == "__main__":
    main()
