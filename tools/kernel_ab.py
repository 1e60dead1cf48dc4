#!/usr/bin/env python3
"""A/B of kernel builds in one call on the card.

    python3 tools/kernel_ab.py decode_attention \\
        '{"before": ["build/parent/decode_attention.cu"],
          "after": ["src/repro_torch/kernels/csrc/decode_attention.cu", "SPLIT_SLOTS=192"]}'

The first argument names a kernel module of ``repro_torch.kernels``
(``flash_attention``, ``decode_attention`` or ``swiglu``).  Each entry of the
JSON names a source of that module, extra ``nvcc`` flags (those starting
with ``-``) and ``NAME=<int>`` settings of the module's own constants for
that build (the decode chunk, ``SPLIT_SLOTS``).  All are built at once with
the port's flags into ``build/ab/`` and swapped in turn under the module's
wrappers.  Per build: the ptxas report of the module's main kernels
(registers, spills); parity with the plain version at its check shapes
(fp32 outputs at 2e-5, gradients at 1e-4; bf16 at 2e-2); its calls at the
main path's shape timed in the order A, B, ..., B, A as ``chip_smoke.py``
times them (L2 emptied by writing a 256 MB buffer), then again with L2
emptied by reading it; device ms by kernel; and the library call's time
where the module has one.  Needs one CUDA card.
"""
import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import build as kb  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kernel_ref  # noqa: E402


def _randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (scale * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)


# ------------------------------------------------------------- the modules
# Each: the word in the names of the kernels whose ptxas report is printed,
# the word in those the profile sums, parity checks (label -> max |err|,
# raising past the bar), and the calls timed at the main path's shape with
# the library calls timed once beside them.

def flash_checks(mod, gen):
    out = {}
    for B, S, Hq, Hkv, hd, causal, window in [
            smoke.FLASH_TRAIN, (1, 1024, 40, 8, 128, True, 0), (1, 200, 4, 4, 64, True, 48),
            (2, 128, 4, 4, 80, False, 0)]:
        q, do = (_randn(gen, B, S, Hq, hd) for _ in range(2))
        k, v = (_randn(gen, B, S, Hkv, hd) for _ in range(2))
        out[f"{B}x{S}x{Hq}/{Hkv}x{hd} window={window}"] = smoke._check_kernel(
            lambda a, b, c: mod.flash_attention(a, b, c, causal=causal, window=window),
            lambda a, b, c: ops.flash_attention(a, b, c, causal=causal, window=window,
                                                impl="ref"),
            (q, k, v), do, f"flash {B}x{S}x{Hq}/{Hkv}x{hd}")
    return out


def flash_calls(mod, gen):
    B, S, H, _, hd, _, _ = smoke.FLASH_TRAIN
    q, k, v, do = (_randn(gen, B, S, H, hd) for _ in range(4))
    o, lse = mod.flash_attention_fwd(q, k, v)
    calls = {"fwd": lambda: mod.flash_attention_fwd(q, k, v),
             "bwd": lambda: mod.flash_attention_bwd(q, k, v, o, lse, do)}
    return calls, {}


def decode_checks(mod, gen):
    B, H, hd, C = (smoke.PHI3_DECODE[k] for k in ("B", "H", "hd", "C"))
    out = {}
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (_randn(gen, *s, dtype=dtype) for s in ((B, H, hd), (B, H, C, hd),
                                                          (B, H, C, hd)))
        for length in (1, 700, C):
            L = torch.tensor([length], dtype=torch.int32, device="cuda")
            out[f"{str(dtype)[6:]}@{length}"] = smoke._close(
                mod.decode_attention(q, k, v, L), ops.decode_attention(q, k, v, L, impl="ref"),
                tol, f"decode {dtype} length={length}")
    return out


def decode_calls(mod, gen):
    B, H, hd, C = (smoke.PHI3_DECODE[k] for k in ("B", "H", "hd", "C"))
    q, k, v = (_randn(gen, *s, dtype=torch.bfloat16) for s in ((B, H, hd), (B, H, C, hd),
                                                               (B, H, C, hd)))
    L = torch.tensor([C], dtype=torch.int32, device="cuda")
    mask = torch.ones(1, 1, 1, C, dtype=torch.bool, device="cuda")
    return ({"call": lambda: mod.decode_attention(q, k, v, L)},
            {"sdpa": lambda: F.scaled_dot_product_attention(q.unsqueeze(2), k, v,
                                                            attn_mask=mask)})


def swiglu_checks(mod, gen):
    out = {}
    for T, d, f in [(256, 256, 512), (100, 256, 512), (128, 200, 512), (128, 256, 520),
                    (256, 3072, 8192)]:
        x, dout = _randn(gen, T, d), _randn(gen, T, f)
        wg, wu = (_randn(gen, d, f, scale=0.05) for _ in range(2))
        dg, du = mod.swiglu_bwd(x, wg, wu, dout)
        pdg, pdu = kernel_ref.swiglu_bwd_ref(x, wg, wu, dout)
        # the d-3072 slice against float64 (chip_smoke.py says why)
        exact = (lambda t: t.double()) if d == 3072 else (lambda t: t)
        out[f"{T}x{d}x{f}"] = {
            "out": smoke._close(mod.swiglu_fwd(x, wg, wu),
                                F.silu(exact(x) @ exact(wg)) * (exact(x) @ exact(wu)), 2e-5,
                                f"swiglu {T}x{d}x{f}"),
            "dg": float((dg - pdg).abs().max()), "du": float((du - pdu).abs().max())}
    return out


def swiglu_calls(mod, gen):
    T, d, f = smoke.SWIGLU_TRAIN
    x, dout = _randn(gen, T, d), _randn(gen, T, f)
    wg, wu = (_randn(gen, d, f, scale=0.02) for _ in range(2))
    return ({"fwd": lambda: mod.swiglu_fwd(x, wg, wu),
             "bwd": lambda: mod.swiglu_bwd(x, wg, wu, dout)}, {})


MODULES = {"flash_attention": ("tf32x3", "flash", flash_checks, flash_calls),
           "decode_attention": ("decode_attention_split", "decode_attention", decode_checks,
                                decode_calls),
           "swiglu": ("tf32x3", "swiglu", swiglu_checks, swiglu_calls)}


# ----------------------------------------------------------- the harness

def build_all(mod, word: str, variants: dict) -> dict:
    """Every variant built at once; name -> (library, module settings)."""
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = mod.__name__.rsplit(".", 1)[1]
    procs = {name: subprocess.Popen(
        [kb._nvcc(), *kb.NVCC_FLAGS, *(f for f in flags if f.startswith("-")), "-I",
         str(kb.CSRC), "-o", str(out_dir / f"{stem}_{name}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, *flags) in variants.items()}
    spec = {}
    real_load = kb.load
    kb.load = lambda name, functions, restype=ctypes.c_int: spec.update(functions)
    mod.build()   # records the entry points' argument types
    kb.load = real_load
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(name, "build failed", log[-3000:], flush=True)
            continue
        print(name, json.dumps([(r["entry"], r["registers"], r["spill_bytes"])
                                for r in smoke._kernel_reports(log) if word in r["entry"]]),
              flush=True)
        lib = ctypes.CDLL(str(out_dir / f"{stem}_{name}.so"))
        for fn, argtypes in spec.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        settings = dict(f.split("=") for f in variants[name][1:] if not f.startswith("-"))
        libs[name] = (lib, {k: int(v) for k, v in settings.items()})
    return libs


class ReadFlush:
    """Stands in for the flush buffer in ``smoke._time_ms``: its ``zero_``
    reads the buffer instead of writing it."""

    def __init__(self, buf):
        self.buf = buf

    def zero_(self):
        self.buf.sum()


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    mod = importlib.import_module(f"repro_torch.kernels.{sys.argv[1]}")
    word, profile_word, checks, calls_of = MODULES[sys.argv[1]]
    libs = build_all(mod, word, json.loads(sys.argv[2]))
    defaults = {k: getattr(mod, k) for _, settings in libs.values() for k in settings}

    def use(name):
        lib, settings = libs[name]
        mod.build = lambda: lib
        for k, v in (defaults | settings).items():
            setattr(mod, k, v)

    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for name in libs:
        use(name)
        out[name] = {"max_abs_err": checks(mod, gen), "ms": {}, "ms_read_flush": {}}
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    reader = ReadFlush(flush)
    calls, library = calls_of(mod, gen)
    order = list(libs) + list(libs)[::-1]
    for key, how in (("ms", flush), ("ms_read_flush", reader)):
        for name in order:
            use(name)
            for call, fn in calls.items():
                out[name][key].setdefault(call, []).append(smoke._time_ms(fn, how))
    for name in libs:
        use(name)
        out[name]["device_ms_by_kernel"] = smoke._device_ms_by_kernel(
            lambda: [fn() for fn in calls.values()], flush, calls=10, word=profile_word)
    out["library"] = {call: {"ms": smoke._time_ms(fn, flush),
                             "ms_read_flush": smoke._time_ms(fn, reader)}
                      for call, fn in library.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "module": sys.argv[1], **out}), flush=True)


if __name__ == "__main__":
    main()
