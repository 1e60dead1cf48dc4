"""CUDA flash-decode for Hopper: build, bind and launch.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention``.  It is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface and
bound with ``ctypes``: the source includes no PyTorch header, so the build
takes seconds.  The library is built on first use into ``build/torch_kernels/``
at the root of the checkout, named by a hash of the source, so an edited
source is rebuilt and concurrent builds never load a half-written file.

``LAUNCHES`` counts the kernel's launches (and nothing else), so a run can
show that its decode path went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
HEAD_DIMS = (64, 96, 128, 256)
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: number of kernel launches since the last reset (see ``kernels.ops``)
LAUNCHES = 0

_LIB = None
#: what the last build did: library path, seconds, and ptxas's report
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "decode-attention kernel is compiled on the machine with the card")


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; idempotent."""
    global _LIB
    if _LIB is not None:
        return _LIB
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    lib_path = BUILD_DIR / f"libdecode_attention_{tag}.so"
    t0 = time.perf_counter()
    log = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{log[-4000:]}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.repro_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    BUILD_INFO.update(path=str(lib_path), seconds=time.perf_counter() - t0,
                      compiler_log=log)
    _LIB = lib
    return lib


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: q [B, Hq, hd], k/v cache [B, Hkv, C, hd] on one
    CUDA device, ``length`` one int32 on that device (slots ``>= length``
    are masked; the decode path always has ``length >= 1``).  Returns
    [B, Hq, hd] in q's dtype."""
    global LAUNCHES
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"expected q [B,Hq,hd] and k/v [B,Hkv,C,hd], got {tuple(q.shape)}, "
            f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, Hq, hd = q.shape
    Bk, Hkv, C, hdk = k_cache.shape
    if Bk != B or hdk != hd or Hkv <= 0 or Hq % Hkv:
        raise ValueError(
            f"q {tuple(q.shape)} does not match cache {tuple(k_cache.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(
            f"dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}: expected one "
            "of float32, bfloat16 for all three")
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k_cache, v_cache, length)):
        raise ValueError("q, k_cache, v_cache and length must be on one CUDA device")
    if length.dtype != torch.int32 or length.numel() != 1:
        raise ValueError(f"length must be one int32, got {length.dtype} "
                         f"with {length.numel()} elements")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous() and length.is_contiguous()):
        raise ValueError("q, k_cache, v_cache and length must be contiguous")
    lib = build()
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            length.data_ptr(), out.data_ptr(), B, Hkv, Hq // Hkv, C, hd,
            _DTYPES[q.dtype], hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
