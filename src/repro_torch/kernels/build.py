"""Build and load the port's CUDA kernels (one shared library per source).

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so ``nvcc`` builds it in seconds.  It is compiled for ``sm_90a`` on
first use into ``build/torch_kernels/`` at the root of the checkout, into a
library named by a hash of the source: an edited source is rebuilt, and a
concurrent build never loads a half-written file.  The hash covers the
source and every header of ``csrc/`` it includes (``hopper.cuh``), so an
edited header rebuilds each library that includes it.  ``nvcc``'s report (ptxas
registers and spills) is kept beside each library as ``lib<name>_<hash>.log``
and read back when the library is already built.  The libraries are bound
with ``ctypes``.  :func:`build_all` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("adamw", "decode_attention", "flash_attention", "swiglu")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()

#: guards the kernel modules' launch counters, which several threads of a
#: process bump at once (the local backend's workers, autograd's device
#: thread): ``LAUNCHES[way] += 1`` is a read-modify-write
COUNT_LOCK = threading.Lock()


def count_launch(counts: dict, way: str) -> None:
    """One more launch on route ``way`` in a kernel module's counter."""
    with COUNT_LOCK:
        counts[way] += 1


#: per source: library path, seconds, whether it was already built, and
#: nvcc's report (ptxas -v)
BUILD_INFO: Dict[str, dict] = {}


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
        "port's kernels are compiled on the machine with the card")


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources_of(path: Path) -> list:
    """``path`` and the headers beside it that it includes, transitively,
    each once, in the order first met."""
    found = [path]
    for p in found:
        for inc in _LOCAL_INCLUDE.findall(p.read_text()):
            header = p.parent / inc
            if header.exists() and header not in found:
                found.append(header)
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources_of(CSRC / f"{name}.cu"):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together; returns :data:`BUILD_INFO` for them."""
    names = list(names)
    t0 = time.perf_counter()
    running = {}
    for name in names:
        path = library_path(name)
        if name in BUILD_INFO:
            continue
        if path.exists():
            log = path.with_suffix(".log")
            BUILD_INFO[name] = dict(path=str(path), seconds=0.0, cached=True,
                                    compiler_log=log.read_text() if log.exists() else "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, path)
    failed = []
    for name, (proc, tmp, path) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {name}.cu:\n{log[-4000:]}")
            continue
        tmp.with_suffix(".log").write_text(log)
        os.replace(tmp.with_suffix(".log"), path.with_suffix(".log"))
        os.replace(tmp, path)
        BUILD_INFO[name] = dict(path=str(path), seconds=time.perf_counter() - t0,
                                cached=False, compiler_log=log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {n: BUILD_INFO[n] for n in names}


def load(name: str, functions: Dict[str, list],
         restype: Optional[type] = ctypes.c_int) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` (built if needed), with ``argtypes``
    and ``restype`` set on each of ``functions``; idempotent."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:    # worker threads may make a kernel's first call at once
        if name not in _LIBS:
            build_all([name])
            lib = ctypes.CDLL(BUILD_INFO[name]["path"])
            for fn_name, argtypes in functions.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIBS[name] = lib
        return _LIBS[name]


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device, as the C entry points take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
