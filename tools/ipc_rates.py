#!/usr/bin/env python3
"""Host rates of the two ways a process backend can move a stage's bulk data
(params, gradient chunks, KV caches) between processes: a
``multiprocessing`` pipe to a spawned child, and a pickled file in a
directory (the run's temporary directory and the checkout's ``build/`` by
default).

    python3 tools/ipc_rates.py [--mb 256] [DIR ...]

Prints one JSON line: MB/s of a pipe send that a spawned child receives
(timed from the send to the child's reply, the child already running), and
per directory its filesystem type and MB/s of a pickle write and of a read.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np


def _receive(conn) -> None:
    conn.send(len(conn.recv()))      # ready: the parent starts its clock after this
    conn.send(len(conn.recv()))


def pipe_rate(a: np.ndarray) -> float:
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    p = ctx.Process(target=_receive, args=(child,), daemon=True)
    p.start()
    child.close()
    parent.send(b"x")
    parent.recv()
    t0 = time.perf_counter()
    parent.send(a)
    parent.recv()
    seconds = time.perf_counter() - t0
    p.join(timeout=60)
    return a.nbytes / 2**20 / seconds


def fs_type(path: Path) -> str:
    real, best = str(path.resolve()), ("/", "?")
    for line in Path("/proc/mounts").read_text().splitlines():
        mnt, fs = line.split()[1:3]
        if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) and len(mnt) >= len(best[0]):
            best = (mnt, fs)
    return best[1]


def file_rates(a: np.ndarray, base: Path) -> dict:
    d = tempfile.mkdtemp(dir=base)
    try:
        path = os.path.join(d, "blob")
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            pickle.dump(a, f, protocol=pickle.HIGHEST_PROTOCOL)
        write = time.perf_counter() - t0
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            back = pickle.load(f)
        read = time.perf_counter() - t0
        if back.nbytes != a.nbytes:
            raise RuntimeError("file round trip lost bytes")
    finally:
        shutil.rmtree(d)
    mb = a.nbytes / 2**20
    return {"dir": str(base), "fs": fs_type(base), "write_mb_per_s": mb / write,
            "read_mb_per_s": mb / read}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=256, help="payload size in MiB")
    ap.add_argument("dirs", nargs="*", type=Path)
    args = ap.parse_args()
    dirs = args.dirs or [Path(tempfile.gettempdir()),
                         Path(__file__).resolve().parents[1] / "build"]
    a = np.ones(args.mb * 2**20, dtype=np.uint8)
    for d in dirs:
        d.mkdir(parents=True, exist_ok=True)
    print(json.dumps({"ipc_rates": {"mb": args.mb, "pipe_mb_per_s": pipe_rate(a),
                                    "files": [file_rates(a, d) for d in dirs]}}), flush=True)


if __name__ == "__main__":
    main()
