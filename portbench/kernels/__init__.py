"""The table of ranged kernels: one module a kernel of the port, named after
the kernel, in this folder (or registered under this package's name in
``sys.modules``).  In the host-traced steps the harness wraps each call into
the kernel in a profiler range of its own and records its shape; the
roofline's least time is counted from those shapes.

A kernel's module states:

* ``OP``: the ``repro_torch.kernels.ops`` attribute it wraps;
* ``RANGE``: its profiler range, ``portbench::<kernel>``;
* ``BACKWARD``: whether a call has autograd backward nodes, whose device
  time belongs to the call;
* ``shape(*args, **kwargs) -> tuple``: what the count needs of a call's
  arguments, hashable and made of numbers;
* ``count(shape) -> {"fwd_ops", "bwd_ops", "fwd_bytes", "bwd_bytes"}``: the
  operations and bytes the call needs (``flops.py``'s rules).
"""
from __future__ import annotations

import importlib
import sys
from pathlib import Path


def table() -> dict:
    """{kernel name: its module}, in the order of the names."""
    names = {p.stem for p in Path(__file__).parent.glob("*.py") if p.stem != "__init__"}
    names |= {m.rpartition(".")[2] for m in sys.modules if m.startswith(f"{__name__}.")}
    return {n: importlib.import_module(f"{__name__}.{n}") for n in sorted(names)}


def roofline(m: dict, name: str):
    """The kernel ``name``'s share of its roofline over the traced steps: the
    least time of every recorded call over all device time launched inside
    its range (and, for a kernel with a backward, inside the backward nodes
    of the autograd operations it recorded), whatever kernels implement it,
    in percent; None where there is nothing to read."""
    t = m.get("trace")
    if not t or name not in t["ranges"]:
        return None
    r = t["ranges"][name]
    if not r["calls"] or not r["device_s"] or not r["least_s"]:
        return None
    # every call needs its backward matched, or the device time is short
    if r["backward"] and r["backward_nodes"] < r["calls"]:
        return None
    return 100.0 * r["least_s"] / r["device_s"]
