"""The device trace of a run's traced steps, reduced to what the per-layer
metrics read.

``torch.profiler`` records the card's kernels, copies and fills, and (in
host-traced steps) the host's operators on every thread: the local
backend's workers are threads, and autograd runs the backward on a thread
of its own.  The reduction gives:

* ``busy_s``: the union of the device intervals, so streams that overlap
  count once;
* ``kernel_s_by_name``: device seconds by kernel name;
* ``ranges``: for each named range the benchmark wrapped around a call into
  the program, the device time launched inside it and inside the backward
  nodes of the autograd operations it recorded, matched by the forward
  thread and sequence number that the profiler gives both;
* ``idle_gaps``: the time between device intervals, by the innermost host
  operator running at each gap's middle (the longest gaps only).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

BACKWARD = "autograd::engine::evaluate_function: "
GAPS_LABELLED = 400          # the longest gaps that get a host label


def profiler(device: str, host: bool):
    """A started profiler of the device's work and, with ``host``, of the
    host's operators on every thread."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if device == "cuda" else []
    kw = {}
    if host or not acts:
        acts.append(ProfilerActivity.CPU)
        try:
            from torch._C._profiler import _ExperimentalConfig

            kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            pass
    prof = profile(activities=acts, **kw)
    prof.start()
    return prof


def device_busy(prof) -> dict:
    """The device's work in a profile that recorded the device alone: the
    union of its intervals and seconds by kernel name, read from the raw
    events (building the operator tree of ``prof.events()`` takes minutes
    for a few of bert's steps)."""
    try:
        raw = prof.profiler.kineto_results.events()
        spans, by_name = [], {}
        for e in raw:
            if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation():
                continue
            a = e.start_ns() / 1e3
            b = a + e.duration_ns() / 1e3
            spans.append((a, b))
            by_name[e.name()] = by_name.get(e.name(), 0.0) + (b - a) / 1e6
    except AttributeError:
        return reduce(prof, [])
    busy = _union(spans)
    return {"busy_s": sum(b - a for a, b in busy) / 1e6, "busy": busy,
            "kernel_s_by_name": by_name, "ranges": {}, "host": []}


def _union(spans: List[tuple]) -> List[tuple]:
    merged: List[list] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def reduce(prof, range_names: List[str]) -> dict:
    """The reduction of a stopped profiler (times in seconds)."""
    events = prof.events()
    dev_type = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in events:
        if e.device_type != dev_type:
            host.append(e)
        elif not getattr(e, "is_user_annotation", False) and e.name not in range_names:
            device.append(e)      # a kernel, copy or fill; not a range drawn on the device
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    busy = _union(spans)
    by_name: Dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6

    ranges = {}
    for rname in range_names:
        tops = [e for e in host if e.name == rname]
        keys = set()
        stack = list(tops)
        while stack:
            e = stack.pop()
            if e.sequence_nr is not None and e.sequence_nr >= 0 and e.name != rname:
                keys.add((e.thread, e.sequence_nr))
            stack.extend(e.cpu_children)
        bwd = [e for e in host if e.name.startswith(BACKWARD)
               and (getattr(e, "fwd_thread", e.thread), e.sequence_nr) in keys]
        ranges[rname] = {
            "calls": len(tops), "backward_nodes": len(bwd),
            "forward_device_s": sum(e.device_time_total for e in tops) / 1e6,
            "backward_device_s": sum(e.device_time_total for e in bwd) / 1e6,
        }
        ranges[rname]["device_s"] = (ranges[rname]["forward_device_s"]
                                     + ranges[rname]["backward_device_s"])

    return {"busy_s": sum(b - a for a, b in busy) / 1e6, "busy": busy,
            "kernel_s_by_name": by_name, "ranges": ranges,
            "host": [(e.time_range.start, e.time_range.end, e.name) for e in host
                     if not e.name.startswith("ProfilerStep")]}


def idle_gaps(red: dict, limit: int = 10) -> List[list]:
    """The gaps between device intervals, summed by the innermost host
    operator open at each gap's middle; the ``limit`` largest sums."""
    busy = red["busy"]
    gaps = [(b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:]) if b1[0] > b0[1]]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    gaps = gaps[:GAPS_LABELLED]
    if not gaps or not red["host"]:
        return []
    starts = np.array([h[0] for h in red["host"]])
    ends = np.array([h[1] for h in red["host"]])
    names = [h[2] for h in red["host"]]
    sums: Dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        open_ = np.nonzero((starts <= mid) & (ends >= mid))[0]
        label = "no host operator open"
        if open_.size:
            label = names[open_[np.argmin(ends[open_] - starts[open_])]]
        sums[label] = sums.get(label, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:limit]]


def top_ops(red: dict, limit: int = 10, width: int = 160) -> List[list]:
    """The device operations that took most time, by name."""
    top = sorted(red["kernel_s_by_name"].items(), key=lambda kv: -kv[1])[:limit]
    return [[k[:width], v] for k, v in top]
