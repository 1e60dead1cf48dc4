"""The comparison that decides ``correct``.

A training cell's program is held to the plain reference over its first
``harness.CHECKED_STEPS`` steps, on the same weights and batches:

* ``loss_gap``: the gap between the program's and the reference's loss at
  the first step, before any update (the later steps' losses are kept
  beside it: AdamW's first update moves each weight by about the learning
  rate in the sign of its gradient, so weights whose gradient is near
  nought move either way on rounding, and every run of the program and of
  the control reads those steps' gaps about a hundred times higher);
* ``grad_gap``: the first step's gradient, as the program's optimizer got
  it (AdamW's first moment after one step over 1 - b1), against the
  reference's: by the worst layer's leaf, the gap between the two norms
  over the larger of the reference's norm of that leaf and of the median
  leaf;
* ``change_gap``: each leaf's change from the initial weights after those
  steps, as the state that the next step starts from keeps it (the fp32
  masters), by the same measure; leaves whose reference gradient is under a
  thousandth of the median leaf's move by round-off alone and are left out;
* ``replica_gap`` (cells with more than one replica): the largest
  difference between any replica's optimizer state (fp32 masters and both
  moments) and its stage's first replica's, at the same point; the replicas
  apply the same reduced gradient and stay bit-identical, so its limit is 0;
* ``off_route_launches`` and ``missing_launches``: the window's launches,
  forward and backward, of the kernels the family expects
  (``adapters/<family>.py``'s ``expected_launches``) that left the wgmma
  route, and those short of the expected count.

Each number has a limit of its own in ``limits/<cell>.json``; the run is
correct where every number the cell's limits name is there and at or under
its limit.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable

import torch

DROP_BELOW = 1e-3     # of the median leaf's reference gradient norm
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "replica_gap", "off_route_launches",
           "missing_launches")


def per_layer_norms(name: str, t: torch.Tensor, lo: int = 0) -> Dict[str, float]:
    """The norm of each layer's slice of a stacked leaf (axis 0, the first
    numbered ``lo``), or of an unstacked leaf."""
    if not name.startswith("layers."):
        return {name: float(torch.linalg.vector_norm(t, dtype=torch.float64))}
    n = torch.linalg.vector_norm(t.reshape(t.shape[0], -1), dim=1, dtype=torch.float64)
    return {f"{name}#{lo + i}": float(v) for i, v in enumerate(n.tolist())}


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Iterable[str]) -> tuple:
    """(worst relative gap, its leaf) over the leaves in ``keep``."""
    keep = sorted(keep)
    med = statistics.median(ref[n] for n in keep)
    worst, leaf = -1.0, None
    for n in keep:
        g = abs(prog.get(n, math.inf) - ref[n]) / max(ref[n], med)
        if math.isnan(g):
            g = math.inf
        if g > worst:
            worst, leaf = g, n
    return worst, leaf


def readings(prog: dict, ref: dict) -> tuple:
    """The numbers compared, and what they were read from."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError(f"{len(prog['losses'])} program losses, {len(ref['losses'])} reference")
    gaps = [abs(a - b) for a, b in zip(prog["losses"], ref["losses"])]
    loss_gap = gaps[0]
    names = set(ref["grad_norms"])
    extra = (set(prog["grad_norms"]) | set(prog["change_norms"])) - names
    if extra:
        raise ValueError(f"program leaves the reference has not: {sorted(extra)[:5]}")
    grad_gap, grad_leaf = norm_gap(prog["grad_norms"], ref["grad_norms"], names)
    med = statistics.median(ref["grad_norms"].values())
    moved = {n for n in names if ref["grad_norms"][n] >= DROP_BELOW * med}
    change_gap, change_leaf = norm_gap(prog["change_norms"], ref["change_norms"], moved)
    if math.isnan(loss_gap):
        loss_gap = math.inf
    got = {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
    if "replica_gap" in prog:
        got["replica_gap"] = prog["replica_gap"]
    return (got,
            {"grad_leaf": grad_leaf, "change_leaf": change_leaf,
             "left_out": sorted(names - moved), "leaves": len(names),
             "losses": prog["losses"], "reference_losses": ref["losses"],
             "loss_gaps": gaps})


def launch_numbers(counts: Dict[str, int], expected: Dict[str, int]) -> dict:
    """Off-route and missing launches of the window from the port's counters
    (a difference of ``ops.launch_counts()`` over the window) against
    ``expected``, {kernel: forward launches of the window}, each with as
    many backward launches."""
    off = missing = 0
    for base, want in expected.items():
        for total, wgmma in ((base, f"{base}_wgmma"), (f"{base}_bwd", f"{base}_bwd_wgmma")):
            off += counts[total] - counts[wgmma]
            missing += max(0, want - counts[wgmma])
    return {"off_route_launches": off, "missing_launches": missing}


def verdict(numbers: dict, limits: dict, required=None) -> tuple:
    """(correct, checks): each number beside its limit; a required number
    (by default every one the limits name) that is missing fails."""
    required = set(limits) if required is None else set(required)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS
              if k in numbers and k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok and required <= set(checks), checks
