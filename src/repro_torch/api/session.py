"""What the port has of ``repro.api.session``: the solver's infeasibility
error and the paper's default objective weights, which the serving planner
and the training planner's callers share.

The fluent ``Session`` front door itself (profile -> plan -> simulate ->
emulate, with the plan cache) is not ported yet: ROADMAP port queue item 5
(the session, fault injection and ``ExecutionConfig``).
"""
from __future__ import annotations

from typing import Tuple

# the paper's §5.1 default weight pair (alpha2 = 2^16 * 1e-9)
DEFAULT_ALPHA: Tuple[float, float] = (1.0, 2**16 * 1e-9)


class InfeasiblePlanError(RuntimeError):
    """The solver found no feasible (partition, memory, d) for the budget —
    typed so callers can distinguish infeasibility from real failures."""
