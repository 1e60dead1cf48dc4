"""Content-addressed cache of solved DeploymentPlans (``repro.api.plan_cache``
for the port: the same keys and the same files).

Solving is the expensive step of the paper's workflow — seconds to minutes
per (model, platform, objective) point — yet the decision is a pure function
of the merged profile, the platform and the solver knobs.  This cache keys a
solved :class:`~repro.api.plan.DeploymentPlan` on exactly those inputs (the
same quantities ``DeploymentPlan`` records and fingerprints) so repeated
``python -m repro_torch sweep`` / ``Session.plan`` runs are near-instant.

Safety over speed, twice:

* the key folds in :func:`~repro.api.plan.profile_fingerprint` of the
  *merged* profile + platform, so a profiler or platform-model change is a
  cache miss, never a stale hit;
* every hit is additionally verified through ``plan.resolve(profile=...)``
  before use — a corrupted or hand-edited cache file degrades to a re-solve.

Entries are one plan JSON per file under the cache root (default
``$REPRO_PLAN_CACHE`` or ``~/.cache/repro/plans``), named by a digest of the
solve inputs; delete the directory to flush.  ``--no-plan-cache`` at the CLI
(or ``Session(plan_cache=False)``) bypasses it entirely.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Optional, Union

from repro_torch.api.plan import DeploymentPlan

_ENV_VAR = "REPRO_PLAN_CACHE"


def default_cache_dir() -> Path:
    env = os.environ.get(_ENV_VAR)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro" / "plans"


class PlanCache:
    """Disk-backed DeploymentPlan cache, one JSON file per solve key."""

    def __init__(self, root: Union[str, Path, None] = None):
        self.root = Path(root) if root is not None else default_cache_dir()
        self.hits = 0
        self.misses = 0
        self.evictions = 0   # corrupt/stale entries unlinked during get()

    # ------------------------------------------------------------------ keys
    @staticmethod
    def solve_key(*, profile_fingerprint: str, platform: str, alpha,
                  total_micro_batches: int, solver: str, engine: str,
                  merge_to, d_options, max_stages, pipelined_sync: bool,
                  rounds: Optional[int] = None,
                  seed: Optional[int] = None) -> str:
        """Digest of everything that determines the solver's decision.

        ``solver``/``engine`` are included even though ``content_hash``
        treats them as provenance: different engines may legitimately return
        different (equally scored) plans, and a cache must never change
        *which* plan a given command returns."""
        blob = json.dumps({
            "fp": profile_fingerprint, "platform": platform,
            "alpha": [float(a) for a in alpha],
            "M": int(total_micro_batches), "solver": solver, "engine": engine,
            "merge_to": merge_to,
            "d_options": [int(d) for d in d_options],
            "max_stages": max_stages, "pipelined_sync": bool(pipelined_sync),
            "rounds": rounds, "seed": seed,
        }, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:24]

    def _path(self, key: str) -> Path:
        return self.root / f"plan-{key}.json"

    # ---------------------------------------------------------------- lookup
    def get(self, key: str, verify=None) -> Optional[DeploymentPlan]:
        """The cached plan for ``key``, or None.  Unreadable, corrupt or
        ``verify``-failing entries are evicted and count as misses — a hit
        is only ever a plan that will actually be used (``verify`` is the
        caller's resolve check; an exception or falsy return rejects)."""
        path = self._path(key)
        try:
            plan = DeploymentPlan.load(path)
            if verify is not None:
                verify(plan)
        except FileNotFoundError:
            self.misses += 1
            return None
        except Exception:
            # corrupt / stale-schema / drifted entry: evict and re-solve
            try:
                path.unlink()
            except OSError:
                pass
            self.evictions += 1
            self.misses += 1
            return None
        self.hits += 1
        return plan

    def put(self, key: str, plan: DeploymentPlan) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        # per-process-unique tmp + atomic replace: concurrent solvers of the
        # same key cannot interleave into a corrupt entry
        fd, tmp = tempfile.mkstemp(prefix=f"plan-{key}.", suffix=".tmp",
                                   dir=self.root)
        try:
            with os.fdopen(fd, "w") as f:
                f.write(plan.to_json() + "\n")
            os.replace(tmp, self._path(key))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


def resolve_plan_cache(
        spec: Union[None, bool, str, Path, PlanCache]) -> Optional[PlanCache]:
    """Session/CLI cache spec: False/None -> disabled, True -> default dir,
    a path -> that dir, an instance -> itself."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return PlanCache()
    if isinstance(spec, PlanCache):
        return spec
    return PlanCache(spec)
