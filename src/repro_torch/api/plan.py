"""The serializable deployment artifact (``repro.api.plan`` for the port).

A :class:`DeploymentPlan` saved by the JAX package (``repro serve ... -o
plan.json``, ``DeploymentPlan.save``) loads here field for field and
resolves against the port's own profiler, checked by the same profile
fingerprint, so one JSON drives both packages.  The port executes serve
plans (``repro_torch.serving.run_serve_plan``); training-plan execution,
merged profiles and measured profiles are not ported yet.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.partition import ModelProfile
from repro_torch.core.perfmodel import Config
from repro_torch.serverless.platform import Platform, get_platform

SCHEMA_VERSION = 1


class PlanCompatibilityError(RuntimeError):
    """A DeploymentPlan does not match the profile/platform it is replayed
    against (stale profiler, edited JSON, wrong platform or merge depth)."""


def profile_fingerprint(profile: ModelProfile,
                        platform: Optional[Platform] = None) -> str:
    """Stable 16-hex digest of a layer profile's quantitative content, with
    the platform's own parameters folded in when given — byte for byte the
    JAX package's digest for analytic profiles."""
    arr = profile.arrays()
    h = hashlib.sha256()
    h.update(f"{profile.name}:{profile.L}".encode())
    for key in ("s", "a", "o", "g", "Tf", "Tb"):
        h.update(key.encode())
        h.update(np.ascontiguousarray(arr[key], dtype=np.float64).tobytes())
    if platform is not None:
        h.update(json.dumps(dataclasses.asdict(platform),
                            sort_keys=True).encode())
    return h.hexdigest()[:16]


@dataclass(frozen=True)
class ResolvedPlan:
    """A DeploymentPlan bound back to live objects, ready to execute."""

    profile: ModelProfile
    platform: Platform
    config: Config
    total_micro_batches: int
    pipelined_sync: bool


@dataclass(frozen=True)
class DeploymentPlan:
    """One deployable FuncPipe configuration, serializable and replayable."""

    model: str                    # profiler-resolvable model id
    platform: str                 # Platform.name (see platform.get_platform)
    x: Tuple[int, ...]            # partition boundary bits, len L-1
    z: Tuple[int, ...]            # per-layer memory option index, len L
    d: int                        # data-parallel degree
    total_micro_batches: int      # M (= global_batch / micro_batch)
    alpha: Tuple[float, float]    # objective weights (a1 cost, a2 time)
    pipelined_sync: bool          # eq (2) collective vs eq (1)
    merge_to: Optional[int]       # layer-merge depth (None = unmerged)
    seq: Optional[int]            # profile arg (arch models; None = default)
    micro_batch: Optional[int]    # profile arg (None = family default)
    profile_fingerprint: str      # fingerprint of the MERGED profile
    t_iter: float                 # solver-predicted iteration time (s)
    c_iter: float                 # solver-predicted cost ($ / iteration)
    objective: float              # a1 * c_iter + a2 * t_iter
    solver: str                   # cd | exhaustive | tpdmp | bayes | manual
    engine: str                   # batch | scalar | dp | -
    solve_seconds: float          # provenance only; excluded from the hash
    profile_source: str = "analytic"   # analytic | measured
    workload: str = "train"            # train | serve
    serving: Optional[dict] = None     # serve-workload record (SLO, request
    #                                    shape, latency/cost breakdown) —
    #                                    present iff workload == "serve"
    version: int = SCHEMA_VERSION

    @property
    def config(self) -> Config:
        return Config(x=self.x, d=self.d, z=self.z)

    @property
    def n_stages(self) -> int:
        return sum(self.x) + 1

    @property
    def content_hash(self) -> str:
        """Stable digest of the plan's content (solver provenance excluded)."""
        d = self._as_dict()
        for prov in ("solve_seconds", "solver", "engine"):
            d.pop(prov)
        blob = json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # --------------------------------------------------------- serialization
    def _as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["x"], d["z"] = list(self.x), list(self.z)
        d["alpha"] = list(self.alpha)
        return d

    def to_json(self, *, indent: Optional[int] = 2) -> str:
        return json.dumps(self._as_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, blob: str) -> "DeploymentPlan":
        d = json.loads(blob)
        version = d.get("version", 0)
        if version != SCHEMA_VERSION:
            raise PlanCompatibilityError(
                f"plan schema version {version} != supported {SCHEMA_VERSION}")
        # plans saved before these fields existed were analytic training plans
        d.setdefault("profile_source", "analytic")
        d.setdefault("workload", "train")
        d.setdefault("serving", None)
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise PlanCompatibilityError(
                f"plan JSON has unknown fields {sorted(unknown)}")
        missing = names - set(d)
        if missing:
            raise PlanCompatibilityError(
                f"plan JSON is missing fields {sorted(missing)}")
        d["x"] = tuple(int(v) for v in d["x"])
        d["z"] = tuple(int(v) for v in d["z"])
        d["alpha"] = tuple(float(v) for v in d["alpha"])
        return cls(**d)

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "DeploymentPlan":
        with open(path) as f:
            return cls.from_json(f.read())

    # -------------------------------------------------------------- resolve
    def resolve(self, *, check: bool = True) -> ResolvedPlan:
        """Rebuild the plan's profile with the port's profiler and verify it
        against the recorded fingerprint."""
        from repro_torch.core.profiler import resolve_profile

        try:
            platform = get_platform(self.platform)
        except KeyError as e:
            raise PlanCompatibilityError(str(e)) from None
        if self.profile_source != "analytic":
            raise NotImplementedError(
                f"plan for {self.model!r} was solved against a "
                f"{self.profile_source} profile; calibration is not ported "
                "yet: ROADMAP port queue item 3 (tracing and calibration)")
        if self.merge_to is not None:
            raise NotImplementedError(
                "merged profiles (merge_to) belong to training plans, not "
                "ported yet: ROADMAP port queue item 1 (training slice)")
        try:
            profile = resolve_profile(self.model, platform, seq=self.seq,
                                      micro_batch=self.micro_batch)
        except KeyError as e:
            raise PlanCompatibilityError(str(e)) from None
        if check:
            got = profile_fingerprint(profile, platform)
            if got != self.profile_fingerprint:
                raise PlanCompatibilityError(
                    f"profile/platform fingerprint mismatch for model "
                    f"{self.model!r} on {platform.name}: plan was solved "
                    f"against {self.profile_fingerprint}, freshly built state "
                    f"is {got} (L={profile.L}).  The profiler or platform "
                    "model changed since the plan was saved — re-plan.")
        L = profile.L
        if len(self.x) != L - 1 or len(self.z) != L:
            raise PlanCompatibilityError(
                f"plan indexes {len(self.z)} layers but profile "
                f"{profile.name!r} has {L}")
        J = len(platform.memory_options)
        if any(not 0 <= j < J for j in self.z):
            raise PlanCompatibilityError(
                f"plan memory indices {self.z} out of range for platform "
                f"{platform.name!r} with {J} memory options")
        return ResolvedPlan(profile=profile, platform=platform,
                            config=self.config,
                            total_micro_batches=self.total_micro_batches,
                            pipelined_sync=self.pipelined_sync)
