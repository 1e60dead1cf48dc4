"""The serializable deployment artifact (``repro.api.plan`` for the port).

A :class:`DeploymentPlan` freezes one co-optimization decision — model,
platform, partition ``x``, per-layer memory ``z``, DP degree ``d``, the
micro-batch budget, the objective weights and the solver's predicted
time/cost — together with a fingerprint of the (merged) layer profile the
decision indexes into.  A plan saved by either package loads in the other
field for field and resolves against that package's own profiler (merged
with ``merge_layers`` where ``merge_to`` is set), checked by the same
fingerprint, so one JSON drives both.  The port evaluates, simulates and
emulates training plans here (``emulate`` runs the storage-backed engine
through an ``ExecutionConfig``), and serves serve plans with
``repro_torch.serving.run_serve_plan``.  A plan solved against a measured
(calibrated) profile resolves only with that profile passed in.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.partition import ModelProfile, merge_layers, stages_of
from repro_torch.core.perfmodel import Config, Evaluation, evaluate
from repro_torch.serverless.platform import MB, Platform, get_platform

SCHEMA_VERSION = 1


class PlanCompatibilityError(RuntimeError):
    """A DeploymentPlan does not match the profile/platform it is replayed
    against (stale profiler, edited JSON, wrong platform or merge depth)."""


def profile_fingerprint(profile: ModelProfile,
                        platform: Optional[Platform] = None) -> str:
    """Stable 16-hex digest of a layer profile's quantitative content, with
    the platform's own parameters folded in when given, and the profile's
    provenance for non-analytic sources — byte for byte the JAX package's
    digest."""
    arr = profile.arrays()
    h = hashlib.sha256()
    h.update(f"{profile.name}:{profile.L}".encode())
    for key in ("s", "a", "o", "g", "Tf", "Tb"):
        h.update(key.encode())
        h.update(np.ascontiguousarray(arr[key], dtype=np.float64).tobytes())
    if platform is not None:
        h.update(json.dumps(dataclasses.asdict(platform),
                            sort_keys=True).encode())
    if profile.source != "analytic":
        h.update(f"source={profile.source}".encode())
        if profile.calibration is not None:
            h.update(json.dumps(dataclasses.asdict(profile.calibration),
                                sort_keys=True).encode())
    return h.hexdigest()[:16]


@dataclass(frozen=True)
class ResolvedPlan:
    """A DeploymentPlan bound back to live objects, ready to execute."""

    profile: ModelProfile         # merged profile the config indexes into
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
    def n_workers(self) -> int:
        return self.n_stages * self.d

    @property
    def content_hash(self) -> str:
        """Stable digest of the plan's content (solver provenance excluded)."""
        d = self._as_dict()
        for prov in ("solve_seconds", "solver", "engine"):
            d.pop(prov)
        blob = json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # ---------------------------------------------------------- construction
    @classmethod
    def from_result(cls, result, *, platform: Platform,
                    alpha: Tuple[float, float], total_micro_batches: int,
                    model: Optional[str] = None, pipelined_sync: bool = True,
                    solver: str = "cd", engine: str = "batch",
                    merge_to: Optional[int] = None, seq: Optional[int] = None,
                    micro_batch: Optional[int] = None) -> "DeploymentPlan":
        """Freeze a ``planner.PlanResult`` (any solver path) into a plan."""
        cfg, ev = result.config, result.evaluation
        return cls(
            model=model if model is not None else result.profile.name,
            platform=platform.name,
            x=tuple(int(v) for v in cfg.x), z=tuple(int(v) for v in cfg.z),
            d=int(cfg.d), total_micro_batches=int(total_micro_batches),
            alpha=(float(alpha[0]), float(alpha[1])),
            pipelined_sync=bool(pipelined_sync), merge_to=merge_to,
            seq=seq, micro_batch=micro_batch,
            profile_fingerprint=profile_fingerprint(result.profile, platform),
            t_iter=float(ev.t_iter), c_iter=float(ev.c_iter),
            objective=float(result.objective), solver=solver, engine=engine,
            solve_seconds=float(result.solve_seconds),
            profile_source=result.profile.source,
        )

    @classmethod
    def from_config(cls, profile: ModelProfile, platform: Platform,
                    config: Config, total_micro_batches: int, *,
                    model: Optional[str] = None, pipelined_sync: bool = True,
                    merge_to: Optional[int] = None, seq: Optional[int] = None,
                    micro_batch: Optional[int] = None,
                    solver: str = "manual") -> "DeploymentPlan":
        """Freeze a hand-built configuration; predictions come from the
        closed-form model."""
        ev: Evaluation = evaluate(profile, platform, config,
                                  total_micro_batches,
                                  pipelined_sync=pipelined_sync)
        return cls(
            model=model if model is not None else profile.name,
            platform=platform.name,
            x=tuple(int(v) for v in config.x),
            z=tuple(int(v) for v in config.z), d=int(config.d),
            total_micro_batches=int(total_micro_batches),
            alpha=(1.0, 0.0), pipelined_sync=bool(pipelined_sync),
            merge_to=merge_to, seq=seq, micro_batch=micro_batch,
            profile_fingerprint=profile_fingerprint(profile, platform),
            t_iter=float(ev.t_iter), c_iter=float(ev.c_iter),
            objective=float(ev.c_iter), solver=solver, engine="-",
            solve_seconds=0.0, profile_source=profile.source,
        )

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
    def resolve(self, *, profile: Optional[ModelProfile] = None,
                platform: Optional[Platform] = None,
                check: bool = True) -> ResolvedPlan:
        """Bind the plan back to live objects, verifying compatibility.

        The profile is rebuilt with the port's profiler from the recorded
        ``(model, seq, micro_batch)`` and merged to ``merge_to``, unless
        ``profile`` (already merged) is given; ``platform`` overrides the
        recorded one.  Either way the profile is fingerprint-checked, so one
        that drifted from the one the plan was solved against raises
        :class:`PlanCompatibilityError`."""
        from repro_torch.core.profiler import resolve_profile

        if platform is None:
            try:
                platform = get_platform(self.platform)
            except KeyError as e:
                raise PlanCompatibilityError(str(e)) from None
        if profile is None:
            if self.profile_source != "analytic":
                raise PlanCompatibilityError(
                    f"plan for {self.model!r} was solved against a "
                    f"{self.profile_source} profile, which the profiler "
                    "cannot rebuild (it only derives analytic tables) — "
                    "pass the measured profile explicitly "
                    "(ModelProfile.load(...) via profile=, or "
                    "`python -m repro_torch simulate/emulate --profile measured.json`)")
            try:
                full = resolve_profile(self.model, platform, seq=self.seq,
                                       micro_batch=self.micro_batch)
            except KeyError as e:
                raise PlanCompatibilityError(str(e)) from None
            profile = (merge_layers(full, self.merge_to)
                       if self.merge_to is not None else full)
        if check:
            got = profile_fingerprint(profile, platform)
            if got != self.profile_fingerprint:
                src = getattr(profile, "source", "analytic")
                why = (
                    f"  Profile source mismatch: the plan was solved "
                    f"against a {self.profile_source} profile but a "
                    f"{src} profile was supplied."
                    if src != self.profile_source else
                    "  The profiler or platform model changed since the "
                    "plan was saved — re-plan, or pass the original "
                    "profile explicitly.")
                raise PlanCompatibilityError(
                    f"profile/platform fingerprint mismatch for model "
                    f"{self.model!r} on {platform.name}: plan was solved "
                    f"against {self.profile_fingerprint} "
                    f"({self.profile_source}), freshly built state is "
                    f"{got} ({src}; L={profile.L}, "
                    f"merge_to={self.merge_to}).{why}")
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

    def _require_train(self, what: str) -> None:
        """Training-only entry points reject serve plans instead of
        mis-executing them as a 1-step training run."""
        if self.workload != "train":
            raise PlanCompatibilityError(
                f"{what} executes *training* plans; this plan for "
                f"{self.model!r} has workload={self.workload!r}. Serve it "
                "through repro_torch.serving.run_serve_plan(plan) instead.")

    # ------------------------------------------------------------- execution
    def evaluate(self, **resolve_kw) -> Evaluation:
        """Closed-form performance model prediction (eq 6/7)."""
        self._require_train("DeploymentPlan.evaluate")
        rp = self.resolve(**resolve_kw)
        return evaluate(rp.profile, rp.platform, rp.config,
                        rp.total_micro_batches,
                        pipelined_sync=rp.pipelined_sync)

    def simulate(self, *, contention: bool = False, trace: bool = False,
                 **resolve_kw):
        """Replay through the analytic discrete-event simulator.
        ``trace=True`` materializes the DP's predicted spans as
        ``SimResult.trace`` (``repro_torch.obs.Trace``)."""
        from repro_torch.serverless.simulator import simulate_funcpipe

        self._require_train("DeploymentPlan.simulate")
        rp = self.resolve(**resolve_kw)
        return simulate_funcpipe(rp.profile, rp.platform, rp.config,
                                 rp.total_micro_batches,
                                 pipelined_sync=rp.pipelined_sync,
                                 contention=contention, trace=trace)

    def emulate(self, exec_config=None, *, steps=None, contention: bool = False,
                execution=None, backend=None, trace=None, faults=None, tolerance=None,
                payload_true=None, throttle=None, bandwidth=None, **resolve_kw):
        """Execute through the storage-backed engine on an execution backend
        (``"emulated"``, ``"local"``, ``"process"`` or any registered one);
        the same saved plan JSON drives every backend.  How to execute is an
        :class:`~repro_torch.serverless.execution.ExecutionConfig`; the
        keywords are its deprecated legacy spelling (never mix the two).
        ``execution`` attaches the numerics (``Execution``: the arch, its
        params, the batches and the device).  A traced run carries this
        plan's document in ``trace.meta["plan"]``, so ``python -m
        repro_torch calibrate`` re-plans straight from the file."""
        from repro_torch.serverless.execution import ExecutionConfig
        from repro_torch.serverless.runtime import run_plan

        self._require_train("DeploymentPlan.emulate")
        ec = ExecutionConfig.merge(
            exec_config,
            dict(backend=backend, steps=steps, trace=trace, faults=faults,
                 tolerance=tolerance, payload_true=payload_true,
                 throttle=throttle, bandwidth=bandwidth),
            where="DeploymentPlan.emulate")
        rp = self.resolve(**resolve_kw)
        res = run_plan(rp.profile, rp.platform, rp.config, rp.total_micro_batches, ec,
                       pipelined_sync=rp.pipelined_sync, contention=contention,
                       execution=execution)
        if res.trace is not None:
            res.trace.meta["plan"] = self._as_dict()
        return res

    # ------------------------------------------------------------ describing
    def describe(self) -> str:
        try:
            platform = get_platform(self.platform)
        except KeyError as e:
            raise PlanCompatibilityError(str(e)) from None
        st = stages_of(self.x)
        mems = [platform.memory_options[self.z[lo]] // MB for lo, _ in st]
        if self.workload == "serve":
            sv = self.serving or {}
            return (f"{self.model} on {self.platform} [serve]: {len(st)} "
                    f"stages, mem={mems}MB, batch={sv.get('batch')}, "
                    f"prefill={sv.get('prefill_tokens')} "
                    f"new={sv.get('new_tokens')} tokens, "
                    f"SLO={sv.get('slo_s')}s, predicted "
                    f"t_request={self.t_iter:.3f}s "
                    f"cost=${sv.get('cost_per_1k', 1000 * self.c_iter):.4f}"
                    f"/1k-req [{self.solver}/{self.engine}, "
                    f"hash {self.content_hash}]")
        mu = max(1, self.total_micro_batches // self.d)
        return (f"{self.model} on {self.platform}: {len(st)} stages x "
                f"d={self.d} ({self.n_workers} workers), mem={mems}MB, "
                f"M={self.total_micro_batches} (mu={mu}/worker), "
                f"sync={'eq(2)' if self.pipelined_sync else 'eq(1)'}, "
                f"predicted t_iter={self.t_iter:.3f}s "
                f"cost=${self.c_iter:.6f}/iter "
                f"[{self.solver}/{self.engine}, hash {self.content_hash}]")
