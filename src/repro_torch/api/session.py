"""Fluent front door over the paper's workflow ①-⑤ (``repro.api.session``
for the port).

    from repro_torch.api import session
    s = (session("bert-large", platform="aws", global_batch=64)
         .profile()
         .plan(merge_to=14)
         .simulate()
         .emulate(steps=2))
    s.deployment_plan.save("plan.json")

Each step stores its artifact on the session and returns ``self``; later
steps trigger earlier ones (``plan`` profiles, ``simulate`` plans).
``emulate(ExecutionConfig(trace=True))`` then ``calibrate()`` folds the
traced run into a measured profile, and a following ``plan()`` re-solves on
it.  ``save_plan``/``load_plan`` persist the decision as a
:class:`DeploymentPlan`, fingerprint-checked against this session's
profile on load.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

from repro_torch.api.plan import DeploymentPlan, profile_fingerprint
from repro_torch.api.plan_cache import PlanCache, resolve_plan_cache
from repro_torch.core import planner
from repro_torch.core.partition import ModelProfile, merge_layers
from repro_torch.core.profiler import resolve_profile
from repro_torch.serverless.platform import Platform, get_platform

# the paper's §5.1 default weight pair (alpha2 = 2^16 * 1e-9)
DEFAULT_ALPHA: Tuple[float, float] = (1.0, 2**16 * 1e-9)


class InfeasiblePlanError(RuntimeError):
    """The solver found no feasible (partition, memory, d) for the budget —
    typed so callers can distinguish infeasibility from real failures."""


class Session:
    """Mutable builder: model + platform + batch budget -> plan -> replay."""

    def __init__(self, model: str, platform: Union[str, Platform] = "aws", *,
                 global_batch: int = 64, micro_batch: Optional[int] = None,
                 seq: Optional[int] = None, pipelined_sync: bool = True,
                 contention: bool = False,
                 plan_cache: Union[None, bool, str, PlanCache] = None):
        self.model = model
        self.platform = (get_platform(platform)
                         if isinstance(platform, str) else platform)
        self.global_batch = global_batch
        # micro_batch=None means "unspecified": 4 for the M budget (the
        # paper's default micro-batch) and each profile family's own default
        # when profiling; an explicit value — even 4 — is honored and
        # recorded in the plan verbatim
        self.micro_batch = 4 if micro_batch is None else micro_batch
        self._profile_mb: Optional[int] = micro_batch
        self.seq = seq
        self.pipelined_sync = pipelined_sync
        self.contention = contention
        # None/False = solve every time; True = default cache dir; a path or
        # PlanCache = that cache (see repro_torch.api.plan_cache)
        self.plan_cache: Optional[PlanCache] = resolve_plan_cache(plan_cache)

        self.model_profile: Optional[ModelProfile] = None
        self.deployment_plan: Optional[DeploymentPlan] = None
        self.plan_result: Optional[planner.PlanResult] = None  # in-memory twin
        self.plans: List[DeploymentPlan] = []       # sweep results
        self.plan_results: List[planner.PlanResult] = []
        self.recommended: Optional[int] = None      # index into .plans
        self.evaluation = None                      # perfmodel Evaluation
        self.sim_result = None                      # simulator SimResult
        self.engine_result = None                   # runtime EngineResult
        self.calibration = None                     # obs.calibrate.Calibration

    @property
    def total_micro_batches(self) -> int:
        return max(1, self.global_batch // self.micro_batch)

    # ------------------------------------------------------------ workflow ①
    def profile(self) -> "Session":
        """Build the layer profile (paper Fig 2 component ③)."""
        self.model_profile = resolve_profile(
            self.model, self.platform, seq=self.seq,
            micro_batch=self._profile_mb)
        return self

    def _require_profile(self) -> ModelProfile:
        if self.model_profile is None:
            self.profile()
        return self.model_profile

    # ------------------------------------------------------------ workflow ②
    def plan(self, *, alpha: Tuple[float, float] = DEFAULT_ALPHA,
             merge_to: Optional[int] = planner.DEFAULT_MERGE_TO,
             solver: str = "cd", engine: str = "batch",
             d_options: Sequence[int] = planner.DEFAULT_D_OPTIONS,
             max_stages: Optional[int] = None, rounds: int = 100,
             seed: int = 0, workload: str = "train",
             slo: Optional[float] = None, serve_batch: Optional[int] = None,
             prefill_tokens: Optional[int] = None,
             new_tokens: Optional[int] = None) -> "Session":
        """Co-optimize partition + resources; freeze a DeploymentPlan.

        ``solver``: ``cd`` / ``cd-steepest`` / ``exhaustive`` (the
        MIQP-style co-optimizer), ``tpdmp`` or ``bayes`` (the §5.6
        comparison algorithms).
        ``engine``: ``batch`` / ``scalar`` (enumeration, identical plans) or
        ``dp`` (the exact cut-point DP — pair it with ``merge_to=None`` to
        plan at full layer depth).

        ``workload="serve"`` switches the objective to inference serving:
        the SLO-aware planner (:mod:`repro_torch.serving.planner`) minimizes
        $/1k-requests subject to ``slo`` seconds per request, with the
        KV-cache counted in the per-stage memory constraint.  Serve plans
        skip the plan cache (its key covers the training knobs only) and
        replay through :func:`repro_torch.serving.run_serve_plan`, not
        ``emulate``/``simulate``.

        With a ``plan_cache`` attached to the session, the solve is keyed on
        (merged-profile fingerprint, platform, objective, M, solver knobs)
        and a verified cache hit skips the solver entirely.
        """
        if workload == "serve":
            from repro_torch.serving.planner import plan_serving

            if slo is None:
                raise ValueError(
                    "plan(workload='serve') needs slo= (seconds per request)")
            kw = dict(slo=slo, max_stages=max_stages)
            if serve_batch is not None:
                kw["batch"] = serve_batch
            if prefill_tokens is not None:
                kw["prefill_tokens"] = prefill_tokens
            if new_tokens is not None:
                kw["new_tokens"] = new_tokens
            self.deployment_plan = plan_serving(
                self.model, self.platform, **kw)
            self.plan_result = None
            return self
        if workload != "train":
            raise ValueError(
                f"unknown workload {workload!r}; expected train | serve")
        prof = self._require_profile()
        M = self.total_micro_batches

        cache_key = None
        if self.plan_cache is not None:
            merged = (merge_layers(prof, merge_to)
                      if merge_to is not None else prof)
            cache_key = PlanCache.solve_key(
                profile_fingerprint=profile_fingerprint(merged, self.platform),
                platform=self.platform.name, alpha=alpha,
                total_micro_batches=M, solver=solver, engine=engine,
                merge_to=merge_to, d_options=d_options, max_stages=max_stages,
                pipelined_sync=self.pipelined_sync,
                rounds=rounds if solver == "bayes" else None,
                seed=seed if solver == "bayes" else None)
            rp = None

            def _verify(plan, merged=merged):
                nonlocal rp
                rp = plan.resolve(profile=merged, platform=self.platform)

            cached = self.plan_cache.get(cache_key, verify=_verify)
            if cached is not None:
                from repro_torch.core.perfmodel import evaluate

                ev = evaluate(rp.profile, rp.platform, rp.config,
                              rp.total_micro_batches,
                              pipelined_sync=rp.pipelined_sync)
                self.plan_result = planner.PlanResult(
                    rp.config, ev, ev.objective(*alpha),
                    cached.solve_seconds, rp.profile)
                self.deployment_plan = cached
                return self

        common = dict(alpha=alpha, total_micro_batches=M, merge_to=merge_to,
                      d_options=d_options, pipelined_sync=self.pipelined_sync)
        if solver in ("cd", "cd-steepest", "exhaustive"):
            r = planner.solve(prof, self.platform, method=solver,
                              engine=engine, max_stages=max_stages, **common)
        elif solver == "tpdmp":
            r = planner.tpdmp_solve(prof, self.platform, engine=engine,
                                    **common)
        elif solver == "bayes":
            if engine != "batch":
                raise ValueError(
                    f"solver='bayes' has no {engine!r} engine: it samples "
                    "through the batched kernel only (engine='batch')")
            r = planner.bayes_solve(prof, self.platform, rounds=rounds,
                                    seed=seed, **common)
        else:
            raise ValueError(f"unknown solver {solver!r}")
        if r is None:
            raise InfeasiblePlanError(
                f"no feasible plan for {self.model} on {self.platform.name} "
                f"at M={M} (try a smaller batch or another platform)")
        self.plan_result = r
        self.deployment_plan = DeploymentPlan.from_result(
            r, model=self.model, platform=self.platform, alpha=alpha,
            total_micro_batches=M, pipelined_sync=self.pipelined_sync,
            solver=solver, engine=engine, merge_to=merge_to, seq=self.seq,
            micro_batch=self._profile_mb)
        if cache_key is not None:
            self.plan_cache.put(cache_key, self.deployment_plan)
        return self

    def sweep(self, *, alphas: Optional[Sequence[Tuple[float, float]]] = None,
              **plan_kw) -> "Session":
        """Plan across the paper's objective-weight pairs; pick the §5.1
        recommendation (fastest plan with speedup/cost ratio >= 0.8)."""
        from repro_torch.serverless.frameworks import ALPHA_PAIRS

        self._require_profile()
        self.plans, self.plan_results = [], []
        for alpha in (ALPHA_PAIRS if alphas is None else alphas):
            try:
                self.plan(alpha=alpha, **plan_kw)
            except InfeasiblePlanError:
                continue
            if self.deployment_plan.config not in [p.config for p in self.plans]:
                self.plans.append(self.deployment_plan)
                self.plan_results.append(self.plan_result)
        if not self.plans:
            raise InfeasiblePlanError(
                f"no feasible plan for {self.model} on {self.platform.name} "
                "at any objective weight")
        rec = planner.recommend(self.plan_results)
        self.recommended = self.plan_results.index(rec)
        self.deployment_plan = self.plans[self.recommended]
        self.plan_result = self.plan_results[self.recommended]
        return self

    # ----------------------------------------------------------- replay paths
    def _require_plan(self) -> DeploymentPlan:
        if self.deployment_plan is None:
            self.plan()
        return self.deployment_plan

    def evaluate(self) -> "Session":
        """Closed-form model prediction for the current plan."""
        self.evaluation = self._require_plan().evaluate(
            profile=self._merged_profile(), platform=self.platform)
        return self

    def simulate(self, *, trace: bool = False) -> "Session":
        """Replay the plan through the analytic discrete-event simulator.
        ``trace=True`` attaches the predicted spans (``sim_result.trace``)."""
        self.sim_result = self._require_plan().simulate(
            contention=self.contention, trace=trace,
            profile=self._merged_profile(),
            platform=self.platform)
        return self

    def emulate(self, exec_config=None, *, steps=None, execution=None,
                backend=None, trace=None, faults=None, tolerance=None,
                payload_true=None, throttle=None,
                bandwidth=None) -> "Session":
        """Execute the plan through the storage-backed runtime engine.

        How to execute is an :class:`repro_torch.serverless.execution.
        ExecutionConfig` (backend, steps, tracing, the process backend's
        payload-true/throttle/bandwidth calibration axes, fault injection
        and recovery policy); the individual keywords are the deprecated
        legacy spelling shimmed through the same config.  ``trace=True``
        records per-worker spans (``engine_result.trace``) — the input
        :meth:`calibrate` folds back into a measured profile."""
        from repro_torch.serverless.execution import ExecutionConfig

        ec = ExecutionConfig.merge(
            exec_config,
            dict(backend=backend, steps=steps, trace=trace, faults=faults,
                 tolerance=tolerance, payload_true=payload_true,
                 throttle=throttle, bandwidth=bandwidth),
            where="Session.emulate")
        self.engine_result = self._require_plan().emulate(
            ec, contention=self.contention, execution=execution,
            profile=self._merged_profile(), platform=self.platform)
        return self

    # ------------------------------------------------------ calibration loop
    def calibrate(self, *, warmup: Optional[int] = None) -> "Session":
        """Fold the last traced emulation back into a *measured* profile.

        Requires a prior ``.emulate(ExecutionConfig(trace=True, ...))``.
        The session's profile is replaced by the measured one (already at
        the plan's merged depth — subsequent merging is a no-op), so a
        following ``.plan(...)`` re-solves against observed reality; the
        :class:`repro_torch.obs.calibrate.Calibration` artifact (observations,
        per-stage scales, named perf-model warnings, residuals) lands on
        ``self.calibration``."""
        from repro_torch.obs.calibrate import calibrate_profile

        if self.engine_result is None or self.engine_result.trace is None:
            raise ValueError(
                "calibrate() needs a traced emulation first — call "
                ".emulate(ExecutionConfig(trace=True, ...)) on this session")
        plan = self.deployment_plan
        rp = plan.resolve(profile=self._merged_profile(),
                          platform=self.platform)
        cal = calibrate_profile(
            self.engine_result.trace, rp.profile, rp.platform, rp.config,
            rp.total_micro_batches, pipelined_sync=rp.pipelined_sync,
            warmup=warmup)
        self.calibration = cal
        self.model_profile = cal.profile
        return self

    def _merged_profile(self) -> ModelProfile:
        plan = self.deployment_plan
        prof = self._require_profile()
        if plan.merge_to is not None:
            prof = merge_layers(prof, plan.merge_to)
        return prof

    # ------------------------------------------------------------ persistence
    def save_plan(self, path) -> "Session":
        self._require_plan().save(path)
        return self

    def load_plan(self, path) -> "Session":
        """Load a saved plan and fingerprint-check it against this session's
        freshly built profile (raises PlanCompatibilityError on drift)."""
        plan = DeploymentPlan.load(path)
        prof = self._require_profile()
        if plan.merge_to is not None:
            prof = merge_layers(prof, plan.merge_to)
        plan.resolve(profile=prof, platform=self.platform)  # raises on drift
        self.deployment_plan = plan
        self.plan_result = None
        return self


def session(model: str, platform: Union[str, Platform] = "aws",
            **kw) -> Session:
    """Entry point: ``repro_torch.api.session("bert-large", platform="aws")``."""
    return Session(model, platform, **kw)
