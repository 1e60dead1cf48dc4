"""``python -m repro_torch``: the port's command-line front door (``repro.cli``
for the port).

    plan      profile a model + co-optimize -> print/save a DeploymentPlan
    simulate  replay a plan through the analytic discrete-event simulator
    emulate   execute a plan through the storage-backed runtime engine
    inspect   validate a trace (emulate/simulate --trace); pipeline-health
              metrics + predicted-vs-observed gap attribution
    sweep     the paper's workflow ①-⑤: Pareto frontier + recommendation +
              the §5.6 baseline algorithms (old examples/plan_serverless.py)
    serve     SLO-aware inference serving: plan a serve partition, execute
              pipelined decode on a backend, autoscale under arrival traces
    train     pipelined, tensor-, data- and expert-parallel training on a
              mesh of spawned ranks (``repro_torch.launch.train``;
              ``--plan auto`` asks ``core.tpu_planner`` for the plan)
    dryrun    shape-only sweep of every arch x shape on the production
              meshes: plan, per-rank bytes, analytic and counted roofline
              (``repro_torch.launch.dryrun``)
    bench     not ported: raises NotImplementedError (the benchmark folder
              is the JAX package's; the port's benchmark comes in a change of
              its own)

Every subcommand that plans accepts ``--fast`` (small merge depth, reduced
DP grid) so CI can smoke the whole surface in seconds.  ``plan -o plan.json``
then ``simulate plan.json`` / ``emulate plan.json`` replays the saved
artifact bit-identically (fingerprint-checked; see ``repro_torch.api``).
A plan, trace or measured profile written by either package's CLI is read
by the other's.  ``emulate --numerics`` runs the stage workers on the card
(``--device cuda``, the default; ``--device cpu`` asks for the CPU, never a
silent fallback), every attention layer and FFN through the kernels there.
"""
from __future__ import annotations

import argparse
import sys
from contextlib import contextmanager
from typing import List, Optional

from repro_torch.serverless.platform import MB, get_platform


@contextmanager
def _operator_errors():
    """Model/platform lookups raise KeyError with a helpful message; at the
    CLI that is an operator typo, not a bug — exit cleanly like the old
    per-driver mains did.  Scoped to the lookup call sites so unrelated
    KeyErrors keep their tracebacks."""
    try:
        yield
    except KeyError as e:
        raise SystemExit(
            f"error: {e.args[0] if e.args else e}") from None

_PLATFORM_CHOICES = ("aws", "alibaba")
_FAST = dict(merge_to=6, d_options=(1, 2, 4))


def _add_model_args(p: argparse.ArgumentParser, *, model_default=None):
    p.add_argument("--model", default=model_default,
                   help="paper model (bert-large, resnet101, amoebanet-d18/36)"
                        " or assigned arch id")
    p.add_argument("--platform", default="aws", choices=_PLATFORM_CHOICES)
    p.add_argument("--batch", type=int, default=None,
                   help="global batch size (default 64)")
    p.add_argument("--micro-batch", type=int, default=None,
                   help="micro-batch size (default 4; explicit values are "
                        "also used when profiling arch models)")
    p.add_argument("--seq", type=int, default=None,
                   help="profiling sequence length (arch models)")
    p.add_argument("--lambda-ml-sync", action="store_true",
                   help="use the 3-phase eq (1) collective instead of eq (2)")
    p.add_argument("--contention", action="store_true",
                   help="model §5.4 bandwidth contention")


def _add_cache_args(p: argparse.ArgumentParser):
    p.add_argument("--plan-cache", default=None, metavar="DIR",
                   help="plan-cache directory (default: $REPRO_PLAN_CACHE "
                        "or ~/.cache/repro/plans)")
    p.add_argument("--no-plan-cache", action="store_true",
                   help="always solve; never read or write the plan cache")


def _add_solver_args(p: argparse.ArgumentParser):
    p.add_argument("--merge-to", type=int, default=None,
                   help="layer-merge depth (default: planner default)")
    p.add_argument("--alpha2", type=float, default=None,
                   help="time weight a2 in the objective a1*c + a2*t "
                        "(a1=1; default 2^16 * 1e-9)")
    p.add_argument("--solver", default="cd",
                   choices=("cd", "cd-steepest", "exhaustive", "tpdmp",
                            "bayes"))
    p.add_argument("--engine", default="batch",
                   choices=("batch", "scalar", "dp"),
                   help="search engine: batch/scalar enumerate the merged "
                        "partition space, dp is the exact cut-point DP "
                        "(defaults to full layer depth unless --merge-to "
                        "or --fast bounds it)")
    p.add_argument("--max-stages", type=int, default=None)
    p.add_argument("--fast", action="store_true",
                   help="CI-sized search (merge_to=6, d in {1,2,4})")


def _cache_spec(args):
    """CLI plan-cache policy: on by default (repeated plans/sweeps become
    near-instant), --no-plan-cache to always solve, --plan-cache DIR to
    point somewhere else."""
    if getattr(args, "no_plan_cache", False):
        return None
    explicit = getattr(args, "plan_cache", None)
    return True if explicit is None else explicit


def _make_session(args, **kw):
    from repro_torch.api import session

    return session(args.model, platform=args.platform,
                   global_batch=64 if args.batch is None else args.batch,
                   micro_batch=args.micro_batch,
                   seq=args.seq, pipelined_sync=not args.lambda_ml_sync,
                   contention=getattr(args, "contention", False),
                   plan_cache=_cache_spec(args), **kw)


def _plan_kw(args) -> dict:
    from repro_torch.core import planner

    alpha2 = 2**16 * 1e-9 if args.alpha2 is None else args.alpha2
    if args.solver == "bayes" and args.engine != "batch":
        # bayes is a random sampler over the batched kernel; silently running
        # it instead of the requested scalar/dp engine would mislead
        raise SystemExit(
            f"--solver bayes only runs on the batch kernel; drop "
            f"--engine {args.engine}")
    kw = dict(alpha=(1.0, alpha2), solver=args.solver,
              engine=args.engine)
    if args.solver in ("cd", "cd-steepest", "exhaustive") \
            and args.max_stages is not None:
        kw["max_stages"] = args.max_stages
    if args.merge_to is not None:
        kw["merge_to"] = args.merge_to
    elif args.fast:
        kw["merge_to"] = _FAST["merge_to"]
    elif args.engine == "dp":
        kw["merge_to"] = None          # exact DP: plan at full layer depth
    else:
        kw["merge_to"] = planner.DEFAULT_MERGE_TO
    if args.fast:
        kw["d_options"] = _FAST["d_options"]
    return kw


def _load_or_plan(args):
    """Shared simulate/emulate input: a saved plan file or --model flags."""
    from repro_torch.api import DeploymentPlan

    if args.plan_file:
        # flags that would contradict what the plan file records must not be
        # silently ignored — a replay always uses the recorded decisions
        conflicting = [name for name, passed in [
            ("--model", args.model),
            ("--lambda-ml-sync", args.lambda_ml_sync),
            ("--batch", args.batch is not None),
            ("--alpha2", args.alpha2 is not None),
            ("--merge-to", args.merge_to is not None),
            ("--seq", args.seq is not None),
            ("--micro-batch", args.micro_batch is not None),
            ("--solver", args.solver != "cd"),
            ("--engine", args.engine != "batch"),
            ("--max-stages", args.max_stages is not None),
            ("--fast", args.fast),
            ("--plan-cache", getattr(args, "plan_cache", None) is not None),
        ] if passed]
        if conflicting:
            raise SystemExit(
                f"{', '.join(conflicting)} conflict with replaying "
                f"{args.plan_file}: a saved plan replays exactly as "
                "recorded.  Drop the flags (or drop the file to plan fresh).")
        try:
            return DeploymentPlan.load(args.plan_file)
        except FileNotFoundError:
            raise SystemExit(f"error: no such plan file: {args.plan_file}")
    if not args.model:
        raise SystemExit("pass a saved plan.json or --model")
    with _operator_errors():        # unknown model/platform lookups only
        s = _make_session(args).profile()
    return s.plan(**_plan_kw(args)).deployment_plan


def _profile_override(args) -> dict:
    """``--profile FILE``: resolve the plan against a saved (typically
    *measured*) ModelProfile instead of rebuilding the analytic tables —
    the only way to replay a plan whose ``profile_source`` is measured."""
    if not getattr(args, "profile", None):
        return {}
    from repro_torch.core.partition import ModelProfile

    try:
        return {"profile": ModelProfile.load(args.profile)}
    except FileNotFoundError:
        raise SystemExit(f"error: no such profile file: {args.profile}")


# ------------------------------------------------------------------- plan
def _cmd_plan(args) -> int:
    if not args.model:
        raise SystemExit("--model is required")
    with _operator_errors():        # unknown model/platform lookups only
        s = _make_session(args).profile()
    plan = s.plan(**_plan_kw(args)).deployment_plan
    print(plan.describe())
    cached = " [plan cache hit]" if s.plan_cache and s.plan_cache.hits else ""
    print(f"solve: {plan.solve_seconds:.2f}s{cached} "
          f"(alpha={plan.alpha[0]:g},{plan.alpha[1]:.3e}; "
          f"objective={plan.objective:.6f})")
    r = s.plan_result
    if r is not None and r.stats is not None:
        print(f"planner: {r.stats.describe()}")
    if args.out:
        plan.save(args.out)
        print(f"wrote {args.out} (content hash {plan.content_hash})")
    return 0


# --------------------------------------------------------------- simulate
def _cmd_simulate(args) -> int:
    from repro_torch.core.perfmodel import evaluate
    from repro_torch.serverless.simulator import simulate_funcpipe

    plan = _load_or_plan(args)
    print(plan.describe())
    # one profile rebuild + fingerprint check (--profile overrides rebuild)
    rp = plan.resolve(**_profile_override(args))
    sim = simulate_funcpipe(rp.profile, rp.platform, rp.config,
                            rp.total_micro_batches,
                            pipelined_sync=rp.pipelined_sync,
                            contention=args.contention,
                            trace=bool(args.trace))
    if args.trace:
        sim.trace.save(args.trace)
        print(f"wrote trace {args.trace} "
              f"({len(sim.trace.spans)} predicted spans)")
    bd = sim.breakdown
    print(f"simulate: t_iter={sim.t_iter:.3f}s cost=${sim.cost:.6f}/iter "
          f"mem={sim.total_mem_gb:.1f}GB "
          f"(compute={bd['compute']:.3f}s pipe_comm={bd['pipeline_comm']:.3f}s "
          f"sync={bd['sync']:.3f}s)")
    ev = evaluate(rp.profile, rp.platform, rp.config, rp.total_micro_batches,
                  pipelined_sync=rp.pipelined_sync)
    print(f"vs perfmodel: t_iter={ev.t_iter:.3f}s "
          f"(rel err {abs(sim.t_iter - ev.t_iter) / ev.t_iter:.1%})")
    return 0


# ---------------------------------------------------------------- emulate
def _numeric_partition(cfg, n_stages: int) -> tuple:
    """Boundary vector over the arch profile ([embed]+layers+[head]) cutting
    at period boundaries so every stage owns whole instances."""
    L = cfg.n_layers + 2
    plen = cfg.period_len
    n_inst = cfg.n_periods
    assert n_stages <= n_inst, (n_stages, n_inst)
    x = [0] * (L - 1)
    for s in range(1, n_stages):
        inst = round(s * n_inst / n_stages)
        layer = inst * plen               # first layer of stage s
        x[layer] = 1                      # cut after profile layer `layer`
    return tuple(x)


def _min_feasible_z(profile, platform, x, d, mu):
    from repro_torch.core import planner

    stage_mem = planner._min_feasible_stage_mem(profile, platform, x, d, mu)
    if stage_mem is None:
        raise SystemExit("no memory option fits the per-stage working set")
    return planner._expand_z(stage_mem, x, profile.L)


def _numeric_plan(args):
    """Numeric-mode setup: period-aligned manual partition + Execution on
    ``--device`` (weights from torch's generator at seed 0, batches from the
    port's synthetic loader)."""
    import dataclasses

    import torch

    from repro_torch.api import DeploymentPlan
    from repro_torch.models.common import resolve_device
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.perfmodel import Config
    from repro_torch.core.profiler import arch_model_profile
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import registry
    from repro_torch.optim import AdamW
    from repro_torch.serverless.runtime import Execution

    platform = get_platform(args.platform)
    arch = args.model or "phi3-mini-3.8b"
    if arch not in ARCH_IDS:
        raise SystemExit(
            f"--numerics runs the real model and needs a ported arch id, got "
            f"{arch!r}; archs: {sorted(ARCH_IDS)}")
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              n_layers=args.n_layers)
    seq = args.seq if args.seq is not None else 16
    batch = 64 if args.batch is None else args.batch
    shape = InputShape("emulate", seq, batch, "train")
    mu = max(1, batch // (args.dp * 2))
    if batch % (args.dp * mu):
        raise SystemExit(f"--batch {batch} must be divisible by dp*mu "
                         f"= {args.dp}*{mu}")
    if args.stages > cfg.n_periods:
        raise SystemExit(
            f"--stages {args.stages} exceeds the {cfg.n_periods} period "
            f"instances of {arch} at --n-layers {args.n_layers}")
    mb = batch // (args.dp * mu)
    prof = arch_model_profile(cfg, platform, seq=seq, micro_batch=mb)
    x = _numeric_partition(cfg, args.stages)
    z = _min_feasible_z(prof, platform, x, args.dp, mu)
    plan = DeploymentPlan.from_config(
        prof, platform, Config(x=x, d=args.dp, z=z), args.dp * mu,
        model=f"{arch}@reduced{args.n_layers}",   # replayable spelling
        pipelined_sync=not args.lambda_ml_sync, seq=seq,
        micro_batch=mb, solver="manual")
    try:
        dev = resolve_device(args.device)   # no card: an error, never the CPU
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None
    params0 = registry.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                   device=dev)
    ex = Execution(cfg=cfg, optimizer=AdamW(lr=1e-2), init_params=params0,
                   batch_fn=lambda k: make_batch(cfg, shape, step=k, device=dev),
                   use_kernels=True, device=dev)
    return plan, prof, ex


def _cmd_emulate(args) -> int:
    from repro_torch.core.perfmodel import evaluate
    from repro_torch.serverless.runtime import run_plan
    from repro_torch.serverless.simulator import simulate_funcpipe

    if args.numerics:
        if args.plan_file:
            raise SystemExit(
                "--numerics builds its own period-aligned plan and cannot "
                "replay a plan file; drop the file argument (numeric runs "
                "can SAVE their plan with -o, and that file replays on the "
                "timing axis via `repro simulate`/`repro emulate` without "
                "--numerics)")
        # the numeric partition is manual: solver flags would be silently
        # ignored, so reject them (mirrors the plan-file conflict check)
        ignored = [name for name, passed in [
            ("--merge-to", args.merge_to is not None),
            ("--alpha2", args.alpha2 is not None),
            ("--micro-batch", args.micro_batch is not None),
            ("--solver", args.solver != "cd"),
            ("--engine", args.engine != "batch"),
            ("--max-stages", args.max_stages is not None),
            ("--fast", args.fast),
            ("--profile", bool(args.profile)),
        ] if passed]
        if ignored:
            raise SystemExit(
                f"{', '.join(ignored)} have no effect with --numerics "
                "(the numeric partition comes from --stages/--dp/--batch)")
        plan, prof, ex = _numeric_plan(args)
        rp = plan.resolve(profile=prof)
    else:
        plan = _load_or_plan(args)
        rp = plan.resolve(**_profile_override(args))
        ex = None
    print(plan.describe())
    if args.out:
        plan.save(args.out)
        print(f"wrote {args.out} (content hash {plan.content_hash})")

    from repro_torch.serverless.execution import ExecutionConfig

    faults_obj = None
    if args.fault_plan and args.fault_seed is not None:
        raise SystemExit("--fault-plan and --fault-seed are mutually "
                         "exclusive (one names the schedule, the other "
                         "generates it)")
    if args.fault_plan or args.fault_seed is not None:
        from repro_torch.serverless import faults as F

        if args.fault_plan:
            faults_obj = F.FaultPlan.load(args.fault_plan)
        else:
            faults_obj = F.FaultPlan.generate(
                args.fault_seed, steps=args.steps,
                S=sum(rp.config.x) + 1, d=rp.config.d)
        print(f"fault plan: {faults_obj.counts() or 'empty'} "
              f"(seed={faults_obj.seed})")

    try:
        ec = ExecutionConfig(
            backend=args.backend, steps=args.steps, trace=bool(args.trace),
            payload_true=bool(args.payload_true),
            throttle=bool(args.throttle), bandwidth=args.bandwidth,
            faults=faults_obj, retries=args.retries,
            checkpoint_every=args.checkpoint_every)
        with _operator_errors():    # unknown backend name lists the registry
            ec.resolve_backend()    # all execution validation lives here
    except ValueError as e:
        raise SystemExit(f"error: {e}") from None
    res = run_plan(rp.profile, rp.platform, rp.config,
                   rp.total_micro_batches, ec,
                   pipelined_sync=rp.pipelined_sync,
                   contention=args.contention, execution=ex)
    for k, m in enumerate(res.metrics):
        print(f"step {k}: loss={m['loss']:.4f} ce={m['ce']:.4f} "
              f"aux={m['aux']:.4f}")
    clock = "host wall-clock" if res.wall_clock else "virtual"
    # a wall-clock run gives compute and pipe_comm only when traced
    parts = " ".join(f"{label}={res.breakdown[k]:.3f}s" for k, label in (
        ("compute", "compute"), ("pipeline_comm", "pipe_comm"), ("sync", "sync"))
        if k in res.breakdown)
    print(f"engine[{res.backend}]: t_iter={res.t_iter:.3f}s ({clock}) "
          f"cost=${res.cost:.6f}/iter mem={res.total_mem_gb:.1f}GB ({parts})")
    ss = res.store_stats
    print(f"store: {ss.puts} puts / {ss.gets} gets / {ss.deletes} deletes, "
          f"{ss.bytes_in / MB:.0f}MB in / {ss.bytes_out / MB:.0f}MB out, "
          f"peak {ss.peak_bytes / MB:.0f}MB (drained, bytes conserved)")
    if ss.class_bytes_in:
        per_cls = " ".join(f"{c}={ss.class_bytes_in[c] / MB:.0f}MB"
                           for c in sorted(ss.class_bytes_in))
        print(f"store uploads by key class: {per_cls}")
    if res.fault_report is not None:
        print(f"fault tolerance: {res.fault_report.describe()}")

    if args.trace:
        # attach the simulator's predicted timeline so `python -m repro_torch inspect` can
        # run the gap attribution straight off the file
        sim_t = simulate_funcpipe(rp.profile, rp.platform, rp.config,
                                  rp.total_micro_batches,
                                  pipelined_sync=rp.pipelined_sync,
                                  contention=args.contention, trace=True)
        res.trace.predicted = sim_t.trace.spans
        # embed the plan document so `python -m repro_torch calibrate` (and inspect) can
        # re-plan straight from the file, no plan JSON needed
        res.trace.meta["plan"] = plan._as_dict()
        res.trace.save(args.trace)
        print(f"wrote trace {args.trace} ({len(res.trace.spans)} spans + "
              f"{len(sim_t.trace.spans)} predicted)")

    if res.wall_clock:
        # host seconds are not the cost model's seconds: the analytic
        # comparison only makes sense on virtual-clock backends
        print(f"vs simulator: n/a (backend {res.backend!r} measures host "
              "wall-clock; numerics validated instead)")
        return 0
    sim = simulate_funcpipe(rp.profile, rp.platform, rp.config,
                            rp.total_micro_batches,
                            pipelined_sync=rp.pipelined_sync,
                            contention=args.contention)
    ev = evaluate(rp.profile, rp.platform, rp.config, rp.total_micro_batches,
                  pipelined_sync=rp.pipelined_sync)
    for name, t in [("simulator", sim.t_iter), ("perfmodel", ev.t_iter)]:
        print(f"vs {name}: t_iter={t:.3f}s "
              f"(rel err {abs(res.t_iter - t) / t:.1%})")
    return 0


# ------------------------------------------------------------------ sweep
def _cmd_sweep(args) -> int:
    """Paper workflow ①-⑤ (old examples/plan_serverless.py output format)."""
    import os

    from repro_torch.api import InfeasiblePlanError
    from repro_torch.core import planner
    from repro_torch.core.partition import stages_of
    from repro_torch.serverless.frameworks import ALPHA_PAIRS
    from repro_torch.serverless.simulator import simulate_funcpipe

    if not args.model:
        raise SystemExit("--model is required")
    platform = get_platform(args.platform)
    with _operator_errors():
        s = _make_session(args)
        prof = s.profile().model_profile
    M = s.total_micro_batches
    if args.merge_to is not None:
        merge_to = args.merge_to
    elif args.fast:
        merge_to = _FAST["merge_to"]
    elif args.engine == "dp":
        merge_to = None                # exact DP: sweep at full layer depth
    else:
        merge_to = 12
    print(f"model={args.model} params={prof.param_bytes/2**20:.0f}MB "
          f"layers={prof.L} global_batch={s.global_batch} micro_batches={M} "
          f"merge_to={'full' if merge_to is None else merge_to} "
          f"engine={args.engine}")
    plan_kw = dict(merge_to=merge_to, engine=args.engine)
    if args.fast:
        plan_kw["d_options"] = _FAST["d_options"]
    results, saved = [], []
    for alpha in ALPHA_PAIRS:
        try:
            s.plan(alpha=alpha, **plan_kw)
        except InfeasiblePlanError:
            print(f"alpha={alpha}: infeasible")
            continue
        r, plan = s.plan_result, s.deployment_plan
        results.append(r)
        saved.append(plan)
        sim = simulate_funcpipe(r.profile, platform, r.config, M,
                                pipelined_sync=s.pipelined_sync,
                                contention=args.contention)
        st = stages_of(r.config.x)
        mems = [platform.memory_options[r.config.z[lo]] // MB for lo, _ in st]
        print(f"alpha2={alpha[1]:.2e}: stages={len(st)} d={r.config.d} "
              f"mem={mems}MB t_iter={sim.t_iter:.2f}s cost=${sim.cost:.5f} "
              f"(model predicts {r.evaluation.t_iter:.2f}s; "
              f"solve {r.solve_seconds:.1f}s)")
    if not results:
        print("no feasible FuncPipe config for this model/batch on this "
              "platform (try a smaller batch or the alibaba platform)")
        return 1
    rec = planner.recommend(results)
    print(f"\nRECOMMENDED: d={rec.config.d}, {sum(rec.config.x)+1} stages, "
          f"t={rec.evaluation.t_iter:.2f}s, ${rec.evaluation.c_iter:.5f}/iter")
    if s.plan_cache is not None and (s.plan_cache.hits or s.plan_cache.misses):
        print(f"plan cache: {s.plan_cache.hits} hits / "
              f"{s.plan_cache.misses} misses / "
              f"{s.plan_cache.evictions} evicted ({s.plan_cache.root})")
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        for plan in saved:
            path = os.path.join(args.save_dir,
                                f"{plan.model}-{plan.content_hash}.json")
            plan.save(path)
        print(f"saved {len(saved)} plans to {args.save_dir}/")

    print("\nbaseline algorithms (same objective, alpha2=2^19e-9):")
    base_merge = 8 if merge_to is None else min(8, merge_to)
    for name in ("tpdmp", "bayes"):
        try:
            s.plan(alpha=(1.0, 2**19 * 1e-9), solver=name,
                   merge_to=base_merge,
                   **({"d_options": _FAST["d_options"]} if args.fast else {}))
        except InfeasiblePlanError:
            continue
        r = s.plan_result
        print(f"  {name}: t={r.evaluation.t_iter:.2f}s "
              f"${r.evaluation.c_iter:.5f} obj={r.objective:.5f}")
    return 0


# ------------------------------------------------------------------ serve
def _cmd_serve(args) -> int:
    """Plan (or replay) a ``workload="serve"`` deployment; optionally run the
    pipelined decode through a backend and/or the autoscaling simulator."""
    from repro_torch.api import DeploymentPlan
    from repro_torch.serving import autoscale_plan, plan_serving, run_serve_plan

    if args.plan_file:
        if args.model or args.slo is not None:
            raise SystemExit(
                "--model/--slo conflict with replaying a saved serve plan; "
                "drop the flags (or drop the file to plan fresh)")
        try:
            plan = DeploymentPlan.load(args.plan_file)
        except FileNotFoundError:
            raise SystemExit(f"error: no such plan file: {args.plan_file}")
    else:
        if not args.model:
            raise SystemExit("pass a saved serve plan.json or --model")
        if args.slo is None:
            raise SystemExit("--slo SECONDS is required when planning "
                             "(the per-request latency constraint)")
        with _operator_errors():    # unknown model/platform lookups only
            plan = plan_serving(
                args.model, args.platform, slo=args.slo,
                batch=args.serve_batch, prefill_tokens=args.prefill_tokens,
                new_tokens=args.new_tokens, max_stages=args.max_stages)
    print(plan.describe())
    sv = plan.serving or {}
    if "n_feasible" in sv:
        print(f"planner: {sv['n_feasible']} feasible candidates over "
              f"{sv['n_candidates']} partitions; "
              f"t_prefill={sv['t_prefill']:.3f}s "
              f"t_token={sv['t_token'] * 1e3:.1f}ms "
              f"kv={sum(sv['kv_bytes']) / MB:.1f}MB/stage-set")
    if args.out:
        plan.save(args.out)
        print(f"wrote {args.out} (content hash {plan.content_hash})")

    if args.execute:
        from repro_torch.models.common import resolve_device

        try:
            dev = resolve_device(args.device)   # no card: an error, never the CPU
        except RuntimeError as e:
            raise SystemExit(f"error: {e}") from None
        res = run_serve_plan(plan, backend=args.execute, seed=args.seed,
                             trace=bool(args.trace), device=dev, use_kernels=True)
        clock = "host wall-clock" if res.backend == "process" else "virtual"
        print(f"serve[{res.backend}]: {res.tokens.shape[0]} request(s) x "
              f"{res.tokens.shape[1]} tokens  t_request={res.t_request:.3f}s "
              f"({clock})  cost=${res.cost_per_1k:.4f}/1k-req")
        print(f"tokens: {res.tokens.tolist()}")
        ss = res.store_stats
        cls = ss.class_bytes_in or {}
        per_cls = " ".join(f"{c}={cls[c] / MB:.2f}MB" for c in sorted(cls))
        print(f"store: {ss.puts} puts / {ss.gets} gets (drained); "
              f"uploads by key class: {per_cls or 'none'}")
        if args.trace:
            res.trace.save(args.trace)
            print(f"wrote trace {args.trace} ({len(res.trace.spans)} spans)")

    if args.autoscale:
        try:
            replicas = tuple(int(x) for x in args.autoscale.split(","))
        except ValueError:
            raise SystemExit(
                f"--autoscale wants a comma list of replica counts, got "
                f"{args.autoscale!r}")
        rows = autoscale_plan(
            plan, rate=args.rate, horizon=args.horizon, replicas=replicas,
            arrival=args.arrival, trace_file=args.trace_file, seed=args.seed)
        print(f"\nautoscale ({args.arrival} arrivals, rate={args.rate}/s, "
              f"horizon={args.horizon}s, seed={args.seed}):")
        print("replicas  requests      p50      p95      p99  viol%  "
              "cold      $/1k   util")
        for r in rows:
            print(f"{r.replicas:>8d}  {r.requests:>8d} {r.p50:>8.3f} "
                  f"{r.p95:>8.3f} {r.p99:>8.3f} "
                  f"{r.slo_violation_frac:>6.1%} {r.cold_starts:>5d} "
                  f"{r.cost_per_1k:>9.4f} {r.utilization:>6.1%}")
    return 0


# ---------------------------------------------------------------- inspect
def _cmd_inspect(args) -> int:
    """Validate a saved trace and print pipeline health + gap attribution."""
    from repro_torch.obs import (
        ELAPSED,
        Trace,
        TraceValidationError,
        gap_attribution,
        pipeline_health,
        validate_trace,
    )

    try:
        tr = Trace.load(args.trace_file)
    except FileNotFoundError:
        raise SystemExit(f"error: no such trace file: {args.trace_file}")
    except (ValueError, KeyError) as e:
        raise SystemExit(f"error: not a repro trace: {e}")
    try:
        validate_trace(tr)
    except TraceValidationError as e:
        raise SystemExit(f"trace INVALID: {e}")
    meta = tr.meta
    print(f"trace OK: {len(tr.spans)} spans  model={meta.get('model', '?')} "
          f"backend={meta.get('backend', '?')} "
          f"clock={meta.get('clock', '?')} "
          f"S={meta.get('S', '?')} d={meta.get('d', '?')} "
          f"mu={meta.get('mu', '?')} steps={meta.get('steps', '?')} "
          f"t_total={float(meta.get('t_total', 0.0)):.3f}s")

    h = pipeline_health(tr)
    have_bw = any("up_bw_util" in row for row in h["stages"])
    hdr = "stage  compute  bubble    up-busy  dn-busy"
    if have_bw:
        hdr += "  up-util  dn-util"
    print(hdr)
    for row in h["stages"]:
        line = (f"{row['stage']:>5d}  {row['compute_frac']:>7.1%} "
                f"{row['bubble_frac']:>7.1%}  {row['up_frac']:>7.1%} "
                f"{row['dn_frac']:>8.1%}")
        if "up_bw_util" in row:
            line += f"  {row['up_bw_util']:>7.1%}  {row['dn_bw_util']:>7.1%}"
        print(line)
    print(f"straggler ratio: {h['straggler_ratio']:.3f}")
    rcv = h.get("recovery")
    if rcv is not None:
        print(f"recovery: {rcv['retry_count']} retries "
              f"({rcv['retry_s']:.3f}s backoff), "
              f"{rcv['restart_count']} restore reads "
              f"({rcv['restart_s']:.3f}s, "
              f"{rcv['restart_bytes'] / MB:.0f}MB re-fetched)")
    for phase in ("fwd", "bwd", "sync"):
        pb = h["phase_bytes"].get(phase)
        if pb:
            print(f"bytes[{phase}]: {pb['up'] / MB:.0f}MB up / "
                  f"{pb['dn'] / MB:.0f}MB down")
    rec = h.get("reconciliation")
    if rec is not None:
        verdict = "OK" if rec["ok"] else "MISMATCH"
        print(f"byte reconciliation vs StoreStats: {verdict} "
              f"(spans {rec['span_bytes_up'] / MB:.0f}MB up vs store "
              f"{rec['store_bytes_in'] / MB:.0f}MB in; "
              f"spans {rec['span_bytes_dn'] / MB:.0f}MB down vs store "
              f"{rec['store_bytes_out'] / MB:.0f}MB out)")
    store = meta.get("store") or {}
    cls_in = store.get("class_bytes_in") or {}
    if cls_in:
        per_cls = " ".join(f"{c}={cls_in[c] / MB:.0f}MB"
                           for c in sorted(cls_in))
        print(f"store uploads by key class: {per_cls}")

    if not tr.predicted:
        print("no predicted timeline in this trace — produce one with "
              "`python -m repro_torch emulate --trace` (gap attribution skipped)")
        return 0
    if meta.get("clock") == "wall":
        print("note: observed spans are host wall-clock, predicted spans "
              "are modeled seconds — gaps below compare across clocks")
    rows = gap_attribution(tr)
    print(f"\ngap attribution (top {args.top} of {len(rows)} cells, "
          "per replica-step seconds):")
    print("stage  phase  op          observed  predicted       gap")
    for r in rows[:args.top]:
        op = "elapsed" if r.op == ELAPSED else r.op
        print(f"{r.stage:>5d}  {r.phase:<5s}  {op:<10s} "
              f"{r.observed_s:>9.4f}  {r.predicted_s:>9.4f} "
              f"{r.gap_s:>+9.4f}")
    return 0


# -------------------------------------------------------------- calibrate
def _cmd_calibrate(args) -> int:
    from repro_torch.api import DeploymentPlan
    from repro_torch.obs import Trace, calibrate_trace, replan

    try:
        trace = Trace.load(args.trace_file)
    except FileNotFoundError:
        raise SystemExit(f"error: no such trace file: {args.trace_file}")
    plan = None
    if args.plan:
        try:
            plan = DeploymentPlan.load(args.plan)
        except FileNotFoundError:
            raise SystemExit(f"error: no such plan file: {args.plan}")
    try:
        cal, plan = calibrate_trace(trace, plan=plan, warmup=args.warmup)
    except ValueError as e:
        raise SystemExit(f"error: {e}") from None
    print(cal.describe())
    if args.profile_out:
        cal.profile.save(args.profile_out)
        print(f"wrote measured profile {args.profile_out}")
    if args.no_replan:
        return 0
    alpha = (1.0, args.alpha2) if args.alpha2 is not None else None
    rep = replan(cal, plan, alpha=alpha, engine=args.engine)
    print(rep.describe())
    if args.out:
        rep.new_plan.save(args.out)
        hint = args.profile_out or "PROFILE.json (save one with --profile-out)"
        print(f"wrote re-planned {args.out} (content hash "
              f"{rep.new_plan.content_hash}); replay it with "
              f"`python -m repro_torch simulate/emulate {args.out} --profile {hint}`")
    return 0


# ------------------------------------------------------------- not ported
_NOT_PORTED = {
    "bench": "the JAX package's paper-table benchmarks (benchmarks/run.py) are not "
             "ported: the benchmark folder is the JAX package's, and the port's "
             "benchmark comes in a change of its own",
}


def _not_ported(cmd: str):
    raise NotImplementedError(f"python -m repro_torch {cmd}: {_NOT_PORTED[cmd]}")


# ------------------------------------------------------------------- main
def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # train/dryrun forward their whole tail to the launch drivers' own
    # parsers (argparse REMAINDER won't capture a leading option like
    # --help, so dispatch before parsing)
    if argv and argv[0] in _NOT_PORTED:
        _not_ported(argv[0])
    if argv and argv[0] == "train":
        from repro_torch.launch.train import main as train_main

        return train_main(argv[1:])
    if argv and argv[0] == "dryrun":
        from repro_torch.launch.dryrun import main as dryrun_main

        return dryrun_main(argv[1:])

    ap = argparse.ArgumentParser(
        prog="repro_torch", description="FuncPipe on PyTorch: plan, replay and "
        "train serverless deployments (see repro_torch.api for the library "
        "front door)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("plan", help="co-optimize and save a DeploymentPlan")
    _add_model_args(p)
    _add_solver_args(p)
    _add_cache_args(p)
    p.add_argument("-o", "--out", default=None, help="write plan JSON here")
    p.set_defaults(func=_cmd_plan)

    p = sub.add_parser("simulate",
                       help="replay a plan through the analytic simulator")
    p.add_argument("plan_file", nargs="?", default=None,
                   help="saved DeploymentPlan JSON (or pass --model to plan)")
    _add_model_args(p)
    _add_solver_args(p)
    _add_cache_args(p)
    p.add_argument("--trace", default=None, metavar="OUT.json",
                   help="write the simulator's predicted span timeline as a "
                        "Chrome/Perfetto trace (see `python -m repro_torch inspect`)")
    p.add_argument("--profile", default=None, metavar="PROFILE.json",
                   help="resolve the plan against this saved ModelProfile "
                        "(e.g. a measured profile from `python -m repro_torch calibrate "
                        "--profile-out`) instead of rebuilding the analytic "
                        "tables — required to replay measured plans")
    p.set_defaults(func=_cmd_simulate)

    p = sub.add_parser("emulate",
                       help="execute a plan through the runtime engine")
    p.add_argument("plan_file", nargs="?", default=None,
                   help="saved DeploymentPlan JSON (or pass --model to plan)")
    _add_model_args(p)
    _add_solver_args(p)
    _add_cache_args(p)
    # validated against the live backend registry at run time (not a
    # hardcoded choices=) so register_backend'ed third-party names work here
    p.add_argument("--backend", default="emulated", metavar="NAME",
                   help="execution backend: emulated (virtual-clock cost "
                        "model, default), local (real concurrent worker "
                        "threads, host wall-clock), process (real OS worker "
                        "processes over a file store), aws (real S3 object "
                        "store, needs boto3), oss (stub), or any registered "
                        "backend name; the same plan JSON drives any of them")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("-o", "--out", default=None,
                   help="also save the executed plan JSON here")
    p.add_argument("--numerics", action="store_true",
                   help="run the real model through the store (reduced arch)")
    p.add_argument("--device", default="cuda",
                   help="where --numerics runs the stage workers (default "
                        "cuda; pass cpu to run on the CPU)")
    p.add_argument("--stages", type=int, default=2, help="numeric mode stages")
    p.add_argument("--dp", type=int, default=2, help="numeric mode DP degree")
    p.add_argument("--n-layers", type=int, default=4,
                   help="numeric mode depth")
    p.add_argument("--trace", default=None, metavar="OUT.json",
                   help="record per-worker spans and write a Chrome/Perfetto "
                        "trace with the simulator's predicted timeline "
                        "attached (see `python -m repro_torch inspect`)")
    p.add_argument("--payload-true", action="store_true",
                   help="charge store transfers their real payload sizes "
                        "(np nbytes) instead of the modeled ones; process "
                        "backend only")
    p.add_argument("--throttle", action="store_true",
                   help="sleep each store transfer for nbytes/bandwidth + "
                        "latency per the platform profile, giving traces a "
                        "calibrated wall-clock time axis; process backend "
                        "only")
    p.add_argument("--bandwidth", type=float, default=None, metavar="BYTES_S",
                   help="override the per-worker throttle bandwidth in "
                        "bytes/s (default: the plan's modeled per-worker "
                        "store bandwidth); implies --throttle")
    p.add_argument("--fault-plan", default=None, metavar="PLAN.json",
                   help="chaos-test the run: inject faults from a saved "
                        "FaultPlan JSON; recovery must reproduce the "
                        "fault-free numbers bit-for-bit")
    p.add_argument("--fault-seed", type=int, default=None, metavar="N",
                   help="generate a seeded FaultPlan sized to this run "
                        "instead of loading --fault-plan")
    p.add_argument("--retries", type=int, default=None, metavar="N",
                   help="enable fault tolerance with N max attempts per "
                        "store op (default 5 when faults are injected)")
    p.add_argument("--checkpoint-every", type=int, default=None, metavar="N",
                   help="checkpoint stage state into the object store every "
                        "N steps (default 1 when fault tolerance is on)")
    p.add_argument("--profile", default=None, metavar="PROFILE.json",
                   help="resolve the plan against this saved ModelProfile "
                        "(e.g. a measured profile from `python -m repro_torch calibrate "
                        "--profile-out`) instead of rebuilding the analytic "
                        "tables — required to replay measured plans")
    p.set_defaults(func=_cmd_emulate)

    p = sub.add_parser("inspect",
                       help="validate a saved trace; print pipeline health "
                            "metrics + predicted-vs-observed gap attribution")
    p.add_argument("trace_file", help="trace JSON from emulate/simulate --trace")
    p.add_argument("--top", type=int, default=10,
                   help="attribution rows to print (default 10)")
    p.set_defaults(func=_cmd_inspect)

    p = sub.add_parser("calibrate",
                       help="fold a traced run back into a measured "
                            "profile, re-plan on it and report the delta")
    p.add_argument("trace_file",
                   help="trace JSON from `python -m repro_torch emulate --trace` (the plan "
                        "document is embedded in the trace metadata)")
    p.add_argument("--plan", default=None, metavar="PLAN.json",
                   help="plan the trace executed (only needed for traces "
                        "written before plans were embedded in trace "
                        "metadata)")
    p.add_argument("--warmup", type=int, default=None, metavar="N",
                   help="drop the first N steps from the averages (default: "
                        "1 on multi-step wall-clock traces — JIT compile "
                        "skew — else 0)")
    p.add_argument("--alpha2", type=float, default=None,
                   help="re-plan objective time weight (default: the plan's "
                        "recorded alpha; manual/numeric plans record "
                        "cost-only)")
    p.add_argument("--engine", default="dp",
                   choices=("dp", "batch", "scalar"),
                   help="re-plan engine (default dp: exact at the measured "
                        "profile's full depth)")
    p.add_argument("--no-replan", action="store_true",
                   help="only calibrate and report; skip the re-plan")
    p.add_argument("--profile-out", default=None, metavar="PROFILE.json",
                   help="save the measured ModelProfile here (replay plans "
                        "with `python -m repro_torch simulate/emulate --profile`)")
    p.add_argument("-o", "--out", default=None, metavar="PLAN.json",
                   help="save the re-planned DeploymentPlan here")
    p.set_defaults(func=_cmd_calibrate)

    p = sub.add_parser("sweep", help="Pareto frontier + recommendation + "
                                     "baseline algorithms (paper §5)")
    _add_model_args(p)
    _add_cache_args(p)
    p.add_argument("--merge-to", type=int, default=None)
    p.add_argument("--engine", default="batch",
                   choices=("batch", "scalar", "dp"),
                   help="planner engine for the sweep; dp sweeps exactly at "
                        "full layer depth unless --merge-to bounds it")
    p.add_argument("--fast", action="store_true")
    p.add_argument("--save-dir", default=None,
                   help="save every swept plan JSON into this directory")
    p.set_defaults(func=_cmd_sweep)

    p = sub.add_parser("serve", help="SLO-aware serving: plan, execute "
                                     "pipelined decode, autoscale")
    p.add_argument("plan_file", nargs="?", default=None,
                   help="saved workload='serve' DeploymentPlan JSON "
                        "(or pass --model + --slo to plan fresh)")
    p.add_argument("--model", default=None,
                   help="assigned arch id at reduced depth "
                        "(e.g. phi3-mini-3.8b@reduced)")
    p.add_argument("--platform", default="aws", choices=_PLATFORM_CHOICES)
    p.add_argument("--slo", type=float, default=None, metavar="SECONDS",
                   help="per-request latency SLO the plan must meet "
                        "(infeasible SLOs exit with InfeasibleSLOError)")
    p.add_argument("--serve-batch", type=int, default=1,
                   help="requests decoded together per pipeline (default 1)")
    p.add_argument("--prefill-tokens", type=int, default=64,
                   help="prompt length the SLO is planned at (default 64)")
    p.add_argument("--new-tokens", type=int, default=8,
                   help="tokens decoded per request (default 8)")
    p.add_argument("--max-stages", type=int, default=None)
    p.add_argument("-o", "--out", default=None, help="write plan JSON here")
    p.add_argument("--execute", default=None, metavar="BACKEND",
                   help="run the pipelined prefill+decode through an "
                        "execution backend (emulated | process) and check "
                        "the store drains")
    p.add_argument("--seed", type=int, default=0,
                   help="prompt/arrival seed (default 0; deterministic)")
    p.add_argument("--trace", default=None, metavar="OUT.json",
                   help="with --execute: record prefill/decode spans and "
                        "write a Chrome/Perfetto trace (see `python -m repro_torch inspect`)")
    p.add_argument("--device", default="cuda",
                   help="where --execute runs the stages (default cuda; pass "
                        "cpu to run on the CPU)")
    p.add_argument("--autoscale", default=None, metavar="N,N,...",
                   help="simulate these replica counts under a seeded "
                        "arrival trace (p50/p95/p99, SLO violations, cold "
                        "starts, cost)")
    p.add_argument("--rate", type=float, default=1.0,
                   help="autoscale arrival rate, req/s (default 1.0)")
    p.add_argument("--horizon", type=float, default=120.0,
                   help="autoscale trace horizon, seconds (default 120)")
    p.add_argument("--arrival", default="poisson",
                   choices=("poisson", "bursty", "trace"))
    p.add_argument("--trace-file", default=None, metavar="GAPS.txt",
                   help="inter-arrival gaps file for --arrival trace")
    p.set_defaults(func=_cmd_serve)

    # dispatched before parsing: registered so --help lists them
    sub.add_parser("train", help="pipelined mesh training on spawned ranks "
                   "(python -m repro_torch train --help)", add_help=False)
    sub.add_parser("dryrun", help="shape-only mesh sweep (python -m repro_torch "
                   "dryrun --help)", add_help=False)
    for cmd, what in _NOT_PORTED.items():
        sub.add_parser(cmd, help=f"not ported: {what}", add_help=False)

    args = ap.parse_args(argv)
    from repro_torch.api import InfeasiblePlanError, PlanCompatibilityError
    from repro_torch.serverless.backends import BackendUnavailableError

    try:
        return args.func(args) or 0
    except (PlanCompatibilityError, InfeasiblePlanError,
            BackendUnavailableError) as e:
        # operator-facing outcomes (incl. cloud-backend stubs), not bugs:
        # exit cleanly with the message; a genuine NotImplementedError
        # elsewhere still crashes loudly with its traceback
        raise SystemExit(f"error: {e}") from None


if __name__ == "__main__":
    sys.exit(main())
