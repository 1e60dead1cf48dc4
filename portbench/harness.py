"""One run of one cell of the port's benchmark.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<name>.json``, its family's plain reference in
``reference/<family>.py`` and its port adapter in ``adapters/<family>.py``)
and a traffic mix (``traffic/<name>.json``); its limits are in
``limits/<cell>.json`` and its per-layer metrics' readers in
``metrics/<metric>.py``.  The family gives the step's model FLOPs and the
kernel launches it expects; the kernels whose calls are ranged and counted
are the table in ``kernels/``.

A training run, all in one process:

1. set-up: the weights and every step's batch on the device from
   ``--seed``; the kernels' libraries built or loaded (``build_s``, apart
   from the rest); a probe call of ``run_plan`` (``PROBE_STEPS``) whose
   last steps' time sets how many steps fill ``--seconds``;
2. one ``run_plan`` call on the ``local`` backend with the port's kernels
   and no recompute: ``WARM_STEPS`` steps, of which the first
   ``CHECKED_STEPS`` are read for the comparison (the gradient from the
   optimizer's state after step one, the masters before the step after the
   last, and every replica's optimizer state against its stage's first
   replica's, outside the window), then the window's whole steps, then
   with ``--trace 1``
   ``TRACED_STEPS`` under ``torch.profiler`` recording the device alone
   (busy and idle time, kernels by name), then ``host_traced_steps`` that
   record the host's operators on every thread too (the ranges of the
   table's kernels and what the host did in the device's gaps; host tracing slows a step, so
   the device's idle share is not read from these);
3. once the call has returned and its state is freed: the reference, from
   weights made again from the seed, over the same checked batches.

The window opens at the start of its first step and closes at the end of
its last, each edge after a device synchronisation; the backend's steps
are seen through a subclass of the program's ``LocalBackend`` that only
calls back around ``run_step``.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from portbench import compare, data, devtrace, flops, kernels

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: steps of the probe call, warm steps before the window (the first
#: CHECKED_STEPS of them compared with the reference), device-traced steps
PROBE_STEPS, WARM_STEPS, CHECKED_STEPS, TRACED_STEPS = 3, 3, 3, 3
#: what a traffic file may set; anything else is refused, not ignored
#: the backend's producer lease, in seconds. The program's default, 5 s,
#: reads a stall of the whole process (11-14 s seen on the card's host) as
#: a dead producer, since the consumer that checks stalled too; the runs
#: plant no faults, so a longer lease changes nothing else
LEASE_S = 60.0
TRAFFIC_KEYS = {"stages", "replicas", "micro_batches", "micro_batch", "seq", "pipelined_sync",
                "tokens", "optimizer", "host_traced_steps", "reference_rows"}


def log(*parts) -> None:
    print("portbench:", *parts, file=sys.stderr, flush=True)


def load_cell(name: str) -> dict:
    """A cell by name, with its configuration, traffic, limits and metrics."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    unknown = set(traffic) - TRAFFIC_KEYS
    if unknown:
        raise ValueError(f"traffic {w['traffic']!r} sets {sorted(unknown)}, which this "
                         "harness does not run")

    def reported(m):
        if "workloads" in m:
            return name in m["workloads"]
        return True

    e2e = [m for m in bench["end_to_end"] if reported(m)]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if m["moves"] in moves and reported(m)]
    return {"name": name, "workload": w,
            "config": json.loads((ROOT / entry["file"]).read_text()),
            "traffic": traffic,
            "limits": json.loads((HERE / "limits" / f"{name}.json").read_text()),
            "end_to_end": e2e, "per_layer": per_layer}


def reader(name: str):
    """The ``read(measured)`` of the metric ``name`` (``metrics/<name>.py``)."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def family(cfg: dict):
    """(reference module, port adapter module) of the configuration's family
    (``reference/<family>.py``: ``sizes``, ``leaves``, ``train``,
    ``step_flops``, ``TINY``; ``adapters/<family>.py``: ``arch_config``,
    ``expected_launches``)."""
    return (importlib.import_module(f"portbench.reference.{cfg['family']}"),
            importlib.import_module(f"portbench.adapters.{cfg['family']}"))


def peak_of(device_name: str):
    table = json.loads((HERE / "peaks.json").read_text())
    return table.get(device_name)


class Device:
    def __init__(self, device: str):
        self.cuda = device == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated() if self.cuda else 0

    def reset_peak(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()


# ------------------------------------------------------------ the program side
def make_plan(arch, traffic: dict) -> tuple:
    """(profile, platform, config, M): ``stages`` stages of equal layers, the
    embedding on the first and the head on the last, ``replicas`` each."""
    from repro_torch.core.perfmodel import Config
    from repro_torch.core.profiler import arch_model_profile
    from repro_torch.serverless.platform import get_platform

    S, L = traffic["stages"], arch.n_layers
    if L % S:
        raise ValueError(f"{L} layers do not split into {S} equal stages")
    plat = get_platform("aws")
    prof = arch_model_profile(arch, plat, seq=traffic["seq"], micro_batch=traffic["micro_batch"])
    cuts = {L // S * s for s in range(1, S)}
    x = tuple(1 if i in cuts else 0 for i in range(prof.L - 1))
    d = traffic["replicas"]
    return prof, plat, Config(x=x, d=d, z=(0,) * prof.L), d * traffic["micro_batches"]


def nest(flat: dict) -> dict:
    """Dotted leaf names to the program's nested layout (a numbered level is
    a tuple)."""
    root: dict = {}
    for name, t in flat.items():
        parts = name.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t

    def fix(n):
        if not isinstance(n, dict):
            return n
        n = {k: fix(v) for k, v in n.items()}
        if all(k.isdigit() for k in n):
            return tuple(n[str(i)] for i in range(len(n)))
        return n

    return fix(root)


def state_leaves(tree, path: str = ""):
    """(dotted name, {"master", ...}) of a worker's optimizer state."""
    if isinstance(tree, dict) and "master" in tree:
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from state_leaves(tree[k], f"{path}.{k}" if path else k)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from state_leaves(v, f"{path}.{i}")


def first_gradient_norms(workers, b1: float) -> dict:
    """Each leaf's first gradient as the optimizer got it: AdamW's first
    moment after one step is (1 - b1) g."""
    out = {}
    for w in workers:
        for name, st in state_leaves(w.opt_state):
            out.update(compare.per_layer_norms(name, st["m"] / (1 - b1), lo=w.span.inst_lo))
    return out


def change_norms(workers, init: dict) -> dict:
    """Each leaf's change from the initial weights, from the fp32 masters."""
    out = {}
    for w in workers:
        for name, st in state_leaves(w.opt_state):
            base = init[name]
            if name.startswith("layers."):
                base = base[w.span.inst_lo:w.span.inst_lo + st["master"].shape[0]]
            out.update(compare.per_layer_norms(name, st["master"] - base.float(),
                                               lo=w.span.inst_lo))
    return out


def replica_gap(workers, d: int) -> float:
    """The largest difference between any replica's optimizer state (masters
    and moments) and its stage's first replica's; workers in the order
    built, stage by stage, replica by replica."""
    worst = 0.0
    for s in range(0, len(workers), d):
        first = dict(state_leaves(workers[s].opt_state))
        for w in workers[s + 1:s + d]:
            for name, st in state_leaves(w.opt_state):
                for key, t in st.items():
                    a = first[name][key]
                    if not torch.equal(t, a):
                        worst = max(worst, float((t.float() - a.float()).abs().max()))
    return worst


@contextlib.contextmanager
def recorded_workers():
    """The stage workers the next ``run_plan`` builds, in the order built
    (stage by stage, replica by replica)."""
    from repro_torch.serverless.runtime import worker as wm

    real, made = wm.StageWorker, []

    class Recorded(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    wm.StageWorker = Recorded
    try:
        yield made
    finally:
        wm.StageWorker = real


def windowed_backend(before, after):
    """The program's ``LocalBackend``, calling ``before(k)`` and
    ``after(k, timing)`` around each step."""
    from repro_torch.serverless.backends.local import LocalBackend

    class Windowed(LocalBackend):
        def run_step(self, k, programs, *, pipelined_sync=True):
            before(k)
            timing = super().run_step(k, programs, pipelined_sync=pipelined_sync)
            after(k, timing)
            return timing

    return Windowed(lease_timeout=LEASE_S)


@contextlib.contextmanager
def ranged_kernel_calls(calls: dict, table: dict):
    """Each call into a kernel of ``table`` (``ops.<OP>``) in a profiler range
    of its own (``RANGE``), its shape appended to ``calls[<kernel>]``."""
    from repro_torch.kernels import ops

    def ranged(name, entry, real):
        def call(*args, **kwargs):
            calls[name].append(entry.shape(*args, **kwargs))
            with torch.profiler.record_function(entry.RANGE):
                return real(*args, **kwargs)

        return call

    real = {}
    for name, entry in table.items():
        real[name] = getattr(ops, entry.OP)
        setattr(ops, entry.OP, ranged(name, entry, real[name]))
    try:
        yield
    finally:
        for name in reversed(list(real)):
            setattr(ops, table[name].OP, real[name])


def least_seconds(calls: dict, table: dict, peak: dict) -> dict:
    """Each kernel's roofline time over the recorded calls, forward and
    backward."""
    out = {}
    for name, shapes in calls.items():
        total = 0.0
        for shape in shapes:
            c = table[name].count(shape)
            total += (flops.least_seconds(c["fwd_ops"], c["fwd_bytes"], peak)
                      + flops.least_seconds(c["bwd_ops"], c["bwd_bytes"], peak))
        out[name] = total
    return out


# ------------------------------------------------------------------- the run
def run(cell: dict, seed: int, seconds: float, trace: bool, *, t_start: float,
        device: str = "cuda", check_launches: bool = True) -> dict:
    """One run of a training cell; the raw measurements and the comparison."""
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamW
    from repro_torch.serverless.execution import ExecutionConfig
    from repro_torch.serverless.runtime.engine import Execution, run_plan

    cfg, tr = cell["config"], cell["traffic"]
    ref, adapter = family(cfg)
    dev = Device(device)
    torch.use_deterministic_algorithms(True)
    arch = adapter.arch_config(cfg)
    z = ref.sizes(cfg)
    table = kernels.table()
    prof, plat, config, M = make_plan(arch, tr)
    d, mu, seq = tr["replicas"], tr["micro_batches"], tr["seq"]
    rows = d * mu * tr["micro_batch"]
    o = tr["optimizer"]
    if o["name"] != "AdamW":
        raise ValueError(f"optimizer {o['name']!r}: this harness runs AdamW")
    optimizer = AdamW(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                      weight_decay=o["weight_decay"])
    specs = ref.leaves(cfg)
    marks_setup = {"started": time.perf_counter() - t_start}
    weights = data.make_weights(specs, seed, device)
    params = nest(weights)

    def batch(k):
        t = data.token_batch(tr, z["V"], rows, seed=seed, step=k, device=device)
        return {"tokens": t, "labels": t}

    def call(steps, backend, batch_fn):
        return run_plan(prof, plat, config, M, ExecutionConfig(backend=backend, steps=steps),
                        pipelined_sync=tr["pipelined_sync"],
                        execution=Execution(cfg=arch, optimizer=optimizer, init_params=params,
                                            batch_fn=batch_fn, remat=False,
                                            use_kernels=True, device=device))

    marks_setup["weights"] = time.perf_counter() - t_start
    if dev.cuda:
        # built (the first run in a checkout) or loaded before any step: a
        # worker that compiles inside a step outlasts its peers' lease
        from repro_torch.kernels import build

        build.build_all()
    marks_setup["kernels"] = time.perf_counter() - t_start
    # the probe: how long a step takes once the kernels are loaded
    n_probe = PROBE_STEPS
    batches = [batch(k) for k in range(n_probe)]
    marks: dict = {}

    def p_before(k):
        dev.sync()
        marks[k] = time.perf_counter()

    def p_after(k, _timing):
        dev.sync()
        marks[k] = time.perf_counter() - marks[k]

    call(n_probe, windowed_backend(p_before, p_after), batches.__getitem__)
    marks_setup["probe"] = time.perf_counter() - t_start
    t_step = sorted(marks[k] for k in range(1, n_probe))[(n_probe - 2) // 2]
    n_window = max(2, round(seconds / t_step))
    checked = CHECKED_STEPS
    n_dev, n_host = (TRACED_STEPS, tr["host_traced_steps"]) if trace else (0, 0)
    w0 = WARM_STEPS
    w1 = w0 + n_window            # the window: [w0, w1)
    w2 = w1 + n_dev               # device traced: [w1, w2); host traced: [w2, total)
    total = w2 + n_host
    batches += [batch(k) for k in range(n_probe, total)]
    log(f"probe step {t_step:.4f} s -> {n_window} window steps, {total} in the call")

    st: dict = {"syncs": []}
    prog: dict = {}

    def before(k):
        st.setdefault("starts", []).append(time.perf_counter())
        if k == w0:
            dev.sync()
            st["setup_s"] = time.perf_counter() - t_start
            log("set-up: " + json.dumps(dict(marks_setup, window=st["setup_s"])))
            st["setup_peak"] = dev.peak()
            dev.reset_peak()
            st["counts0"] = ops.launch_counts()
            st["t0"] = time.perf_counter()
        if trace and k == w1:
            st["dev_prof"] = devtrace.profiler(device, host=False)
            st["td0"] = time.perf_counter()
        if trace and k == w2:
            st["calls"] = {n: [] for n in table}
            st["ranged"] = ranged_kernel_calls(st["calls"], table)
            st["ranged"].__enter__()
            st["host_prof"] = devtrace.profiler(device, host=True)

    def after(k, timing):
        if w0 <= k < w1:
            st["syncs"].append(timing.sync)
        if k == w1 - 1:
            dev.sync()
            st["t1"] = time.perf_counter()
            st["peak"] = dev.peak()
            st["counts1"] = ops.launch_counts()
        if trace and k == w2 - 1:
            dev.sync()
            st["td1"] = time.perf_counter()
            st["dev_prof"].stop()
        if trace and k == total - 1:
            dev.sync()
            st["host_prof"].stop()
            st.pop("ranged").__exit__(None, None, None)

    def batch_fn(k):
        if k == 1:
            prog["grad_norms"] = first_gradient_norms(workers[::d], o["b1"])
        if k == checked:
            prog["change_norms"] = change_norms(workers[::d], weights)
            if d > 1:
                prog["replica_gap"] = replica_gap(workers, d)
        return batches[k]

    try:
        with recorded_workers() as workers:
            res = call(total, windowed_backend(before, after), batch_fn)
            workers.clear()
    finally:
        if "ranged" in st:
            st.pop("ranged").__exit__(None, None, None)
    prog["losses"] = res.losses[:checked]
    store = res.store_stats.as_dict()
    # the program's state goes before the reference runs
    del res, params, weights
    checked_tokens = [b["tokens"] for b in batches[:checked]]
    del batches
    gc.collect()
    if dev.cuda:
        torch.cuda.empty_cache()

    out = {
        "setup_s": st["setup_s"], "build_s": marks_setup["kernels"] - marks_setup["weights"],
        "probe_step_s": t_step,
        "window": {"steps": n_window, "seconds": st["t1"] - st["t0"],
                   "tokens": n_window * rows * seq,
                   "flops_per_step": ref.step_flops(cfg, rows, seq)},
        "peak_bytes": st["peak"], "memory_peak_bytes": max(st["peak"], st["setup_peak"]),
        "syncs": st["syncs"], "replicas": d, "store": store,
        "step_starts_s": [t - st["starts"][0] for t in st["starts"]],
    }
    if trace:
        t0 = time.perf_counter()
        dev_red = devtrace.device_busy(st.pop("dev_prof"))
        t1 = time.perf_counter()
        host_red = devtrace.reduce(st.pop("host_prof"), [e.RANGE for e in table.values()])
        t2 = time.perf_counter()
        peak = peak_of(torch.cuda.get_device_name(0)) if dev.cuda else None
        least = least_seconds(st["calls"], table, peak) if peak else {}
        out["trace"] = {
            "steps": n_dev, "window_s": st["td1"] - st["td0"], "busy_s": dev_red["busy_s"],
            "elementwise_s": sum(v for k, v in dev_red["kernel_s_by_name"].items()
                                 if "elementwise" in k),
            "ranges": {n: dict(host_red["ranges"][e.RANGE], least_s=least.get(n),
                               recorded_calls=len(st["calls"][n]), backward=e.BACKWARD)
                       for n, e in table.items()},
            "device_ops": devtrace.top_ops(dev_red), "idle_gaps": devtrace.idle_gaps(host_red),
        }
        del dev_red, host_red
        log(f"traces reduced in {t1 - t0:.1f} s (device) and {t2 - t1:.1f} s (host): "
            + json.dumps(out["trace"]["ranges"]))

    numbers = {}
    out["expected_launches"] = {k: n_window * d * mu * n
                                for k, n in adapter.expected_launches(arch, tr).items()}
    if check_launches:
        counts = {k: st["counts1"][k] - st["counts0"][k] for k in st["counts0"]}
        numbers.update(compare.launch_numbers(counts, out["expected_launches"]))
        out["launches"] = counts
    t0 = time.perf_counter()
    weights = data.make_weights(specs, seed, device)
    ref_out = ref.train(cfg, weights, checked_tokens, o, rows_per_block=tr["reference_rows"])
    del weights
    got, detail = compare.readings(prog, ref_out)
    numbers.update(got)
    out["reference_s"] = time.perf_counter() - t0
    out["numbers"], out["detail"], out["reference"] = numbers, detail, ref_out
    return out
