"""The program's own tracing in a benchmark cell, and what it costs.

    python3 tools/trace_cells.py --workload <cell> --seed <n> [--block-steps 2]

Runs one cell of ``BENCHMARK.json`` as ``portbench/run.py`` sets it up (the
same weights, batches, plan, kernels and backend lease) in one ``run_plan``
call on ``local``: ``WARM`` steps, then blocks of ``--block-steps`` steps
in the order U T T U U T T U (U untraced; T with a ``SpanRecorder``
attached to the backend, no profiler running), each block between two
device synchronisations, then ``--host-steps`` steps under
``torch.profiler`` recording the device and the host's operators on every
thread, the recorder attached too.  It prints one JSON line:

* ``tracing_on_cost``: the T blocks' mean step wall time over the U blocks';
* ``engine_bubble_pct``: the fwd- and bwd-phase download spans of the T
  blocks (the waits for another stage's activation or gradient), summed
  over workers, over workers x the T blocks' wall seconds;
* ``worker_host_cpu_ms_per_step``: the workers' ``StepTiming.worker_cpu_s``
  summed over workers, mean over the T blocks' steps; beside it the whole
  process's CPU and that of autograd's device threads (which launch the
  backward's kernels on a card), a step over the T blocks;
* ``worker_optimizer_ms_per_step``: the device time launched inside the
  ``funcpipe/optimizer`` ranges over the profiled steps, a step;
* ``idle_gaps``: the profiled steps' device gaps by the innermost host
  operator open at each gap's middle (``portbench.devtrace.idle_gaps``);
* ``compute_vs_busy``: the profiled steps' compute spans, the union of
  their device intervals beside the device's busy time, and each phase's
  intervals summed beside the device time of the kernels it launched;
* ``steady_step``: the last T block's last step's compute spans by worker,
  their launch (host) and device seconds, and the union of the device
  intervals.

Needs a card; run from the root of a checkout.  What it prints is no
benchmark metric: ``portbench`` does not attach a recorder.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
                 ("TRITON_CACHE_DIR", "build/triton_cache")):
    os.environ[var] = str(ROOT / sub)
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

WARM = 3
ORDER = "UTTUUTTU"
DEVICE = "cuda"


def _union(intervals) -> float:
    total, hi = 0.0, None
    for a, b in sorted(intervals):
        if hi is None or a > hi:
            total, hi = total + b - a, b
        elif b > hi:
            total, hi = total + b - hi, b
    return total


def _threads_cpu(prefix: str) -> float:
    """CPU seconds of this process's threads whose name starts with
    ``prefix`` (``/proc/self/task``; autograd's device threads are
    ``pt_autograd_<device>``)."""
    total = 0.0
    for task in Path("/proc/self/task").iterdir():
        try:
            if not (task / "comm").read_text().startswith(prefix):
                continue
            fields = (task / "stat").read_text().rsplit(")", 1)[1].split()
        except OSError:            # the thread ended
            continue
        total += (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    return total


def _cpu() -> tuple:
    return time.process_time(), _threads_cpu("pt_autograd")


def run(name: str, seed: int, n_block: int, n_host: int) -> dict:
    import torch

    from portbench import data, devtrace, harness
    from repro_torch.kernels import build
    from repro_torch.obs import SpanRecorder
    from repro_torch.obs.ranges import BWD, FWD, OPTIMIZER
    from repro_torch.optim import AdamW
    from repro_torch.serverless.backends.local import LocalBackend
    from repro_torch.serverless.execution import ExecutionConfig
    from repro_torch.serverless.runtime.engine import Execution, run_plan

    cell = harness.load_cell(name)
    cfg, tr = cell["config"], cell["traffic"]
    ref, adapter = harness.family(cfg)
    torch.use_deterministic_algorithms(True)
    arch = adapter.arch_config(cfg)
    prof, plat, config, M = harness.make_plan(arch, tr)
    d, mu = tr["replicas"], tr["micro_batches"]
    rows = d * mu * tr["micro_batch"]
    o = tr["optimizer"]
    optimizer = AdamW(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                      weight_decay=o["weight_decay"])
    params = harness.nest(data.make_weights(ref.leaves(cfg), seed, DEVICE))
    dev = harness.Device(DEVICE)
    if dev.cuda:
        build.build_all()
    blocks = [(tag, WARM + i * n_block) for i, tag in enumerate(ORDER)]
    w1 = WARM + len(ORDER) * n_block      # profiled: [w1, total)
    total = w1 + n_host
    traced = {k for tag, k0 in blocks if tag == "T" for k in range(k0, k0 + n_block)}
    traced |= set(range(w1, total))
    batches = [{"tokens": t, "labels": t} for t in (
        data.token_batch(tr, ref.sizes(cfg)["V"], rows, seed=seed, step=k, device=DEVICE)
        for k in range(total))]
    starts = {k0 for _, k0 in blocks} | {w1}
    ends = {k0 + n_block - 1 for _, k0 in blocks} | {total - 1}
    st: dict = {"cpu": {}, "t": {}}
    rec = SpanRecorder()

    class Cell(LocalBackend):
        def run_step(self, k, programs, *, pipelined_sync=True):
            if k in starts:
                dev.sync()
                st["t"][k] = time.perf_counter()
                st["t"][f"cpu{k}"] = _cpu()
            if k == w1:
                st["prof"] = devtrace.profiler(DEVICE, host=True)
            timing = super().run_step(k, programs, pipelined_sync=pipelined_sync)
            if k in ends:
                dev.sync()
                st["t"][f"end{k}"] = time.perf_counter()
                st["t"][f"cpuend{k}"] = _cpu()
            if k == total - 1:
                st["prof"].stop()
            if timing.worker_cpu_s:
                st["cpu"][k] = sum(timing.worker_cpu_s.values())
            # step k + 1's contexts are made after this returns
            self.attach_recorder(rec if k + 1 in traced else None)
            return timing

    run_plan(prof, plat, config, M, ExecutionConfig(backend=Cell(lease_timeout=harness.LEASE_S),
                                                    steps=total),
             pipelined_sync=tr["pipelined_sync"],
             execution=Execution(cfg=arch, optimizer=optimizer, init_params=params,
                                 batch_fn=batches.__getitem__, use_kernels=True,
                                 device=DEVICE))
    rec.resolve()

    def wall(k0, n):
        return st["t"][f"end{k0 + n - 1}"] - st["t"][k0]

    def cpu(k0, n, i):
        return st["t"][f"cpuend{k0 + n - 1}"][i] - st["t"][f"cpu{k0}"][i]

    walls = [(tag, wall(k0, n_block)) for tag, k0 in blocks]
    t_blocks = [k0 for tag, k0 in blocks if tag == "T"]
    t_wall = sum(w for tag, w in walls if tag == "T")
    u_wall = sum(w for tag, w in walls if tag == "U")
    n_t = ORDER.count("T") * n_block
    t_steps = traced - set(range(w1, total))
    spans = [sp for sp in rec.spans if sp.step in t_steps]
    workers = {(sp.stage, sp.replica) for sp in spans}
    waits = sum(sp.duration for sp in spans
                if sp.op == "download" and sp.phase in ("fwd", "bwd"))
    last = max(t_steps)
    by_worker: dict = {}
    for sp in spans:
        if sp.op == "compute" and sp.step == last:
            w = by_worker.setdefault(sp.worker, {"launch_s": 0.0, "device_s": 0.0})
            w["launch_s"] += sp.duration
            w["device_s"] += sp.device_duration or 0.0
    red = devtrace.reduce(st.pop("prof"), [OPTIMIZER, FWD, BWD])
    opt, fwd, bwd = (red["ranges"][n] for n in (OPTIMIZER, FWD, BWD))
    profiled = [sp for sp in rec.spans
                if sp.op == "compute" and sp.step >= w1 and sp.device_start is not None]
    return {
        "workload": name, "seed": seed, "script_s": time.perf_counter() - T_START,
        "steps": {"block": n_block, "order": "".join(ORDER), "profiled": n_host},
        "block_walls_s": walls,
        "untraced_step_s": u_wall / (ORDER.count("U") * n_block),
        "traced_step_s": t_wall / n_t,
        "tracing_on_cost": (t_wall / n_t) / (u_wall / (ORDER.count("U") * n_block)) - 1.0,
        "engine_bubble_pct": 100.0 * waits / (len(workers) * t_wall),
        "worker_host_cpu_ms_per_step": 1e3 * sum(st["cpu"][k] for k in t_steps) / n_t,
        "worker_host_cpu_s_by_step": [st["cpu"][k] for k in sorted(t_steps)],
        "process_cpu_ms_per_step": 1e3 * sum(cpu(k0, n_block, 0) for k0 in t_blocks) / n_t,
        "autograd_thread_cpu_ms_per_step":
            1e3 * sum(cpu(k0, n_block, 1) for k0 in t_blocks) / n_t,
        "worker_optimizer_ms_per_step": 1e3 * opt["device_s"] / n_host,
        "optimizer_range": opt,
        "profiled_step_s": wall(w1, n_host) / n_host,
        "device_busy_ms_per_profiled_step": 1e3 * red["busy_s"] / n_host,
        "compute_vs_busy": {
            "compute_device_union_s": _union((sp.device_start, sp.device_end)
                                             for sp in profiled),
            "device_busy_s": red["busy_s"],
            # each phase's device intervals, summed, beside the device time of
            # the kernels its compute launched (the forward's, and the
            # backward nodes of its operations plus the gradient accumulation)
            "fwd_interval_s": sum(sp.device_duration for sp in profiled if sp.phase == "fwd"),
            "fwd_kernel_s": fwd["forward_device_s"],
            "bwd_interval_s": sum(sp.device_duration for sp in profiled if sp.phase == "bwd"),
            "bwd_kernel_s": fwd["backward_device_s"] + bwd["forward_device_s"]},
        "idle_gaps": devtrace.idle_gaps(red, limit=14),
        "steady_step": {"step": last, "by_worker": dict(sorted(by_worker.items())),
                        "device_union_s": _union(
                            (sp.device_start, sp.device_end) for sp in spans
                            if sp.op == "compute" and sp.step == last
                            and sp.device_start is not None)},
        "spans": len(rec.spans),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--block-steps", type=int, default=2)
    ap.add_argument("--host-steps", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    out = run(args.workload, args.seed, args.block_steps, args.host_steps)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
