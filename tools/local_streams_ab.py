#!/usr/bin/env python3
"""Same-call A/B of the ``local`` backend's CUDA streams on one card.

    python3 tools/local_streams_ab.py [--parent build/parent] [--steps 6]

``chip_smoke.py``'s ``train_full`` plan (phi3-mini-3.8b at full width cut to
4 layers, bf16, seed 0, 2 stages x 2 replicas, 2 micro-batches of 2 x 1024
tokens, AdamW(1e-4), the kernels on) trained for ``--steps`` steps on
``local`` with eq (2) and with eq (1), once per variant and child process:

- ``parent``: the tree unpacked at ``--parent`` (e.g. ``git archive HEAD~1``
  into a gitignored directory), run from its own ``src``;
- ``streams``: this checkout (a CUDA stream per worker, events at put and
  get, ``record_stream`` on what a get hands out);
- ``streams_no_record_stream``: the same with ``record_stream`` skipped
  (a diagnosis of the allocator's part, not a safe configuration);
- ``shared_stream``: the same with every worker on one stream of its own.

Variants (``--variants``, all four by default) run in the order A, B, ...,
B, A.  Per run: each step's wall time (the device synchronised at each
step's start), peak memory, the allocator's counts over the run
(``torch.cuda.memory_stats``: device allocations and frees, synchronising
frees) and a digest of the final params, which must equal the emulated
run's in every variant.  Then both ``local`` runs again, traced, with a
CUDA-only ``torch.profiler`` over one steady step (the one before the
last): each worker's compute-span seconds in that step, their sum, the
step's device work (kernels summed and the union of their intervals) and
the trace's straggler ratio.  Prints one
JSON object and writes it to ``chiprun_out/local_streams_ab.json``.  The
parent's kernels are taken from this checkout's build directory (the
sources are the same), so one build serves both.  Needs one CUDA card.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ("parent", "streams", "streams_no_record_stream", "shared_stream")


def child(steps: int, patch: str) -> dict:
    import dataclasses
    import time

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.perfmodel import Config
    from repro_torch.core.profiler import arch_model_profile
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import registry
    from repro_torch.models.common import tree_leaves
    from repro_torch.obs import pipeline_health
    from repro_torch.optim import AdamW
    from repro_torch.serverless.platform import get_platform
    from repro_torch.serverless.runtime import Execution, run_plan

    if patch != "none":
        from repro_torch.serverless.backends import local
        if patch == "no_record_stream":
            def hand_out(obj, value):
                if obj.ready is not None:
                    torch.cuda.current_stream().wait_event(obj.ready)
                return value
            local._hand_out = hand_out
        elif patch == "shared_stream":
            real = local.LocalBackend._worker_streams

            def one_stream(self):
                if not self._streams and torch.cuda.is_initialized():
                    shared = torch.cuda.Stream()
                    real(self)
                    self._streams = {k: shared for k in self._streams}
                return self._streams
            local.LocalBackend._worker_streams = one_stream

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=4)
    plat = get_platform("aws")
    prof = arch_model_profile(cfg, plat, seq=1024, micro_batch=2)
    x = tuple(1 if i == 2 else 0 for i in range(prof.L - 1))
    config, M = Config(x=x, d=2, z=(0,) * prof.L), 4
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    shape = InputShape("train", 1024, 8, "train")
    batches = [{k: v.cuda() for k, v in make_batch(cfg, shape, seed=0, step=k,
                                                   device="cpu").items()}
               for k in range(steps)]
    from torch.profiler import ProfilerActivity, profile

    watched = steps - 2          # a steady step, profiled in the traced runs
    out = {}
    for name, backend, pipelined, traced in (
            ("emulated", "emulated", True, False), ("local_eq2", "local", True, False),
            ("local_eq1", "local", False, False), ("local_eq2_traced", "local", True, True),
            ("local_eq1_traced", "local", False, True)):
        marks, window = [], {}

        def batch_fn(k):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if traced and k == watched:
                window["prof"] = profile(activities=[ProfilerActivity.CUDA])
                window["prof"].start()
            if traced and k == watched + 1:
                window["prof"].stop()
            return batches[k]

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_stats()
        res = run_plan(prof, plat, config, M, steps=steps, pipelined_sync=pipelined,
                       backend=backend, trace=traced, execution=Execution(
                           cfg=cfg, optimizer=AdamW(lr=1e-4), init_params=params,
                           batch_fn=batch_fn, use_kernels=True, device="cuda"))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        after = torch.cuda.memory_stats()
        digest = hashlib.sha256()
        for a in tree_leaves(res.params):
            digest.update(a.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
        out[name] = {
            "step_wall_s": [b - a for a, b in zip(marks, marks[1:])],
            "losses": res.losses,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "allocator": {k: after.get(k, 0) - before.get(k, 0)
                          for k in ("num_device_alloc", "num_device_free",
                                    "num_sync_all_streams", "num_alloc_retries")},
            "params_sha256": digest.hexdigest()}
        if traced:
            spans = sorted((e.time_range.start, e.time_range.end)
                           for e in window["prof"].events()
                           if e.device_type == torch.autograd.DeviceType.CUDA)
            union, lo, hi = 0.0, None, None
            for a, b in spans:
                if hi is None or a > hi:
                    union += 0.0 if hi is None else hi - lo
                    lo, hi = a, b
                else:
                    hi = max(hi, b)
            union += 0.0 if hi is None else hi - lo
            by_worker = {}
            for sp in res.trace.spans:
                if sp.step == watched and sp.op == "compute":
                    by_worker[sp.worker] = by_worker.get(sp.worker, 0.0) + sp.duration
            out[name]["watched_step"] = {
                "step": watched, "compute_s_by_worker": dict(sorted(by_worker.items())),
                "compute_s_sum": sum(by_worker.values()),
                "device_kernel_sum_s": sum(b - a for a, b in spans) / 1e6,
                "device_kernel_union_s": union / 1e6,
                "straggler_ratio_whole_trace": pipeline_health(res.trace)["straggler_ratio"]}
        del res
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default="build/parent")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--child", choices=("none", "no_record_stream", "shared_stream"))
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.steps, args.child)), flush=True)
        return

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("local_streams_ab needs a CUDA card")
    parent = (ROOT / args.parent).resolve()
    # the parent builds its kernels into its own build/torch_kernels: point
    # that at this checkout's, whose libraries are named by source hash
    (parent / "build").mkdir(exist_ok=True)
    link = parent / "build" / "torch_kernels"
    (ROOT / "build" / "torch_kernels").mkdir(parents=True, exist_ok=True)
    if not link.exists():
        link.symlink_to(ROOT / "build" / "torch_kernels")
    setups = {"parent": (parent, "none"), "streams": (ROOT, "none"),
              "streams_no_record_stream": (ROOT, "no_record_stream"),
              "shared_stream": (ROOT, "shared_stream")}
    variants = [v for v in args.variants.split(",") if v]
    if not set(variants) <= set(VARIANTS) or "parent" not in variants:
        raise SystemExit(f"--variants: 'parent' and any of {VARIANTS}")
    order = variants + variants[::-1]
    runs = {v: [] for v in variants}
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    for variant in order:
        root, patch = setups[variant]
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child", patch,
             "--steps", str(args.steps)],
            env=dict(env, PYTHONPATH=str(root / "src")), capture_output=True, text=True,
            cwd=root)
        if proc.returncode:
            raise SystemExit(f"{variant}: {proc.stderr[-3000:]}")
        runs[variant].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    ref = runs["parent"][0]["emulated"]["params_sha256"]
    for variant, rs in runs.items():
        for r in rs:
            for name, rec in r.items():
                if rec["params_sha256"] != ref:
                    raise SystemExit(f"{variant} {name}: params differ from the parent's "
                                     "emulated run")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    summary = {}
    for variant, rs in runs.items():
        summary[variant] = {}
        for name in ("emulated", "local_eq2", "local_eq1"):
            steady = sorted(s for r in rs for s in r[name]["step_wall_s"][1:])
            summary[variant][name] = {
                "steady_step_median_s": steady[len(steady) // 2],
                "steady_step_min_s": steady[0],
                "max_memory_allocated_bytes": [r[name]["max_memory_allocated_bytes"]
                                               for r in rs],
                "allocator": [r[name]["allocator"] for r in rs]}
        for name in ("local_eq2_traced", "local_eq1_traced"):
            summary[variant][name] = [r[name]["watched_step"] for r in rs]
    doc = {"card": smi, "steps": args.steps, "order": order,
           "params_bit_identical": True, "summary": summary, "runs": runs}
    out = ROOT / "chiprun_out" / "local_streams_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(doc, indent=1))
    print(json.dumps({"card": smi, "summary": summary}))


if __name__ == "__main__":
    main()
