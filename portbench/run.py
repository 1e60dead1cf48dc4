"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell asks
for.  With ``--trace 0`` the result carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics (the readers in ``metrics/``) and
the device's busy and window seconds.  The last line of standard output is
one JSON object; the numbers compared with the reference, each beside its
limit, end standard error and the result's ``checks``.
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
# the program's caches stay in the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
                 ("TRITON_CACHE_DIR", "build/triton_cache")):
    os.environ[var] = str(ROOT / sub)
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"    # deterministic cuBLAS
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload)
    import repro_torch.serverless.runtime.engine  # noqa: F401  (the program under test)

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    harness.log(f"card: {smi}")
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START)

    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        harness.log(f"the run loaded {loaded}")
        return 4

    w = out["window"]
    measured = dict(out, peak=harness.peak_of(torch.cuda.get_device_name(0)))
    metrics = {}
    for m in cell["per_layer" if args.trace else "end_to_end"]:
        v = harness.reader(m["name"])(measured)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": None, "attempted": w["steps"], "failed": 0, "metrics": metrics,
              "device": device}
    if args.trace:
        t = out["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    correct, checks = harness.compare.verdict(out["numbers"], cell["limits"])
    result["correct"] = correct
    # the kernels' build (a checkout's first run) or load, inside setup_s
    result["build_s"] = out["build_s"]
    result["checks"] = checks

    harness.log(json.dumps({"window": w, "setup_s": out["setup_s"], "build_s": out["build_s"],
                            "probe_step_s": out["probe_step_s"],
                            "reference_s": out["reference_s"], "detail": out["detail"],
                            "launches": out.get("launches"),
                            "expected_launches": out["expected_launches"], "syncs": out["syncs"],
                            "store_peak_bytes": out["store"]["peak_bytes"],
                            "step_starts_s": out["step_starts_s"]}))
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {correct}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
