"""Readings that set a cell's limits, on the card at the cell's own size.

    python3 portbench/prove.py --workload <cell> --seeds 11,12,... \
        [--control-seeds ...] [--faults half_batch,...] [--fault-seeds ...] [--out <file>]

For each seed: the program's numbers (``harness.run`` with the shortest
window, the reference beside it); for each control seed: the reference in
fp8 put in the program's place, held to the fp32 reference; for each fault
(``faults.py``) and fault seed: the program with the fault planted.  One
JSON line a reading, to standard output and to ``--out``.  The benchmark's
own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from portbench import compare, data, faults, harness

    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    cell = harness.load_cell(args.workload)
    cfg, tr = cell["config"], cell["traffic"]
    ref, _ = harness.family(cfg)
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(dict(rec, workload=args.workload))
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    references = {}
    for seed in ints(args.seeds):
        t0 = time.perf_counter()
        out = harness.run(cell, seed, 0.0, False, t_start=time.perf_counter())
        references[seed] = out["reference"]
        emit({"what": "program", "seed": seed, "numbers": out["numbers"],
              "detail": out["detail"], "peak_bytes": out["peak_bytes"],
              "seconds": time.perf_counter() - t0})
    z = ref.sizes(cfg)
    rows = tr["replicas"] * tr["micro_batches"] * tr["micro_batch"]
    for seed in ints(args.control_seeds):
        t0 = time.perf_counter()
        tokens = [data.token_batch(tr, z["V"], rows, seed=seed, step=k, device="cuda")
                  for k in range(harness.CHECKED_STEPS)]
        weights = data.make_weights(ref.leaves(cfg), seed, "cuda")
        if seed not in references:
            references[seed] = ref.train(cfg, weights, tokens, tr["optimizer"],
                                         rows_per_block=tr["reference_rows"])
        ctrl = ref.train(cfg, weights, tokens, tr["optimizer"],
                         rows_per_block=tr["reference_rows"], precision="fp8")
        got, detail = compare.readings(ctrl, references[seed])
        emit({"what": "control", "precision": "fp8", "seed": seed, "numbers": got,
              "detail": detail, "seconds": time.perf_counter() - t0})
        del weights, tokens
        torch.cuda.empty_cache()
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in ints(args.fault_seeds):
            t0 = time.perf_counter()
            with faults.plant(fault):
                out = harness.run(cell, seed, 0.0, False, t_start=time.perf_counter())
            emit({"what": "fault", "fault": fault, "seed": seed, "numbers": out["numbers"],
                  "detail": out["detail"], "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
