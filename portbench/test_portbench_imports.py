"""What the benchmark loads, and how it refuses to run: no JAX, JAX's
package or flax in a run (compared by whole top-level names), nothing of the
program in the reference; no result without a card or without the program."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

RUN_TINY = """
import sys, time
from portbench.test_portbench_reference import tiny_cell, tiny_run
tiny_run(tiny_cell("phi3-train-s2d2-b4"))
import portbench.devtrace, portbench.faults, portbench.prove
print(",".join(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import sys
import portbench.reference.dense_transformer, portbench.data, portbench.compare
import portbench.flops
print(",".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _python(code, cwd=ROOT, env_extra=None):
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}", **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=cwd, env=env, timeout=300)


def test_a_run_loads_no_jax():
    p = _python(RUN_TINY)
    assert p.returncode == 0, p.stderr[-3000:]
    names = set(p.stdout.strip().splitlines()[-1].split(","))
    assert "repro_torch" in names and not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    p = _python(REFERENCE)
    assert p.returncode == 0, p.stderr[-3000:]
    names = set(p.stdout.strip().splitlines()[-1].split(","))
    assert not names & (FORBIDDEN | {"repro_torch"}), names
    src = (ROOT / "portbench" / "reference" / "dense_transformer.py").read_text()
    assert "repro" not in src.replace("reproduc", "")


def _run_py(root, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(root / "portbench" / "run.py"), "--workload",
                           "phi3-train-s2d2-b4", "--seed", str(2**31 + 5), "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=cwd, env=env,
                          timeout=300)


def test_no_result_without_a_card():
    p = _run_py(ROOT, ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path, tmp_path)
    assert p.returncode != 0 and p.stdout == ""
    assert "repro_torch" in p.stderr
