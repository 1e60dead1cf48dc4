"""The mesh path's serving steps (``repro_torch.core.pipeline``'s prefill
and decode, ``train.serve_step``) on gloo worlds of 8 CPU ranks against the
live JAX package, and the mesh training driver's command line.

The matrix of ``tests/test_multidev.py:58-64`` (phi3 4 x 1, gemma3 2 x 2
with its global layers' KV sharded over the data axis, jamba, dbrx 2 x 2
with expert parallelism, xlstm 2 x 2): prefill logits and 6 decode steps'
logits within 2e-3 of JAX's ``registry.prefill`` and ``decode_step`` (the
sharded case decodes from empty caches, as JAX's check does); phi3 again
with ``use_kernels`` (the decode-attention wrapper's plain version here).
``python -m repro_torch train --device cpu`` takes 2 steps of a reduced
config with ``jax`` and ``repro`` shadowed; so do ``dryrun`` (one record)
and ``train --plan auto`` (the plan ``core.tpu_planner`` picks).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import registry as jreg

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import tpu_planner
from repro_torch.launch.mesh import run_jobs
from repro_torch.launch.roofline import h100
from repro_torch.launch.train import plan_chip
from repro_torch.testing.pipeline_equiv import mesh_shape
from repro_torch.testing.serve_equiv import (
    S_PRE,
    gather_rows,
    rank_serve,
    serve_config,
    serve_plan,
)

REPO = Path(__file__).resolve().parents[1]
# tests/test_multidev.py:58-64: (arch, stages, tensor, seq_shards)
MATRIX = [
    ("phi3-mini-3.8b", 4, 1, 1),
    ("gemma3-4b", 2, 2, 2),           # data-axis-sharded KV (long-context path)
    ("jamba-v0.1-52b", 2, 1, 1),
    ("dbrx-132b", 2, 2, 1),
    ("xlstm-125m", 2, 2, 1),
]
N_DECODE = 6


def _jax_cfg(arch, stages, tensor):
    import dataclasses

    cfg = jconfigs.get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    return dataclasses.replace(cfg, stages=stages, tensor=tensor)


def _case(arch, stages, tensor, seq_shards, use_kernels=False):
    cfg = serve_config(arch, stages, tensor)
    plan, dshape, B = serve_plan(cfg, stages, tensor, seq_shards, N_DECODE)
    assert plan.seq_shards == (plan.data if seq_shards > 1 else 1)
    jcfg = _jax_cfg(arch, stages, tensor)
    base = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, dshape.seq_len),
                                             dtype=np.int32)
    return dict(cfg=cfg, jcfg=jcfg, plan=plan, dshape=dshape, B=B, base=base, toks=toks,
                job=(rank_serve, mesh_shape(cfg, plan),
                     (cfg, plan, dshape, jax.tree.map(np.asarray, base), toks, N_DECODE,
                      use_kernels)))


@pytest.fixture(scope="module")
def serve_runs():
    """Every case and phi3 with the kernel wrappers, in one world of 8 CPU
    ranks (one intra-op thread each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cases = {row[0]: _case(*row) for row in MATRIX}
    cases["phi3_kernels"] = _case(*MATRIX[0], use_kernels=True)
    try:
        outs = run_jobs([c["job"] for c in cases.values()], device="cpu")
    finally:
        torch.set_num_threads(n)
    for c, out in zip(cases.values(), outs):
        c["results"] = out
    return cases


def _jax_reference(c):
    """JAX's prefill (unless the KV is sharded) and decode steps."""
    jcfg, base, toks = c["jcfg"], c["base"], jnp.asarray(c["toks"])
    s_ctx = c["dshape"].seq_len
    decode = jax.jit(lambda p, cache, t: jreg.decode_step(jcfg, p, cache, t))
    pre = None
    if c["plan"].seq_shards > 1:
        caches, first = jreg.init_decode_caches(jcfg, c["B"], s_ctx), 0
    else:
        pre, caches = jax.jit(lambda p, t: jreg.prefill(jcfg, p, {"tokens": t},
                                                        capacity=s_ctx))(base, toks[:, :S_PRE])
        first = S_PRE
    steps = []
    for t in range(first, first + N_DECODE):
        lg, caches = decode(base, caches, toks[:, t:t + 1])
        steps.append(np.asarray(lg))
    return (None if pre is None else np.asarray(pre)), steps


@pytest.mark.parametrize("case", [row[0] for row in MATRIX] + ["phi3_kernels"])
def test_mesh_serve_matches_jax(serve_runs, case):
    """Pipelined prefill and decode logits on the mesh within 2e-3 of JAX's
    single-device ones; every rank of a data index holds the same logits."""
    c = serve_runs[case]
    pre, steps = _jax_reference(c)
    res, plan = c["results"], c["plan"]
    for r in res:
        twin = next(o for o in res if o["d"] == r["d"] and o["m"] == 0)
        for a, b in zip(r["decode"], twin["decode"]):
            assert np.array_equal(a, b)
    if pre is not None:
        assert float(np.abs(gather_rows(res, plan, "prefill") - pre).max()) < 2e-3
    got = gather_rows(res, plan, "decode")
    assert len(got) == N_DECODE
    for a, b in zip(got, steps):
        assert float(np.abs(a - b).max()) < 2e-3, case


def _run_without_jax(tmp_path, *args):
    """``python -m repro_torch <args>`` in a subprocess whose ``jax`` and
    ``repro`` are packages that refuse to import."""
    for name in ("jax", "repro"):
        (tmp_path / name).mkdir(exist_ok=True)
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} must not be imported')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(REPO / "src")]),
               TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-m", "repro_torch", *args], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def test_train_cli_runs_on_cpu_without_jax(tmp_path):
    """``python -m repro_torch train --device cpu``: 2 steps of
    phi3-mini-3.8b@reduced on 2 stages x 2 replicas with ``jax`` and
    ``repro`` shadowed by packages that refuse to import; the plan line
    names the transport, the loss falls."""
    out = _run_without_jax(
        tmp_path, "train", "--arch", "phi3-mini-3.8b", "--reduced", "--data", "2", "--model",
        "2", "--stages", "2", "--steps", "2", "--seq", "16", "--batch", "8", "--device", "cpu",
        "--ckpt-every", "2")
    lines = out.stdout.splitlines()
    assert "transport=gloo, host-staged" in lines[0] and "ranks=4" in lines[0]
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines if ln.startswith("step")]
    assert len(losses) == 2 and losses[1] < losses[0]
    assert lines[-1] == "done."
    assert sorted(p.name for p in tmp_path.glob("repro_torch_train.msgpack.rank*")) == \
        [f"repro_torch_train.msgpack.rank{r}" for r in range(4)]


def test_dryrun_and_plan_auto_name_item_7b(tmp_path):
    """The mesh path's analytic half: ``dryrun`` writes one shape-only
    record, and ``train --plan auto`` trains the plan ``core.tpu_planner``
    picks (for four ranks sharing the CPU's one "card"), both with ``jax``
    and ``repro`` shadowed."""
    out = _run_without_jax(tmp_path, "dryrun", "--arch", "phi3-mini-3.8b", "--shape",
                           "train_4k", "--out", str(tmp_path / "dry"))
    rec = json.loads((tmp_path / "dry" / "phi3-mini-3.8b_train_4k_16x16.json").read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["memory"]["argument_bytes"] > 0 and rec["roofline_counted"]["flops"] > 0
    assert out.stdout.startswith("[dryrun] phi3-mini-3.8b x train_4k mesh=16x16")

    out = _run_without_jax(tmp_path, "train", "--plan", "auto", "--arch", "phi3-mini-3.8b",
                           "--reduced", "--data", "2", "--model", "2", "--steps", "2",
                           "--device", "cpu")
    lines = out.stdout.splitlines()
    auto = dict(kv.split("=") for kv in lines[0].split(" (est")[0].split()[2:])
    assert lines[0].startswith("[plan auto] S=") and "ms/step)" in lines[0]
    cfg = get_config("phi3-mini-3.8b").reduced()
    best = tpu_planner.solve(cfg, InputShape("cli", 128, 8, "train"), data=2, model=2,
                             chip=h100(4))[0].plan
    assert auto == {"S": str(best.stages), "tp": str(best.tensor),
                    "mu": str(best.microbatches), "remat": best.remat}
    assert lines[1].startswith(f"plan: stages={best.stages} tensor={best.tensor} "
                               f"mu={best.microbatches} ep=1 remat={best.remat} ranks=4")
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines if ln.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses)) and lines[-1] == "done."
    assert plan_chip(4, "cpu").hbm_bytes == 20e9
