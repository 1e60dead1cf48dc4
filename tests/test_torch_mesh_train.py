"""The mesh path's training step (``repro_torch.core.pipeline``,
``train.train_step``, ``launch.mesh``) on gloo worlds of 8 CPU ranks
against the live JAX package.

The matrix of ``tests/test_multidev.py:42-50`` (phi3, qwen2.5, gemma3, dbrx
with expert parallelism, jamba, xlstm, hubert; ``data x stages x tensor =
8``): each case's one AdamW step on the mesh holds its loss (2e-4) against
JAX's single-device ``reference_step`` run here, and every rank's updated
parameters (1e-2) against its view of JAX's ``to_pipeline_layout`` of the
reference, the bars of ``src/repro/testing/pipeline_equiv.py:110``.  The
weights come from JAX's ``init_params`` and the batch from JAX's
``make_batch``.  phi3's case also runs with ``remat`` "none" and "layer"
and the unidirectional ring: bit-identical to the default at data 2.  The
ring reduce-scatter and all-gather (uni and bi) hold the exact sums at 1e-5
on JAX's shapes, and the reduce-scatter adds in JAX's ring order, bit for
bit.  A rank that raises fails the launch with its traceback.

All cases run in one spawned world (``launch.mesh.run_jobs``): a world's
start (spawn, imports, gloo groups) costs more than a case's step.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import sharding as jsharding
from repro.core.plan import make_plan as jax_make_plan
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models import registry as jreg
from repro.optim import AdamW as JaxAdamW
from repro.testing.pipeline_equiv import reference_step as jax_reference_step

from repro_torch.configs.base import InputShape
from repro_torch.core.plan import make_plan
from repro_torch.core import collectives as cc
from repro_torch.launch.mesh import TIMEOUT_S, MeshShape, RankError, run_jobs, run_mesh
from repro_torch.models.common import tree_leaves
from repro_torch.optim import AdamW
from repro_torch.testing import collectives_check
from repro_torch.testing.pipeline_equiv import (
    equiv_config,
    mesh_shape,
    rank_train,
    worst_param_err,
)

# tests/test_multidev.py:42-50: (arch, stages, tensor, n_layers)
MATRIX = [
    ("phi3-mini-3.8b", 4, 1, 4),      # pure pipeline
    ("qwen2.5-14b", 2, 4, 4),         # deep TP, qkv bias, kv heads < tp lanes
    ("gemma3-4b", 2, 4, None),        # sliding window + kv-share sync
    ("dbrx-132b", 4, 1, 4),           # MoE + expert parallelism
    ("jamba-v0.1-52b", 2, 1, None),   # hybrid mamba+attn+moe period
    ("xlstm-125m", 2, 2, None),       # sLSTM/mLSTM, tp-replicated mixers
    ("hubert-xlarge", 4, 2, 4),       # encoder, no shift
]
VARIANTS = {"remat_none": dict(remat="none"), "remat_layer": dict(remat="layer"),
            "uni_ring": dict(bidirectional=False)}
SHAPE = InputShape("equiv", 64, 8, "train")
LR = 1e-2


def _jax_cfg(arch, stages, tensor, n_layers):
    """JAX's side of ``equiv_config``, built as JAX's check builds it."""
    cfg = jconfigs.get_config(arch).reduced()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts), router_aux_weight=0.0))
    return dataclasses.replace(cfg, stages=stages, tensor=tensor)


def _case(arch, stages, tensor, n_layers, remat="tick"):
    cfg = equiv_config(arch, stages, tensor, n_layers)
    jcfg = _jax_cfg(arch, stages, tensor, n_layers)
    kw = dict(data=8 // (stages * tensor), model=stages * tensor, microbatches=2, remat=remat)
    plan = make_plan(cfg, SHAPE, **kw)
    jplan = jax_make_plan(jcfg, jconfigs.base.InputShape("equiv", 64, 8, "train"), **kw)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    base = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    batch = jax_make_batch(jcfg, jconfigs.base.InputShape("equiv", 64, 8, "train"), seed=0)
    return dict(cfg=cfg, jcfg=jcfg, plan=plan, jplan=jplan, base=base, batch=batch,
                base_np=jax.tree.map(np.asarray, base),
                batch_np={k: np.asarray(v) for k, v in batch.items()})


@pytest.fixture(scope="module")
def mesh_runs():
    """Every case, the phi3 variants and the ring check in one world of 8
    CPU ranks, one intra-op thread each; the JAX side of each case."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cases = {row[0]: _case(*row) for row in MATRIX}
    for name, kw in VARIANTS.items():
        cases[name] = _case(*MATRIX[0], remat=kw.get("remat", "tick"))
        cases[name]["bidirectional"] = kw.get("bidirectional", True)
    jobs = [(rank_train, mesh_shape(c["cfg"], c["plan"]),
             (c["cfg"], c["plan"], c["base_np"], [c["batch_np"]], AdamW(lr=LR),
              c.get("bidirectional", True), False))
            for c in cases.values()]
    jobs.append((collectives_check.rank_check, MeshShape(data=8, model=1), ("cpu",)))
    try:
        outs = run_jobs(jobs, device="cpu")
    finally:
        torch.set_num_threads(n)
    for c, out in zip(cases.values(), outs):
        c["results"] = out
    return {"cases": cases, "rings": outs[-1]}


def _jax_reference(c):
    ref = jax.jit(lambda b, x: jax_reference_step(c["jcfg"], b, x, JaxAdamW(lr=LR)))
    new_base, loss, _ = ref(c["base"], c["batch"])
    want = jsharding.to_pipeline_layout(c["jcfg"], c["jplan"], new_base)
    return float(loss), jax.tree.map(np.asarray, want)


@pytest.mark.parametrize("arch,stages,tensor,layers", MATRIX)
def test_mesh_train_step_matches_jax_reference(mesh_runs, arch, stages, tensor, layers):
    """One pipelined AdamW step on the mesh == JAX's single-device step:
    loss within 2e-4 (the same on every rank), every rank's parameters
    within 1e-2 of its view of the laid-out reference."""
    c = mesh_runs["cases"][arch]
    ref_loss, want = _jax_reference(c)
    losses = {r["metrics"][0]["loss"] for r in c["results"]}
    assert len(losses) == 1
    loss = losses.pop()
    assert abs(loss - ref_loss) < 2e-4, (arch, loss, ref_loss)
    name, err = worst_param_err(c["cfg"], c["plan"], c["results"], want)
    assert err < 1e-2, (arch, name, err)
    if c["plan"].ep > 1:
        assert c["plan"].ep == c["plan"].data


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mesh_train_variants_bit_identical(mesh_runs, variant):
    """phi3's case with ``remat`` "none" or "layer" (a checkpoint per period
    instance), or with the unidirectional ring (at data 2 both rings add the
    same two terms): the same loss and every parameter bit-identical to
    the default run (remat "tick", bidirectional)."""
    base, other = mesh_runs["cases"][MATRIX[0][0]], mesh_runs["cases"][variant]
    for a, b in zip(base["results"], other["results"]):
        assert a["metrics"] == b["metrics"]
        for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
            assert np.array_equal(x, y), variant


def _jax_ring_rs(xs, reverse):
    """JAX's ``_ring_reduce_scatter_1d`` simulated over D ranks in float32:
    rank i's result, adding in JAX's order."""
    D = xs.shape[0]
    sgn = -1 if reverse else 1
    chunks = xs.reshape(D, D, -1)
    bufs = [chunks[i][(i - sgn) % D] for i in range(D)]
    for s in range(D - 1):
        bufs = [bufs[(i - sgn) % D] + chunks[i][(i - sgn * (2 + s)) % D] for i in range(D)]
    return bufs


def test_ring_collectives_exact_and_in_jax_order(mesh_runs):
    """Uni- and bidirectional ring reduce-scatter / all-gather on JAX's
    shapes over 8 ranks: within 1e-5 of the exact sums (all-gather exact),
    the composition within 1e-4; each rank's reduce-scatter equals JAX's ring
    order of float32 additions bit for bit (the bidirectional ring's halves
    in opposite directions)."""
    rings = mesh_runs["rings"]
    D = len(rings)
    for key in rings[0]:
        if key == "rs":
            continue
        if key == "compose":
            assert max(r[key] for r in rings) < 1e-4
            continue
        assert max(r[key][0] for r in rings) < 1e-5, key
        assert max(r[key][1] for r in rings) == 0.0, key
    xs = collectives_check._inputs(collectives_check.shapes(D)[0], D)
    uni = _jax_ring_rs(xs, False)
    c = xs.shape[1] // D
    lo = xs.reshape(D, D, c)[:, :, : c // 2].reshape(D, -1)
    hi = xs.reshape(D, D, c)[:, :, c // 2:].reshape(D, -1)
    a, b = _jax_ring_rs(lo, False), _jax_ring_rs(hi, True)
    for i, r in enumerate(rings):
        assert np.array_equal(r["rs"][False], uni[i])
        assert np.array_equal(r["rs"][True], np.concatenate([a[i], b[i]]))


def _rank_of(mesh):
    return mesh.rank


def _fail_on_rank_one(mesh):
    """Rank 1 raises; rank 0 waits in an all-reduce rank 1 never joins."""
    if mesh.rank == 1:
        raise ValueError("rank one refuses")
    return float(cc.all_reduce(torch.ones(1), mesh.axes["data"])[0])


def test_a_failing_rank_fails_the_launch():
    """A rank that raises while its peer waits for it in a collective:
    ``run_mesh`` kills the waiting rank and raises ``RankError`` with the
    failing rank's traceback, long before the groups' timeout; a healthy
    world returns each rank's result in rank order."""
    assert run_mesh(_rank_of, MeshShape(data=2, model=1), device="cpu") == [0, 1]
    t0 = time.perf_counter()
    with pytest.raises(RankError, match="rank 1 failed(.|\n)*rank one refuses"):
        run_mesh(_fail_on_rank_one, MeshShape(data=2, model=1), device="cpu")
    assert time.perf_counter() - t0 < TIMEOUT_S / 2
