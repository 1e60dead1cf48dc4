"""The mesh path's analytic half against the JAX package, on the CPU.

``repro_torch.launch.roofline`` (``CollectiveOp``, ``Roofline``,
``analytic_roofline``, ``model_flops``) and ``repro_torch.core.tpu_planner``
(``_hbm_estimate``, ``solve``) are copies of the JAX package's code with the
chip's constants as an argument.  With ``V5E`` (the JAX package's constants)
every number is held EXACTLY equal to the live JAX package's: every
``Roofline`` field and ``model_flops`` for the 11 configs x the 4 input
shapes x both production meshes on ``make_plan``'s default plan, and
``solve``'s whole ranked list at ``train_4k`` for two objectives.

``repro_torch.launch.dryrun`` is shape-only: its records carry the plan,
the analytic roofline and model FLOPs (equal to JAX's), one rank's argument
bytes (equal to the per-device bytes of the JAX package's abstract
arguments and their partition specs on the same mesh), the counted
roofline (``FlopCounterMode`` on fake tensors) or the reason it is null,
and JAX's skip reasons word for word.
"""
import dataclasses
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as jconfigs
from repro.core import plan as jplan
from repro.core import sharding as jsharding
from repro.core import tpu_planner as jtp
from repro.data.specs import input_specs as jinput_specs
from repro.launch import roofline as jrl
from repro.optim import AdamW as JaxAdamW
from repro.train import serve_step as jsrv
from repro.train import train_step as jts

import repro_torch.configs as tconfigs
from repro_torch.core import plan as tplan
from repro_torch.core import tpu_planner as ttp
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as trl

REPO = Path(__file__).resolve().parents[1]
ARCHS = jconfigs.ARCH_IDS + ["bert-large"]
SHAPES = list(jconfigs.INPUT_SHAPES)
MESHES = {"16x16": dict(pods=1, data=16, model=16), "2x16x16": dict(pods=2, data=16, model=16)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's CPU work: the suite runs several
    workers on the host's cores, and torch pools of a thread a core each
    starve one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return jconfigs.get_config(arch), tconfigs.get_config(arch)


# ------------------------------------------------------------------ roofline
def test_chip_constants():
    """``V5E`` is the JAX package's constants; the H100's memory is divided
    among the ranks that share the card, its rates are the data sheet's."""
    assert (trl.V5E.peak_flops, trl.V5E.hbm_bw, trl.V5E.link_bw, trl.V5E.hbm_bytes) == \
        (jrl.PEAK_FLOPS, jrl.HBM_BW, jrl.ICI_BW, jtp.HBM_BYTES)
    one, four = trl.h100(), trl.h100(4)
    assert (one.peak_flops, one.hbm_bw, one.hbm_bytes) == (989e12, 3.35e12, 80e9)
    assert four.hbm_bytes == 20e9 and four.link_bw == one.link_bw == 847e6 / 2.24
    assert "H100" in four.name and "700 W" in four.name
    r = trl.Roofline(flops=989e12, hbm_bytes=3.35e12, link_bytes=847e6 / 2.24, chip=one)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 1.0, 1.0)


@pytest.mark.parametrize("case", [("all-gather", 1024, 4), ("all-reduce", 1024, 4),
                                  ("collective-permute", 1024, 1), ("reduce-scatter", 256, 4),
                                  ("all-to-all", 1000, 8), ("all-reduce", 64, 1)])
def test_link_bytes_equal_jax(case):
    """``CollectiveOp.link_bytes`` on ``tests/test_substrate.py``'s cases
    (and an all-to-all and a group of one)."""
    assert trl.CollectiveOp(*case).link_bytes == jrl.CollectiveOp(*case).link_bytes
    op = trl.CollectiveOp(*case, trip_mult=5.0)
    assert op.weighted_link_bytes == jrl.CollectiveOp(*case, trip_mult=5.0).weighted_link_bytes


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_roofline_equals_jax(arch):
    """Every ``Roofline`` field (``as_dict``) and ``model_flops``, EXACTLY
    JAX's, on the default plan of every input shape on both production
    meshes, both ring schedules."""
    jcfg, tcfg = _cfgs(arch)
    for sname in SHAPES:
        js, ts = jconfigs.INPUT_SHAPES[sname], tconfigs.INPUT_SHAPES[sname]
        assert trl.model_flops(tcfg, ts) == jrl.model_flops(jcfg, js)
        for mesh in MESHES.values():
            jp, tp = jplan.make_plan(jcfg, js, **mesh), tplan.make_plan(tcfg, ts, **mesh)
            assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
            for bidi in (True, False):
                want = jrl.analytic_roofline(jcfg, js, jp, bidirectional=bidi)
                got = trl.analytic_roofline(tcfg, ts, tp, bidirectional=bidi)
                assert got.as_dict() == want.as_dict(), (arch, sname, mesh, bidi)
                assert got.chip == trl.V5E


def _result_rows(results):
    return [(dataclasses.asdict(r.plan), r.t_step_est, r.cost, r.hbm_est, r.objective, r.note)
            for r in results]


@pytest.mark.parametrize("arch", ARCHS)
def test_solve_equals_jax(arch):
    """``solve``'s whole ranked list (plan fields, ``t_step_est``, cost,
    ``hbm_est``, objective, in order) EXACTLY JAX's at ``train_4k`` for two
    objectives; JAX's ``AssertionError`` for an infeasible factorisation is
    the port's ``ValueError``, caught alike."""
    jcfg, tcfg = _cfgs(arch)
    js, ts = jconfigs.INPUT_SHAPES["train_4k"], tconfigs.INPUT_SHAPES["train_4k"]
    for alpha in ((1.0, 1.0), (0.0, 1.0)):
        want = jtp.solve(jcfg, js, alpha=alpha)
        got = ttp.solve(tcfg, ts, alpha=alpha, chip=trl.V5E)
        assert want and _result_rows(got) == _result_rows(want), (arch, alpha)
    for r in got:
        assert ttp._hbm_estimate(tcfg, ts, r.plan) == r.hbm_est <= trl.V5E.hbm_bytes


def test_solve_on_the_h100_ranks_by_its_constants():
    """On four ranks of one H100 (20e9 bytes a rank) the planner keeps
    every plan under the rank's share and ranks by the H100's rates: each
    ``t_step_est`` is the analytic roofline's with those rates times the
    padded-layer waste."""
    cfg = dataclasses.replace(tconfigs.get_config("phi3-mini-3.8b"), n_layers=4)
    shape = tconfigs.InputShape("train", 1024, 8, "train")
    chip = trl.h100(4)
    res = ttp.solve(cfg, shape, data=2, model=2, chip=chip)
    assert res and [r.objective for r in res] == sorted(r.objective for r in res)
    for r in res:
        assert r.hbm_est <= 20e9 and r.plan.stages * r.plan.tensor == 2
        rl = trl.analytic_roofline(cfg, shape, r.plan, chip=chip)
        waste = r.plan.n_instances * cfg.period_len / cfg.n_layers
        assert r.t_step_est == rl.t_step_est * waste and r.cost == 4 * r.t_step_est
    # a share too small for any plan leaves nothing
    assert ttp.solve(cfg, shape, data=2, model=2, chip=trl.h100(64)) == []


def test_issued_roofline_maps_collective_stats():
    """``issued_roofline`` from one rank's ``core.collectives.stats()``:
    each category onto JAX's kind and link bytes (ring bytes are what the
    rank sent, halved for the bidirectional ring as the analytic model
    halves them; a psum moves 2 (g-1)/g of its payload), counts the calls."""
    stats = {"ring_rs": {"calls": 6, "seconds": 1.0, "bytes": 3000},
             "ring_ag": {"calls": 6, "seconds": 1.0, "bytes": 1500},
             "psum_model": {"calls": 4, "seconds": 1.0, "bytes": 800},
             "psum_tp": {"calls": 10, "seconds": 1.0, "bytes": 400},
             "metrics": {"calls": 2, "seconds": 0.1, "bytes": 16},
             "p2p": {"calls": 8, "seconds": 2.0, "bytes": 640},
             "a2a_ep": {"calls": 2, "seconds": 0.1, "bytes": 900}}
    sizes = {"data": 4, "model": 4, "tp": 2, "world": 16}
    r = trl.issued_roofline(stats, sizes, flops=2.0, hbm_bytes=3.0, bubble_factor=1.5,
                            chip=trl.h100(4))
    by_kind = r.collective_bytes_by_kind
    assert by_kind["reduce-scatter"] == 1500 and by_kind["all-gather"] == 750
    assert by_kind["all-reduce"] == 2 * 800 * 3 / 4 + 2 * 400 * 1 / 2 + 2 * 16 * 15 / 16
    assert by_kind["collective-permute"] == 640 and by_kind["all-to-all"] == 900 * 3 / 4
    assert r.collective_counts == {"reduce-scatter": 6, "all-gather": 6, "all-reduce": 16,
                                   "collective-permute": 8, "all-to-all": 2}
    assert r.link_bytes == sum(by_kind.values())
    assert r.t_step_est == max(2.0 / 989e12, 3.0 / 3.35e12) * 1.5 + r.link_bytes / (847e6 / 2.24)
    uni = trl.issued_roofline(stats, sizes, bidirectional=False).collective_bytes_by_kind
    assert (uni["reduce-scatter"], uni["all-gather"]) == (3000, 1500)


# -------------------------------------------------------------------- dryrun
def _per_device_bytes(tree, specs, sizes) -> int:
    """Bytes one device holds of abstract arrays sharded by ``specs`` on a
    mesh of ``sizes``: each leaf's bytes over the sizes of the axes its
    partition spec names (what XLA counts as a device's argument)."""
    leaves = jax.tree.leaves(tree)
    pspecs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(pspecs)
    total = 0
    for sds, spec in zip(leaves, pspecs):
        shards = 1
        for entry in spec:
            for name in (entry if isinstance(entry, tuple) else (entry,)):
                shards *= sizes[name] if name else 1
        nbytes = math.prod(sds.shape) * np.dtype(sds.dtype).itemsize
        assert nbytes % shards == 0
        total += nbytes // shards
    return total


def _jax_argument_bytes(arch, sname, mesh) -> int:
    """One device's argument bytes of the JAX package's step, from its own
    abstract shapes and partition specs (``lower_combo``'s arguments)."""
    cfg, shape = jconfigs.get_config(arch), jconfigs.INPUT_SHAPES[sname]
    plan = jplan.make_plan(cfg, shape, **mesh)
    sizes = {"pod": mesh["pods"], "data": mesh["data"], "model": mesh["model"]}
    total = _per_device_bytes(jsharding.abstract_layout_shapes(cfg, plan),
                              jsharding.pipeline_param_specs(cfg, plan), sizes)
    total += _per_device_bytes(jinput_specs(cfg, shape), jts.batch_pspecs(cfg, shape, plan),
                               sizes)
    if shape.kind == "train":
        total += _per_device_bytes(*jts.opt_state_specs(cfg, plan, JaxAdamW(lr=1e-4)), sizes)
    if shape.kind == "decode":
        total += _per_device_bytes(*jsrv.cache_specs(cfg, plan, shape), sizes)
    return total


@pytest.mark.parametrize("arch,sname,mesh", [("phi3-mini-3.8b", "train_4k", "16x16"),
                                             ("qwen3-moe-235b-a22b", "decode_32k", "16x16"),
                                             ("jamba-v0.1-52b", "long_500k", "2x16x16")])
def test_dryrun_record_matches_jax(arch, sname, mesh):
    """A dry-run record: the plan, the analytic roofline and model FLOPs
    EXACTLY JAX's; one rank's argument bytes EXACTLY the per-device bytes
    of JAX's abstract arguments; the planner's memory estimate beside them;
    the compiler's byte counts null."""
    rec = dryrun.dry_combo(arch, sname, multi_pod=mesh == "2x16x16", verbose=False)
    json.dumps(rec)
    jcfg, js = jconfigs.get_config(arch), jconfigs.INPUT_SHAPES[sname]
    jp = jplan.make_plan(jcfg, js, **MESHES[mesh])
    assert (rec["status"], rec["mesh"], rec["chip"]) == ("ok", mesh, trl.V5E.name)
    assert rec["plan"] == {"stages": jp.stages, "tensor": jp.tensor,
                           "microbatches": jp.microbatches, "ep": jp.ep,
                           "seq_shards": jp.seq_shards, "remat": jp.remat,
                           "bidirectional": True}
    want = jrl.analytic_roofline(jcfg, js, jp)
    assert rec["roofline"] == want.as_dict()
    mf = jrl.model_flops(jcfg, js)
    chips = math.prod(MESHES[mesh].values())
    assert (rec["model_flops_global"], rec["model_flops_per_chip"],
            rec["useful_flops_ratio"]) == (mf, mf / chips, (mf / chips) / want.flops)
    mem = rec["memory"]
    assert mem["argument_bytes"] == _jax_argument_bytes(arch, sname, MESHES[mesh])
    assert mem["argument_bytes"] == sum(mem["argument_bytes_by_part"].values())
    assert (mem["output_bytes"], mem["temp_bytes"], mem["peak_bytes"]) == (None, None, None)
    assert mem["hbm_estimate"] == jtp._hbm_estimate(jcfg, js, jp)
    if jp.seq_shards > 1:
        assert mem["argument_bytes_by_part"]["caches"] > 0 and jp.seq_shards == 32


def test_dryrun_counts_dense_forwards_and_names_why_not_others():
    """``roofline_counted``: phi3's stage forward counted on fake tensors
    (the plain attention computes every score, so the count exceeds the
    analytic model's causal half, within 2x), scaled to one rank's step;
    null for qwen3-moe (MoE) and jamba (MoE and Mamba) with the reason."""
    rec = dryrun.dry_combo("phi3-mini-3.8b", "train_4k", verbose=False)
    c = rec["roofline_counted"]
    assert c["stage_layers"] == 2 and c["microbatch_rows"] == 1 and c["passes"] == 4.0
    assert c["flops"] == c["stage_forward_flops"] * rec["plan"]["microbatches"] * 4.0
    assert 1.0 < c["flops_over_analytic"] < 2.0
    assert c["flops_over_analytic"] == c["flops"] / rec["roofline"]["flops"]
    assert c["link_bytes"] == rec["roofline"]["link_bytes"]
    assert "roofline_counted_reason" not in rec
    moe = dryrun.dry_combo("qwen3-moe-235b-a22b", "decode_32k", verbose=False)
    assert moe["roofline_counted"] is None and moe["roofline_counted_reason"].startswith("MoE")
    jamba = dryrun.dry_combo("jamba-v0.1-52b", "train_4k", verbose=False)
    assert jamba["roofline_counted"] is None
    assert "MoE" in jamba["roofline_counted_reason"]
    assert "Mamba" in jamba["roofline_counted_reason"]


def test_dryrun_skips_word_for_word():
    """The skip records carry the JAX dry run's reasons, word for word."""
    jax_src = (REPO / "src" / "repro" / "launch" / "dryrun.py").read_text()
    enc = dryrun.dry_combo("bert-large", "decode_32k", verbose=False)
    full = dryrun.dry_combo("phi3-mini-3.8b", "long_500k", verbose=False)
    assert enc == {"arch": "bert-large", "shape": "decode_32k", "status": "skip",
                   "reason": "encoder has no decode step"}
    assert full == {"arch": "phi3-mini-3.8b", "shape": "long_500k", "status": "skip",
                    "reason": "full-attention arch: 500k decode infeasible (DESIGN.md)"}
    for rec in (enc, full):
        assert f'"{rec["reason"]}"' in jax_src


def test_dryrun_all_both_meshes(tmp_path):
    """``dryrun --all --both-meshes``: exit 0, one record for each of the 88
    arch x shape x mesh combinations, none failed, the skips where JAX's
    ``supports_shape`` says so."""
    assert dryrun.main(["--all", "--both-meshes", "--out", str(tmp_path)]) == 0
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert len(recs) == len(ARCHS) * len(SHAPES) * 2 == 88
    for rec in recs:
        supported = jconfigs.get_config(rec["arch"]).supports_shape(rec["shape"])
        assert rec["status"] == ("ok" if supported else "skip"), rec
