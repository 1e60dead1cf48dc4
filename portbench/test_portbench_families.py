"""A family and a kernel enter the benchmark with new modules only: the
harness finds a family's reference and adapter, and the table's kernels, by
name, and reads from them the step's model FLOPs, the launches the window
expects and the ranged calls.  The dense cells read what they read before
the family declared them."""
import sys
import time
import types

import pytest

from portbench import compare, flops, harness, kernels
from portbench.adapters import dense_transformer as A
from portbench.reference import dense_transformer as R
from portbench.test_portbench_reference import CELLS, SEED, cpu_verdict, tiny_cell


def _module(name, **attrs):
    mod = types.ModuleType(name)
    mod.__dict__.update(attrs)
    return mod


def _counts(expected):
    """Counters of a window whose every expected launch took the wgmma route."""
    out = {}
    for k, n in expected.items():
        out.update({k: n, f"{k}_wgmma": n, f"{k}_bwd": n, f"{k}_bwd_wgmma": n})
    return out


def test_a_family_enters_with_new_modules_only(monkeypatch):
    """A family and a kernel that exist only in this test, registered under
    their packages' names: ``harness.run`` takes them as it takes the files
    of ``reference/``, ``adapters/`` and ``kernels/``."""
    ref = _module("portbench.reference.toy_family", sizes=R.sizes, leaves=R.leaves,
                  train=R.train, TINY=dict(R.TINY, num_hidden_layers=4),
                  step_flops=lambda cfg, rows, seq: 7.0 * rows * seq)
    adapter = _module("portbench.adapters.toy_family", arch_config=A.arch_config,
                      expected_launches=lambda arch, traffic: {
                          "flash_attention": arch.n_layers // 2})
    toy = _module("portbench.kernels.toy_kernel", OP="swiglu", RANGE="portbench::toy_kernel",
                  BACKWARD=False, shape=lambda x, *a, **kw: (x.numel(),),
                  count=lambda shape: {"fwd_ops": 0.0, "bwd_ops": 0.0,
                                       "fwd_bytes": 2.0 * shape[0], "bwd_bytes": 0.0})
    for mod in (ref, adapter, toy):
        monkeypatch.setitem(sys.modules, mod.__name__, mod)
    from repro_torch.kernels import ops

    real = ops.swiglu
    cell = tiny_cell("phi3-train-s2d2-b4", family="toy_family")
    cfg, tr = cell["config"], cell["traffic"]
    assert harness.family(cfg) == (ref, adapter) and cfg["num_hidden_layers"] == 4
    assert set(kernels.table()) == {"adamw", "flash_attention", "swiglu", "toy_kernel"}

    out = harness.run(cell, SEED, 0.0, True, t_start=time.perf_counter(), device="cpu",
                      check_launches=False)
    assert ops.swiglu is real
    assert cpu_verdict(out["numbers"], cell), out["numbers"]
    rows = tr["replicas"] * tr["micro_batches"] * tr["micro_batch"]
    assert out["window"]["flops_per_step"] == 7.0 * rows * tr["seq"]
    n_window = out["window"]["steps"]
    expected = {"flash_attention": n_window * tr["replicas"] * tr["micro_batches"] * 2}
    assert out["expected_launches"] == expected
    ranges = out["trace"]["ranges"]
    # the toy's range nests with swiglu's around the same calls
    assert ranges["toy_kernel"]["recorded_calls"] == ranges["toy_kernel"]["calls"]
    assert ranges["toy_kernel"]["calls"] == ranges["swiglu"]["calls"] > 0
    assert ranges["toy_kernel"]["backward"] is False and ranges["swiglu"]["backward"] is True
    assert ranges["adamw"]["calls"] == tr["host_traced_steps"] * tr["stages"] * tr["replicas"]

    counts = _counts(expected)
    assert compare.launch_numbers(counts, expected) == {"off_route_launches": 0,
                                                        "missing_launches": 0}
    counts["flash_attention"] -= 1
    counts["flash_attention_wgmma"] -= 1
    assert compare.launch_numbers(counts, expected) == {"off_route_launches": 0,
                                                        "missing_launches": 1}
    peak = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
    least = harness.least_seconds({"toy_kernel": [(3.35e6,)]}, kernels.table(), peak)
    assert least == {"toy_kernel": 2e-6}


@pytest.mark.parametrize("name", CELLS)
def test_dense_cells_read_the_parents_numbers(name):
    """A dense cell's expected launches are one flash attention and one
    swiglu call a layer, micro-batch and replica, and its launch numbers and
    step FLOPs are the arithmetic the harness had before families declared
    them."""
    cell = harness.load_cell(name)
    cfg, tr = cell["config"], cell["traffic"]
    ref, adapter = harness.family(cfg)
    arch = adapter.arch_config(cfg)
    d, mu, n_window = tr["replicas"], tr["micro_batches"], 37
    per = adapter.expected_launches(arch, tr)
    assert per == {"flash_attention": arch.n_layers, "swiglu": arch.n_layers}
    want = n_window * d * mu * arch.n_layers
    expected = {k: n_window * d * mu * n for k, n in per.items()}
    counts = _counts(expected)
    # two forward flash launches off the wgmma route, three backward swiglu
    # launches missing
    counts.update(flash_attention=want + 2, swiglu_bwd=want - 3, swiglu_bwd_wgmma=want - 3)
    assert compare.launch_numbers(counts, expected) == {"off_route_launches": 2,
                                                        "missing_launches": 3}
    z = R.sizes(cfg)
    rows, seq = d * mu * tr["micro_batch"], tr["seq"]
    attn_fwd = 4.0 * flops.pairs(seq, z["causal"]) * z["H"] * z["hd"] * rows * z["L"]
    assert ref.step_flops(cfg, rows, seq) == (
        flops.model_flops(R.matmul_params(z), rows * seq) + 3.0 * attn_fwd)
