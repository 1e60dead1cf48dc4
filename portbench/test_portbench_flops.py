"""The yardstick's arithmetic against hand reckonings: a step's model FLOPs
(through the cell's family), the kernels' operations and bytes (through the
table in ``kernels/``), the roofline's least time, and the readers that turn
them into per-layer metrics."""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from portbench import flops, harness, kernels
from portbench.reference import dense_transformer as R

ROOT = Path(__file__).resolve().parent.parent
PEAK = json.loads((ROOT / "portbench" / "peaks.json").read_text())["NVIDIA H100 80GB HBM3"]


def config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def step_flops(name, rows, seq):
    """A step's model FLOPs as a run reads them: from the config's family."""
    cfg = config(name)
    ref, _ = harness.family(cfg)
    return ref.step_flops(cfg, rows, seq)


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name}", ROOT / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_phi3_step_is_56_7_tflop():
    layer = 4 * 3072 * 3072 + 3 * 3072 * 8192       # q, k, v, o; gate, up, down
    n = 4 * layer + 32064 * 3072                      # and the head; not the embedding
    assert R.matmul_params(R.sizes(config("phi3-mini-3.8b-l4"))) == n == 551_485_440
    attn = 4 * (2048 * 2049 // 2) * 32 * 96 * 8 * 4  # causal pairs, 8 rows, 4 layers
    want = 6 * n * 16384 + 3 * attn
    assert step_flops("phi3-mini-3.8b-l4", 8, 2048) == want
    assert abs(want / 56.7e12 - 1) < 1e-3


@pytest.mark.parametrize("cell", ["phi3-train-s2d2-b4", "phi3-train-s2d1-b4"])
def test_phi3_cells_step_is_226_8_tflop(cell):
    """32 rows of 2,048 tokens a step: four times the 8-row step above."""
    c = harness.load_cell(cell)
    tr = c["traffic"]
    rows = tr["replicas"] * tr["micro_batches"] * tr["micro_batch"]
    assert (rows, tr["seq"]) == (32, 2048)
    got = step_flops(c["config"]["name"], rows, tr["seq"])
    assert got == 4 * step_flops("phi3-mini-3.8b-l4", 8, 2048)
    assert abs(got / 226.8e12 - 1) < 1e-3


def test_bert_step_is_45_2_tflop():
    n = 24 * (4 * 1024 * 1024 + 3 * 1024 * 4096) + 30522 * 1024
    attn = 4 * 512 * 512 * 16 * 64 * 32 * 24          # every pair, 32 rows, 24 layers
    assert step_flops("bert-large", 32, 512) == 6 * n * 16384 + 3 * attn
    assert abs(step_flops("bert-large", 32, 512) / 45.2e12 - 1) < 2e-3


def test_model_flops_is_the_ports_arithmetic():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.roofline import model_flops

    arch = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=4)
    shape = InputShape("train", 2048, 8, "train")
    assert flops.model_flops(arch.active_param_count(), 8 * 2048) == model_flops(arch, shape)


def test_kernel_calls_against_hand_counts():
    table = kernels.table()
    bf16 = dict(dtype=torch.bfloat16, device="meta")
    q = torch.empty(2, 1024, 32, 96, **bf16)
    shape = table["flash_attention"].shape(q, q, q, causal=True)
    assert shape == (2, 1024, 32, 32, 96, True, 2)
    f = table["flash_attention"].count(shape)
    assert f == flops.flash_call(2, 1024, 32, 32, 96, True)
    assert f["fwd_ops"] == 4 * (1024 * 1025 // 2) * 32 * 96 * 2      # 12.9 GFLOP
    assert abs(f["fwd_ops"] / 12.9e9 - 1) < 1e-2 and f["bwd_ops"] == 2 * f["fwd_ops"]
    q = 2 * 1024 * 32 * 96 * 2
    assert f["fwd_bytes"] == 4 * q + 2 * 32 * 1024 * 4
    x, w = torch.empty(2, 1024, 3072, **bf16), torch.empty(3072, 8192, **bf16)
    shape = table["swiglu"].shape(x, w, w)
    assert shape == (2048, 3072, 8192, 2)
    s = table["swiglu"].count(shape)
    assert s == flops.swiglu_call(2048, 3072, 8192)
    assert s["fwd_ops"] == 4 * 2048 * 3072 * 8192                    # 206 GFLOP
    assert s["fwd_bytes"] == 2 * (2048 * 3072 + 2 * 3072 * 8192 + 2048 * 8192)
    assert s["bwd_ops"] == 2 * s["fwd_ops"]
    assert s["bwd_bytes"] == 2 * (2 * 2048 * 3072 + 4 * 3072 * 8192 + 2048 * 8192)


def test_adamw_counts_a_phi3_stage():
    """One call at a phi3-mini-l4 stage (the embedding and two layers):
    325.0 M elements at 30 B, 9.75 GB, 2.910 ms at 3.35 TB/s; the state's
    padding between leaves is not counted."""
    from repro_torch.kernels.adamw import LeafTable
    from repro_torch.optim import AdamW

    cfg = config("phi3-mini-3.8b-l4")
    sizes = []
    for name, shape, _ in R.leaves(cfg):
        n = int(torch.Size(shape).numel())
        if name.startswith("layers."):
            sizes += [n // shape[0]] * 2                  # two of the four layers
        elif name == "embed":
            sizes.append(n)
    rows, g, s = [], 0, 0
    for n in sizes:
        rows.append((g, s, n))
        g, s = g + n, s + -(-n // 8) * 8
    table = LeafTable(rows, "cpu")
    assert table.grad_numel == sum(sizes) == 325_005_312
    entry = kernels.table()["adamw"]
    odd = LeafTable([(0, 0, 5), (5, 8, 3)], "cpu")        # a leaf of 5 padded to 8
    assert entry.shape(None, None, {}, None, odd) == (8, 0) and odd.state_numel == 11
    param = torch.empty(s, dtype=torch.bfloat16, device="meta")
    shape = entry.shape(AdamW(lr=1e-4), None, {}, param, table, step=1, replicas=2)
    assert shape == (325_005_312, 2)
    c = entry.count(shape)
    assert c["fwd_bytes"] == 30 * 325_005_312 and abs(c["fwd_bytes"] / 9.75e9 - 1) < 1e-3
    assert c["bwd_bytes"] == c["bwd_ops"] == c["fwd_ops"] == 0
    t = harness.least_seconds({"adamw": [shape]}, {"adamw": entry}, PEAK)["adamw"]
    assert t == c["fwd_bytes"] / 3.35e12 and abs(t * 1e3 - 2.910) < 1e-3
    assert entry.count(entry.shape(None, None, {}, None, table))["fwd_bytes"] == 28 * 325_005_312


def test_least_seconds_sums_the_tables_counts():
    """The roofline time of recorded calls: each call's forward and backward
    bound, summed, as flash's and swiglu's were counted before the table."""
    calls = {"flash_attention": [(1, 2048, 32, 32, 96, True, 2)] * 3,
             "swiglu": [(2048, 3072, 8192, 2), (512, 1024, 4096, 2)]}
    got = harness.least_seconds(calls, kernels.table(), PEAK)
    for name, call in (("flash_attention", flops.flash_call), ("swiglu", flops.swiglu_call)):
        want = 0.0
        for *dims, elem in calls[name]:
            c = call(*dims, elem=elem)
            want += (flops.least_seconds(c["fwd_ops"], c["fwd_bytes"], PEAK)
                     + flops.least_seconds(c["bwd_ops"], c["bwd_bytes"], PEAK))
        assert got[name] == want


def test_least_time_takes_the_binding_bound():
    # bert's unmasked [4, 512, 16 heads, 64] forward is bound by its bytes,
    # phi3's FFN by its operations
    f = flops.flash_call(4, 512, 16, 16, 64, False)
    t = flops.least_seconds(f["fwd_ops"], f["fwd_bytes"], PEAK)
    assert t == f["fwd_bytes"] / 3.35e12 and abs(t * 1e3 - 0.0050) < 1e-4
    s = flops.swiglu_call(2048, 3072, 8192)
    assert flops.least_seconds(s["fwd_ops"], s["fwd_bytes"], PEAK) == s["fwd_ops"] / 989e12


def _measured(**trace):
    t = {"steps": 3, "window_s": 2.0, "busy_s": 0.75, "elementwise_s": 0.09,
         "ranges": {"flash_attention": {"calls": 96, "backward_nodes": 96, "device_s": 0.4,
                                        "least_s": 0.1, "backward": True},
                    "swiglu": {"calls": 96, "backward_nodes": 0, "device_s": 0.4,
                               "least_s": 0.2, "backward": True},
                    "adamw": {"calls": 8, "backward_nodes": 0, "device_s": 0.0334,
                              "least_s": 0.0233, "backward": False}}}
    t.update(trace)
    return {"trace": t, "peak": PEAK, "replicas": 2, "syncs": [0.05, 0.07],
            "store": {"peak_bytes": 3.5e9},
            "window": {"steps": 10, "seconds": 5.0, "flops_per_step": 56.7e12}}


def test_readers():
    m = _measured()
    assert reader("step_mfu")(m) == pytest.approx(100 * 56.7e12 * 10 / (5.0 * 989e12))
    assert reader("device.idle_pct")(m) == pytest.approx(50.0)   # 0.25 s busy of 0.5 a step
    assert reader("device.busy_ms_per_step")(m) == pytest.approx(250.0)
    assert reader("worker.elementwise_ms_per_step")(m) == pytest.approx(30.0)
    assert reader("flash_attention_roofline")(m) == pytest.approx(25.0)
    assert reader("swiglu_roofline")(m) is None      # a backward left unmatched
    assert reader("adamw_roofline")(m) == pytest.approx(100 * 0.0233 / 0.0334)  # none to match
    idle = dict(m["trace"]["ranges"]["adamw"], device_s=0.0)
    assert reader("adamw_roofline")(_measured(ranges={"adamw": idle})) is None
    assert reader("adamw_roofline")(_measured(ranges={})) is None    # no kernel of that name
    assert reader("sync.s_per_step")(m) == pytest.approx(0.06)
    assert reader("sync.s_per_step")(dict(m, replicas=1)) is None
    assert reader("store.peak_gb")(m) == pytest.approx(3.5)
    for name in ("device.idle_pct", "worker.elementwise_ms_per_step", "flash_attention_roofline",
                 "adamw_roofline"):
        assert reader(name)({"trace": None}) is None
