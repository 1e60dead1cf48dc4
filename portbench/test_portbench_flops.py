"""The yardstick's arithmetic against hand reckonings: a step's model FLOPs,
the kernels' operations and bytes, the roofline's least time, and the
readers that turn them into per-layer metrics."""
import importlib.util
import json
from pathlib import Path

import pytest

from portbench import flops
from portbench.reference import dense_transformer as R

ROOT = Path(__file__).resolve().parent.parent
PEAK = json.loads((ROOT / "portbench" / "peaks.json").read_text())["NVIDIA H100 80GB HBM3"]


def sizes(name):
    return R.sizes(json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text()))


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name}", ROOT / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_phi3_step_is_56_7_tflop():
    z = sizes("phi3-mini-3.8b-l4")
    layer = 4 * 3072 * 3072 + 3 * 3072 * 8192       # q, k, v, o; gate, up, down
    n = 4 * layer + 32064 * 3072                      # and the head; not the embedding
    assert flops.matmul_params(z) == n == 551_485_440
    attn = 4 * (2048 * 2049 // 2) * 32 * 96 * 8 * 4  # causal pairs, 8 rows, 4 layers
    want = 6 * n * 16384 + 3 * attn
    assert flops.step_flops(z, 8, 2048) == want
    assert abs(want / 56.7e12 - 1) < 1e-3


def test_bert_step_is_45_2_tflop():
    z = sizes("bert-large")
    n = 24 * (4 * 1024 * 1024 + 3 * 1024 * 4096) + 30522 * 1024
    attn = 4 * 512 * 512 * 16 * 64 * 32 * 24          # every pair, 32 rows, 24 layers
    assert flops.step_flops(z, 32, 512) == 6 * n * 16384 + 3 * attn
    assert abs(flops.step_flops(z, 32, 512) / 45.2e12 - 1) < 2e-3


def test_model_flops_is_the_ports_arithmetic():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.roofline import model_flops

    arch = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=4)
    shape = InputShape("train", 2048, 8, "train")
    assert flops.model_flops(arch.active_param_count(), 8 * 2048) == model_flops(arch, shape)


def test_kernel_calls_against_hand_counts():
    f = flops.flash_call(2, 1024, 32, 32, 96, True)
    assert f["fwd_ops"] == 4 * (1024 * 1025 // 2) * 32 * 96 * 2      # 12.9 GFLOP
    assert abs(f["fwd_ops"] / 12.9e9 - 1) < 1e-2 and f["bwd_ops"] == 2 * f["fwd_ops"]
    q = 2 * 1024 * 32 * 96 * 2
    assert f["fwd_bytes"] == 4 * q + 2 * 32 * 1024 * 4
    s = flops.swiglu_call(2048, 3072, 8192)
    assert s["fwd_ops"] == 4 * 2048 * 3072 * 8192                    # 206 GFLOP
    assert s["fwd_bytes"] == 2 * (2048 * 3072 + 2 * 3072 * 8192 + 2048 * 8192)
    assert s["bwd_ops"] == 2 * s["fwd_ops"]
    assert s["bwd_bytes"] == 2 * (2 * 2048 * 3072 + 4 * 3072 * 8192 + 2048 * 8192)


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
                                        "least_s": 0.1},
                    "swiglu": {"calls": 96, "backward_nodes": 0, "device_s": 0.4,
                               "least_s": 0.2}}}
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
    assert reader("sync.s_per_step")(m) == pytest.approx(0.06)
    assert reader("sync.s_per_step")(dict(m, replicas=1)) is None
    assert reader("store.peak_gb")(m) == pytest.approx(3.5)
    for name in ("device.idle_pct", "worker.elementwise_ms_per_step", "flash_attention_roofline"):
        assert reader(name)({"trace": None}) is None
