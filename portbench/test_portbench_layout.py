"""The benchmark's files: BENCHMARK.json against its contract, and every
configuration, cell, traffic mix, limit and metric reader found by name."""
import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = {"hidden_size", "intermediate_size", "head_dim", "num_attention_heads",
          "num_key_value_heads", "num_experts_per_tok"}
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    seen = set()
    for sec, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                      ("workloads", {"name", "config", "traffic", "chips", "why"})):
        assert 1 <= len(BENCH[sec]) <= 24
        for e in BENCH[sec]:
            assert set(e) == keys, e["name"]
            assert NAME.match(e["name"]) and (sec, e["name"]) not in seen
            seen.add((sec, e["name"]))
            assert _line(e["why"])
    for c in BENCH["configs"]:
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) or k in WIDTHS for k in c["reduced"])
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        # one module, one layer name, letter for letter
        module = m["layer"].split(": ")[-1].split(" ")[0]
        layers.setdefault(module, set()).add(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())


def test_cells_use_configs_and_chips():
    configs = {c["name"] for c in BENCH["configs"]}
    assert configs == {w["config"] for w in BENCH["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    names = [w["name"] for w in BENCH["workloads"]]
    assert names == ["phi3-train-s2d2-b4", "bert-train-s2d2", "phi3-train-s2d1-b4"]
    for m in BENCH["per_layer"]:
        assert set(m.get("workloads", names)) <= set(names)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(name):
    cell = harness.load_cell(name)
    ref, adapter = harness.family(cell["config"])
    assert callable(ref.train) and callable(adapter.arch_config)
    tr = cell["traffic"]
    assert set(cell["limits"]) == ({"loss_gap", "grad_gap", "change_gap", "off_route_launches",
                                    "missing_launches"} | ({"replica_gap"}
                                                           if tr["replicas"] > 1 else set()))
    assert set(tr) == harness.TRAFFIC_KEYS
    assert harness.WARM_STEPS >= harness.CHECKED_STEPS >= 3
    rows = tr["replicas"] * tr["micro_batches"] * tr["micro_batch"]
    # a phi3 step is 32 rows of 2,048 tokens, enough work that the card and
    # not the shared host paces it; bert's 16,384 tokens leave it host-paced
    assert rows * tr["seq"] == (65536 if name.startswith("phi3-") else 16384)
    # the rate is bounded end to end only where its runs are steady; a cell
    # whose step the host paces reads it per layer, beside the device's share
    rate = {"train_tokens_per_s"} if name.startswith("phi3-") else set()
    assert {m["name"] for m in cell["end_to_end"]} == rate | {"peak_mem_gb", "setup_s"}
    assert {m["moves"] for m in cell["per_layer"]} == rate | {"peak_mem_gb"}
    if not rate:
        assert {m["name"] for m in cell["per_layer"]} >= {"train_tokens_per_s.host_paced",
                                                          "device.busy_ms_per_step.host_paced"}
    assert cell["per_layer"]
    arch = adapter.arch_config(cell["config"])
    prof, _, config, M = harness.make_plan(arch, tr)
    assert prof.L == arch.n_layers + 2 and sum(config.x) == tr["stages"] - 1
    assert M == tr["replicas"] * tr["micro_batches"]


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(name):
    assert callable(harness.reader(name))


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_files_state_their_cut(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == name and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert set(cfg["published"]) == set(cfg["reduced"])
    assert cfg["assumed"] and cfg["deployment"]
