"""The plain reference against the port on the CPU at a reduced size: its
loss and gradients against the port's own plain path in fp32, a whole run
of each cell's timed path (bf16, the kernels' plain versions) held to its
limits, and the control (the reference in fp8) failing them."""
import copy
import json
import time
from pathlib import Path

import pytest
import torch

from portbench import compare, data, harness
from portbench.reference import dense_transformer as R

ROOT = Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 77


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cell(name: str, **config) -> dict:
    """The cell at a size the CPU runs in seconds: its widths cut to its
    family's ``TINY`` (``config`` set over them), its sequence 16 tokens;
    plan, steps, optimizer and limits as they are."""
    cell = copy.deepcopy(harness.load_cell(name))
    cell["config"].update(config)
    ref, _ = harness.family(cell["config"])
    cell["config"].update(ref.TINY, **config)
    cell["traffic"].update(seq=16, reference_rows=1)
    return cell


def tiny_run(cell, **kw):
    return harness.run(cell, SEED, 0.0, False, t_start=time.perf_counter(), device="cpu",
                       check_launches=False, **kw)


def cpu_verdict(numbers, cell, required=None):
    """The verdict on every number a CPU run reads (all but the launches)."""
    if required is None:
        required = set(cell["limits"]) - {"off_route_launches", "missing_launches"}
    return compare.verdict(numbers, cell["limits"], required=required)[0]


@pytest.mark.parametrize("config", ["phi3-mini-3.8b-l4", "bert-large"])
def test_reference_matches_the_ports_plain_path(config):
    """fp32 both sides: the reference's loss and every gradient equal the
    port's ``registry.loss_fn`` under autograd."""
    from repro_torch.models import registry

    cell = tiny_cell({"phi3-mini-3.8b-l4": "phi3-train-s2d2-b4",
                      "bert-large": "bert-train-s2d2"}[config], param_dtype="float32")
    cfg = cell["config"]
    _, adapter = harness.family(cfg)
    arch = adapter.arch_config(cfg)
    flat = {n: t.clone().requires_grad_() for n, t in
            data.make_weights(R.leaves(cfg), SEED, "cpu", dtype=torch.float32).items()}
    tokens = data.token_batch(cell["traffic"], cfg["vocab_size"], 4, seed=SEED, step=0,
                              device="cpu")
    loss, _ = registry.loss_fn(arch, harness.nest(flat), {"tokens": tokens, "labels": tokens})
    port = torch.autograd.grad(loss, list(flat.values()))
    z = R.sizes(cfg)
    count = tokens.numel() - (tokens.shape[0] if z["shift"] else 0)
    mine = R._loss_sum(z, flat, tokens, "fp32") / count
    ref = torch.autograd.grad(mine, list(flat.values()))
    assert float(mine.detach()) == pytest.approx(float(loss.detach()), rel=1e-6)
    for name, a, b in zip(flat, port, ref):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-7, msg=name)


@pytest.mark.parametrize("name", CELLS)
def test_timed_path_is_correct_at_a_reduced_size(name):
    cell = tiny_cell(name)
    out = tiny_run(cell)
    assert cpu_verdict(out["numbers"], cell), out["numbers"]
    assert len(out["detail"]["losses"]) == harness.CHECKED_STEPS
    assert out["detail"]["left_out"] == []
    if cell["traffic"]["replicas"] > 1:
        assert out["numbers"]["replica_gap"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference computed in fp8 in the program's place fails a limit."""
    cell = tiny_cell(name)
    cfg, tr = cell["config"], cell["traffic"]
    ref, _ = harness.family(cfg)
    rows = tr["replicas"] * tr["micro_batches"] * tr["micro_batch"]
    tokens = [data.token_batch(tr, cfg["vocab_size"], rows, seed=SEED, step=k, device="cpu")
              for k in range(harness.CHECKED_STEPS)]
    weights = data.make_weights(ref.leaves(cfg), SEED, "cpu")
    kw = dict(rows_per_block=tr["reference_rows"])
    exact = ref.train(cfg, weights, tokens, tr["optimizer"], **kw)
    ctrl = ref.train(cfg, weights, tokens, tr["optimizer"], precision="fp8", **kw)
    numbers, _ = compare.readings(ctrl, exact)
    assert not cpu_verdict(numbers, cell, ("loss_gap", "grad_gap", "change_gap")), numbers
