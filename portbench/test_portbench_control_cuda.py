"""On the card, at each cell's own size: the control (the reference in fp8
in the program's place) fails the cell's limits on three seeds.  Skips
without a card; run there with
``python3 -m pytest -q -m cuda portbench/test_portbench_control_cuda.py``."""
import json
from pathlib import Path

import pytest
import torch

from portbench import compare, data, harness

ROOT = Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    cell = harness.load_cell(name)
    cfg, tr = cell["config"], cell["traffic"]
    ref, _ = harness.family(cfg)
    rows = tr["replicas"] * tr["micro_batches"] * tr["micro_batch"]
    for seed in (2**31 + 301, 2**31 + 302, 2**31 + 303):
        tokens = [data.token_batch(tr, cfg["vocab_size"], rows, seed=seed, step=k, device=card)
                  for k in range(harness.CHECKED_STEPS)]
        weights = data.make_weights(ref.leaves(cfg), seed, card)
        kw = dict(rows_per_block=tr["reference_rows"])
        exact = ref.train(cfg, weights, tokens, tr["optimizer"], **kw)
        ctrl = ref.train(cfg, weights, tokens, tr["optimizer"], precision="fp8", **kw)
        numbers, _ = compare.readings(ctrl, exact)
        assert not compare.verdict(numbers, cell["limits"],
                                   required=("loss_gap", "grad_gap", "change_gap"))[0], numbers
        del weights, tokens
        torch.cuda.empty_cache()
