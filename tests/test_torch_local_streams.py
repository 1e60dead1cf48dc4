"""The ``local`` backend's per-worker CUDA streams.

On the CPU: a payload without CUDA tensors carries no event and is handed
out as it was put, and a run without a CUDA context makes no streams.  On
a card (marker ``cuda``): a tensor put on one stream and taken on another
is read only after the putter's writes, and ``run_plan`` on ``local`` (a
stream per worker) trains to params bit-identical to ``emulated``.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.perfmodel import Config
from repro_torch.core.profiler import arch_model_profile
from repro_torch.data.synthetic import make_batch
from repro_torch.configs.base import InputShape
from repro_torch.models import registry
from repro_torch.models.common import tree_leaves
from repro_torch.optim import SGD
from repro_torch.serverless.backends.local import LocalBackend, LocalStore
from repro_torch.serverless.platform import get_platform
from repro_torch.serverless.runtime import Execution, run_plan
from repro_torch.serverless.simulator import stage_aggregates

AWS = get_platform("aws")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plan(cfg):
    prof = arch_model_profile(cfg, AWS, seq=16, micro_batch=2)
    x = tuple(1 if i == 2 else 0 for i in range(prof.L - 1))
    return prof, Config(x=x, d=2, z=(0,) * prof.L), 4


def test_host_payloads_carry_no_event():
    store = LocalStore()
    value = {"act": torch.ones(3), "aux": (torch.zeros(2), None)}
    store.put("k0/r0/m0/act0", 12.0, value=value)
    assert store._objects["k0/r0/m0/act0"].ready is None
    assert store.get("k0/r0/m0/act0") is value
    assert store.take("k0/r0/m0/act0", return_nbytes=True) == (value, 12.0)
    store.put("k0/r0/m0/act1", 4.0)          # timing-only: no value at all
    assert store._objects["k0/r0/m0/act1"].ready is None


def test_no_cuda_context_no_streams():
    if torch.cuda.is_initialized():
        pytest.skip("this process has a CUDA context")
    cfg = get_config("phi3-mini-3.8b").reduced()
    prof, config, M = _plan(cfg)
    be = LocalBackend()
    be.open(stage_aggregates(prof, AWS, config, M))
    try:
        assert be._worker_streams() == {}
    finally:
        be.close()


@pytest.mark.cuda
def test_cross_stream_take_waits_for_the_putter(cuda_device):
    store = LocalStore()
    producer, consumer = torch.cuda.Stream(), torch.cuda.Stream()
    n = 1 << 22
    with torch.cuda.stream(producer):
        torch.cuda._sleep(100_000_000)       # ~50 ms: the write lands late
        x = torch.full((n,), 3.0, device=cuda_device)
        store.put("k0/r0/m0/act0", 4.0 * n, value={"x": x})
    assert store._objects["k0/r0/m0/act0"].ready is not None
    with torch.cuda.stream(consumer):
        got = store.take("k0/r0/m0/act0")["x"]
        total = got.sum()
    del x, got
    torch.cuda.synchronize()
    assert total.item() == 3.0 * n


@pytest.mark.cuda
@pytest.mark.parametrize("pipelined", [True, False], ids=["eq2", "eq1"])
def test_local_streams_params_bit_identical_to_emulated(cuda_device, pipelined):
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b").reduced(), n_layers=4)
    prof, config, M = _plan(cfg)
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    batches = [{k: v.cuda() for k, v in make_batch(
        cfg, InputShape("train", 16, 8, "train"), seed=0, step=k, device="cpu").items()}
        for k in range(2)]
    runs = {}
    for backend in ("emulated", "local"):
        res = run_plan(prof, AWS, config, M, steps=2, backend=backend,
                       pipelined_sync=pipelined, execution=Execution(
                           cfg=cfg, optimizer=SGD(lr=0.05), init_params=params,
                           batch_fn=lambda k: batches[k], device="cuda"))
        runs[backend] = (res.losses, tree_leaves(res.params))
    assert runs["local"][0] == runs["emulated"][0]
    assert all(torch.equal(a, b) for a, b in zip(runs["local"][1], runs["emulated"][1]))
