"""The stage worker's flat optimizer state and the AdamW kernel.

On the CPU: a ``StageWorker``'s in-place update over its flat buffers is bit
for bit the per-leaf functional update it replaced (kept here as the
oracle), for AdamW at d 1-3 with and without weight decay and for SGD; the
caller's params stay untouched, replicas share no storage, every leaf is
16-byte aligned, ``export_state``/``load_state`` round-trip, and
``opt_state`` keeps the ``{"master", "m", "v"}`` tree the benchmark reads.
On a card (marker ``cuda``): the kernel is bit-equal to the plain path at a
phi3-mini stage's leaf shapes plus a leaf of odd size, a 2 x 2 ``run_plan``
on ``local`` launches it once a worker and step, and the replicas' state is
bit-identical.
"""
import dataclasses

import numpy as np
import pytest
import torch

from portbench.harness import state_leaves
from repro_torch.configs import get_config
from repro_torch.core.perfmodel import Config
from repro_torch.core.profiler import arch_model_profile
from repro_torch.data.synthetic import make_batch
from repro_torch.configs.base import InputShape
from repro_torch.kernels import adamw as aw
from repro_torch.kernels import build as kernel_build
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import SGD, AdamW
from repro_torch.serverless.platform import get_platform
from repro_torch.serverless.runtime import Execution, run_plan
from repro_torch.serverless.runtime import worker as worker_mod
from repro_torch.serverless.runtime.worker import StageWorker, stage_instance_ranges

AWS = get_platform("aws")
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's CPU torch runs: the suite runs
    several workers on the host's cores, and torch pools of a thread a core
    each starve one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tiny():
    """phi3's block at odd small widths (leaves of 36 and 36036 elements
    need padding to a multiple of 8), bf16, two stages of one layer."""
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b").reduced(), d_model=36,
                              vocab_size=1001, d_ff=52, n_heads=2, n_kv_heads=1,
                              head_dim=18, param_dtype="bfloat16")
    params = registry.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params, stage_instance_ranges(cfg, (0, 1, 0))


def _old_update(optimizer, params, opt_state, reduced, step, d):
    """The per-leaf functional update the flat one replaced: ``reduced / d``
    (the engine's), then ``optimizer.update`` a leaf, the new master cast to
    the param's dtype; returns new (params, opt_state) leaves."""
    grad = reduced / d if d > 1 else reduced
    leaves = tree_leaves(params)
    parts = torch.split(grad, [a.numel() for a in leaves])
    new_params, new_states = [], []
    for g, p, st in zip(parts, leaves, opt_state):
        sub = {k: v for k, v in st.items() if k != "master"}
        master, sub = optimizer.update(g.reshape(p.shape), st["master"], sub, step)
        new_params.append(master.to(p.dtype))
        new_states.append({"master": master, **sub})
    return new_params, new_states


def _grads(n, steps, seed=5):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((1e-2 * rng.standard_normal(n)).astype(np.float32))
            for _ in range(steps)]


CASES = [("adamw", d, wd) for d in (1, 2, 3) for wd in (0.0, 0.01)] + [("sgd", 2, None)]


@pytest.mark.parametrize("opt,d,wd", CASES)
def test_flat_update_bit_equal_to_per_leaf_loop(opt, d, wd):
    cfg, params, spans = _tiny()
    optimizer = SGD(lr=0.05) if opt == "sgd" else AdamW(lr=1e-2, weight_decay=wd)
    for span in spans:
        w = StageWorker(cfg, span, params, mu=1, optimizer=optimizer, device="cpu",
                        replicas=d)
        ref_params = [a.clone() for a in tree_leaves(w.params)]
        ref_state = [{"master": a.float(), **optimizer.init_state(a.float())}
                     for a in ref_params]
        ref_tree = tree_map(lambda a: a.clone(), w.params)
        for step, g in enumerate(_grads(sum(a.numel() for a in ref_params), STEPS)):
            ref_params, ref_state = _old_update(optimizer, ref_tree, ref_state, g, step, d)
            ref_tree = tree_unflatten(ref_tree, ref_params)
            w.apply_update(g.clone(), step=step)
            for got, want in zip(tree_leaves(w.params), ref_params):
                assert got.dtype == want.dtype and torch.equal(got, want)
            for (_, got), want in zip(state_leaves(w.opt_state), ref_state):
                assert got.keys() == want.keys()
                assert all(torch.equal(got[k], want[k]) for k in want)


def test_caller_params_stay_untouched():
    cfg, params, spans = _tiny()
    before = tree_map(lambda a: a.clone(), params)
    workers = [StageWorker(cfg, span, params, mu=1, optimizer=AdamW(lr=1e-2), device="cpu",
                           replicas=2) for span in spans]
    for w in workers:
        for step, g in enumerate(_grads(int(w.grad_nbytes // 4), STEPS)):
            w.apply_update(g, step=step)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(before)))
    assert not torch.equal(workers[0].params["embed"], before["embed"])   # the worker's moved


def test_replicas_share_no_storage():
    cfg, params, spans = _tiny()
    a, b = (StageWorker(cfg, spans[0], params, mu=1, optimizer=AdamW(), device="cpu",
                        replicas=2) for _ in range(2))

    def storages(tree):
        return {t.untyped_storage().data_ptr() for t in tree_leaves(tree)}

    mine = storages(a.export_state())
    assert not mine & storages(b.export_state())
    assert not mine & storages(params)
    # a's params are its own bf16 buffer, its state three fp32 buffers
    assert len(storages(a.params)) == 1 and len(storages(a.opt_state)) == 3


def test_every_leaf_is_16_byte_aligned():
    cfg, params, spans = _tiny()
    for span in spans:
        w = StageWorker(cfg, span, params, mu=1, replicas=1, optimizer=AdamW(),
                        device="cpu")
        sizes = [t.numel() for t in tree_leaves(w.params)]
        assert any(n % 8 for n in sizes)            # padding is exercised
        for t in tree_leaves(w.export_state()):
            assert t.data_ptr() % 16 == 0 and t.is_contiguous()


def test_export_load_state_round_trips_into_the_buffers():
    cfg, params, spans = _tiny()
    a, b = (StageWorker(cfg, spans[1], params, mu=1, replicas=1, optimizer=AdamW(lr=1e-2),
                        device="cpu")
            for _ in range(2))
    grads = _grads(int(a.grad_nbytes // 4), 2)
    a.apply_update(grads[0].clone(), step=0)
    ptrs = [t.data_ptr() for t in tree_leaves(b.export_state())]
    b.load_state(a.export_state())
    assert [t.data_ptr() for t in tree_leaves(b.export_state())] == ptrs
    assert all(torch.equal(p, q) for p, q in
               zip(tree_leaves(a.export_state()), tree_leaves(b.export_state())))
    for w in (a, b):                 # the loaded state keeps stepping alike
        w.apply_update(grads[1].clone(), step=1)
    assert all(torch.equal(p, q) for p, q in
               zip(tree_leaves(a.export_state()), tree_leaves(b.export_state())))
    state = a.export_state()
    bad = {"params": state["params"],
           "opt_state": tree_map(lambda t: t.double(), state["opt_state"])}
    with pytest.raises(ValueError, match="does not match"):
        b.load_state(bad)


def test_opt_state_keeps_the_benchmarks_tree():
    cfg, params, spans = _tiny()
    w = StageWorker(cfg, spans[0], params, mu=1, replicas=1, optimizer=AdamW(),
                    device="cpu")
    leaves = list(state_leaves(w.opt_state))
    assert [n for n, _ in leaves] == ["embed", "layers.0.ff.w_down", "layers.0.ff.w_gate",
                                      "layers.0.ff.w_up", "layers.0.mixer.wk",
                                      "layers.0.mixer.wo", "layers.0.mixer.wq",
                                      "layers.0.mixer.wv", "layers.0.norm1", "layers.0.norm2"]
    for (_, st), p in zip(leaves, tree_leaves(w.params)):
        assert list(st) == ["master", "m", "v"]
        assert all(t.shape == p.shape and t.dtype == torch.float32 for t in st.values())
        assert torch.equal(st["master"], p.float())


def test_ops_adamw_on_the_cpu_is_the_plain_path():
    torch.manual_seed(0)
    opt = AdamW(lr=1e-2, weight_decay=0.01)
    rows = [(0, 0, 13), (13, 16, 4)]
    table = aw.LeafTable(rows, "cpu")
    grad = torch.randn(17)
    before = ops.launch_counts()["adamw"]
    out = []
    for impl in ("auto", "ref"):
        state = {"master": torch.linspace(-1, 1, 20), "m": torch.zeros(20),
                 "v": torch.zeros(20)}
        param = torch.zeros(20, dtype=torch.bfloat16)
        ops.adamw_(opt, grad, state, param, table, step=0, replicas=2, impl=impl)
        out.append((state, param))
    assert ops.launch_counts()["adamw"] == before
    (s0, p0), (s1, p1) = out
    assert all(torch.equal(s0[k], s1[k]) for k in s0) and torch.equal(p0, p1)
    master, new = opt.update(grad[:13] / 2, torch.linspace(-1, 1, 20)[:13],
                             {"m": torch.zeros(13), "v": torch.zeros(13)}, 0)
    assert torch.equal(s0["master"][:13], master) and torch.equal(s0["v"][:13], new["v"])
    assert torch.equal(p0[:13], master.to(torch.bfloat16))
    assert torch.equal(s0["master"][13:16], torch.linspace(-1, 1, 20)[13:16])  # padding
    with pytest.raises(ValueError, match="impl"):
        ops.adamw_(opt, grad, out[0][0], None, table, step=0, impl="pallas")


@pytest.mark.parametrize("bad,match", [("cpu", "CUDA device"), ("keys", "state keys"),
                                       ("dtype", "bfloat16"), ("offset", "multiple of 4"),
                                       ("reach", "reaches")])
def test_kernel_wrapper_rejects_before_building(bad, match):
    # the checks run before nvcc is looked for, so they hold on any machine
    state = {"master": torch.zeros(16), "m": torch.zeros(16), "v": torch.zeros(16)}
    rows, param = [(0, 0, 8), (8, 8, 8)], torch.zeros(16, dtype=torch.bfloat16)
    if bad == "keys":
        state = {"master": state["master"], "mu": state["m"]}
    elif bad == "dtype":
        param = torch.zeros(16)
    elif bad == "offset":
        rows = [(0, 2, 8)]
    elif bad == "reach":
        rows = [(0, 0, 8), (8, 12, 8)]
    with pytest.raises(ValueError, match=match):
        aw.adamw_(AdamW(), torch.zeros(16), state, param, aw.LeafTable(rows, "cpu"), step=0)


def test_kernel_wrapper_takes_only_adamw():
    state = {"master": torch.zeros(16), "m": torch.zeros(16), "v": torch.zeros(16)}
    with pytest.raises(TypeError, match="not SGD"):
        aw.adamw_(SGD(), torch.zeros(16), state, None, aw.LeafTable([(0, 0, 16)], "cpu"),
                  step=0)


def test_step_constants_are_float32_as_pytorch_takes_them():
    opt = AdamW(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)
    inv_d, b1, omb1, b2, omb2, ibc1, ibc2, eps, wd, lr = aw.step_constants(opt, 4, 3)
    f32 = np.float32
    assert inv_d == float(f32(1) / f32(3)) and omb1 == float(f32(0.09999999999999998))
    bc1, _ = opt.bias_corrections(4)
    assert bc1.dtype == torch.float32 and ibc1 == float(f32(1) / f32(bc1.item()))
    assert all(float(f32(x)) == x for x in (b1, b2, omb2, ibc2, eps, wd, lr))


# ------------------------------------------------------------------ on a card
def _phi3_stage_rows():
    """A phi3-mini stage's leaves (embed + 2 layers, 325 M parameters), then
    a leaf of odd size and one more whose gradient offset is then not a
    multiple of 4: (gradient offset, state offset, count) rows."""
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=2)
    d, f, q, kv = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim, \
        cfg.n_kv_heads * cfg.head_dim
    sizes = [cfg.vocab_size * d, 2 * f * d, 2 * d * f, 2 * d * f, 2 * d * kv, 2 * q * d,
             2 * d * q, 2 * d * kv, 2 * d, 2 * d, 1001, d]
    rows, g, s = [], 0, 0
    for n in sizes:
        rows.append((g, s, n))
        g, s = g + n, s + -(-n // 8) * 8
    return rows, g, s


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
def test_kernel_bit_equal_to_plain_on_the_card(cuda_device, d):
    rows, n_grad, n_state = _phi3_stage_rows()
    assert sum(n for _, _, n in rows) - 1001 - 3072 == 325_005_312
    table = aw.LeafTable(rows, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    master0 = 0.02 * torch.randn(n_state, generator=gen, device=cuda_device)
    for wd in (0.0, 0.01):
        opt = AdamW(lr=1e-4, weight_decay=wd)
        sides = []
        for _ in range(2):
            state = {"master": master0.clone(), "m": torch.zeros_like(master0),
                     "v": torch.zeros_like(master0)}
            sides.append((state, torch.zeros(n_state, dtype=torch.bfloat16,
                                             device=cuda_device)))
        ops.reset_launch_counts()
        for step in range(STEPS):
            grad = 1e-2 * d * torch.randn(n_grad, generator=gen, device=cuda_device)
            for (state, param), impl in zip(sides, ("auto", "ref")):
                ops.adamw_(opt, grad, state, param, table, step=step, replicas=d, impl=impl)
            torch.cuda.synchronize()
            (ks, kp), (rs, rp) = sides
            for k in ks:
                diff = int((ks[k] != rs[k]).sum())
                assert diff == 0, f"{k} differs in {diff} elements at step {step}, wd {wd}"
            assert torch.equal(kp, rp), f"bf16 params differ at step {step}, wd {wd}"
        assert ops.launch_counts()["adamw"] == STEPS


@pytest.mark.cuda
def test_local_run_launches_once_a_worker_and_step(cuda_device, monkeypatch):
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b").reduced(), param_dtype="bfloat16")
    prof = arch_model_profile(cfg, AWS, seq=16, micro_batch=2)
    x = tuple(1 if i == 2 else 0 for i in range(prof.L - 1))
    config, M, steps = Config(x=x, d=2, z=(0,) * prof.L), 4, 2
    params = registry.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                                  device=cuda_device)
    batches = [{k: v.cuda() for k, v in make_batch(
        cfg, InputShape("train", 16, 8, "train"), seed=0, step=k, device="cpu").items()}
        for k in range(steps)]
    made = []

    class Recorded(StageWorker):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(worker_mod, "StageWorker", Recorded)
    kernel_build.build_all()     # a worker that compiles mid-step outlasts its peers' lease
    torch.use_deterministic_algorithms(True)
    try:
        ops.reset_launch_counts()
        res = run_plan(prof, AWS, config, M, steps=steps, backend="local",
                       execution=Execution(cfg=cfg, optimizer=AdamW(lr=1e-3), init_params=params,
                                           batch_fn=batches.__getitem__, use_kernels=True,
                                           device=cuda_device))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(made) == 4 and all(np.isfinite(res.losses))
    assert ops.launch_counts()["adamw"] == len(made) * steps
    for first, second in (made[0:2], made[2:4]):       # stage by stage, replica by replica
        for p, q in zip(tree_leaves(first.export_state()), tree_leaves(second.export_state())):
            assert torch.equal(p, q)
