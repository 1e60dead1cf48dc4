"""One SGD step of phi3-mini-3.8b (full width, 4 layers, bf16, train_full's
first batch) on the rank mesh (2 stages x tp 2, four ranks on one card),
with and without the kernels, each held leaf by leaf against the
single-process step with and without the kernels.

    python3 tools/mesh_sgd_diag.py [--lr 1.0]

Prints one JSON line: per leaf, max |a - b| over max |b| and over the
step's largest update, for every pairing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core import sharding  # noqa: E402
from repro_torch.core.plan import make_plan  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.launch.mesh import MeshShape, run_jobs  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import SGD  # noqa: E402
from repro_torch.train.train_step import local_batch, make_train_state, make_train_step  # noqa: E402

SHAPE = InputShape("train", 1024, 8, "train")


def _single(cfg, lr, use_kernels):
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = {k: v.cuda() for k, v in make_batch(cfg, SHAPE, seed=0, device="cpu").items()}
    p = tree_map(lambda a: a.detach().clone().requires_grad_(True), params)
    loss, _ = registry.loss_fn(cfg, p, batch, use_kernels=use_kernels)
    loss.backward()
    with torch.no_grad():
        new = tree_map(lambda a: (a.detach().float() - lr * a.grad.float()).to(a.dtype)
                       if a.grad is not None else a.detach(), p)
    return params, new, float(loss)


def _cmp(got, want, init) -> list:
    out = []
    for a, b, c in zip(tree_leaves(got), tree_leaves(want), tree_leaves(init)):
        a, b, c = a.float(), b.float(), c.float()
        err = float((a - b).abs().max())
        out.append([round(err / max(float(b.abs().max()), 1e-30), 5),
                    round(err / max(float((b - c).abs().max()), 1e-30), 5)])
    return out


def rank(mesh, cfg, plan, lr, use_kernels, refs):
    dev = mesh.device
    base = registry.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    init = sharding.local_params(cfg, plan, base, d=mesh.d, m=mesh.m)
    sgd = SGD(lr=lr, momentum=0.0)
    params, opt = make_train_state(cfg, plan, mesh, base, sgd)
    del base
    b = make_batch(cfg, SHAPE, seed=0, device="cpu")
    b = local_batch({k: v.to(dev) for k, v in b.items()}, plan, mesh)
    params, _, m = make_train_step(cfg, plan, mesh, sgd, use_kernels=use_kernels)(
        params, opt, b, 0)
    out = {"rank": mesh.rank, "loss": m["loss"]}
    for name, path in refs.items():
        ref = sharding.local_params(cfg, plan, torch.load(path, mmap=True), d=mesh.d, m=mesh.m)
        out[name] = _cmp(params, tree_map(lambda a: a.to(dev), ref), init)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, default=1.0)
    a = ap.parse_args()
    torch.use_deterministic_algorithms(True)
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=4, stages=2, tensor=2)
    doc, refs = {"lr": a.lr}, {}
    with tempfile.TemporaryDirectory() as tmp:
        news = {}
        for k in (False, True):
            init, new, loss = _single(cfg, a.lr, k)
            news[k] = new
            doc[f"single_loss_kernels_{k}"] = loss
            refs[f"single_kernels_{k}"] = os.path.join(tmp, f"ref{int(k)}.pt")
            torch.save(tree_map(lambda t: t.cpu(), new), refs[f"single_kernels_{k}"])
        doc["single_kernels_vs_plain"] = _cmp(news[True], news[False], init)
        del news, init, new
        torch.cuda.empty_cache()
        plan = make_plan(cfg, SHAPE, data=1, model=4, microbatches=4)
        shape = MeshShape(data=1, model=4, tensor=2, kv_heads=cfg.n_kv_heads)
        outs = run_jobs([(rank, shape, (cfg, plan, a.lr, k, refs)) for k in (False, True)],
                        device="cuda")
        doc["mesh_plain"], doc["mesh_kernels"] = outs
    print(json.dumps(doc))


if __name__ == "__main__":
    main()
