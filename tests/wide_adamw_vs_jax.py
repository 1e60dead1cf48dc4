"""The bf16 AdamW training path at phi3-mini-3.8b's full width, the port
against the live JAX engine, on the CPU.

The full-width training run on the card (``chip_smoke.py``'s ``train_full``)
sees its loss rise after AdamW's first step.  This script runs the same
kind of plan through both engines on the same params and batches, so that
the rise can be told apart from a fault of the port: phi3-mini-3.8b at full
width (d_model 3072, 32 heads of 96, d_ff 8192, vocab 32064) cut to 2
layers, bf16 params with fp32 masters, 2 stages, ``d = 1``, ``mu = 2``
micro-batches of 2 sequences x 256 tokens, AdamW(lr=1e-4), 3 steps.

It takes about 19 GiB of host memory and a minute or two on 8 cores; it is
a script and not a test for that reason.  Run it from the root of the repo:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/wide_adamw_vs_jax.py

It prints one JSON line with both engines' losses and the largest param
difference, and exits 1 when they disagree beyond the stated tolerances.
"""
import dataclasses
import gc
import json
import resource
import sys
import time

import jax
import numpy as np
import torch

import repro.configs as jconfigs
from repro.configs.base import InputShape as JaxInputShape
from repro.core.perfmodel import Config as JaxConfig
from repro.core.profiler import arch_model_profile as jax_profile
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models import registry as jreg
from repro.optim import AdamW as JaxAdamW
from repro.serverless.execution import ExecutionConfig
from repro.serverless.platform import AWS_LAMBDA
from repro.serverless.runtime import Execution as JaxExecution
from repro.serverless.runtime import run_plan as jax_run_plan

from repro_torch.configs import get_config
from repro_torch.core.perfmodel import Config
from repro_torch.core.profiler import arch_model_profile
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import params_from_jax
from repro_torch.optim import AdamW
from repro_torch.serverless.platform import get_platform
from repro_torch.serverless.runtime import Execution, run_plan

ARCH, N_LAYERS, SEQ, BATCH, D, MU, STEPS, LR = "phi3-mini-3.8b", 2, 256, 4, 1, 2, 3, 1e-4
# bf16 at this width: a loss of ~11-17 carries a few 1e-2 of rounding; the
# params move by lr a step whatever the gradient, so a gradient sign that
# differs costs 2 lr a step, plus one bf16 ulp of |w| < 0.25 (9.8e-4)
LOSS_TOL, PARAM_TOL = 5e-2, 2 * LR * STEPS + 9.8e-4


def main() -> int:
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH), n_layers=N_LAYERS)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=N_LAYERS)
    assert jcfg.param_dtype == cfg.param_dtype == "bfloat16"
    L = N_LAYERS + 2
    x = tuple(1 if i == 1 else 0 for i in range(L - 1))   # [embed, l0 | l1, head]
    mb = BATCH // (D * MU)

    t0 = time.perf_counter()
    params0 = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    batches = [jax_make_batch(jcfg, JaxInputShape("wide", SEQ, BATCH, "train"), step=k)
               for k in range(STEPS)]
    jres = jax_run_plan(
        jax_profile(jcfg, AWS_LAMBDA, seq=SEQ, micro_batch=mb), AWS_LAMBDA,
        JaxConfig(x=x, d=D, z=(0,) * L), total_micro_batches=D * MU,
        exec_config=ExecutionConfig(steps=STEPS),
        execution=JaxExecution(cfg=jcfg, optimizer=JaxAdamW(lr=LR), init_params=params0,
                               batch_fn=lambda k: batches[k]))
    jax_losses = [float(v) for v in jres.losses]
    jax_params = [np.asarray(a, np.float32) for a in jax.tree.leaves(jres.params)]
    params_np = jax.tree.map(np.asarray, params0)
    tbatches = [{k: torch.from_numpy(np.array(v)) for k, v in b.items()} for b in batches]
    t_jax = time.perf_counter() - t0
    del jres, params0, batches
    gc.collect()

    t0 = time.perf_counter()
    res = run_plan(arch_model_profile(cfg, get_platform("aws"), seq=SEQ, micro_batch=mb),
                   get_platform("aws"), Config(x=x, d=D, z=(0,) * L),
                   total_micro_batches=D * MU, steps=STEPS,
                   execution=Execution(cfg=cfg, optimizer=AdamW(lr=LR),
                                       init_params=params_from_jax(params_np, device="cpu"),
                                       batch_fn=lambda k: tbatches[k], device="cpu"))
    t_port = time.perf_counter() - t0
    param_err = max(float(np.max(np.abs(b.float().numpy() - a)))
                    for a, b in zip(jax_params, tree_leaves(res.params)))
    loss_err = max(abs(a - b) for a, b in zip(res.losses, jax_losses))
    ok = loss_err <= LOSS_TOL and param_err <= PARAM_TOL
    print(json.dumps({
        "model": f"{ARCH} full width, {N_LAYERS} layers, bf16", "seq": SEQ, "batch": BATCH,
        "d": D, "mu": MU, "optimizer": f"AdamW(lr={LR})", "steps": STEPS,
        "losses_jax": jax_losses, "losses_port": list(res.losses),
        "loss_max_abs_diff": loss_err, "loss_tol": LOSS_TOL,
        "param_max_abs_diff": param_err, "param_tol": PARAM_TOL,
        "seconds_jax": t_jax, "seconds_port": t_port,
        "max_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
        "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
