#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure is an uncaught exception
and a non-zero exit:

1. device — CUDA must be present; the card's name and power limit.
2. build  — compile the decode-attention kernel from ``src/`` with nvcc.
3. kernel parity — the CUDA kernel against its plain PyTorch version on the
   sweep of ``tests/test_kernels.py::test_decode_attention`` (fp32 at 2e-5,
   bf16 at 2e-2) and at phi3-mini-3.8b's decode shape; the kernel's median
   time there beside its HBM bound, the plain version and PyTorch's
   ``scaled_dot_product_attention`` as a yardstick (CUDA events, L2 flushed).
4. full-width serve — phi3-mini-3.8b, all 32 layers, bf16, random weights
   from seed 0, a hand-built 4-stage serve plan run through
   ``run_serve_plan(..., use_kernels=True)``: kernel launches counted, tokens
   bit-identical to the monolithic loop, store drained.  Then, teacher-forced
   with those tokens, every decode-attention call of the loop is held
   against the plain version (``impl="ref"``) on its real inputs (bf16,
   2e-2); the same full-width model cast to fp32 holds each step's logits
   within 2e-4 of the plain version's.  In bf16 the step logits are only
   reported, beside the drift a float64 attention causes: 32 bf16 layers
   amplify any change of rounding past 2e-2.
5. reduced fp32 serve — phi3-mini-3.8b@reduced through the same entry point
   with and without the kernel: identical tokens.

The last lines are the kernels' record, the ``nvidia-smi`` name/power line
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.api.plan import DeploymentPlan, profile_fingerprint  # noqa: E402
from repro_torch.core.perfmodel import Config  # noqa: E402
from repro_torch.core.profiler import resolve_profile  # noqa: E402
from repro_torch.kernels import decode_attention as da_kernel  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.serverless.platform import get_platform  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ServingSpec,
    arch_config_for_model,
    estimate_serving,
    make_prompt,
    reference_decode,
    run_serve_plan,
)

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

KERNEL_CASES = [(512, 1), (512, 511), (1024, 700), (2048, 2048)]
KERNEL_HEADS = [(8, 2, 64), (4, 4, 128), (16, 2, 128)]
PHI3_DECODE = dict(B=4, H=32, hd=96, C=1024)
SERVE = dict(batch=4, prefill_tokens=1008, new_tokens=16)   # s_ctx = 1024
SERVE_CUTS = (8, 16, 24)       # 4 stages of 8 layers (profile: embed, 32, head)
REDUCED = dict(batch=2, prefill_tokens=24, new_tokens=8)
FP32_STEPS = 5                 # teacher-forced steps of the fp32 full-width check


def emit(doc: dict) -> None:
    print(json.dumps(doc), flush=True)


def _close(out, ref, tol, what):
    err = float((out.float() - ref.float()).abs().max())
    if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
        raise AssertionError(f"{what}: kernel disagrees with plain, max |err| {err}")
    return err


def _time_ms(fn, flush, reps=25):
    """Median of ``reps`` single-call CUDA-event timings, L2 flushed before
    each (the decode path finds each layer's cache cold)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "card": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    da_kernel.build()
    log = da_kernel.BUILD_INFO["compiler_log"]
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": da_kernel.BUILD_INFO["path"], "kernels": len(regs),
          "max_registers": max(regs, default=None),
          "max_spill_bytes": max(spills, default=None)})


def phase_kernel_parity(smi: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    n_cases = 0
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for C, length in KERNEL_CASES:
            for Hq, Hkv, hd in KERNEL_HEADS:
                q, k, v = rand(2, Hq, hd, dtype=dtype), rand(2, Hkv, C, hd, dtype=dtype), \
                    rand(2, Hkv, C, hd, dtype=dtype)
                L = torch.tensor([length], dtype=torch.int32, device="cuda")
                _close(ops.decode_attention(q, k, v, L),
                       ops.decode_attention(q, k, v, L, impl="ref"), tol,
                       f"C={C} length={length} Hq={Hq} Hkv={Hkv} hd={hd} {dtype}")
                n_cases += 1

    B, H, hd, C = (PHI3_DECODE[k] for k in ("B", "H", "hd", "C"))
    phi3_err = {}
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q, k, v = rand(B, H, hd, dtype=dtype), rand(B, H, C, hd, dtype=dtype), \
            rand(B, H, C, hd, dtype=dtype)
        for length in (1, 700, 1024):
            L = torch.tensor([length], dtype=torch.int32, device="cuda")
            err = _close(ops.decode_attention(q, k, v, L),
                         ops.decode_attention(q, k, v, L, impl="ref"), tol,
                         f"phi3 B={B} H={H} hd={hd} C={C} length={length} {dtype}")
            phi3_err[f"{str(dtype)[6:]}@{length}"] = err
            n_cases += 1
    torch.cuda.synchronize()

    # timing at the serve phase's shape: bf16, a full cache (length = C)
    q, k, v = rand(B, H, hd, dtype=torch.bfloat16), \
        rand(B, H, C, hd, dtype=torch.bfloat16), rand(B, H, C, hd, dtype=torch.bfloat16)
    length = C
    L = torch.tensor([length], dtype=torch.int32, device="cuda")
    mask = (torch.arange(C, device="cuda") < length).view(1, 1, 1, C)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    ms = _time_ms(lambda: da_kernel.decode_attention(q, k, v, L), flush)
    plain_ms = _time_ms(lambda: ops.decode_attention(q, k, v, L, impl="ref"), flush)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q.unsqueeze(2), k, v, attn_mask=mask), flush)
    esz = q.element_size()
    nbytes = 2 * B * H * length * hd * esz + 2 * q.numel() * esz   # K,V to length; q; out
    flops = 4 * B * H * length * hd                                # QK^T and PV
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[torch.bfloat16])
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / PEAK_FLOPS[torch.bfloat16] \
        else "operations"
    rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_s * 1e3, "bound_by": bound_by,
           "max_abs_err": phi3_err["bfloat16@1024"]}
    emit({"phase": "kernel_parity", "card": smi, "cases": n_cases,
          "phi3_max_abs_err": phi3_err,
          "timing_shape": {"B": B, "Hq": H, "Hkv": H, "hd": hd, "C": C,
                           "length": length, "dtype": "bfloat16"},
          "bytes": nbytes, "flops": flops,
          "hbm_gb_per_s": nbytes / (ms * 1e-3) / 1e9,
          "roofline_share": bound_s * 1e3 / ms, **rec})
    return rec


def manual_serve_plan(model: str, *, cuts, batch: int, prefill_tokens: int,
                      new_tokens: int, platform: str = "aws",
                      mem_index: int = -1) -> DeploymentPlan:
    """A hand-built ``workload="serve"`` plan: period-aligned stage cuts at
    profile layers ``cuts`` and one memory option for every layer."""
    plat = get_platform(platform)
    cfg = arch_config_for_model(model)
    profile = resolve_profile(model, plat, seq=prefill_tokens, micro_batch=batch)
    x = [0] * (profile.L - 1)
    for c in cuts:
        x[c] = 1
    z = (mem_index % len(plat.memory_options),) * profile.L
    spec = ServingSpec(slo_s=3600.0, batch=batch, prefill_tokens=prefill_tokens,
                       new_tokens=new_tokens)
    est = estimate_serving(profile, plat, Config(x=tuple(x), d=1, z=z), cfg, spec)
    return DeploymentPlan(
        model=model, platform=plat.name, x=tuple(x), z=z, d=1,
        total_micro_batches=1, alpha=(1.0, 0.0), pipelined_sync=False,
        merge_to=None, seq=prefill_tokens, micro_batch=batch,
        profile_fingerprint=profile_fingerprint(profile, plat),
        t_iter=est.t_request, c_iter=est.cost_per_request,
        objective=est.cost_per_request, solver="manual", engine="-",
        solve_seconds=0.0, workload="serve",
        serving={**spec.as_dict(), "t_prefill": est.t_prefill,
                 "t_token": est.t_token, "t_request": est.t_request,
                 "cost_per_request": est.cost_per_request,
                 "cost_per_1k": est.cost_per_1k,
                 "kv_bytes": list(est.kv_bytes)})


@contextlib.contextmanager
def routed(fn):
    """Route the model's decode-attention calls through ``fn`` in the block
    (``models.attention`` looks ``ops.decode_attention`` up at each call)."""
    real = ops.decode_attention
    ops.decode_attention = fn
    try:
        yield
    finally:
        ops.decode_attention = real


def attention_fp64(q, k_cache, v_cache, length, **_):
    """The plain version's arithmetic in float64: a second correct rounding,
    which measures how far bf16 noise alone moves the logits."""
    B, Hq, hd = q.shape
    Hkv, C = k_cache.shape[1], k_cache.shape[2]
    qg = (q.double() * hd**-0.5).reshape(B, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bhgd,bhcd->bhgc", qg, k_cache.double())
    s = torch.where(torch.arange(C, device=q.device) < length.reshape(-1)[0], s, -1e30)
    o = torch.einsum("bhgc,bhcd->bhgd", torch.softmax(s, dim=-1), v_cache.double())
    return o.reshape(B, Hq, hd).to(q.dtype)


def teacher_forced(cfg, params, prompt, tokens, *, s_ctx, call_tol, logit_tol=None):
    """Feed the decode loop ``tokens``.  Every decode-attention call of the
    kernel loop is held against the plain version (``impl="ref"``) on the
    same inputs at ``call_tol``; every step is also rerun from the same
    caches with the plain version and with a float64 attention, and the
    step logits compared (held at ``logit_tol`` when given)."""
    dev = params["embed"].device
    toks = torch.from_numpy(tokens).to(dev)
    _, caches = registry.prefill(
        cfg, params, {"tokens": torch.from_numpy(prompt).to(dev)},
        capacity=s_ctx)
    kernel = ops.decode_attention
    rec = {"calls": 0, "call_max_abs_err": 0.0, "calls_ok": True, "step_kernel_vs_ref": [],
           "step_ref_vs_fp64": [], "step_kernel_vs_fp64": [], "logits_ok": True,
           "logits_abs_max": 0.0}

    def checked(q, k, v, length, **_):
        out = kernel(q, k, v, length)
        ref = kernel(q, k, v, length, impl="ref")
        rec["calls"] += 1
        rec["call_max_abs_err"] = max(rec["call_max_abs_err"],
                                      float((out.float() - ref.float()).abs().max()))
        rec["calls_ok"] &= bool(torch.allclose(out.float(), ref.float(),
                                               rtol=call_tol, atol=call_tol))
        return out

    def step(fn, c, tok):
        with routed(fn):
            return registry.decode_step(cfg, params, c, tok, use_kernels=True)[0].float()

    for t in range(1, tokens.shape[1]):
        tok = toks[:, t - 1:t]
        ref = step(lambda q, k, v, n, **_: kernel(q, k, v, n, impl="ref"),
                   tree_map(torch.clone, caches), tok)
        f64 = step(attention_fp64, tree_map(torch.clone, caches), tok)
        got = step(checked, caches, tok)
        if not torch.isfinite(got).all():
            raise AssertionError(f"non-finite logits on the kernel path at step {t}")
        rec["step_kernel_vs_ref"].append(float((got - ref).abs().max()))
        rec["step_ref_vs_fp64"].append(float((ref - f64).abs().max()))
        rec["step_kernel_vs_fp64"].append(float((got - f64).abs().max()))
        rec["logits_abs_max"] = max(rec["logits_abs_max"], float(got.abs().max()))
        if logit_tol is not None:
            rec["logits_ok"] &= bool(torch.allclose(got, ref, rtol=logit_tol, atol=logit_tol))
    if rec["calls"] != (tokens.shape[1] - 1) * cfg.n_layers:
        raise AssertionError(f"{rec['calls']} decode-attention calls, expected "
                             f"{(tokens.shape[1] - 1) * cfg.n_layers}")
    if not (rec["calls_ok"] and rec["logits_ok"]):
        raise AssertionError(f"kernel path disagrees with impl='ref': {rec}")
    return rec


def profile_decode(cfg, params, prompt, tokens, *, s_ctx, steps=2) -> dict:
    """Where a decode round's time goes: ``torch.profiler`` over ``steps``
    monolithic decode steps (the stage workers make the same per-layer
    calls), after one warm-up step."""
    from torch.profiler import ProfilerActivity, profile

    dev = params["embed"].device
    toks = torch.from_numpy(tokens).to(dev)
    _, caches = registry.prefill(
        cfg, params, {"tokens": torch.from_numpy(prompt).to(dev)}, capacity=s_ctx)
    registry.decode_step(cfg, params, caches, toks[:, :1], use_kernels=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(1, steps + 1):
            registry.decode_step(cfg, params, caches, toks[:, t:t + 1], use_kernels=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / steps
    wall_ms = wall * 1e3 / steps
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    host = sorted((e for e in events if e.device_type != torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    return {"steps": steps, "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top_kernels_ms_per_step": [[e.key[:80], dev_us(e) / 1e3 / steps, e.count // steps]
                                        for e in top],
            "top_host_ops_ms_per_step": [[e.key[:60], e.self_cpu_time_total / 1e3 / steps,
                                          e.count // steps] for e in host]}


def phase_serve_full(smi: str) -> int:
    torch.use_deterministic_algorithms(True)
    model = "phi3-mini-3.8b"
    cfg = arch_config_for_model(model)
    t0 = time.perf_counter()
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    plan = manual_serve_plan(model, cuts=SERVE_CUTS, **SERVE)
    prompt = make_prompt(cfg, SERVE["batch"], SERVE["prefill_tokens"], seed=0)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = run_serve_plan(plan, params=params, prompt=prompt, use_kernels=True)
    launches = ops.launch_counts()["decode_attention"]
    expect = (SERVE["new_tokens"] - 1) * cfg.n_layers
    if launches != expect:
        raise AssertionError(f"decode_attention launched {launches} times, "
                             f"expected (new_tokens - 1) x n_layers = {expect}")
    peak = torch.cuda.max_memory_allocated()

    mono = reference_decode(cfg, params, prompt, SERVE["new_tokens"], use_kernels=True)
    if not np.array_equal(res.tokens, mono):
        raise AssertionError(f"pipelined tokens differ from the monolithic loop:\n"
                             f"{res.tokens}\n{mono}")
    s_ctx = SERVE["prefill_tokens"] + SERVE["new_tokens"]
    tf_bf16 = teacher_forced(cfg, params, prompt, res.tokens, s_ctx=s_ctx, call_tol=2e-2)
    prof = profile_decode(cfg, params, prompt, res.tokens, s_ctx=s_ctx)
    # the same model in fp32: the logits of the kernel path hold at 2e-4
    params = tree_map(lambda a: a.float(), params)
    torch.cuda.empty_cache()
    tf_fp32 = teacher_forced(dataclasses.replace(cfg, param_dtype="float32"), params,
                             prompt, res.tokens[:, :FP32_STEPS], s_ctx=s_ctx, call_tol=2e-5,
                             logit_tol=2e-4)
    emit({"phase": "serve_full", "card": smi, "model": model, "dtype": cfg.param_dtype,
          "n_layers": cfg.n_layers, "stages": plan.n_stages, **SERVE,
          "s_ctx": s_ctx,
          "kernel_launches": launches, "tokens_match_monolithic": True,
          "teacher_forced_bf16": tf_bf16, "teacher_forced_fp32": tf_fp32,
          "decode_profile": prof,
          "store_drained": True,
          "store": res.store_stats.as_dict(),
          "t_request_virtual_s": res.t_request,
          "param_init_s": t_init,
          "prefill_wall_s": res.round_wall_s[0],
          "decode_round_wall_s": list(res.round_wall_s[1:]),
          "decode_round_wall_s_median": statistics.median(res.round_wall_s[1:]),
          "max_memory_allocated_bytes": peak,
          "tokens_head": res.tokens[0].tolist()})
    del params
    torch.cuda.empty_cache()
    return launches


def phase_serve_reduced(smi: str) -> None:
    model = "phi3-mini-3.8b@reduced"
    cfg = arch_config_for_model(model)
    plan = manual_serve_plan(model, cuts=(1,), **REDUCED)
    ops.reset_launch_counts()
    with_kernel = run_serve_plan(plan, seed=0, use_kernels=True)
    launches = ops.launch_counts()["decode_attention"]
    plain = run_serve_plan(plan, seed=0, use_kernels=False)
    expect = (REDUCED["new_tokens"] - 1) * cfg.n_layers
    if launches != expect:
        raise AssertionError(f"reduced serve launched {launches}, expected {expect}")
    if not np.array_equal(with_kernel.tokens, plain.tokens):
        raise AssertionError(f"kernel and plain tokens differ:\n{with_kernel.tokens}\n"
                             f"{plain.tokens}")
    emit({"phase": "serve_reduced", "card": smi, "model": model,
          "dtype": cfg.param_dtype, "stages": plan.n_stages, **REDUCED,
          "kernel_launches": launches, "tokens_match_plain": True,
          "t_request_virtual_s": with_kernel.t_request})


def main() -> None:
    smi = phase_device()
    phase_build()
    rec = phase_kernel_parity(smi)
    launches = phase_serve_full(smi)
    phase_serve_reduced(smi)
    emit({"kernels": [{
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:68",
        "launches": launches, **rec}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
