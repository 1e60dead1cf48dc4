"""The port's xLSTM mixers (``repro_torch.models.xlstm``), encoders and
frontends (``models.multimodal``, the encoder loss, the frontend batches)
and the four archs they bring (xlstm-125m, bert-large, hubert-xlarge,
internvl2-26b) against the live JAX package on the CPU.

Configs, parameter counts and profiles exactly equal; ``mlstm_forward`` /
``slstm_forward`` / their decodes and VJPs against JAX's in fp32 (2e-4) and
bf16 (2e-2), errors over the largest reference value; prefill + decode
against the forward for xlstm-125m and internvl2-26b
(``tests/test_models_unit.py:23-48``); loss and every gradient of the four
archs against ``jax.grad`` with hubert's frames and internvl2's image
embeddings (``tests/test_smoke_archs.py:20-46``); non-causal attention at hd
80; ``run_plan`` for xlstm and bert-large against JAX's engine (losses 2e-4,
params 2e-3, clock, cost and ``StoreStats`` exactly equal); ``run_serve_plan``
for xlstm against JAX's tokens and cache bytes, and on ``process`` equal to
``emulated``; the workers refusing the frontends with JAX's messages; the
batches; and a run that never imports jax.  Weights come from the JAX
package's ``init_params`` through ``params_from_jax``, inputs from numpy or
from JAX, passed as numpy.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import InputShape as JaxInputShape
from repro.core.perfmodel import Config as JaxConfig
from repro.core.profiler import arch_model_profile as jax_profile
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models import attention as jattn
from repro.models import registry as jreg
from repro.models import xlstm as jxlstm
from repro.optim import SGD as JaxSGD
from repro.serverless.execution import ExecutionConfig as JaxExecutionConfig
from repro.serverless.platform import AWS_LAMBDA
from repro.serverless.runtime import Execution as JaxExecution
from repro.serverless.runtime import run_plan as jax_run_plan
from repro.serverless.runtime.worker import StageWorker as JaxStageWorker
from repro.serverless.runtime.worker import stage_instance_ranges as jax_ranges
from repro.serving import kv_bytes_per_instance as jax_kv_bytes
from repro.serving import make_prompt as jax_make_prompt
from repro.serving import plan_serving
from repro.serving import run_serve_plan as jax_run_serve_plan
from repro.serving.worker import ServeStageWorker as JaxServeStageWorker

from repro_torch.api.plan import DeploymentPlan
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.perfmodel import Config
from repro_torch.core.profiler import arch_model_profile
from repro_torch.data.synthetic import make_batch
from repro_torch.models import attention, registry, xlstm
from repro_torch.models.common import tree_leaves
from repro_torch.optim import SGD
from repro_torch.serverless.execution import ExecutionConfig
from repro_torch.serverless.platform import get_platform
from repro_torch.serverless.runtime import Execution, run_plan
from repro_torch.serverless.runtime.worker import StageWorker, stage_instance_ranges
from repro_torch.serving import kv_bytes_per_instance, run_serve_plan
from repro_torch.serving.worker import ServeStageWorker

torch.backends.cuda.matmul.allow_tf32 = False
REPO = Path(__file__).resolve().parents[1]
AWS = get_platform("aws")
NEW_ARCHS = ["xlstm-125m", "bert-large", "hubert-xlarge", "internvl2-26b"]
XLSTM = "xlstm-125m"
# errors over max |reference|: the reference tests' fp32 bar, and bf16's
TOLS = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's CPU runs: the suite runs several
    workers on the host's cores, and torch pools of a thread a core each
    starve one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().float().cpu().numpy()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, what=""):
    """max |got - want| <= tol * max(|want|) (want from JAX, any dtype)."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = _np(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |err| {err} over max |ref| {scale}"


def _cfgs(arch, dtype="float32"):
    jcfg, cfg = jconfigs.get_config(arch).reduced(), get_config(arch).reduced()
    return (dataclasses.replace(jcfg, param_dtype=dtype),
            dataclasses.replace(cfg, param_dtype=dtype))


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_counts_and_profile_equal_jax(arch):
    """Every field of the port's config, ``param_count`` (the xLSTM term is
    JAX's approximation), ``active_param_count``, ``reduced()`` (with
    ``n_frontend_tokens``), ``uses_attention``, ``subquadratic`` and
    ``supports_shape`` equal JAX's; ``arch_model_profile`` exactly JAX's."""
    assert (arch in ARCH_IDS) == (arch != "bert-large")
    for cfg, jcfg in ((get_config(arch), jconfigs.get_config(arch)),
                      (get_config(arch).reduced(), jconfigs.get_config(arch).reduced())):
        for f in dataclasses.fields(cfg):
            a, b = getattr(cfg, f.name), getattr(jcfg, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            elif f.name == "period":
                a, b = [dataclasses.asdict(s) for s in a], [dataclasses.asdict(s) for s in b]
            assert a == b, (arch, f.name)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert (cfg.uses_attention, cfg.subquadratic) == (jcfg.uses_attention, jcfg.subquadratic)
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            assert cfg.supports_shape(shape) == jcfg.supports_shape(shape)
        for kw in ({}, dict(seq=64, micro_batch=2)):
            assert dataclasses.asdict(arch_model_profile(cfg, AWS, **kw)) == \
                dataclasses.asdict(jax_profile(jcfg, AWS_LAMBDA, **kw))


def test_registry_mirrors_jax():
    """All eleven of JAX's configs resolve; ``ARCH_IDS`` is JAX's, without
    bert-large, so ``bert-large`` stays the paper's Table 1 profile and
    ``bert-large@reduced`` is unknown, as in JAX."""
    from repro_torch.core.profiler import arch_config, resolve_profile

    assert ARCH_IDS == jconfigs.ARCH_IDS
    for arch in jconfigs._ARCH_MODULES:
        assert get_config(arch).name == jconfigs.get_config(arch).name
    from repro.core.profiler import resolve_profile as jax_resolve

    assert dataclasses.asdict(resolve_profile("bert-large", AWS)) == \
        dataclasses.asdict(jax_resolve("bert-large", AWS_LAMBDA))
    for bad in ("bert-large@reduced", "bert-large@layers4"):
        with pytest.raises(KeyError):
            arch_config(bad)
        with pytest.raises(KeyError):
            resolve_profile(bad, AWS)
    cfg = arch_config("internvl2-26b@layers8")
    assert cfg.param_count() == dataclasses.replace(
        jconfigs.get_config("internvl2-26b"), n_layers=8).param_count()


# ------------------------------------------------------------------ mixers
_MIXER_PARAMS: dict = {}


def _mixer(kind, dtype):
    """(jcfg, cfg, JAX params, port params) of xlstm@reduced's ``kind``
    mixer in ``dtype``."""
    if (kind, dtype) not in _MIXER_PARAMS:
        jcfg, cfg = _cfgs(XLSTM, dtype)
        init = jxlstm.init_mlstm_params if kind == "mlstm" else jxlstm.init_slstm_params
        p = init(jax.random.PRNGKey(0), jcfg, jnp.dtype(dtype))
        _MIXER_PARAMS[kind, dtype] = (jcfg, cfg, p,
                                      registry.params_from_jax(_np_tree(p), device="cpu"))
    return _MIXER_PARAMS[kind, dtype]


def _input(B, S, d, dtype, seed):
    x = 0.5 * np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    return jx, registry.params_from_jax(np.asarray(jx), device="cpu")


def _forward(kind):
    return (jxlstm.mlstm_forward, xlstm.mlstm_forward) if kind == "mlstm" else \
        (jxlstm.slstm_forward, xlstm.slstm_forward)


def _jax_forward_vjp(kind, jcfg, p, jx, jg):
    """JAX's prefill forward (output, state) and the VJP of the output for
    cotangent ``jg`` (params, input), jitted: one compile a case."""
    jfwd = _forward(kind)[0]

    def run(pp, xx, gg):
        (out, st), vjp = jax.vjp(lambda a, b: jfwd(a, b, cfg=jcfg, return_state=True), pp, xx)
        return out, st, vjp((gg, jax.tree.map(jnp.zeros_like, st)))

    return jax.jit(run)(p, jx, jg)


@pytest.mark.parametrize("S", [16, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_forward_and_vjp_match_jax(kind, dtype, S):
    """One mLSTM chunk (S 16) and two (S 512: the state carried over the
    chunk boundary); the sLSTM stepped 16 and 512 times.  The output, the
    prefill state (mLSTM: C, n, m, conv tail; sLSTM: c, n, m, h) and, by
    autograd (the mLSTM's chunks checkpointed, the sLSTM's steps kept), the
    input's and every parameter's gradient against ``jax.vjp``.  At the
    sLSTM's first step n is exactly at its floor of 1: both split that
    tie's gradient in half.  In bf16 a gradient further than 2e-2 from
    JAX's must be no further than JAX's from JAX's own fp32 run on the same
    (bf16-valued) inputs: JAX sums the sLSTM's ``r_gates`` gradient over
    the steps in bf16, the port in fp32 (at S 512, 6% and 0.4% of its
    largest value from the fp32 run's)."""
    jcfg, cfg, p, tp = _mixer(kind, dtype)
    jx, tx = _input(1, S, cfg.d_model, dtype, 6 + S)
    g = np.random.default_rng(S).standard_normal(tx.shape).astype(np.float32)
    jg = jnp.asarray(g).astype(jnp.dtype(dtype))
    jout, jst, (jgp, jgx) = _jax_forward_vjp(kind, jcfg, p, jx, jg)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    txg = tx.clone().requires_grad_()
    out, st = _forward(kind)[1](leaves, txg, cfg=cfg, return_state=True)
    tol = TOLS[dtype]
    assert out.dtype == tx.dtype and out.shape == tuple(jout.shape)
    _close(out, jout, tol, f"{kind} out")
    for name, a, b in zip(st._fields, st, jst):
        assert a.shape == tuple(b.shape) and str(a.dtype)[6:] == str(b.dtype), name
        if name == "m" and kind == "mlstm":   # the stabilizer, a log-scale value
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=tol, atol=tol)
        else:
            _close(a, b, tol, f"{kind} state {name}")
    grads = torch.autograd.grad(out, [txg, *leaves.values()],
                                registry.params_from_jax(np.asarray(jg), device="cpu"))
    named = [("input", grads[0], jgx)] + [(n, gt, jgp[n]) for n, gt in zip(leaves, grads[1:])]
    wide = None
    for name, gt, jgt in named:
        assert gt.dtype == tx.dtype
        want = np.asarray(jgt.astype(jnp.float32))
        scale = float(np.abs(want).max())
        err = float(np.abs(_np(gt) - want).max())
        if err <= tol * scale:
            continue
        assert dtype == "bfloat16", f"d {name}: max |err| {err} over max |ref| {scale}"
        if wide is None:
            f32 = lambda t: jax.tree.map(lambda a: a.astype(jnp.float32), t)  # noqa: E731
            _, _, (wgp, wgx) = _jax_forward_vjp(
                kind, dataclasses.replace(jcfg, param_dtype="float32"), f32(p), f32(jx),
                f32(jg))
            wide = {"input": wgx, **wgp}
        ref = np.asarray(wide[name])
        assert float(np.abs(_np(gt) - ref).max()) <= float(np.abs(want - ref).max()), \
            f"d {name}: max |err| {err} over max |ref| {scale}, further from fp32 than JAX's"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_decode_matches_jax(dtype):
    """16 one-token steps of ``mlstm_decode`` and ``slstm_decode`` from
    empty caches, each step's output and every cache leaf against JAX's,
    the caches updated in place; in fp32 the steps' outputs also match the
    parallel forward (JAX's test_mlstm_chunked_vs_recurrent, 3e-4)."""
    B, S = 2, 16
    for kind, jinit, init, jdec, dec in (
            ("mlstm", lambda c, dt: jxlstm.init_mlstm_cache(
                B, c, int(c.d_model * c.xlstm.m_proj_factor), c.n_heads, dt),
             xlstm.init_mlstm_cache, jxlstm.mlstm_decode, xlstm.mlstm_decode),
            ("slstm", lambda c, dt: jxlstm.init_slstm_cache(B, c, dt),
             xlstm.init_slstm_cache, jxlstm.slstm_decode, xlstm.slstm_decode)):
        jcfg, cfg, p, tp = _mixer(kind, dtype)
        jx, tx = _input(B, S, cfg.d_model, dtype, 5)
        jcache = jinit(jcfg, jnp.dtype(dtype))
        stacked = init(1, B, cfg, getattr(torch, dtype), "cpu")
        cache = type(stacked)(*(a[0] for a in stacked))
        jstep = jax.jit(lambda pp, xx, cc, jdec=jdec, jcfg=jcfg: jdec(pp, xx, cc, cfg=jcfg))
        ys = []
        for t in range(S):
            jy, jcache = jstep(p, jx[:, t:t + 1], jcache)
            y, new = dec(tp, tx[:, t:t + 1], cache, cfg=cfg)
            assert new is cache
            _close(y, jy, TOLS[dtype], f"{kind} step {t}")
            for name, a, b in zip(cache._fields, cache, jcache):
                if name == "m":   # a log-scale stabilizer
                    np.testing.assert_allclose(_np(a), np.asarray(b), rtol=TOLS[dtype],
                                               atol=TOLS[dtype])
                else:
                    _close(a, b, TOLS[dtype], f"{kind} step {t} cache {name}")
            ys.append(y)
        if dtype == "float32":
            full = _forward(kind)[1](tp, tx, cfg=cfg)
            np.testing.assert_allclose(_np(torch.cat(ys, dim=1)), _np(full),
                                       rtol=3e-4, atol=3e-4)


# ------------------------------------------------------ non-causal attention
def test_non_causal_attention_hd80_matches_jax():
    """hd 80 (hubert's head width) on a custom encoder config, d 320 and 4
    heads: the training forward's plain path and its kernel path (the
    flash kernel's plain version here), the prefill, and the blockwise
    path with ``causal=False`` against JAX's kernel route on the CPU (its
    jnp oracle, as ``repro.kernels.ops`` takes it there), with gradients of
    the kernel path against ``jax.vjp``."""
    from repro.kernels import ops as jax_ops

    jcfg = dataclasses.replace(jconfigs.get_config("hubert-xlarge").reduced(), d_model=320,
                               head_dim=80, n_kv_heads=4)
    cfg = dataclasses.replace(get_config("hubert-xlarge").reduced(), d_model=320,
                              head_dim=80, n_kv_heads=4)
    spec = cfg.period[0]
    p = jattn.init_attn_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = registry.params_from_jax(_np_tree(p), device="cpu")
    B, S = 2, 128
    x = np.random.default_rng(8).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = jnp.arange(S, dtype=jnp.int32)
    want = jattn.attn_forward(p, jnp.asarray(x), cfg=jcfg, spec=spec, positions=pos)
    tx = torch.from_numpy(x)
    tpos = torch.arange(S, dtype=torch.int32)
    for use_kernels in (False, True):
        got = attention.attn_forward(tp, tx, cfg=cfg, spec=spec, positions=tpos,
                                     use_kernels=use_kernels)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-4, atol=2e-5)
    y, cache = attention.attn_prefill(tp, tx, cfg=cfg, spec=spec, positions=tpos, capacity=S)
    jy, jcache = jattn.attn_prefill(p, jnp.asarray(x), cfg=jcfg, spec=spec, positions=pos,
                                    capacity=S)
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(_np(cache.k), np.asarray(jcache.k), rtol=2e-5, atol=2e-5)
    # the attention core: blockwise and the flash path, non-causal, vs
    # JAX's; and its gradients
    rng = np.random.default_rng(9)
    q, k, v, do = (rng.standard_normal((1, 128, 4, 80)).astype(np.float32) for _ in range(4))
    jo = jax_ops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=False)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    blockwise = attention._blockwise_attention(tq, tk, tv, torch.arange(128), False, 0)
    np.testing.assert_allclose(_np(blockwise), np.asarray(jo), rtol=2e-5, atol=2e-5)
    from repro_torch.kernels import ops

    o = ops.flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_np(o), np.asarray(jo), rtol=2e-5, atol=2e-5)
    _, vjp = jax.vjp(lambda a, b, c: jax_ops.flash_attention(a, b, c, causal=False),
                     *map(jnp.asarray, (q, k, v)))
    for got, want in zip(torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do)),
                         vjp(jnp.asarray(do))):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_flash_backward_dq_correction_by_key_means():
    """The bf16 wgmma dQ pass's arithmetic, emulated: dS rounded to bf16, D
    from the rounded O, and r_i c subtracted from dq (r_i the row's sum of
    the rounded dS, c = ``key_means``).  On keys that share a large common
    component the corrected dq lands within 2e-2 of float64's largest
    value for no mask, causal and a window, where the uncorrected product
    misses by far; ``key_means`` is [B, Hkv, hd] in k's dtype."""
    from repro_torch.kernels.flash_attention import key_means

    rng = np.random.default_rng(11)
    B, S, Hq, Hkv, hd = 1, 256, 4, 2, 64
    G, scale = Hq // Hkv, hd ** -0.5

    def rows(H):   # a common component per head and a smaller one per row
        common = rng.standard_normal((1, 1, H, hd))
        return torch.from_numpy(0.6 * common + 0.3 * rng.standard_normal((B, S, H, hd))).to(
            torch.bfloat16)

    q, k, v = rows(Hq), rows(Hkv), rows(Hkv)
    do = torch.from_numpy(1e-3 * rng.standard_normal((B, S, Hq, hd))).to(torch.bfloat16)
    c = key_means(k)
    assert c.shape == (B, Hkv, hd) and c.dtype == k.dtype
    assert float((c.double() - k.double().mean(1)).abs().max()) < 1e-2
    kk, vv = (t.double().repeat_interleave(G, dim=2) for t in (k, v))
    cc = c.double().repeat_interleave(G, dim=1)                     # [B, Hq, hd]
    pos = torch.arange(S)
    for causal, window in ((False, 0), (True, 0), (True, 48)):
        allow = torch.ones(S, S, dtype=torch.bool)
        if causal:
            allow = pos[None, :] <= pos[:, None]
            if window:
                allow &= pos[None, :] > pos[:, None] - window
        s_ = torch.einsum("bshd,bthd->bhst", q.double(), kk) * scale
        p = torch.softmax(s_.masked_fill(~allow, -torch.inf), dim=-1)
        o = torch.einsum("bhst,bthd->bshd", p, vv)
        dp = torch.einsum("bshd,bthd->bhst", do.double(), vv)

        def dq_of(o_used, rounded, corrected):
            D = (do.double() * o_used).sum(-1).transpose(1, 2)[..., None]
            ds = p * (dp - D)
            if rounded:
                ds = ds.to(torch.bfloat16).double()
            dq = torch.einsum("bhst,bthd->bshd", ds, kk)
            if corrected:
                dq = dq - (ds.sum(-1)[..., None] * cc[:, :, None, :]).transpose(1, 2)
            return dq * scale

        want = dq_of(o, False, False)
        top = float(want.abs().max())
        o16 = o.to(torch.bfloat16).double()
        fixed = float((dq_of(o16, True, True) - want).abs().max())
        plain = float((dq_of(o16, True, False) - want).abs().max())
        assert fixed <= 2e-2 * top < plain, (causal, window, fixed / top, plain / top)


# -------------------------------------------------------- whole-model checks
def _jax_batch(jcfg, B, S, kind="train", seed=0):
    return jax_make_batch(jcfg, JaxInputShape("t", S, B, kind), seed=seed)


def _to_port(batch):
    return {k: registry.params_from_jax(np.asarray(v), device="cpu") for k, v in batch.items()}


@pytest.mark.parametrize("arch", [XLSTM, "internvl2-26b"])
def test_prefill_decode_matches_forward(arch):
    """tests/test_models_unit.py:23-48 on the port, for the JAX package's
    weights: the forward's hidden state against JAX's, then the port's
    prefill of 28 tokens (with internvl2's 16 patch embeddings in its first
    positions) and 4 decode steps against the port's own forward logits
    (1e-4 / 2e-4)."""
    jcfg, cfg = _cfgs(arch)
    jparams = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    params = registry.params_from_jax(_np_tree(jparams), device="cpu")
    B, S = 2, 32
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, cfg.vocab_size,
                                         jnp.int32))
    jbatch = {"tokens": jnp.asarray(toks)}
    if cfg.frontend == "vision":
        from repro.models.multimodal import synth_patch_embeds

        jbatch["image_embeds"] = synth_patch_embeds(jax.random.PRNGKey(2), jcfg, B)
    batch = _to_port(jbatch)
    jh, _ = jax.jit(lambda pp, b: jreg.forward(jcfg, pp, b))(jparams, {**jbatch, "labels": toks})
    h, _ = registry.forward(cfg, params, {**batch, "labels": batch["tokens"]})
    np.testing.assert_allclose(_np(h), np.asarray(jh), rtol=2e-4, atol=2e-4)
    ref = _np(registry._logits(cfg, params, h))
    pre = {**batch, "tokens": batch["tokens"][:, :S - 4]}
    logits, caches = registry.prefill(cfg, params, pre, capacity=S)
    np.testing.assert_allclose(_np(logits[:, 0]), ref[:, S - 5], rtol=1e-4, atol=1e-4)
    for t in range(S - 4, S):
        logits, caches = registry.decode_step(cfg, params, caches, batch["tokens"][:, t:t + 1])
        np.testing.assert_allclose(_np(logits[:, 0]), ref[:, t], rtol=1e-4, atol=2e-4,
                                   err_msg=f"{arch} step {t}")
    meta = registry.init_decode_caches(cfg, B, S, device="meta")
    assert [tuple(a.shape) for a in tree_leaves(meta)] == \
        [tuple(a.shape) for a in tree_leaves(caches)]
    assert [a.dtype for a in tree_leaves(meta)] == [a.dtype for a in tree_leaves(caches)]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_loss_and_grads_match_jax(arch):
    """tests/test_smoke_archs.py:20-46 held against JAX: the loss (the
    encoders' in place, no shift) and every parameter's gradient against
    ``jax.value_and_grad`` of JAX's ``loss_fn`` on a JAX-made batch
    (hubert's frames, internvl2's image embeddings); hubert's unused
    ``embed`` gets an exactly zero gradient, as ``jax.grad`` gives; one SGD
    step lowers the loss."""
    jcfg, cfg = _cfgs(arch)
    jparams = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    jbatch = _jax_batch(jcfg, 2, 32)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jreg.loss_fn(jcfg, p, jbatch), has_aux=True))(jparams)
    params = registry.params_from_jax(_np_tree(jparams), device="cpu")
    leaves = [a.requires_grad_() for a in tree_leaves(params)]
    batch = _to_port(jbatch)
    loss, m = registry.loss_fn(cfg, params, batch)
    assert abs(float(loss.detach()) - float(jloss)) < 2e-4
    assert abs(float(m["ce"].detach()) - float(jm["ce"])) < 2e-4
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for i, (g, jg) in enumerate(zip(grads, jax.tree.leaves(jgrads))):
        jg = np.asarray(jg)
        if g is None:
            assert not jg.any(), f"leaf {i}: no gradient on the port, JAX's nonzero"
            continue
        scale = max(1.0, float(np.abs(jg).max()))
        np.testing.assert_allclose(_np(g) / scale, jg / scale, rtol=2e-4, atol=2e-4,
                                   err_msg=f"{arch} leaf {i}")
    if cfg.frontend == "audio":
        assert grads[tree_leaves(params).index(params["embed"])] is None
        assert not np.asarray(jgrads["embed"]).any()
    with torch.no_grad():
        stepped = [a - 0.05 * (g if g is not None else 0) for a, g in zip(leaves, grads)]
        from repro_torch.models.common import tree_unflatten

        loss2, _ = registry.loss_fn(cfg, tree_unflatten(params, stepped), batch)
    assert float(loss2) < float(loss.detach())


# ------------------------------------------------------------------ engine
def _x(L, cut):
    return tuple(1 if i == cut else 0 for i in range(L - 1))


@pytest.fixture(scope="module", params=[(XLSTM, 2), ("bert-large", 1)],
                ids=["xlstm", "bert"])
def engine_runs(request):
    """The plan of tests/test_runtime.py's engine test: xlstm@reduced cut
    into [embed + its period | head], bert-large@reduced into [embed, l0 |
    l1, head]; 2 replicas, mu 2, 8 x 16 tokens, eq (2), SGD(0.05), 2 steps,
    on the JAX engine and on the port's."""
    arch, cut = request.param
    jcfg, cfg = _cfgs(arch)
    B, S, d, mu, steps = 8, 16, 2, 2, 2
    L = cfg.n_layers + 2
    x = _x(L, cut)
    params0 = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    batches = [jax_make_batch(jcfg, JaxInputShape("emu", S, B, "train"), step=k)
               for k in range(steps)]
    jres = jax_run_plan(
        jax_profile(jcfg, AWS_LAMBDA, seq=S, micro_batch=B // (d * mu)), AWS_LAMBDA,
        JaxConfig(x=x, d=d, z=(0,) * L), total_micro_batches=d * mu,
        exec_config=JaxExecutionConfig(steps=steps), execution=JaxExecution(cfg=jcfg, optimizer=JaxSGD(lr=0.05), init_params=params0,
                               batch_fn=lambda k: batches[k]))
    tb = [_to_port(b) for b in batches]
    res = run_plan(arch_model_profile(cfg, AWS, seq=S, micro_batch=B // (d * mu)), AWS,
                   Config(x=x, d=d, z=(0,) * L), total_micro_batches=d * mu,
                   exec_config=ExecutionConfig(steps=steps), execution=Execution(cfg=cfg, optimizer=SGD(lr=0.05),
                                       init_params=registry.params_from_jax(
                                           _np_tree(params0), device="cpu"),
                                       batch_fn=lambda k: tb[k], device="cpu"))
    return SimpleNamespace(cfg=cfg, res=res, jres=jres)


def test_run_plan_matches_jax_engine(engine_runs):
    """Losses within 2e-4 and params within 2e-3 of the JAX engine's
    (tests/test_runtime.py:250-253); the clock, cost and store traffic
    exactly equal.  bert-large's loss is the encoder's (no shift)."""
    res, jres = engine_runs.res, engine_runs.jres
    assert len(res.losses) == 2
    for a, b in zip(res.losses, jres.losses):
        assert abs(a - b) < 2e-4, (res.losses, jres.losses)
    worst = max(float(np.max(np.abs(_np(b) - np.asarray(a))))
                for a, b in zip(jax.tree.leaves(jres.params), tree_leaves(res.params)))
    assert worst < 2e-3
    assert res.t_iter == jres.t_iter and res.t_total == jres.t_total
    assert res.cost == jres.cost and res.breakdown == jres.breakdown
    assert res.store_stats.as_dict() == jres.store_stats.as_dict()


def test_stage_cuts_fall_on_xlstm_periods():
    """xlstm's period is an mLSTM and an sLSTM layer: a cut between them
    raises in both packages; cuts on period boundaries map alike."""
    cfg, jcfg = get_config(XLSTM), jconfigs.get_config(XLSTM)
    good = _x(cfg.n_layers + 2, 6)
    assert [(s.inst_lo, s.inst_hi) for s in stage_instance_ranges(cfg, good)] == \
        [(s.inst_lo, s.inst_hi) for s in jax_ranges(jcfg, good)] == [(0, 3), (3, 6)]
    bad = _x(cfg.n_layers + 2, 5)
    with pytest.raises(ValueError, match="mid-period") as e:
        stage_instance_ranges(cfg, bad)
    with pytest.raises(ValueError, match="mid-period") as je:
        jax_ranges(jcfg, bad)
    assert str(e.value) == str(je.value)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-26b"])
def test_workers_refuse_frontends_as_jax_does(arch):
    """The training and serving stage workers refuse the audio and vision
    frontends with the JAX workers' own messages, and so does the CLI's
    ``emulate --numerics``."""
    jcfg, cfg = _cfgs(arch)
    span, jspan = stage_instance_ranges(cfg, _x(4, 2))[0], jax_ranges(jcfg, _x(4, 2))[0]
    messages = []
    for make, jmake in (
            (lambda: StageWorker(cfg, span, {}, mu=1, replicas=1, optimizer=SGD(),
                                 device="cpu"),
             lambda: JaxStageWorker(jcfg, jspan, {}, mu=1, optimizer=JaxSGD())),
            (lambda: ServeStageWorker(cfg, span, {}, s_ctx=8),
             lambda: JaxServeStageWorker(jcfg, jspan, {}, s_ctx=8))):
        with pytest.raises(NotImplementedError) as e:
            make()
        with pytest.raises(NotImplementedError) as je:
            jmake()
        assert str(e.value) == str(je.value)
        messages.append(str(je.value))
    from repro_torch.cli import main

    with pytest.raises(NotImplementedError) as e:
        main(["emulate", "--model", arch, "--numerics", "--device", "cpu", "--stages", "1",
              "--dp", "1", "--batch", "2", "--seq", "16", "--steps", "1", "--n-layers", "2",
              "--no-plan-cache"])
    assert str(e.value) == messages[0]


# ----------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """xlstm@reduced served on emulated, 2 stages [embed + period | head],
    batch 2, 8 + 3 tokens, by the JAX engine and by the port."""
    model, B, prefill, new = f"{XLSTM}@reduced", 2, 8, 3
    jplan = plan_serving(model, "aws", slo=60.0, batch=B, prefill_tokens=prefill,
                         new_tokens=new)
    x = [0] * len(jplan.x)
    x[2] = 1
    jplan = dataclasses.replace(jplan, x=tuple(x), z=(0,) * (len(x) + 1))
    path = tmp_path_factory.mktemp("plans") / "plan.json"
    jplan.save(path)
    jcfg, cfg = _cfgs(XLSTM)
    params = registry.params_from_jax(_np_tree(jreg.init_params(jcfg, jax.random.PRNGKey(0))),
                                      device="cpu")
    prompt = jax_make_prompt(jcfg, B, prefill, seed=0)
    plan = DeploymentPlan.load(path)
    return SimpleNamespace(
        jres=jax_run_serve_plan(jplan, backend="emulated", seed=0), plan=plan, cfg=cfg,
        jcfg=jcfg, params=params, prompt=prompt, B=B, s_ctx=prefill + new, new=new,
        res=run_serve_plan(plan, device="cpu", params=params, prompt=prompt))


def test_serve_matches_jax_engine(served):
    """Tokens equal the JAX engine's, the clock, cost and store traffic
    exact, and the bytes that cross the store each round are the mLSTM
    (C, n, m, conv) and sLSTM (c, n, m, h) caches, flattened in field
    order, as JAX's ``init_decode_caches`` sizes them."""
    res, jres, cfg = served.res, served.jres, served.cfg
    assert np.array_equal(res.tokens, jres.tokens), (res.tokens, jres.tokens)
    assert res.t_request == jres.t_request and res.cost_per_request == jres.cost_per_request
    assert res.kv_bytes == jres.kv_bytes
    assert res.store_stats.as_dict() == jres.store_stats.as_dict()
    B, s_ctx = served.B, served.s_ctx
    per_inst = kv_bytes_per_instance(cfg, B, s_ctx)
    assert per_inst == jax_kv_bytes(served.jcfg, B, s_ctx)
    di, H, dh = 2 * cfg.d_model, cfg.n_heads, cfg.d_model // cfg.n_heads
    mlstm_b = B * H * (di // H) ** 2 * 4 + B * di * 4 + B * H * 4 + B * 3 * di * 4
    slstm_b = 4 * B * H * dh * 4
    assert per_inst == mlstm_b + slstm_b
    assert res.kv_bytes == (per_inst, 0.0)
    assert res.store_stats.class_bytes_in["kv"] == served.new * per_inst


def test_serve_on_process_matches_emulated(served):
    """The same request on ``process`` (each stage a spawned child, the
    mLSTM and sLSTM caches through a file every round, rebuilt there as
    their named tuples): the same tokens."""
    res = run_serve_plan(served.plan, backend="process", device="cpu", params=served.params,
                         prompt=served.prompt)
    assert res.backend == "process" and np.array_equal(res.tokens, served.res.tokens)
    st = res.store_stats
    assert st.puts == st.deletes == served.res.store_stats.puts


# ----------------------------------------------------------------- batches
def test_make_batch_kinds_and_frontends():
    """Audio train batches {frames, labels}, vision batches with
    ``image_embeds`` of ``n_frontend_tokens`` patches, prefill and decode
    batches of uniform tokens: the keys, shapes and dtypes of JAX's, seeded,
    the frames and patches 0.1 x N(0, 1)."""
    for arch in ("hubert-xlarge", "internvl2-26b", XLSTM):
        jcfg, cfg = _cfgs(arch)
        for kind in ("train", "prefill", "decode"):
            shape, jshape = InputShape("b", 64, 4, kind), JaxInputShape("b", 64, 4, kind)
            b = make_batch(cfg, shape, seed=1, step=2, device="cpu")
            jb = jax_make_batch(jcfg, jshape, seed=1, step=2)
            assert sorted(b) == sorted(jb), (arch, kind)
            for k in b:
                assert tuple(b[k].shape) == tuple(jb[k].shape), (arch, kind, k)
                assert str(b[k].dtype)[6:] == str(jb[k].dtype), (arch, kind, k)
            again = make_batch(cfg, shape, seed=1, step=2, device="cpu")
            assert all(torch.equal(b[k], again[k]) for k in b)
            for k in ("frames", "image_embeds"):
                if k in b:
                    assert abs(float(b[k].std()) - 0.1) < 0.01 and abs(float(b[k].mean())) < 0.01
    cfg = get_config(XLSTM).reduced()
    big = make_batch(cfg, InputShape("u", 512, 64, "prefill"), device="cpu")["tokens"]
    # uniform, not Zipf: token 0 at 1/V, not at Zipf's ~1/H(V, 1.2)
    assert float((big == 0).float().mean()) < 5 / cfg.vocab_size
    assert int(big.min()) >= 0 and int(big.max()) < cfg.vocab_size


# ---------------------------------------------------------------- no jax
def test_new_paths_never_import_jax():
    """A CPU training step of xlstm@reduced, the loss of hubert@reduced on
    frames and of internvl2@reduced with patch embeddings, and a served
    xlstm request through the port leave jax and repro out of
    sys.modules."""
    code = (
        "import sys, dataclasses, torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.configs.base import InputShape\n"
        "from repro_torch.core.perfmodel import Config\n"
        "from repro_torch.core.profiler import arch_model_profile\n"
        "from repro_torch.data.synthetic import make_batch\n"
        "from repro_torch.models import registry\n"
        "from repro_torch.optim import SGD\n"
        "from repro_torch.serverless.platform import get_platform\n"
        "from repro_torch.serverless.runtime import Execution, run_plan\n"
        "from repro_torch.serving import plan_serving, run_serve_plan\n"
        "plat = get_platform('aws')\n"
        "cfg = get_config('xlstm-125m').reduced()\n"
        "params = registry.init_params(cfg, torch.Generator().manual_seed(0), device='cpu')\n"
        "batch = make_batch(cfg, InputShape('t', 8, 4, 'train'), device='cpu')\n"
        "res = run_plan(arch_model_profile(cfg, plat, seq=8, micro_batch=2), plat,\n"
        "               Config(x=(0, 0, 1), d=1, z=(0,) * 4), 2, steps=1,\n"
        "               execution=Execution(cfg=cfg, optimizer=SGD(lr=0.05),\n"
        "                   init_params=params, batch_fn=lambda k: batch, device='cpu'))\n"
        "assert res.losses[0] > 0\n"
        "for arch in ('hubert-xlarge', 'internvl2-26b'):\n"
        "    cfg = get_config(arch).reduced()\n"
        "    params = registry.init_params(cfg, torch.Generator().manual_seed(0), device='cpu')\n"
        "    batch = make_batch(cfg, InputShape('t', 32, 2, 'train'), device='cpu')\n"
        "    assert registry.loss_fn(cfg, params, batch)[0] > 0\n"
        "plan = plan_serving('xlstm-125m@reduced', 'aws', slo=60.0, batch=2,\n"
        "                    prefill_tokens=8, new_tokens=2)\n"
        "assert run_serve_plan(plan, device='cpu').tokens.shape == (2, 2)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.')) or m == 'repro')\n"
        "print('LEAKED', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout
