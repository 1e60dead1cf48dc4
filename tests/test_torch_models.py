"""The port's dense decoder (``repro_torch.models``) against the JAX package
on the CPU, in fp32, at 2e-4: attention prefill/decode (caches included,
append and ring layouts), the monolithic prefill + three decode steps, and
the parameter layout.  Inputs come from numpy with a seed or from the JAX
package's own ``init_params``, handed across as numpy arrays."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LayerSpec as JaxLayerSpec
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import registry as jreg
from repro.serving import arch_config_for_model as jax_arch

from repro_torch.configs.base import LayerSpec
from repro_torch.models import attention, common, registry
from repro_torch.serving import arch_config_for_model

ARCHS = ["phi3-mini-3.8b@reduced", "qwen2.5-14b@reduced"]
TOL = dict(rtol=2e-4, atol=2e-4)
B, S = 2, 8


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(port cfg, jax cfg, jax params as numpy, port params)."""
    cfg, jcfg = arch_config_for_model(request.param), jax_arch(request.param)
    jparams = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    if jcfg.qkv_bias:   # zero-initialised: give the bias terms real values
        rng = np.random.default_rng(1)
        layers = jparams["layers"][0]
        for name in ("bq", "bk", "bv"):
            shape = layers["mixer"][name].shape
            layers["mixer"][name] = jnp.asarray(
                0.1 * rng.standard_normal(shape, dtype=np.float32))
    params_np = jax.tree.map(np.asarray, jparams)
    return cfg, jcfg, params_np, registry.params_from_jax(params_np, device="cpu")


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.tensor(np.asarray(a))


def _layer(params_np, i=0):
    return jax.tree.map(lambda a: a[i], params_np["layers"][0]["mixer"])


def test_config_matches_jax(arch):
    cfg, jcfg, _, _ = arch
    for f in dataclasses.fields(cfg):
        mine, theirs = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name == "period":
            mine = [dataclasses.astuple(s) for s in mine]
            theirs = [dataclasses.astuple(s) for s in theirs]
        assert mine == theirs, f.name
    assert cfg.param_count() == jcfg.param_count()


def test_param_layout_matches_jax(arch):
    cfg, jcfg, params_np, _ = arch
    mine = registry.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat_j, _ = jax.tree_util.tree_flatten_with_path(params_np)
    flat_t = common.tree_leaves(mine)
    assert len(flat_t) == len(flat_j)
    for (path, a), t in zip(flat_j, flat_t):
        assert tuple(t.shape) == a.shape and str(t.dtype)[6:] == str(a.dtype), path
    # same scales: the output projections shrink with depth
    wo = _np(mine["layers"][0]["mixer"]["wo"])
    assert abs(wo.std() - 0.02 / cfg.n_layers ** 0.5) < 0.05 * 0.02


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 64), dtype=np.float32)
    scale = 0.1 * rng.standard_normal(64, dtype=np.float32)
    pos = np.arange(5, dtype=np.int32)
    np.testing.assert_allclose(
        _np(common.rms_norm(_t(x), _t(scale))),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale))), **TOL)
    np.testing.assert_allclose(
        _np(common.apply_rope(_t(x), _t(pos), 10_000.0)),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        **TOL)


def _assert_cache(mine, theirs):
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("window", [0, 4, 16])
def test_attn_prefill_then_decode_matches_jax(arch, window):
    """Append layout (window 0) and the ring (window 4 <= S wraps, window
    16 > S pads), prefill and then three decode tokens, caches included."""
    cfg, jcfg, params_np, _ = arch
    spec, jspec = LayerSpec(window=window), JaxLayerSpec(window=window)
    p_np = _layer(params_np)
    p = {k: _t(v) for k, v in p_np.items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    pos = np.arange(S, dtype=np.int32)
    cap = S + 3
    y, cache = attention.attn_prefill(p, _t(x), cfg=cfg, spec=spec,
                                      positions=_t(pos), capacity=cap)
    jy, jcache = jattn.attn_prefill(p_np, jnp.asarray(x), cfg=jcfg, spec=jspec,
                                    positions=jnp.asarray(pos), capacity=cap)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)
    _assert_cache(cache, jcache)
    for _ in range(3):
        x1 = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
        out, cache = attention.attn_decode(p, _t(x1), cache, cfg=cfg, spec=spec,
                                           use_kernels=True)
        jout, jcache = jattn.attn_decode(p_np, jnp.asarray(x1), jcache, cfg=jcfg,
                                         spec=jspec)
        np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
        _assert_cache(cache, jcache)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_and_three_decode_steps_match_jax(arch, use_kernels):
    cfg, jcfg, params_np, params = arch
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    cap = S + 4
    logits, caches = registry.prefill(cfg, params, {"tokens": _t(toks)}, capacity=cap)
    jlogits, jcaches = jreg.prefill(jcfg, params_np, {"tokens": jnp.asarray(toks)},
                                    capacity=cap)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1), dtype=np.int32)
        logits, caches = registry.decode_step(cfg, params, caches, _t(nxt),
                                              use_kernels=use_kernels)
        jlogits, jcaches = jreg.decode_step(jcfg, params_np, jcaches,
                                            jnp.asarray(nxt), use_pallas=use_kernels)
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
        for mine, theirs in zip(caches, jcaches):
            _assert_cache(mine, theirs)


def test_padding_instances_are_identity(arch):
    """An extra (masked) period instance changes neither logits nor the
    real caches, and its own cache stays untouched by decode."""
    cfg, _, _, _ = arch
    gen = torch.Generator().manual_seed(5)
    params = registry.init_params(cfg, gen, device="cpu", n_instances=cfg.n_periods + 1)
    trimmed = common.tree_map(lambda a: a, params)
    trimmed["layers"] = common.tree_map(lambda a: a[:cfg.n_periods], params["layers"])
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, dtype=torch.int32)
    mask = registry.active_mask(cfg, cfg.n_periods + 1)
    assert not mask[-1].any()
    from repro_torch.models.transformer import scan_decode, scan_prefill

    h = registry.embed_tokens(cfg, params, toks)
    pos = torch.arange(S, dtype=torch.int32)
    h_pad, c_pad = scan_prefill(params["layers"], h, mask, cfg=cfg, positions=pos,
                                capacity=S + 1)
    h_ref, c_ref = scan_prefill(trimmed["layers"], h, mask[:-1], cfg=cfg,
                                positions=pos, capacity=S + 1)
    assert torch.equal(h_pad, h_ref)
    frozen = common.tree_map(torch.clone, c_pad)
    x1 = registry.embed_tokens(cfg, params, toks[:, :1])
    d_pad, c_pad = scan_decode(params["layers"], x1, c_pad, mask, cfg=cfg)
    d_ref, c_ref = scan_decode(trimmed["layers"], x1, c_ref, mask[:-1], cfg=cfg)
    assert torch.equal(d_pad, d_ref)
    for a, b in zip(c_pad[0], frozen[0]):
        assert torch.equal(a[-1], b[-1])     # the padding instance's cache


def test_params_from_jax_casts_and_copies(arch):
    _, _, params_np, _ = arch
    bf = registry.params_from_jax(params_np, device="cpu", dtype=torch.bfloat16)
    assert bf["embed"].dtype == torch.bfloat16
    torch.testing.assert_close(bf["embed"].float(), _t(params_np["embed"]),
                               rtol=1e-2, atol=1e-3)
    f32 = registry.params_from_jax(params_np, device="cpu")
    f32["embed"].zero_()
    assert np.abs(params_np["embed"]).sum() > 0     # a copy, not a view


def test_cuda_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = arch_config_for_model(ARCHS[0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.init_decode_caches(cfg, 1, 8)
