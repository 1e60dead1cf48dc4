"""The port's dense decoder (``repro_torch.models``) against the JAX package
on the CPU, in fp32, at 2e-4: the training forward (attention and MLP on
both routes, the blockwise attention at 4096 tokens), ``loss_fn`` and every
gradient, attention prefill/decode (caches included, append and ring
layouts, and prompts of 4096 tokens), the monolithic prefill + three decode
steps, and the parameter layout; for phi3-mini-3.8b, qwen2.5-14b (q/k/v
biases) and gemma3-4b (sliding windows, q/k norms) reduced, and gemma3-4b
reduced at heads of 256.  Inputs come from numpy with a seed or from the
JAX package's own ``init_params`` and ``make_batch``, handed across as numpy
arrays."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import InputShape as JaxInputShape
from repro.configs.base import LayerSpec as JaxLayerSpec
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import registry as jreg
from repro.serving import arch_config_for_model as jax_arch

from repro_torch.configs.base import LayerSpec
from repro_torch.models import attention, common, mlp, registry
from repro_torch.serving import arch_config_for_model

torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32 on a card too

# "<arch>@hd256": the reduced config at heads of 256 (d_model 512, 2 query
# heads sharing 1 kv head), built alike in both packages
ARCHS = ["phi3-mini-3.8b@reduced", "qwen2.5-14b@reduced", "gemma3-4b@reduced",
         "gemma3-4b@hd256"]
HD256 = dict(d_model=512, n_heads=2, n_kv_heads=1, head_dim=256)
TOL = dict(rtol=2e-4, atol=2e-4)
B, S = 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's CPU torch runs: the suite runs
    several workers on the host's cores, and torch pools of a thread a core
    each starve one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(model):
    """(port cfg, jax cfg) of an ``ARCHS`` id."""
    base, _, spec = model.partition("@")
    if spec == "hd256":
        return (dataclasses.replace(arch_config_for_model(f"{base}@reduced"), **HD256),
                dataclasses.replace(jax_arch(f"{base}@reduced"), **HD256))
    return arch_config_for_model(model), jax_arch(model)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(port cfg, jax cfg, jax params as numpy, port params)."""
    cfg, jcfg = _configs(request.param)
    jparams = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    # zero-initialised biases and q/k norm scales: give them real values
    rng = np.random.default_rng(1)
    for layer in jparams["layers"]:
        for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
            if name in layer["mixer"]:
                shape = layer["mixer"][name].shape
                layer["mixer"][name] = jnp.asarray(
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


# ------------------------------------------------------------------ training
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("window", [0, 4])
def test_attn_forward_matches_jax(arch, use_kernels, window):
    """Both routes: the plain path (bf16-style einsum then fp32 softmax) and
    ``ops.flash_attention`` (its plain version on the CPU), against JAX's
    ``attn_forward`` with and without ``use_pallas``."""
    cfg, jcfg, params_np, _ = arch
    spec, jspec = LayerSpec(window=window), JaxLayerSpec(window=window)
    p_np = _layer(params_np)
    p = {k: _t(v) for k, v in p_np.items()}
    x = np.random.default_rng(11).standard_normal((B, S, cfg.d_model), dtype=np.float32)
    pos = np.arange(S, dtype=np.int32)
    y = attention.attn_forward(p, _t(x), cfg=cfg, spec=spec, positions=_t(pos),
                               use_kernels=use_kernels)
    jy = jattn.attn_forward(p_np, jnp.asarray(x), cfg=jcfg, spec=jspec,
                            positions=jnp.asarray(pos), use_pallas=use_kernels)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_mlp_forward_matches_jax(arch, use_kernels):
    cfg, _, params_np, _ = arch
    p_np = jax.tree.map(lambda a: a[0], params_np["layers"][0]["ff"])
    x = np.random.default_rng(12).standard_normal((B, S, cfg.d_model), dtype=np.float32)
    y = mlp.mlp_forward({k: _t(v) for k, v in p_np.items()}, _t(x), use_kernels=use_kernels)
    jy = jmlp.mlp_forward(p_np, jnp.asarray(x), use_pallas=use_kernels)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 256), (False, 0)])
def test_blockwise_attention_matches_jax_at_4096(causal, window):
    """The O(S*block) path at its threshold, on a tiny width (2 query heads
    sharing one kv head of 16)."""
    Sb = attention.BLOCKWISE_THRESHOLD
    rng = np.random.default_rng(13)
    q = rng.standard_normal((1, Sb, 2, 16), dtype=np.float32)
    k, v = (rng.standard_normal((1, Sb, 1, 16), dtype=np.float32) for _ in range(2))
    pos = np.arange(Sb, dtype=np.int32)
    got = attention._blockwise_attention(_t(q), _t(k), _t(v), _t(pos), causal, window)
    want = jattn._blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(pos), causal, window)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_prefill_at_4096_then_three_decodes_matches_jax():
    """The repaired fault: a prompt of 4096 tokens used to raise in the port;
    it now goes through the blockwise attention, as in JAX."""
    model = ARCHS[0]
    cfg, jcfg = arch_config_for_model(model), jax_arch(model)
    params_np = jax.tree.map(np.asarray, jreg.init_params(jcfg, jax.random.PRNGKey(3)))
    params = registry.params_from_jax(params_np, device="cpu")
    Sp = attention.BLOCKWISE_THRESHOLD
    rng = np.random.default_rng(14)
    toks = rng.integers(0, cfg.vocab_size, (1, Sp), dtype=np.int32)
    cap = Sp + 3
    logits, caches = registry.prefill(cfg, params, {"tokens": _t(toks)}, capacity=cap)
    jlogits, jcaches = jreg.prefill(jcfg, params_np, {"tokens": jnp.asarray(toks)},
                                    capacity=cap)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (1, 1), dtype=np.int32)
        logits, caches = registry.decode_step(cfg, params, caches, _t(nxt))
        jlogits, jcaches = jreg.decode_step(jcfg, params_np, jcaches, jnp.asarray(nxt))
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
        for mine, theirs in zip(caches, jcaches):
            _assert_cache(mine, theirs)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_loss_and_every_gradient_match_jax(arch, use_kernels):
    """``loss_fn`` and the gradient of every parameter against
    ``jax.value_and_grad(registry.loss_fn)`` on a ``make_batch`` batch."""
    cfg, jcfg, params_np, _ = arch
    batch = jax_make_batch(jcfg, JaxInputShape("t", 16, 2, "train"), seed=3)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jreg.loss_fn(jcfg, p, batch, use_pallas=use_kernels),
        has_aux=True)(jax.tree.map(jnp.asarray, params_np))
    params = registry.params_from_jax(params_np, device="cpu")
    leaves = common.tree_leaves(params)
    for a in leaves:
        a.requires_grad_()
    tbatch = {k: _t(v) for k, v in batch.items()}
    loss, aux = registry.loss_fn(cfg, params, tbatch, use_kernels=use_kernels)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    np.testing.assert_allclose(float(aux["ce"].detach()), float(jaux["ce"]), **TOL)
    assert float(aux["aux"]) == float(jaux["aux"]) == 0.0
    flat_j = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat_j) == len(grads)
    for (path, jg), g in zip(flat_j, grads):
        np.testing.assert_allclose(_np(g), np.asarray(jg), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(15)
    logits = rng.standard_normal((2, 5, 33), dtype=np.float32) * 3
    labels = rng.integers(0, 33, (2, 5), dtype=np.int32)
    np.testing.assert_allclose(
        _np(common.softmax_cross_entropy(_t(logits), _t(labels))),
        np.asarray(jcommon.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6, atol=1e-6)
