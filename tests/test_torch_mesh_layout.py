"""The mesh path's layout side (``repro_torch.core.{plan,sharding,
collectives,pipeline}``, ``train.train_step``, ``train.serve_step``,
``data.specs``) against the live JAX package on the CPU, with no ranks.

``make_plan``, ``to_pipeline_layout`` (bit-exact, padding stages, GQA kv
replication, expert shards), ``layer_mask_array``, ``grad_sync_tree``,
``_master_shape`` over the abstract laid-out shapes of every config,
``cache_specs`` (the sequence-sharded ``long_500k`` KV too), ``input_specs``
and the collective costs equal JAX's exactly.  The model functions' mesh
hooks sit where JAX's do: with stand-in hooks (a doubling ``psum_tp``,
shape-keeping expert exchanges, a sequence shard of two) the port's
attention, FFN, MoE, Mamba and xLSTM layers hold JAX's outputs with the same
hooks, and with ``LOCAL_CTX`` they are bit-identical to a call without a
context.  ``_chunked_ce`` holds JAX's on every tp lane.  A bf16 embedding
table's gradient rows sum in fp32 (the mesh's first card run found a
Zipf batch's frequent rows lost to bf16 accumulation).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import collectives as jcc
from repro.core import pipeline as jpipe
from repro.core import plan as jplan
from repro.core import sharding as jsharding
from repro.data import specs as jspecs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import registry as jreg
from repro.models import transformer as jtrans
from repro.train import serve_step as jserve
from repro.train import train_step as jtrain

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.core import collectives as cc
from repro_torch.core import pipeline
from repro_torch.core import sharding
from repro_torch.core.plan import make_plan
from repro_torch.data.specs import input_specs
from repro_torch.models import attention, registry, transformer
from repro_torch.models.common import LOCAL_CTX, ParallelCtx, tree_leaves, tree_map
from repro_torch.train import serve_step, train_step

torch.backends.cuda.matmul.allow_tf32 = False
ALL = ARCH_IDS + ["bert-large"]
# (data, model, pods, stages-or-None): None takes the config's own factorization
MESHES = [(16, 16, 1, None), (16, 16, 2, None), (2, 4, 1, 4), (2, 4, 1, 2), (8, 2, 1, 1),
          (1, 8, 1, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's CPU runs: the suite runs several
    workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plans(cfg, jcfg, shape_name):
    for data, model, pods, stages in MESHES:
        kw = {} if stages is None else dict(stages=stages, tensor=model // stages)
        yield (make_plan(cfg, INPUT_SHAPES[shape_name], data=data, model=model, pods=pods, **kw),
               jplan.make_plan(jcfg, jconfigs.INPUT_SHAPES[shape_name], data=data,
                               model=model, pods=pods, **kw))


def _np(t):
    return t.detach().float().cpu().numpy()


# ------------------------------------------------------------------- plans
@pytest.mark.parametrize("arch", ALL)
def test_make_plan_equals_jax(arch):
    """Every field, ``ppstage`` and ``model_axis`` of the plan equal JAX's
    for every named shape on six meshes (pods, config factorizations and
    overrides), the micro-batch and remat overrides too."""
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    assert set(INPUT_SHAPES) == set(jconfigs.INPUT_SHAPES)
    for name in INPUT_SHAPES:
        assert dataclasses.asdict(INPUT_SHAPES[name]) == \
            dataclasses.asdict(jconfigs.INPUT_SHAPES[name])
        for p, jp in _plans(cfg, jcfg, name):
            assert dataclasses.asdict(p) == dataclasses.asdict(jp), (arch, name)
            assert (p.ppstage, p.model_axis) == (jp.ppstage, jp.model_axis)
    kw = dict(data=4, model=4, stages=2, tensor=2, microbatches=3, remat="layer")
    assert dataclasses.asdict(make_plan(cfg, INPUT_SHAPES["train_4k"], **kw)) == \
        dataclasses.asdict(jplan.make_plan(jcfg, jconfigs.INPUT_SHAPES["train_4k"], **kw))
    with pytest.raises(ValueError, match="model axis"):
        make_plan(cfg, INPUT_SHAPES["train_4k"], data=2, model=4, stages=3, tensor=1)


@pytest.mark.parametrize("arch", ALL)
def test_input_specs_equal_jax(arch):
    """Every named shape's inputs: the same names, shapes and dtypes as
    JAX's ShapeDtypeStructs, on the meta device."""
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        got = input_specs(cfg, shape)
        want = jspecs.input_specs(jcfg, jconfigs.INPUT_SHAPES[name])
        assert list(got) == list(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == want[k].shape
            assert str(v.dtype).split(".")[-1] == str(want[k].dtype)


# ----------------------------------------------------------------- layouts
def _reduced_pair(arch):
    return get_config(arch).reduced(), jconfigs.get_config(arch).reduced()


LAYOUTS = [(1, 1, 1), (3, 1, 1), (2, 2, 2), (1, 4, 4)]


@pytest.mark.parametrize("arch", ALL)
def test_pipeline_layout_equals_jax(arch):
    """``to_pipeline_layout`` of JAX's initial parameters equals JAX's bit
    for bit on four (stages, tensor, data) plans, padding stages (3 stages
    of 2 periods) and kv heads fewer than tp lanes among them;
    ``layer_mask_array`` equals JAX's; ``local_params`` of a rank equals its
    view of the layout (the data shard of the experts under expert
    parallelism)."""
    cfg, jcfg = _reduced_pair(arch)
    jp = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    base = registry.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    shape = INPUT_SHAPES["train_4k"]
    for stages, tensor, data in LAYOUTS:
        kw = dict(data=data, model=stages * tensor, stages=stages, tensor=tensor)
        plan = make_plan(cfg, shape, **kw)
        jpl = jplan.make_plan(jcfg, jconfigs.INPUT_SHAPES["train_4k"], **kw)
        got = sharding.to_pipeline_layout(cfg, plan, base)
        want = jsharding.to_pipeline_layout(jcfg, jpl, jp)
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert tuple(a.shape) == b.shape
            assert np.array_equal(a.numpy(), np.asarray(b)), (arch, stages, tensor)
        assert np.array_equal(sharding.layer_mask_array(cfg, plan),
                              jsharding.layer_mask_array(jcfg, jpl))
        for d in range(data):
            for m in (0, plan.model_axis - 1):
                mine = sharding.local_params(cfg, plan, base, d=d, m=m)
                view = sharding.local_layout(cfg, plan, got, d=d, m=m)
                for a, b in zip(tree_leaves(mine), tree_leaves(view)):
                    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ALL)
def test_grad_sync_and_master_shapes_equal_jax(arch):
    """At full size with no allocation: ``abstract_layout_shapes`` (meta
    tensors) equal JAX's ShapeDtypeStructs, ``grad_sync_tree`` equals JAX's
    leaf for leaf, and ``_master_shape`` of every leaf equals JAX's, on the
    config's own plan and a tp 2 / data 4 one."""
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    shape, jshape = INPUT_SHAPES["train_4k"], jconfigs.INPUT_SHAPES["train_4k"]
    for kw in (dict(data=16, model=16), dict(data=4, model=4, stages=2, tensor=2)):
        plan, jpl = make_plan(cfg, shape, **kw), jplan.make_plan(jcfg, jshape, **kw)
        shapes = tree_leaves(sharding.abstract_layout_shapes(cfg, plan))
        jshapes = jax.tree.leaves(jsharding.abstract_layout_shapes(jcfg, jpl))
        assert len(shapes) == len(jshapes)
        for a, b in zip(shapes, jshapes):
            assert a.device.type == "meta"
            assert (tuple(a.shape), str(a.dtype).split(".")[-1]) == (b.shape, str(b.dtype))
        syncs = tree_leaves(train_step.grad_sync_tree(cfg, plan))
        jsyncs = jax.tree.leaves(jtrain.grad_sync_tree(jcfg, jpl))
        assert [dataclasses.astuple(s) for s in syncs] == \
            [dataclasses.astuple(s) for s in jsyncs]
        for a, s, js in zip(shapes, syncs, jsyncs):
            size = int(np.prod(a.shape))
            assert train_step._master_shape(tuple(a.shape), size, s, plan) == \
                tuple(jtrain._master_shape(tuple(a.shape), size, js, jpl))


@pytest.mark.parametrize("arch", [a for a in ALL if not get_config(a).is_encoder])
def test_cache_specs_equal_jax(arch):
    """The global cache shapes and dtypes of the decode shapes (``long_500k``
    with its KV sharded over the data axis) equal JAX's, at full size on
    the meta device; a rank's caches are the global ones cut by the batch
    and (sharded) capacity."""
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    for name in ("decode_32k", "long_500k"):
        if not jcfg.supports_shape(name):
            continue
        for kw in (dict(data=16, model=16), dict(data=2, model=4, stages=2, tensor=2)):
            plan = make_plan(cfg, INPUT_SHAPES[name], **kw)
            jpl = jplan.make_plan(jcfg, jconfigs.INPUT_SHAPES[name], **kw)
            got = tree_leaves(serve_step.cache_specs(cfg, plan, INPUT_SHAPES[name]))
            want = jax.tree.leaves(jserve.cache_specs(jcfg, jpl, jconfigs.INPUT_SHAPES[name])[0])
            assert [(tuple(a.shape), str(a.dtype).split(".")[-1]) for a in got] == \
                [(b.shape, str(b.dtype)) for b in want], (arch, name, kw)
            assert all(a.device.type == "meta" for a in got)


def test_collective_groups_and_costs_equal_jax():
    """tp groups, stage peers, the pipeline permutation and the ring cost
    model equal JAX's."""
    for stages, tp in ((1, 1), (4, 1), (2, 4), (16, 1), (2, 8)):
        assert cc.tp_groups(stages, tp) == jcc.tp_groups(stages, tp)
        assert cc.stage_peers(stages, tp) == jcc.stage_peers(stages, tp)
        assert cc.pipeline_perm(stages, tp) == jcc.pipeline_perm(stages, tp)
    for nbytes in (0.0, 1e6, 3.3e9):
        for d in (1, 2, 8, 16):
            for bi in (False, True):
                for fn in ("reduce_scatter_cost", "all_gather_cost", "all_reduce_cost"):
                    assert dataclasses.astuple(getattr(cc, fn)(nbytes, d, bi)) == \
                        dataclasses.astuple(getattr(jcc, fn)(nbytes, d, bi))


def test_mesh_rank_order_is_jax_make_mesh_order():
    """Rank (pod, d, m) is (pod*data + d)*model + m, the row-major device
    order of ``jax.make_mesh`` on CPU devices; the kv-share groups are
    JAX's ``kvg`` lists of model indices, offset by the rank's row."""
    from repro_torch.launch.mesh import MeshShape, _axis_groups

    shape = MeshShape(data=2, model=8, pods=2, tensor=4, kv_heads=2)
    ranks = np.arange(shape.world).reshape(2, 2, 8)
    for r in range(shape.world):
        assert ranks[shape.coords(r)] == r == shape.rank_of(*shape.coords(r))
    groups = _axis_groups(shape)
    kvg = [[s * 4 + g * 2 + u for u in range(2)] for s in range(2) for g in range(2)]
    assert groups["kvshare"][:4] == kvg
    assert groups["tp"][:2] == jcc.tp_groups(2, 4)
    assert groups["data"][0] == [0, 8] and groups["pod"][0] == [0, 16]
    assert groups["seq"][0] == [0, 8, 16, 24]


# --------------------------------------------------------- model mesh hooks
def test_parallel_ctx_fields_equal_jax():
    assert [f.name for f in dataclasses.fields(ParallelCtx)] == \
        [f.name for f in dataclasses.fields(jcommon.ParallelCtx)]
    assert LOCAL_CTX == ParallelCtx()


def _layer0(tree, j):
    return tree["layers"][j]


def _pick0(tree):
    return tree_map(lambda a: a[0], tree) if isinstance(tree, dict) else tree


def _inputs(cfg, seed=0, B=2, S=16):
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def _hooks(jax_side: bool, **kw):
    """Stand-in hooks: a doubling psum_tp, shape-keeping expert exchanges
    (x1.5 there, /1.5 back), sequence hooks as identities."""
    base = (jcommon.ParallelCtx if jax_side else ParallelCtx)(**kw)
    return dataclasses.replace(
        base, psum_tp=lambda x: 2 * x,
        ep_all_to_all=lambda x: x * 1.5, ep_all_to_all_back=lambda x: x / 1.5)


def _close(got, want, tol=2e-5):
    want = np.asarray(want, dtype=np.float32)
    err = float(np.abs(_np(got) - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), err


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "qwen2.5-14b", "gemma3-4b",
                                  "dbrx-132b", "jamba-v0.1-52b", "xlstm-125m"])
def test_layer_hooks_sit_where_jax_puts_them(arch):
    """The first layer of each kind in the reduced arch's period, forward,
    prefill and decode, with the stand-in hooks: the port's output
    holds JAX's with the same hooks (xLSTM's through ``_repl_ctx``, so
    unchanged), and with ``LOCAL_CTX`` it is bit-identical to a call with
    no context."""
    cfg, jcfg = _reduced_pair(arch)
    jp = jreg.init_params(jcfg, jax.random.PRNGKey(1))
    params = registry.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x, jx = _inputs(cfg)
    pos = torch.arange(x.shape[1], dtype=torch.int32)
    jpos = jnp.arange(x.shape[1], dtype=jnp.int32)
    ctx, jctx = _hooks(False, tp_size=2), _hooks(True, tp_size=2)
    kinds = {}
    for j, spec in enumerate(cfg.period):   # the first layer of each kind
        kinds.setdefault((spec.mixer, spec.ff, bool(spec.window)), j)
    for j in kinds.values():
        spec = cfg.period[j]
        p = _pick0(params["layers"][j])
        pj = jax.tree.map(lambda a: a[0], jp["layers"][j])
        got, aux = transformer.layer_forward(p, x, True, cfg=cfg, spec=spec, positions=pos,
                                             ctx=ctx)
        want, jaux = jtrans.layer_forward(pj, jx, True, cfg=jcfg, spec=jcfg.period[j],
                                          positions=jpos, ctx=jctx)
        _close(got, want)
        if aux is not None:
            _close(aux, jaux)
        plain, _ = transformer.layer_forward(p, x, True, cfg=cfg, spec=spec, positions=pos)
        local, _ = transformer.layer_forward(p, x, True, cfg=cfg, spec=spec, positions=pos,
                                             ctx=LOCAL_CTX)
        assert torch.equal(plain, local)
        got, cache = transformer.layer_prefill(p, x, True, cfg=cfg, spec=spec, positions=pos,
                                               ctx=ctx, capacity=20)
        want, jcache = jtrans.layer_prefill(pj, jx, True, cfg=jcfg, spec=jcfg.period[j],
                                            positions=jpos, ctx=jctx, capacity=20)
        _close(got, want)
        tok = x[:, :1]
        got, _ = transformer.layer_decode(p, tok, cache, True, cfg=cfg, spec=spec, ctx=ctx)
        want, _ = jtrans.layer_decode(pj, jx[:, :1], jcache, True, cfg=jcfg,
                                      spec=jcfg.period[j], ctx=jctx)
        _close(got, want)


def test_sharded_decode_matches_jax_shard():
    """A global layer's decode on shard 1 of 2 (``seq_shards`` 2, the
    combine hooks as identities): the round-robin writes, the ``valid``
    rule and the partial softmax equal JAX's shard step by step, and the
    cache holds only this shard's positions."""
    cfg, jcfg = _reduced_pair("phi3-mini-3.8b")
    spec, jspec = cfg.period[0], jcfg.period[0]
    jp = jax.tree.map(lambda a: a[0], jreg.init_params(jcfg, jax.random.PRNGKey(2))["layers"][0])
    p = registry.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")["mixer"]
    jp = jp["mixer"]
    kw = dict(seq_shards=2, seq_index=1)
    ctx = ParallelCtx(**kw, pmax_seq=lambda x: x)
    jctx = jcommon.ParallelCtx(**kw, pmax_seq=lambda x: x)
    C = 4
    cache = attention.init_kv_cache(1, 2, cfg.n_kv_heads, C, cfg.hd, torch.float32, "cpu")
    cache = attention.KVCache(*(a[0] for a in cache))
    jcache = jattn.init_kv_cache(2, jcfg.n_kv_heads, C, jcfg.hd, jnp.float32)
    xs = np.random.default_rng(3).standard_normal((6, 2, 1, cfg.d_model)).astype(np.float32)
    for t in range(6):
        got, cache = attention.attn_decode(p, torch.from_numpy(xs[t]), cache, cfg=cfg,
                                           spec=spec, ctx=ctx)
        want, jcache = jattn.attn_decode(jp, jnp.asarray(xs[t]), jcache, cfg=jcfg, spec=jspec,
                                         ctx=jctx)
        if t >= 1:   # position 0 belongs to shard 0: this shard has no key yet
            _close(got, want)
        _close(cache.k, jcache.k, 1e-6)
        assert cache.cursor.tolist() == np.asarray(jcache.cursor).tolist()
    assert attention.cache_capacity(spec, 70, 2) == jattn.cache_capacity(jspec, 70, 2) == 35


@pytest.mark.parametrize("tp", [1, 2, 3])
def test_chunked_ce_equals_jax_on_every_lane(tp):
    """The lane-partitioned CE over 1100 positions (three chunks, the last
    short) and its gradient equal JAX's on every lane, shifted and not; the
    lanes sum to the full mean CE."""
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 1101, 16)).astype(np.float32)
    w = (0.3 * rng.standard_normal((50, 16))).astype(np.float32)
    lab = rng.integers(0, 50, (2, 1101), dtype=np.int32)
    for shift in (True, False):
        total = 0.0
        for lane in range(tp):
            ht = torch.from_numpy(h).requires_grad_(True)
            got = pipeline._chunked_ce(ht, torch.from_numpy(w), torch.from_numpy(lab), shift,
                                       tp=tp, tp_index=lane)
            want, jg = jax.value_and_grad(lambda a: jpipe._chunked_ce(
                a, jnp.asarray(w), jnp.asarray(lab), shift, tp=tp, tp_index=lane))(jnp.asarray(h))
            assert abs(float(got) - float(want)) <= 2e-6 * max(1.0, abs(float(want)))
            if got.requires_grad:
                got.backward()
                _close(ht.grad, jg, 1e-5)
            else:
                assert float(np.abs(np.asarray(jg)).max()) == 0.0
            total += float(got)
        full = pipeline._chunked_ce(torch.from_numpy(h), torch.from_numpy(w),
                                    torch.from_numpy(lab), shift)
        assert abs(total - float(full)) <= 1e-5 * abs(float(full))


def test_bf16_embedding_gradient_sums_in_fp32():
    """A bf16 table's gradient rows are summed in fp32 and rounded once: a
    row hit 1,590 times (a Zipf batch's most frequent token) holds its
    float64 sum within a bf16 rounding, where autograd's own lookup gradient
    (duplicates added one by one in bf16) loses most of it; an fp32 table
    keeps autograd's own gradient, bit for bit."""
    rng = np.random.default_rng(5)
    g = torch.from_numpy((rng.standard_normal((1600, 64)) * 1e-3 + 2e-3).astype(np.float32))
    ids = torch.cat([torch.zeros(1590, dtype=torch.long), torch.arange(1, 11)])
    exact = torch.zeros(20, 64, dtype=torch.float64).index_add_(0, ids, g.bfloat16().double())
    for dtype in (torch.bfloat16, torch.float32):
        w = torch.from_numpy(rng.standard_normal((20, 64)).astype(np.float32)).to(dtype)
        mine = w.clone().requires_grad_(True)
        out = registry.embed_tokens(None, {"embed": mine}, ids)
        out.backward(g.to(dtype))
        own = w.clone().requires_grad_(True)
        own[ids].backward(g.to(dtype))
        assert torch.equal(out, w[ids])
        err = float((mine.grad.double() - exact).abs().max() / exact.abs().max())
        if dtype == torch.float32:
            assert torch.equal(mine.grad, own.grad)
        else:
            own_err = float((own.grad.double() - exact).abs().max() / exact.abs().max())
            assert err < 4e-3 < 0.1 < own_err, (err, own_err)
    with torch.no_grad():
        assert torch.equal(registry.embed_tokens(None, {"embed": w}, ids), w[ids])
