"""The port's kernel modules against the JAX package.

On the CPU: the port's plain versions (``decode_attention_ref``,
``flash_attention_ref``, ``swiglu_ref``) against the JAX oracles and, for
some cases, the Pallas kernels in interpret mode (the cases of
``tests/test_kernels.py``); their autograd gradients against ``jax.vjp`` of
the oracles; the dispatcher, the capability probe, the CUDA wrappers' input checks,
routes and launch counts, and the build cache.  On a card (marker
``cuda``): each hand-written CUDA kernel, forward and backward, against its
plain version, and the tensor-core kernels' one-tile probes against matrix
products.  The tf32x3 route's arithmetic (three TF32 products for each fp32
product) is also emulated on the CPU against the JAX oracle.
"""
import contextlib

import numpy as np
import pytest
import torch

try:  # the machine with the card runs only the ``cuda`` tests, without jax
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref
    from repro.kernels.decode_attention import decode_attention as pallas_decode
    from repro.kernels.flash_attention import flash_attention as pallas_flash
    from repro.kernels.swiglu import swiglu as pallas_swiglu
except ImportError:
    jnp = None

from repro_torch.configs import get_config
from repro_torch.kernels import adamw as aw
from repro_torch.kernels import build as kernel_build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import swiglu as sg
from repro_torch.kernels.ref import (
    decode_attention_ref,
    flash_attention_ref,
    swiglu_bwd_ref,
    swiglu_ref,
)

CASES = [(512, 1), (512, 511), (1024, 700), (2048, 2048)]
HEADS = [(8, 2, 64), (4, 4, 128), (16, 2, 128)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's CPU torch runs: the suite runs
    several workers on the host's cores, and torch pools of a thread a core
    each starve one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, Hq, Hkv, C, hd, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, hd), dtype=np.float32),
            rng.standard_normal((B, Hkv, C, hd), dtype=np.float32),
            rng.standard_normal((B, Hkv, C, hd), dtype=np.float32))


@pytest.fixture
def need_jax():
    if jnp is None:
        pytest.skip("jax is not installed here")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("C,length", CASES)
@pytest.mark.parametrize("Hq,Hkv,hd", HEADS)
def test_decode_ref_matches_jax_oracle_and_pallas(need_jax, C, length, Hq, Hkv, hd):
    q, k, v = _inputs(2, Hq, Hkv, C, hd)
    got = decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), length).numpy()
    oracle = jax_ref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), jnp.int32(length))
    pallas = pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.int32(length), interpret=True)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("length", [3, np.array([2, 5])])
def test_decode_ref_length_forms_match_jax(need_jax, length):
    # ``length`` as a scalar or per sequence [B], as the JAX oracle accepts
    q, k, v = _inputs(2, 4, 2, 8, 64, seed=5)
    got = decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.as_tensor(length)).numpy()
    expect = jax_ref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), jnp.asarray(length))
    np.testing.assert_allclose(got, np.asarray(expect), rtol=2e-5, atol=2e-5)


def _decode_split_emulation(q, k, v, length, chunk):
    """The split-K decode kernels' algorithm in plain torch (fp32): each
    chunk of ``chunk`` cache slots gives a partial softmax (m in the log2
    domain, l, acc) over its slots below ``length``, an empty chunk (-1e30,
    0, 0); the partials merge in chunk order, l floored at 1e-30."""
    B, Hq, hd = q.shape
    Hkv, C = k.shape[1], k.shape[2]
    n = min(int(length), C)
    qs = (q.float() * (hd ** -0.5 * np.log2(np.e))).reshape(B, Hkv, Hq // Hkv, hd)
    parts = []
    for c0 in range(0, C, chunk):
        c1 = min(c0 + chunk, n)
        if c1 <= c0:
            parts.append((torch.full(qs.shape[:3], -1e30), torch.zeros(qs.shape[:3]),
                          torch.zeros(qs.shape)))
            continue
        s = torch.einsum("bhgd,bhcd->bhgc", qs, k[:, :, c0:c1].float())
        m = s.amax(-1)
        p = torch.exp2(s - m[..., None])
        parts.append((m, p.sum(-1), torch.einsum("bhgc,bhcd->bhgd", p, v[:, :, c0:c1].float())))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    den, num = torch.zeros_like(big), torch.zeros(qs.shape)
    for m, l, acc in parts:
        w = torch.exp2(m - big)
        den, num = den + l * w, num + acc * w[..., None]
    return (num / den.clamp_min(1e-30)[..., None]).reshape(B, Hq, hd).to(q.dtype)


def test_decode_split_chunk_depends_on_capacity_and_grid_only():
    # the chunk is a function of the capacity C alone: not of the batch, the
    # heads or the card, so a sequence's partials (and bits) do not depend on
    # the rest of its batch.  phi3's serve shape (B 4, 32 kv heads, G 1, C
    # 1024): 128-slot chunks, 8 of them, 1024 blocks, >= 4 on each of 132 SMs
    chunk = da.split_chunk(1024)
    assert (chunk, -(-1024 // chunk)) == (128, 8)
    assert 4 * 32 * -(-1024 // chunk) >= 4 * 132
    for C in (16, 64, 512, 1000, 2048, 32768):
        chunk = da.split_chunk(C)
        assert 0 < chunk <= C and (chunk == C or chunk % 32 == 0)
    # a cache of one chunk or less is one split
    assert [-(-C // da.split_chunk(C)) for C in (1, 16, 128)] == [1, 1, 1]


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("edge", ["first", "below", "at", "above", "full"])
def test_decode_split_merge_matches_jax_oracle_and_pallas(need_jax, G, edge):
    """The split-K kernels' algorithm (chunked partials merged in a fixed
    order), emulated at the chunk the kernel would take, over lengths 1, a
    chunk edge and one either side of it, and C, with GQA G 1, 4 and 8."""
    B, Hkv, C, hd = 2, 2, 256, 64
    q, k, v = _inputs(B, Hkv * G, Hkv, C, hd, seed=19)
    chunk = da.split_chunk(C)
    assert C // chunk >= 2
    length = {"first": 1, "below": chunk - 1, "at": chunk, "above": chunk + 1, "full": C}[edge]
    got = _decode_split_emulation(*(torch.from_numpy(a) for a in (q, k, v)), length, chunk)
    oracle = jax_ref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.int32(length))
    pallas = pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(length),
                           interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-5, atol=2e-5)


def test_ops_dispatch_cpu_goes_to_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 8, 2, 64, 64))
    before = ops.launch_counts()["decode_attention"]
    expect = decode_attention_ref(q, k, v, 40)
    for impl in ("auto", "ref"):
        out = ops.decode_attention(q, k, v, torch.tensor([40], dtype=torch.int32),
                                   impl=impl)
        assert torch.equal(out, expect)
    assert ops.launch_counts()["decode_attention"] == before
    with pytest.raises(ValueError, match="impl"):
        ops.decode_attention(q, k, v, 40, impl="pallas")


def test_launch_counter_reset():
    da.LAUNCHES = 7
    aw.LAUNCHES = 9
    fa.LAUNCHES = {"wgmma": 4, "tf32x3": 5, "simt": 2}
    fa.BWD_LAUNCHES = {"wgmma": 3, "tf32x3": 1, "simt": 2}
    sg.LAUNCHES = {"wgmma": 3, "tf32x3": 6, "simt": 1}
    sg.BWD_LAUNCHES = {"wgmma": 2, "tf32x3": 4, "simt": 1}
    assert ops.launch_counts() == {"decode_attention": 7, "adamw": 9, "flash_attention": 11,
                                   "flash_attention_bwd": 6, "flash_attention_wgmma": 4,
                                   "flash_attention_tf32x3": 5, "flash_attention_simt": 2,
                                   "flash_attention_bwd_wgmma": 3,
                                   "flash_attention_bwd_tf32x3": 1,
                                   "flash_attention_bwd_simt": 2, "swiglu": 10, "swiglu_bwd": 7,
                                   "swiglu_wgmma": 3, "swiglu_tf32x3": 6, "swiglu_simt": 1,
                                   "swiglu_bwd_wgmma": 2, "swiglu_bwd_tf32x3": 4,
                                   "swiglu_bwd_simt": 1}
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}
    assert da.LAUNCHES == aw.LAUNCHES == 0
    assert fa.LAUNCHES == fa.BWD_LAUNCHES == {"wgmma": 0, "tf32x3": 0, "simt": 0}
    assert sg.LAUNCHES == sg.BWD_LAUNCHES == {"wgmma": 0, "tf32x3": 0, "simt": 0}


def test_launch_counters_keep_every_count_across_threads():
    """The local backend's worker threads (and autograd's device thread)
    count launches at once: 8 threads x 2000 counts each through the
    wrappers' counting helper, with the interpreter switching threads as
    often as it can, lose none, and ``ops.launch_counts()`` read meanwhile
    never goes backwards."""
    import sys
    import threading

    from repro_torch.kernels import build as kbuild

    ops.reset_launch_counts()
    n_threads, per = 8, 2000
    interval = sys.getswitchinterval()
    seen, done = [], threading.Event()

    def count():
        for _ in range(per):
            kbuild.count_launch(fa.LAUNCHES, "wgmma")
            kbuild.count_launch(sg.BWD_LAUNCHES, "tf32x3")

    def read():
        while not done.is_set():
            seen.append(ops.launch_counts()["flash_attention_wgmma"])

    sys.setswitchinterval(1e-6)
    try:
        reader = threading.Thread(target=read)
        threads = [threading.Thread(target=count) for _ in range(n_threads)]
        reader.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        done.set()
        reader.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not reader.is_alive()
    counts = ops.launch_counts()
    assert counts["flash_attention_wgmma"] == counts["flash_attention"] == n_threads * per
    assert counts["swiglu_bwd_tf32x3"] == counts["swiglu_bwd"] == n_threads * per
    assert seen == sorted(seen)
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("bad", ["cpu", "dtype", "head_dim", "groups", "length"])
def test_cuda_wrapper_rejects_before_building(bad):
    # the checks run before nvcc is looked for, so they hold on any machine
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 8, 2, 64, 64))
    length = torch.tensor([3], dtype=torch.int32)
    if bad == "dtype":
        q = q.double()
    elif bad == "head_dim":
        q, k, v = q[..., :48], k[..., :48], v[..., :48]
    elif bad == "groups":
        q = q[:, :3]
    elif bad == "length":
        length = length.long()
    with pytest.raises(ValueError):
        da.decode_attention(q, k, v, length)


def test_decode_wrapper_rejects_misaligned_tensors():
    # the split pass loads 16 bytes at a time: q 4 bytes past a boundary
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 8, 2, 64, 64))
    q = torch.zeros(q.numel() + 1)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        da.decode_attention(q, k, v, torch.tensor([3], dtype=torch.int32))


def test_build_cache_hit_keeps_compiler_report(tmp_path, monkeypatch):
    """A library that is already built is not compiled again, and its nvcc
    report (ptxas registers and spills), kept beside it, is read back."""
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernel_build, "BUILD_INFO", {})
    monkeypatch.setattr(kernel_build, "_nvcc", lambda: pytest.fail("nvcc was called"))
    lib = kernel_build.library_path("swiglu")
    assert lib.parent == tmp_path and lib.suffix == ".so"
    lib.write_bytes(b"")
    report = "ptxas info    : Used 128 registers, 0 bytes spill stores, 0 bytes spill loads\n"
    lib.with_suffix(".log").write_text(report)
    info = kernel_build.build_all(["swiglu"])["swiglu"]
    assert info == dict(path=str(lib), seconds=0.0, cached=True, compiler_log=report)
    lib.with_suffix(".log").unlink()
    kernel_build.BUILD_INFO.clear()
    assert kernel_build.build_all(["swiglu"])["swiglu"]["compiler_log"] == ""


def test_build_header_edit_changes_library_path(tmp_path, monkeypatch):
    """A library's name hashes its source and every header of ``csrc/`` the
    source includes, so an edited shared header is never served from a
    stale cached library; a source that includes no header keeps its name."""
    for name in ("flash_attention", "swiglu", "decode_attention"):
        (tmp_path / f"{name}.cu").write_bytes((kernel_build.CSRC / f"{name}.cu").read_bytes())
    header = tmp_path / "hopper.cuh"
    header.write_bytes((kernel_build.CSRC / "hopper.cuh").read_bytes())
    monkeypatch.setattr(kernel_build, "CSRC", tmp_path)
    assert kernel_build.sources_of(tmp_path / "swiglu.cu") == [tmp_path / "swiglu.cu", header]
    before = {n: kernel_build.library_path(n) for n in ("flash_attention", "swiglu",
                                                         "decode_attention")}
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: kernel_build.library_path(n) for n in before}
    assert after["flash_attention"] != before["flash_attention"]
    assert after["swiglu"] != before["swiglu"]
    assert after["decode_attention"] == before["decode_attention"]


def test_capability_probe():
    ok = dict(n_q_heads=8, n_kv_heads=2, capacity=512)
    assert ops.decode_attention_capable(**ok)
    assert ops.decode_attention_capable(**{**ok, "capacity": 64})
    assert ops.decode_attention_capable(**{**ok, "capacity": 1024})
    # the split-K kernel's last chunk may be short: any capacity
    assert ops.decode_attention_capable(**{**ok, "capacity": 520})
    assert ops.decode_attention_capable(**{**ok, "capacity": 1040})
    assert not ops.decode_attention_capable(**{**ok, "window": 128})
    assert not ops.decode_attention_capable(**{**ok, "seq_shards": 2})
    assert not ops.decode_attention_capable(n_q_heads=6, n_kv_heads=4, capacity=512)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, tol):
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = [(2, Hq, Hkv, C, hd, length) for C, length in CASES
              for Hq, Hkv, hd in HEADS]
    shapes += [(4, 32, 32, 1024, 96, n) for n in (1, 700, 1024)]   # phi3 decode
    # jamba's decode: G 4 at hd 128 over 1024 + 16 slots (a short last chunk)
    shapes += [(4, 32, 8, 1040, 128, n) for n in (1, 1024, 1025, 1040)]
    for B, Hq, Hkv, C, hd, length in shapes:
        q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
                   for a in _inputs(B, Hq, Hkv, C, hd))
        L = torch.tensor([length], dtype=torch.int32, device=cuda_device)
        out = ops.decode_attention(q, k, v, L)
        expect = ops.decode_attention(q, k, v, L, impl="ref")
        torch.testing.assert_close(out.float(), expect.float(), rtol=tol, atol=tol)
    torch.cuda.synchronize()



@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_cuda_decode_split_edges_match_plain_and_repeat_bits(cuda_device, dtype, tol):
    """The split pass's edges: lengths at a chunk's edges and past C, G 1, 4
    and 8; two calls give the same bits, and ``length`` is read on the card
    (the same launch arguments with another length on the device)."""
    B, Hkv, C, hd = 2, 2, 1024, 128
    for G in (1, 4, 8):
        q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
                   for a in _inputs(B, Hkv * G, Hkv, C, hd))
        chunk = da.split_chunk(C)
        L = torch.zeros(1, dtype=torch.int32, device=cuda_device)
        for length in (1, chunk - 1, chunk, chunk + 1, 2 * chunk, C - 1, C, C + 5):
            L.fill_(length)
            out = ops.decode_attention(q, k, v, L)
            torch.testing.assert_close(out.float(), ops.decode_attention(
                q, k, v, L, impl="ref").float(), rtol=tol, atol=tol,
                msg=f"G={G} length={length} chunk={chunk} {dtype}")
            assert torch.equal(out, ops.decode_attention(q, k, v, L)), f"G={G} length={length}"
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_split_is_batch_invariant(cuda_device, dtype):
    """A sequence decoded alone and in a batch of 4 gives the same bits: the
    chunk and the heads a block depend on neither the batch nor the card."""
    B, Hkv, G, C, hd = 4, 2, 4, 1024, 128
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _inputs(B, Hkv * G, Hkv, C, hd))
    L = torch.tensor([700], dtype=torch.int32, device=cuda_device)
    batch = ops.decode_attention(q, k, v, L)
    for b in range(B):
        alone = ops.decode_attention(q[b:b + 1].contiguous(), k[b:b + 1].contiguous(),
                                     v[b:b + 1].contiguous(), L)
        assert torch.equal(alone[0], batch[b]), f"sequence {b} {dtype}"


@pytest.mark.cuda
def test_cuda_decode_heads_per_block_rule(cuda_device):
    """The query heads a split-pass block takes (the CUDA source's rule): the
    group rounded up to a power of two while a lane's accumulators hold them,
    and one head a block for fp32 at hd 256."""
    heads = da.build().repro_decode_attention_heads
    assert [heads(96, 1, G) for G in (1, 2, 4, 5, 8)] == [1, 2, 2, 2, 2]
    assert [heads(64, 0, G) for G in (1, 3, 5, 8)] == [1, 4, 8, 8]
    assert [heads(256, 0, G) for G in (1, 2, 8)] == [1, 1, 1]
    assert [heads(256, 1, G) for G in (1, 2, 8)] == [1, 2, 2]
    assert heads(80, 0, 1) == -1


# ------------------------------------------------------------ flash attention
# (S, Hq, Hkv, hd) of tests/test_kernels.py::test_flash_attention_shapes
FLASH_SHAPES = [(128, 4, 4, 64), (256, 8, 2, 64), (256, 4, 1, 128), (128, 2, 2, 96),
                (384, 8, 4, 256)]
FLASH_WINDOWS = [64, 128, 1024]       # test_flash_attention_window: B 1, S 256, 4/2 heads of 64
FLASH_NONCAUSAL = (2, 128, 4, 4, 80)  # test_flash_attention_noncausal: B, S, Hq, Hkv, hd
SWIGLU_SHAPES = [(256, 256, 512), (512, 512, 2048), (128, 384, 1536)]


def _tol(dtype):
    # tests/test_kernels.py:15
    return 2e-2 if dtype in (torch.bfloat16, "bfloat16") else 2e-5


def _qkv(B, S, Hq, Hkv, hd, seed=42):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hq, hd), dtype=np.float32),
            rng.standard_normal((B, S, Hkv, hd), dtype=np.float32),
            rng.standard_normal((B, S, Hkv, hd), dtype=np.float32))


def _swiglu_inputs(T, d, f, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, d), dtype=np.float32),
            (0.05 * rng.standard_normal((d, f))).astype(np.float32),
            (0.05 * rng.standard_normal((d, f))).astype(np.float32))


def _flash_cases():
    cases = [(2, S, Hq, Hkv, hd, True, 0) for S, Hq, Hkv, hd in FLASH_SHAPES]
    cases += [(1, 256, 4, 2, 64, True, w) for w in FLASH_WINDOWS]
    B, S, Hq, Hkv, hd = FLASH_NONCAUSAL
    return cases + [(B, S, Hq, Hkv, hd, False, 0)]


def _bf16_np(a):
    """numpy fp32 -> the bf16 values both frameworks round it to, as fp32."""
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window", _flash_cases())
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_matches_jax_oracle(need_jax, B, S, Hq, Hkv, hd, causal, window, dtype):
    q, k, v = _qkv(B, S, Hq, Hkv, hd)
    tdt = getattr(torch, dtype)
    got = flash_attention_ref(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                              causal=causal, window=window)
    expect = jax_ref.flash_attention_ref(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                                         causal=causal, window=window)
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(expect, np.float32),
                               rtol=tol, atol=tol)


def test_flash_ref_matches_pallas_interpret(need_jax):
    q, k, v = _qkv(2, 256, 8, 2, 64)
    got = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    pallas = pallas_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=True, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window", [
    (2, 128, 4, 4, 64, True, 0), (2, 64, 8, 2, 64, True, 0), (1, 96, 4, 2, 96, True, 32),
    (2, 48, 4, 4, 80, False, 0)])
def test_flash_ref_grads_match_jax_vjp(need_jax, B, S, Hq, Hkv, hd, causal, window):
    q, k, v = _qkv(B, S, Hq, Hkv, hd, seed=7)
    do = np.random.default_rng(8).standard_normal(q.shape, dtype=np.float32)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention_ref(*ts, causal=causal, window=window)
    got = torch.autograd.grad(out, ts, torch.from_numpy(do))
    _, vjp = jax.vjp(lambda a, b, c: jax_ref.flash_attention_ref(
        a, b, c, causal=causal, window=window), *(jnp.asarray(a) for a in (q, k, v)))
    for g, e in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4, atol=1e-4)


def _tf32(a):
    """fp32 -> TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest on the 13 low
    bits of the pattern, ties away from zero (the sign lies apart from the
    magnitude bits, so a carry rounds the magnitude up)."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(a, b, products):
    """a @ b in fp32 as the tf32x3 kernels take it: each operand split into
    hi = tf32(x) and lo = tf32(x - hi), and the TF32 products lo hi + hi lo +
    hi hi summed into one fp32 accumulator (``products`` 3), or hi hi alone
    (``products`` 1, plain TF32)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if products == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _flash_tf32(q, k, v, do, products):
    """Causal attention and its gradients ([H, S, hd] fp32) with every
    product of the tf32x3 kernels emulated: S = Q K^T and O = P V forward,
    S, dP = dO V^T, dV = P^T dO, dK = dS^T Q and dQ = dS K backward; the
    softmax, D = rowsum(dO O) and dS = P (dP - D) in fp32."""
    S, hd = q.shape[1], q.shape[2]
    scale = np.float32(hd ** -0.5)
    allow = np.tril(np.ones((S, S), dtype=bool))
    s = _tf32_matmul(q, k.transpose(0, 2, 1), products)
    z = np.where(allow, s * scale, -np.inf)
    m = z.max(-1, keepdims=True)
    p = np.exp(z - m)
    l = p.sum(-1, keepdims=True)
    o = _tf32_matmul(p, v, products) / l
    lse = m + np.log(l)
    d = (do * o).sum(-1, keepdims=True)
    p = np.where(allow, np.exp(s * scale - lse), np.float32(0))
    ds = p * (_tf32_matmul(do, v.transpose(0, 2, 1), products) - d)
    dv = _tf32_matmul(p.transpose(0, 2, 1), do, products)
    dk = _tf32_matmul(ds.transpose(0, 2, 1), q, products) * scale
    dq = _tf32_matmul(ds, k, products) * scale
    return o, (dq, dk, dv)


def _trunc32(v):
    """float64 -> fp32 rounded toward zero, as the tensor cores' fp32
    accumulation adds: rounded to nearest, then one step toward zero where
    that went past ``v``."""
    r = v.astype(np.float32)
    r.view(np.uint32)[...] -= (np.abs(r) > np.abs(v)).astype(np.uint32)
    return r


#: k of a fresh accumulator in the swiglu tf32x3 kernel: one 32-wide k-tile
SWIGLU_K_REFRESH = 32


def _tf32x3_truncating(a, b, k_refresh):
    """a [..., M, K] @ b [..., K, N] as the tf32x3 wgmma kernels sum it: per
    k8 step three TF32 products (lo hi, hi lo, hi hi), each added to an fp32
    accumulator that truncates toward zero (the sum over the k8 step
    exact); every ``k_refresh`` of k the accumulator starts afresh and is
    added to the running sum with round-to-nearest fp32 adds (``k_refresh``
    >= K: one accumulator throughout)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    pairs = [(x.astype(np.float64), y.astype(np.float64))
             for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))]
    K = a.shape[-1]
    shape = np.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (a.shape[-2], b.shape[-1])
    running = np.zeros(shape, dtype=np.float32)
    for r0 in range(0, K, k_refresh):
        acc = np.zeros_like(running)
        for k0 in range(r0, min(r0 + k_refresh, K), 8):
            for x, y in pairs:
                acc = _trunc32(acc + x[..., k0:k0 + 8] @ y[..., k0:k0 + 8, :])
        running = running + acc
    return running


#: the hd-256 tf32x3 kernels' fresh-accumulator intervals
#: (csrc/flash_attention.cu, namespace x3w): head-dim columns of the scores
#: S = Q K^T forward (kScoreRefreshFwd) and of S and dP backward
#: (kScoreRefreshBwd), keys of O = P V (kPvRefresh), and rows of the
#: gradient products dV, dK (q rows) and dQ (keys) (kGradRefresh)
FLASH_HD256_REFRESH = dict(scores_fwd=128, scores_bwd=32, pv=32, grads=64)


def _flash_tf32x3_hd256(q, k, v, do):
    """Causal attention and its gradients ([H, S, 256] fp32) as the hd-256
    tf32x3 kernels sum them: every product by :func:`_tf32x3_truncating` at
    the kernels' refresh intervals (the gradients taken transposed, as the
    backward passes take them: dV^T = dO^T P, dK^T = Q^T dS, dQ^T = K^T dS^T);
    the softmax, D = rowsum(dO O) and dS = P (dP - D) in fp32."""
    r = FLASH_HD256_REFRESH
    S, hd = q.shape[1], q.shape[2]
    scale = np.float32(hd ** -0.5)
    allow = np.tril(np.ones((S, S), dtype=bool))
    kt, qt, dot = (a.transpose(0, 2, 1) for a in (k, q, do))
    s = _tf32x3_truncating(q, kt, r["scores_fwd"])
    z = np.where(allow, s * scale, -np.inf)
    m = z.max(-1, keepdims=True)
    p = np.exp(z - m)
    l = p.sum(-1, keepdims=True)
    o = _tf32x3_truncating(p, v, r["pv"]) / l
    lse = m + np.log(l)
    d = (do * o).sum(-1, keepdims=True)
    s = _tf32x3_truncating(q, kt, r["scores_bwd"])
    p = np.where(allow, np.exp(s * scale - lse), np.float32(0))
    ds = p * (_tf32x3_truncating(do, v.transpose(0, 2, 1), r["scores_bwd"]) - d)
    dv = _tf32x3_truncating(dot, p, r["grads"]).transpose(0, 2, 1)
    dk = _tf32x3_truncating(qt, ds, r["grads"]).transpose(0, 2, 1) * scale
    dq = _tf32x3_truncating(kt, ds.transpose(0, 2, 1), r["grads"]).transpose(0, 2, 1) * scale
    return o, (dq, dk, dv)


@pytest.mark.parametrize("hd", [96, 256])
def test_flash_tf32x3_arithmetic_holds_fp32_tolerances(need_jax, hd):
    """The tf32x3 route's arithmetic, emulated on the CPU, holds the fp32 bars
    against the JAX oracle: 2e-5 on the output, 1e-4 on the gradients
    against ``jax.vjp``.  hd 96: phi3-mini's attention shape (S 1024,
    causal; 4 of its heads), the mma.sync kernels' products rounded to
    nearest.  hd 256: gemma3-4b's heads (S 1024, causal, 2 heads), the
    wgmma kernels' summation (truncating accumulators refreshed at
    ``FLASH_HD256_REFRESH``).  One TF32 product misses 2e-5, which is why
    the kernels take three."""
    B, S, H = 1, 1024, 4 if hd == 96 else 2
    q, k, v = _qkv(B, S, H, H, hd, seed=15)
    do = np.random.default_rng(16).standard_normal(q.shape, dtype=np.float32)
    heads = [a[0].transpose(1, 0, 2).copy() for a in (q, k, v, do)]   # [H, S, hd]
    want, vjp = jax.vjp(lambda a, b, c: jax_ref.flash_attention_ref(a, b, c, causal=True),
                        *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(do))

    def bshd(a):
        return a.transpose(1, 0, 2)[None]

    o, grads = _flash_tf32(*heads, products=3) if hd == 96 else _flash_tf32x3_hd256(*heads)
    assert o.dtype == np.float32
    np.testing.assert_allclose(bshd(o), np.asarray(want), rtol=2e-5, atol=2e-5)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(bshd(g), np.asarray(w), rtol=1e-4, atol=1e-4)
    o1, _ = _flash_tf32(*heads, products=1)
    assert np.abs(bshd(o1) - np.asarray(want)).max() > 2e-5


def _swiglu_tf32x3(x, wg, wu, dout, k_refresh):
    """The tf32x3 route's forward and backward kernels emulated (g and u by
    :func:`_tf32x3_truncating`, the epilogues in fp32), then the chain
    rule's three products in fp32: (out, (dx, dw_gate, dw_up))."""
    g, u = (_tf32x3_truncating(x, w, k_refresh) for w in (wg, wu))
    sig = np.float32(1) / (np.float32(1) + np.exp(-g))
    out = g * sig * u
    dg = dout * u * (sig * (np.float32(1) + g * (np.float32(1) - sig)))
    du = dout * (g * sig)
    return out, (dg @ wg.T + du @ wu.T, x.T @ dg, x.T @ du)


def test_swiglu_tf32x3_arithmetic_holds_fp32_tolerances(need_jax):
    """The swiglu tf32x3 route's arithmetic, emulated on the CPU at phi3's
    width (T 64 rows, d 3072, f 256 of its 8192 columns), with truncating
    accumulators refreshed every k-tile: the output within 2e-5 of the JAX
    oracle and the gradients within 1e-4 of ``jax.vjp``.  One accumulator
    over all of d (1,152 truncating adds) is measurably worse, which is why
    the kernel refreshes it."""
    T, d, f = 64, 3072, 256
    x, wg, wu = _swiglu_inputs(T, d, f, seed=17)
    dout = np.random.default_rng(18).standard_normal((T, f), dtype=np.float32)
    want, vjp = jax.vjp(jax_ref.swiglu_ref, *(jnp.asarray(a) for a in (x, wg, wu)))
    want_grads = vjp(jnp.asarray(dout))
    out, grads = _swiglu_tf32x3(x, wg, wu, dout, SWIGLU_K_REFRESH)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, np.asarray(want), rtol=2e-5, atol=2e-5)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)
    exact = (x.astype(np.float64) @ wg.astype(np.float64))
    refreshed = np.abs(_tf32x3_truncating(x, wg, SWIGLU_K_REFRESH) - exact).max()
    once = np.abs(_tf32x3_truncating(x, wg, d) - exact).max()
    assert once > 4 * refreshed, (once, refreshed)


# -------------------------------------------------------------------- swiglu
@pytest.mark.parametrize("T,d,f", SWIGLU_SHAPES + [(100, 256, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_ref_matches_jax_oracle(need_jax, T, d, f, dtype):
    x, wg, wu = _swiglu_inputs(T, d, f)
    got = swiglu_ref(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, wg, wu)))
    expect = jax_ref.swiglu_ref(*(jnp.asarray(a, dtype) for a in (x, wg, wu)))
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(expect, np.float32),
                               rtol=tol, atol=tol)


def test_swiglu_ref_matches_pallas_interpret(need_jax):
    x, wg, wu = _swiglu_inputs(256, 256, 512)
    got = swiglu_ref(*(torch.from_numpy(a) for a in (x, wg, wu)))
    pallas = pallas_swiglu(*(jnp.asarray(a) for a in (x, wg, wu)), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("T,d,f", SWIGLU_SHAPES + [(100, 256, 512)])
def test_swiglu_ref_grads_match_jax_vjp(need_jax, T, d, f):
    x, wg, wu = _swiglu_inputs(T, d, f, seed=9)
    dout = np.random.default_rng(10).standard_normal((T, f), dtype=np.float32)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, wg, wu)]
    got = torch.autograd.grad(swiglu_ref(*ts), ts, torch.from_numpy(dout))
    _, vjp = jax.vjp(jax_ref.swiglu_ref, *(jnp.asarray(a) for a in (x, wg, wu)))
    for g, e in zip(got, vjp(jnp.asarray(dout))):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4, atol=1e-4)


def test_swiglu_bwd_ref_chains_to_autograd_of_swiglu_ref():
    """The backward kernel's plain version (dg, du), through the three matrix
    products of ``kernels.swiglu.SwiGLU.backward``, gives autograd's
    gradients of the plain forward."""
    x, wg, wu = (torch.from_numpy(a) for a in _swiglu_inputs(100, 256, 512, seed=11))
    dout = torch.from_numpy(np.random.default_rng(12).standard_normal((100, 512),
                                                                      dtype=np.float32))
    dg, du = swiglu_bwd_ref(x, wg, wu, dout)
    ts = [t.clone().requires_grad_() for t in (x, wg, wu)]
    want = torch.autograd.grad(swiglu_ref(*ts), ts, dout)
    got = (dg @ wg.T + du @ wu.T, x.T @ dg, x.T @ du)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


# -------------------------------------------------- dispatch and input checks
def test_ops_dispatch_cpu_training_kernels_go_to_plain_versions():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 4, 2, 64))
    x, wg, wu = (torch.from_numpy(a) for a in _swiglu_inputs(2 * 24, 64, 128))
    before = ops.launch_counts()
    for impl in ("auto", "ref"):
        assert torch.equal(ops.flash_attention(q, k, v, window=16, impl=impl),
                           flash_attention_ref(q, k, v, window=16))
        got = ops.swiglu(x.reshape(2, 24, 64), wg, wu, impl=impl)
        assert got.shape == (2, 24, 128)
        assert torch.equal(got.reshape(48, 128), swiglu_ref(x, wg, wu))
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        ops.swiglu(x, wg, wu, impl="triton")


@pytest.mark.parametrize("bad,match", [("cpu", "CUDA"), ("dtype", "dtypes"),
                                       ("head_dim", "head dim"), ("groups", "match"),
                                       ("noncontiguous", "contiguous")])
def test_flash_wrapper_rejects_before_building(bad, match):
    # the checks run before nvcc is looked for, so they hold on any machine
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 8, 2, 64))
    if bad == "dtype":
        q = q.double()
    elif bad == "head_dim":
        q, k, v = (torch.zeros(*t.shape[:3], 48) for t in (q, k, v))
    elif bad == "groups":
        q = q[:, :, :3].contiguous()
    elif bad == "noncontiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_fwd(q, k, v)
    o, lse = torch.zeros_like(q), torch.zeros(q.shape[0], q.shape[2], q.shape[1])
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_bwd(q, k, v, o, lse, o)


@pytest.mark.parametrize("bad,match", [("cpu", "CUDA"), ("dtype", "dtypes"),
                                       ("shape", "expected"),
                                       ("noncontiguous", "contiguous")])
def test_swiglu_wrapper_rejects_before_building(bad, match):
    x, wg, wu = (torch.from_numpy(a) for a in _swiglu_inputs(40, 64, 128))
    if bad == "dtype":
        wg = wg.bfloat16()
    elif bad == "shape":
        wu = wu[:, :64]
    elif bad == "noncontiguous":
        wg = wg.T.contiguous().T
    with pytest.raises(ValueError, match=match):
        sg.swiglu_fwd(x, wg, wu)
    with pytest.raises(ValueError, match=match):
        sg.swiglu_bwd(x, wg, wu, torch.zeros(40, 128, dtype=x.dtype))


@pytest.mark.parametrize("offset", [0, 2, 16])
@pytest.mark.parametrize("d,f", [(3072, 8192), (200, 520), (196, 512), (256, 300), (198, 512),
                                 (256, 302)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_swiglu_route(dtype, d, f, offset):
    """With 16-byte aligned pointers (TMA's rules), wgmma for bf16 with d and
    f multiples of 8 and tf32x3 for fp32 with d and f multiples of 4;
    everything else takes the simt kernel."""
    base = torch.empty(64, dtype=torch.bfloat16).data_ptr()   # 64-byte aligned or more
    ptrs = (base, base + 256, base + 512 + offset)
    want = "simt"
    if offset % 16 == 0:
        if dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0:
            want = "wgmma"
        elif dtype == torch.float32 and d % 4 == 0 and f % 4 == 0:
            want = "tf32x3"
    assert sg.route(dtype, d, f, *ptrs) == want


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "qwen2.5-14b"])
def test_swiglu_route_takes_every_config_in_bf16(arch):
    for cfg in (get_config(arch), get_config(arch).reduced()):
        x = torch.empty(3, cfg.d_model, dtype=torch.bfloat16)
        w = torch.empty(cfg.d_model, cfg.d_ff, dtype=torch.bfloat16)
        assert sg.route(torch.bfloat16, cfg.d_model, cfg.d_ff, x[1:].data_ptr(),
                        w.data_ptr(), w.data_ptr()) == "wgmma"


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "qwen2.5-14b"])
def test_swiglu_route_takes_every_config_in_fp32(arch):
    # the reduced configs are fp32 (train_reduced's route); the full widths
    # in fp32 are train_fp32's
    for cfg in (get_config(arch), get_config(arch).reduced()):
        x = torch.empty(3, cfg.d_model)
        w = torch.empty(cfg.d_model, cfg.d_ff)
        assert sg.route(torch.float32, cfg.d_model, cfg.d_ff, x[1:].data_ptr(),
                        w.data_ptr(), w.data_ptr()) == "tf32x3"


@pytest.mark.parametrize("offset", [0, 2, 16])
@pytest.mark.parametrize("hd", [64, 80, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_route(dtype, hd, offset):
    """With 16-byte aligned pointers, wgmma for bf16 at every head dim (TMA's
    rules) and tf32x3 for fp32 at every head dim (16-byte loads: mma.sync at
    hd 64-128, wgmma after the split pass at hd 256); misaligned tensors
    take the simt kernels."""
    base = torch.empty(64, dtype=torch.bfloat16).data_ptr()   # 64-byte aligned or more
    ptrs = (base, base + 256, base + 512 + offset, base + 1024)
    if offset % 16:
        want = "simt"
    else:
        want = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    assert fa.route(dtype, hd, *ptrs) == want


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "qwen2.5-14b", "gemma3-4b"])
def test_flash_route_takes_every_config_in_bf16(arch):
    # phi3 hd 96, qwen2.5 hd 128, gemma3 hd 256, the reduced configs hd 64
    for cfg in (get_config(arch), get_config(arch).reduced()):
        q = torch.empty(1, 3, cfg.n_heads, cfg.head_dim, dtype=torch.bfloat16)
        kv = torch.empty(1, 3, cfg.n_kv_heads, cfg.head_dim, dtype=torch.bfloat16)
        assert fa.route(torch.bfloat16, cfg.head_dim, q[:, 1:].data_ptr(), kv.data_ptr(),
                        kv[:, 2:].data_ptr()) == "wgmma"


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "qwen2.5-14b", "gemma3-4b"])
def test_flash_route_takes_every_config_in_fp32(arch):
    # the reduced configs are fp32 (train_reduced's route), hd 64; the full
    # widths in fp32 hd 96 (train_fp32's route), 128 and 256 (train_gemma_fp32's)
    for cfg in (get_config(arch), get_config(arch).reduced()):
        q = torch.empty(1, 3, cfg.n_heads, cfg.head_dim)
        kv = torch.empty(1, 3, cfg.n_kv_heads, cfg.head_dim)
        assert fa.route(torch.float32, cfg.head_dim, q[:, 1:].data_ptr(), kv.data_ptr(),
                        kv[:, 2:].data_ptr()) == "tf32x3"


@pytest.mark.parametrize("S", [2048, 200, 64, 1])
@pytest.mark.parametrize("B,Hq,Hkv", [(1, 8, 4), (2, 4, 1)])
def test_flash_tf32x3_workspace_size(B, S, Hq, Hkv):
    """The hd-256 tf32x3 route's split planes, hi and lo of each: forward Q
    and K natural, V transposed; backward Q, dO, K and V natural, Q, dO and
    K transposed, the transposed planes' S padded with zeros to a multiple of
    64 (ragged S 200 -> 256, 1 -> 64).  Below hd 256 there is none."""
    s_pad = {2048: 2048, 200: 256, 64: 64, 1: 64}[S]
    assert fa.TF32X3_PAD == 64 and -(-S // 64) * 64 == s_pad
    nq, nk = B * S * Hq * 256, B * S * Hkv * 256
    nqt, nkt = B * Hq * 256 * s_pad, B * Hkv * 256 * s_pad
    fwd = fa.workspace(B, S, Hq, Hkv, 256, backward=False, device="meta")
    bwd = fa.workspace(B, S, Hq, Hkv, 256, backward=True, device="meta")
    assert fwd.dtype == bwd.dtype == torch.float32
    assert fwd.numel() == 2 * nq + 2 * nk + 2 * nkt
    assert bwd.numel() == 4 * nq + 4 * nk + 4 * nqt + 2 * nkt
    for backward in (False, True):
        assert fa.workspace(B, S, Hq, Hkv, 128, backward=backward, device="meta").numel() == 0
    if (B, S, Hq, Hkv) == (1, 2048, 8, 4):   # gemma3-4b's training shape: ~67 and ~184 MB
        assert (4 * fwd.numel(), 4 * bwd.numel()) == (67_108_864, 184_549_376)


class _RecordingLib:
    """Stands in for ``kernels.build.load``'s library: records each entry
    point's name and arguments, and the argument types it was bound with."""

    def __init__(self):
        self.calls, self.argtypes = [], {}

    def load(self, name, functions):
        self.argtypes.update(functions)
        return self

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("dtype,d,f,offset,way", [(torch.bfloat16, 64, 128, 0, "wgmma"),
                                                  (torch.bfloat16, 60, 128, 0, "simt"),
                                                  (torch.float32, 64, 128, 0, "tf32x3"),
                                                  (torch.float32, 62, 128, 0, "simt"),
                                                  (torch.float32, 64, 128, 1, "simt")])
def test_swiglu_wrappers_launch_and_count_by_route(monkeypatch, dtype, d, f, offset, way):
    # the CUDA checks and the library are stood in for, so the CPU can run
    # the wrappers' routing, argument lists and counting
    lib = _RecordingLib()
    monkeypatch.setattr(sg._build, "load", lib.load)
    monkeypatch.setattr(sg, "_check", lambda *tensors: None)
    monkeypatch.setattr(sg._build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    # x `offset` elements past an aligned allocation: 16-byte aligned or not
    x = torch.zeros(40 * d + offset, dtype=dtype)[offset:].view(40, d)
    wg, wu = (torch.zeros(d, f, dtype=dtype) for _ in range(2))
    ops.reset_launch_counts()
    for _ in range(2):
        assert sg.swiglu_fwd(x, wg, wu).shape == (40, f)
    dg, du = sg.swiglu_bwd(x, wg, wu, torch.zeros(40, f, dtype=dtype))
    assert dg.shape == du.shape == (40, f)
    name = "repro_swiglu" if way == "simt" else f"repro_swiglu_{way}"
    assert [n for n, _ in lib.calls] == [f"{name}_fwd"] * 2 + [f"{name}_bwd"]
    for n, args in lib.calls:   # every call matches the arity it was bound with
        assert len(args) == len(lib.argtypes[n]), n
        dims = args[-5:-2] if way == "simt" else args[-4:-1]   # simt passes its dtype too
        assert dims == (40, d, f), n
    if way == "tf32x3":   # the split planes' workspace follows the tensors
        ws = lib.calls[0][1][4]
        assert isinstance(ws, int) and ws % 16 == 0
    counts = ops.launch_counts()
    assert (counts["swiglu"], counts["swiglu_bwd"]) == (2, 1)
    assert (counts[f"swiglu_{way}"], counts[f"swiglu_bwd_{way}"]) == (2, 1)
    for other in set(sg.ROUTES) - {way}:
        assert (counts[f"swiglu_{other}"], counts[f"swiglu_bwd_{other}"]) == (0, 0), other
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("dtype,hd,offset,way", [(torch.bfloat16, 96, 0, "wgmma"),
                                                 (torch.bfloat16, 256, 0, "wgmma"),
                                                 (torch.bfloat16, 256, 1, "simt"),
                                                 (torch.float32, 96, 0, "tf32x3"),
                                                 (torch.float32, 96, 1, "simt"),
                                                 (torch.float32, 256, 0, "tf32x3"),
                                                 (torch.float32, 256, 1, "simt")])
def test_flash_wrappers_launch_and_count_by_route(monkeypatch, dtype, hd, offset, way):
    # the CUDA checks and the library are stood in for, so the CPU can run
    # the wrappers' routing, argument lists and counting
    lib = _RecordingLib()
    monkeypatch.setattr(fa._build, "load", lib.load)
    monkeypatch.setattr(fa, "_check", lambda *tensors: None)
    monkeypatch.setattr(fa._build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    # q `offset` elements past an aligned allocation: 16-byte aligned or not
    q = torch.zeros(2 * 40 * 8 * hd + offset, dtype=dtype)[offset:].view(2, 40, 8, hd)
    k = v = torch.zeros(2, 40, 2, hd, dtype=dtype)
    ops.reset_launch_counts()
    for _ in range(2):
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=16)
    assert o.shape == q.shape and lse.shape == (2, 8, 40) and lse.dtype == torch.float32
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, torch.zeros_like(q))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    prefix = "repro_flash_attention" if way == "simt" else f"repro_flash_{way}"
    assert [name for name, _ in lib.calls] == [f"{prefix}_fwd"] * 2 + [f"{prefix}_bwd"]
    for name, args in lib.calls:   # every call matches the arity it was bound with
        assert len(args) == len(lib.argtypes[name]), name
    # (B, S, Hq, Hkv, hd) follow the pointers; the tensor-core backwards also
    # pass their D scratch, the wgmma and simt routes the keys' means (their
    # dQ passes' correction), the tf32x3 route its split planes' workspace
    # (last of the pointers: at hd 256 an allocation of workspace()'s size,
    # below it none), the simt kernels the dtype code
    n_ptrs = {"repro_flash_wgmma_fwd": 5, "repro_flash_wgmma_bwd": 11,
              "repro_flash_tf32x3_fwd": 6, "repro_flash_tf32x3_bwd": 11,
              "repro_flash_attention_fwd": 5, "repro_flash_attention_bwd": 10}
    for name, args in lib.calls:
        assert args[n_ptrs[name]:n_ptrs[name] + 5] == (2, 40, 8, 2, hd), name
        if way == "tf32x3":
            ws = args[n_ptrs[name] - 1]
            assert (ws != 0 and ws % 16 == 0) if hd == 256 else ws == 0, (name, ws)
    assert lib.calls[0][1][-2] == pytest.approx(hd ** -0.5)
    counts = ops.launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_bwd"]) == (2, 1)
    assert (counts[f"flash_attention_{way}"], counts[f"flash_attention_bwd_{way}"]) == (2, 1)
    for other in set(fa.ROUTES) - {way}:
        assert (counts[f"flash_attention_{other}"],
                counts[f"flash_attention_bwd_{other}"]) == (0, 0), other
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


# ----------------------------------------------------------- on the card
def _grads(fn, inputs, dout):
    ts = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*ts)
    return out.detach(), torch.autograd.grad(out, ts, dout)


def _assert_grads_close(got, want, dtype, what):
    for name, g, w in zip("abc", got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=f"{what} grad {name}")
        else:   # 2e-2 x max|ref| in bf16
            tol = 2e-2 * float(w.float().abs().max())
            err = float((g.float() - w.float()).abs().max())
            assert err <= tol, f"{what} grad {name}: max |err| {err} > {tol}"


@pytest.mark.cuda
def test_cuda_flash_wgmma_probe_matches_matmul(cuda_device):
    """The wgmma route's descriptors and fragment layouts alone, on one tile:
    S = Q K^T (fp32 out) against an fp32 matrix product of the same bf16
    inputs, and O = bf16(S) V against the product of the kernel's own S,
    rounded alike.  hd 96 (two boxes, the second partly zeros) and 128 at
    64 and 128 keys (the backward's and the forward's tiles); hd 256 (four
    boxes, O in two 128-column chunks) at 32 keys (the dQ pass's tiles) and
    64 (the forward's and the dK/dV pass's)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = fa.build()
    rng = np.random.default_rng(13)
    for hd, bks in ((96, (64, 128)), (128, (64, 128)), (256, (32, 64))):
        for bk in bks:
            q, k, v = (torch.from_numpy(rng.standard_normal((rows, hd), dtype=np.float32))
                       .to(cuda_device, torch.bfloat16) for rows in (64, bk, bk))
            s = torch.full((64, bk), float("nan"), device=cuda_device)
            o = torch.full((64, hd), float("nan"), device=cuda_device)
            err = lib.repro_flash_wgmma_probe(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                              s.data_ptr(), o.data_ptr(), hd, bk,
                                              kernel_build.stream_of(q))
            assert err == 0, f"launch failed: cudaError {err}"
            torch.cuda.synchronize()
            what = f"hd={hd} bk={bk}"
            torch.testing.assert_close(s, q.float() @ k.float().T, rtol=1e-3, atol=1e-3,
                                       msg=f"S {what}")
            torch.testing.assert_close(o, s.bfloat16().float() @ v.float(), rtol=1e-3,
                                       atol=1e-2, msg=f"PV {what}")


@pytest.mark.cuda
def test_cuda_flash_tf32x3_probe_matches_matmul(cuda_device):
    """The tf32x3 route's planes, fragment layouts and permutation alone, on
    one 16-row tile: S = Q K^T against an fp32 matrix product with TF32 off,
    and O = S V against the product of the kernel's own S, both at bars that
    one TF32 product would miss.  hd 96 and 128, 32 keys (the forward's
    tile)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = fa.build()
    rng = np.random.default_rng(14)
    for hd in (96, 128):
        q, k, v = (torch.from_numpy(rng.standard_normal((rows, hd), dtype=np.float32))
                   .to(cuda_device) for rows in (16, 32, 32))
        s = torch.full((16, 32), float("nan"), device=cuda_device)
        o = torch.full((16, hd), float("nan"), device=cuda_device)
        err = lib.repro_flash_tf32x3_probe(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                           s.data_ptr(), o.data_ptr(), hd,
                                           kernel_build.stream_of(q))
        assert err == 0, f"launch failed: cudaError {err}"
        torch.cuda.synchronize()
        torch.testing.assert_close(s, q @ k.T, rtol=1e-5, atol=1e-4, msg=f"S hd={hd}")
        torch.testing.assert_close(o, s @ v, rtol=1e-5, atol=1e-3, msg=f"SV hd={hd}")


# the wgmma route's edges beyond the repo's cases: ragged S (100, 200), a
# window that is not a tile multiple, and qwen2.5-14b's attention (GQA 40/8,
# hd 128)
FLASH_EDGES = [(2, 100, 4, 2, 96, True, 0), (1, 200, 4, 4, 64, True, 48),
               (1, 1024, 40, 8, 128, True, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_kernel_matches_plain(cuda_device, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    for B, S, Hq, Hkv, hd, causal, window in _flash_cases() + FLASH_EDGES:
        q, k, v = (torch.from_numpy(a).to(cuda_device, dtype) for a in _qkv(B, S, Hq, Hkv, hd))
        do = torch.randn(q.shape, generator=torch.Generator(cuda_device).manual_seed(1),
                         device=cuda_device).to(dtype)
        way = fa.route(dtype, hd, q.data_ptr(), k.data_ptr(), v.data_ptr())
        assert way == ("wgmma" if dtype == torch.bfloat16 else "tf32x3")
        what = (f"B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} causal={causal} window={window} "
                f"{dtype} ({way})")
        ops.reset_launch_counts()
        out, grads = _grads(lambda a, b, c: ops.flash_attention(
            a, b, c, causal=causal, window=window), (q, k, v), do)
        counts = ops.launch_counts()
        assert (counts[f"flash_attention_{way}"], counts[f"flash_attention_bwd_{way}"]) == (1, 1), \
            f"{what}: {counts}"
        assert (counts["flash_attention"], counts["flash_attention_bwd"]) == (1, 1), counts
        ref, ref_grads = _grads(lambda a, b, c: ops.flash_attention(
            a, b, c, causal=causal, window=window, impl="ref"), (q, k, v), do)
        tol = _tol(dtype)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol, msg=what)
        _assert_grads_close(grads, ref_grads, dtype, what)
        # no atomics: the same inputs give the same bits
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        first = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
        second = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
        assert all(torch.equal(a, b) for a, b in zip(first, second)), f"{what}: not bit-equal"
    torch.cuda.synchronize()


# gemma3-4b's attention (Hq 8, Hkv 4, hd 256) on the wgmma designs: the
# training shape's global and window-1024 layers, a ragged S, MQA, a window
# that is no tile's multiple over a ragged S, and no mask
FLASH_HD256 = [(1, 2048, 8, 4, 256, True, 0), (1, 2048, 8, 4, 256, True, 1024),
               (2, 200, 8, 4, 256, True, 0), (2, 256, 4, 1, 256, True, 0),
               (1, 200, 4, 4, 256, True, 48), (2, 128, 4, 4, 256, False, 0)]


@pytest.mark.cuda
def test_cuda_flash_tf32x3_hd256_probe_matches_float64(cuda_device):
    """The hd-256 tf32x3 design's building blocks on one tile, from its split
    pass's planes: s = q k^T (both operands K-major in shared memory), o =
    s v (s as the register A operand against the permuted V^T planes) and
    z = s^T q (s written into shared memory as a B operand in the planes'
    order, Q^T as A: the backward's transposed gradient products), each
    against a float64 product of the kernel's own s at bars one TF32 product
    misses."""
    lib = fa.build()
    rng = np.random.default_rng(24)
    q, k, v = (torch.from_numpy(rng.standard_normal((rows, 256), dtype=np.float32))
               .to(cuda_device) for rows in (64, 32, 32))
    s = torch.full((64, 32), float("nan"), device=cuda_device)
    o = torch.full((64, 256), float("nan"), device=cuda_device)
    z = torch.full((32, 256), float("nan"), device=cuda_device)
    ws = torch.empty(8 * 64 * 256, device=cuda_device)
    err = lib.repro_flash_tf32x3_hd256_probe(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             s.data_ptr(), o.data_ptr(), z.data_ptr(),
                                             ws.data_ptr(), kernel_build.stream_of(q))
    assert err == 0, f"launch failed: cudaError {err}"
    torch.cuda.synchronize()
    s64 = s.double()
    torch.testing.assert_close(s64, q.double() @ k.double().T, rtol=1e-5, atol=1e-4, msg="S")
    torch.testing.assert_close(o.double(), s64 @ v.double(), rtol=1e-5, atol=1e-3, msg="SV")
    torch.testing.assert_close(z.double(), s64.T @ q.double(), rtol=1e-5, atol=1e-3,
                               msg="S^T Q")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_hd256_wgmma_matches_plain(cuda_device, dtype):
    """hd 256 on its wgmma designs, forward and backward, against the plain
    version: bf16 on the wgmma route at 2e-2 (outputs) and 2e-2 x max|ref|
    (gradients), fp32 on the tf32x3 route (wgmma on split planes) at 2e-5
    and 1e-4; two backward calls give the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    way = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    tol = _tol(dtype)
    for B, S, Hq, Hkv, hd, causal, window in FLASH_HD256:
        q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
                   for a in _qkv(B, S, Hq, Hkv, hd))
        do = torch.randn(q.shape, generator=torch.Generator(cuda_device).manual_seed(1),
                         device=cuda_device).to(dtype)
        what = f"B={B} S={S} Hq={Hq} Hkv={Hkv} causal={causal} window={window} {dtype}"
        ops.reset_launch_counts()
        out, grads = _grads(lambda a, b, c: ops.flash_attention(
            a, b, c, causal=causal, window=window), (q, k, v), do)
        counts = ops.launch_counts()
        assert (counts[f"flash_attention_{way}"], counts[f"flash_attention_bwd_{way}"]) == \
            (1, 1), f"{what}: {counts}"
        ref, ref_grads = _grads(lambda a, b, c: ops.flash_attention(
            a, b, c, causal=causal, window=window, impl="ref"), (q, k, v), do)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol, msg=what)
        _assert_grads_close(grads, ref_grads, dtype, what)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        first = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
        second = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
        assert all(torch.equal(a, b) for a, b in zip(first, second)), f"{what}: not bit-equal"
    torch.cuda.synchronize()


# the tensor-core routes' edges: T = 1 and 100 (ragged row tiles), d = 200
# (a ragged last k-tile), f = 520 (a ragged column tile)
SWIGLU_EDGES = [(1, 256, 512), (100, 256, 512), (128, 200, 512), (128, 256, 520)]
# a slice of phi3's FFN; against its fp32 plain version in bf16 only: in
# fp32 at d = 3072 two correct sums in different orders differ by more than
# 2e-5, and cuBLAS splits K at T = 256, so in fp32 it is held against a
# float64 oracle (test_cuda_swiglu_tf32x3_slice_matches_float64)
SWIGLU_SLICE = (256, 3072, 8192)
# shapes only the simt kernels take: 37 rows, d and f not multiples of 4
SWIGLU_ODD = [(37, 200, 300), (37, 198, 302)]


def _swiglu_way(dtype, d, f):
    """The route of a call on fresh (aligned) tensors."""
    if dtype == torch.bfloat16 and (d % 8, f % 8) == (0, 0):
        return "wgmma"
    return "tf32x3" if dtype == torch.float32 and (d % 4, f % 4) == (0, 0) else "simt"


@pytest.mark.cuda
def test_cuda_swiglu_wgmma_products_match_matmul(cuda_device):
    """The tensor-core mainloop alone, one tile and one k-tile first: g and
    u (bf16) against fp32 matrix products of the same bf16 inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = sg.build()
    for T, d, f in [(128, 64, 128), (64, 64, 128), (128, 128, 256)] + SWIGLU_EDGES + [
            SWIGLU_SLICE]:
        x, wg, wu = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                     for a in _swiglu_inputs(T, d, f))
        g, u = (torch.empty(T, f, dtype=torch.bfloat16, device=cuda_device) for _ in range(2))
        err = lib.repro_swiglu_wgmma_products(x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                                              g.data_ptr(), u.data_ptr(), T, d, f,
                                              kernel_build.stream_of(x))
        assert err == 0, f"launch failed: cudaError {err}"
        for got, w, name in ((g, wg, "g"), (u, wu, "u")):
            want = x.float() @ w.float()
            torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-2,
                                       msg=f"{name} T={T} d={d} f={f}")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_swiglu_tf32x3_products_match_matmul(cuda_device):
    """The tf32x3 mainloop alone (after its split pass), one tile and one
    k-tile first: g and u (fp32) against float64 products of the same inputs
    at 2e-5, a bar one TF32 product misses; then the edges and phi3's FFN
    slice."""
    lib = sg.build()
    for T, d, f in [(128, 32, 128), (64, 32, 128), (128, 64, 256)] + SWIGLU_EDGES + [
            SWIGLU_SLICE]:
        x, wg, wu = (torch.from_numpy(a).to(cuda_device) for a in _swiglu_inputs(T, d, f))
        g, u = (torch.full((T, f), float("nan"), device=cuda_device) for _ in range(2))
        ws = sg.workspace(T, d, f, cuda_device)
        err = lib.repro_swiglu_tf32x3_products(x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                                               g.data_ptr(), u.data_ptr(), ws.data_ptr(), T, d,
                                               f, kernel_build.stream_of(x))
        assert err == 0, f"launch failed: cudaError {err}"
        for got, w, name in ((g, wg, "g"), (u, wu, "u")):
            torch.testing.assert_close(got.double(), x.double() @ w.double(), rtol=2e-5,
                                       atol=2e-5, msg=f"{name} T={T} d={d} f={f}")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_swiglu_tf32x3_slice_matches_float64(cuda_device):
    """phi3's FFN slice (T 256, d 3072, f 8192) in fp32 on the tf32x3 route:
    out, dg and du against a float64 oracle at 2e-5, the gradients at 1e-4
    against float64 autograd; two backward calls give the same bits."""
    T, d, f = SWIGLU_SLICE
    x, wg, wu = (torch.from_numpy(a).to(cuda_device) for a in _swiglu_inputs(T, d, f))
    dout = torch.randn((T, f), generator=torch.Generator(cuda_device).manual_seed(2),
                       device=cuda_device)
    ops.reset_launch_counts()
    out, grads = _grads(ops.swiglu, (x, wg, wu), dout)
    counts = ops.launch_counts()
    assert (counts["swiglu_tf32x3"], counts["swiglu_bwd_tf32x3"]) == (1, 1), counts
    x64, wg64, wu64, dout64 = (t.double() for t in (x, wg, wu, dout))
    ref, ref_grads = _grads(lambda a, b, c: torch.nn.functional.silu(a @ b) * (a @ c),
                            (x64, wg64, wu64), dout64)
    torch.testing.assert_close(out.double(), ref, rtol=2e-5, atol=2e-5, msg="out")
    for g, r, name in zip(grads, ref_grads, ("dx", "dw_gate", "dw_up")):
        torch.testing.assert_close(g.double(), r, rtol=1e-4, atol=1e-4, msg=name)
    g64, u64 = x64 @ wg64, x64 @ wu64
    sig = torch.sigmoid(g64)
    first = sg.swiglu_bwd(x, wg, wu, dout)
    for got, want, name in zip(first, (dout64 * u64 * sig * (1 + g64 * (1 - sig)),
                                       dout64 * g64 * sig), ("dg", "du")):
        torch.testing.assert_close(got.double(), want, rtol=2e-5, atol=2e-5, msg=name)
    second = sg.swiglu_bwd(x, wg, wu, dout)
    assert all(torch.equal(a, b) for a, b in zip(first, second)), "two backward calls differ"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_swiglu_kernel_matches_plain(cuda_device, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = SWIGLU_SHAPES + SWIGLU_EDGES + SWIGLU_ODD
    if dtype == torch.bfloat16:
        cases.append(SWIGLU_SLICE)
    for T, d, f in cases:
        x, wg, wu = (torch.from_numpy(a).to(cuda_device, dtype)
                     for a in _swiglu_inputs(T, d, f))
        dout = torch.randn((T, f), generator=torch.Generator(cuda_device).manual_seed(2),
                           device=cuda_device).to(dtype)
        ops.reset_launch_counts()
        out, grads = _grads(ops.swiglu, (x, wg, wu), dout)
        way = _swiglu_way(dtype, d, f)
        counts = ops.launch_counts()
        assert (counts[f"swiglu_{way}"], counts[f"swiglu_bwd_{way}"]) == (1, 1), counts
        assert (counts["swiglu"], counts["swiglu_bwd"]) == (1, 1), counts
        ref, ref_grads = _grads(lambda a, b, c: ops.swiglu(a, b, c, impl="ref"),
                                (x, wg, wu), dout)
        tol = _tol(dtype)
        what = f"T={T} d={d} f={f} {dtype} ({way})"
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol, msg=what)
        _assert_grads_close(grads, ref_grads, dtype, what)
        dg, du = sg.swiglu_bwd(x, wg, wu, dout)
        pdg, pdu = swiglu_bwd_ref(x, wg, wu, dout)
        torch.testing.assert_close(dg.float(), pdg.float(), rtol=tol, atol=tol, msg=f"dg {what}")
        torch.testing.assert_close(du.float(), pdu.float(), rtol=tol, atol=tol, msg=f"du {what}")
    torch.cuda.synchronize()


if __name__ == "__main__":
    # the refresh interval of the swiglu tf32x3 kernel's accumulators: max
    # |error| of the emulated g = x w_gate against a float64 product, at the
    # arithmetic test's inputs, by k of a fresh accumulator
    #     PYTHONPATH=src python tests/test_torch_kernels.py
    x, wg, _ = _swiglu_inputs(64, 3072, 256, seed=17)
    exact = x.astype(np.float64) @ wg.astype(np.float64)
    print("fp32 product", float(np.abs(x @ wg - exact).max()))
    print("3xTF32, round-to-nearest accumulation",
          float(np.abs(_tf32_matmul(x, wg, 3) - exact).max()))
    for k_refresh in (32, 64, 128, 256, 512, 3072):
        err = np.abs(_tf32x3_truncating(x, wg, k_refresh) - exact)
        print(f"3xTF32, truncating, fresh every {k_refresh}", float(err.max()),
              float(err.mean()))
