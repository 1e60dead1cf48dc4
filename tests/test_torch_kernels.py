"""The port's decode-attention kernel module against the JAX package.

On the CPU: the port's plain ``decode_attention_ref`` against the JAX oracle
and the Pallas kernel in interpret mode (the cases of
``tests/test_kernels.py::test_decode_attention``), the dispatcher, the
capability probe and the CUDA wrapper's input checks.  On a card (marker
``cuda``): the hand-written CUDA kernel against the plain version.
"""
import numpy as np
import pytest
import torch

try:  # the machine with the card runs only the ``cuda`` tests, without jax
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref
    from repro.kernels.decode_attention import decode_attention as pallas_decode
except ImportError:
    jnp = None

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.kernels.ref import decode_attention_ref

CASES = [(512, 1), (512, 511), (1024, 700), (2048, 2048)]
HEADS = [(8, 2, 64), (4, 4, 128), (16, 2, 128)]


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
    assert ops.launch_counts() == {"decode_attention": 7}
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"decode_attention": 0}


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


def test_capability_probe():
    ok = dict(n_q_heads=8, n_kv_heads=2, capacity=512)
    assert ops.decode_attention_capable(**ok)
    assert ops.decode_attention_capable(**{**ok, "capacity": 64})
    assert ops.decode_attention_capable(**{**ok, "capacity": 1024})
    assert not ops.decode_attention_capable(**{**ok, "capacity": 520})
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
    for B, Hq, Hkv, C, hd, length in shapes:
        q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
                   for a in _inputs(B, Hq, Hkv, C, hd))
        L = torch.tensor([length], dtype=torch.int32, device=cuda_device)
        out = ops.decode_attention(q, k, v, L)
        expect = ops.decode_attention(q, k, v, L, impl="ref")
        torch.testing.assert_close(out.float(), expect.float(), rtol=tol, atol=tol)
    torch.cuda.synchronize()

