"""The port's float16 KV pool on the CPU, held to the JAX package: the
plain paged decode over a float16 pool against ``paged_attention_decode(
..., interpret=True)`` on the same pool (within 1e-5 / 1e-6: both widen
the f16 rows to float32 exactly and differ in the summation order only),
and against the float32 pool the f16 one rounds (within 4e-3: the
rounding of K and V to 11 bits, on unit-normal data); the wrapper's
validation takes float16 and routes it to the plain version on the CPU;
an engine with ``cache_dtype=torch.float16`` against the JAX engine with
``jnp.float16`` on shared weights, greedy tokens equal in float32
compute, and the port's ``generate(cache_dtype=)`` the same tokens."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.ops import pallas_kernels as pk  # noqa: E402
from veles_tpu.runtime.engine import DecodeEngine as JaxEngine  # noqa: E402
from veles_tpu_torch.ops.kernels import paged_attention as pa  # noqa: E402
from veles_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from veles_tpu_torch.runtime.generate import generate  # noqa: E402

from _torch_helpers import SERVE_V, serve_pair  # noqa: E402

torch.set_num_threads(2)

PAGED_TOL = dict(rtol=1e-5, atol=1e-6)
F16_ROUNDING_ATOL = 4e-3


def _case(seed, B=3, Hk=2, G=2, Dh=8, psz=4, n_ptab=5):
    """Per-slot page tables over a pool with one scratch row, mixed
    positions, GQA; the pools in float32 and rounded to float16."""
    rng = np.random.default_rng(seed)
    rows = B * n_ptab + 1
    pools = [rng.standard_normal((rows, psz, Hk, Dh)).astype(np.float32)
             for _ in range(2)]
    ptab = rng.permutation(rows - 1)[:B * n_ptab].reshape(
        B, n_ptab).astype(np.int32)
    pos = rng.integers(0, n_ptab * psz, B).astype(np.int32)
    q = rng.standard_normal((B, Hk * G, Dh)).astype(np.float32)
    return q, pools, ptab, pos


def _port(q, pools, ptab, pos, Hk, psz, window, dtype):
    return pa.paged_attention_decode(
        torch.from_numpy(q), *(torch.from_numpy(p).to(dtype) for p in pools),
        torch.from_numpy(ptab), torch.from_numpy(pos), page_size=psz,
        n_kv_heads=Hk, window=window).numpy()


@pytest.mark.parametrize("window,seed,Hk,G,Dh", [
    (None, 0, 2, 2, 8), (6, 1, 2, 2, 8), (None, 2, 1, 4, 16)],
    ids=["full", "window", "gqa4_D16"])
def test_plain_f16_pool_matches_jax_kernel(window, seed, Hk, G, Dh):
    q, pools, ptab, pos = _case(seed, Hk=Hk, G=G, Dh=Dh)
    if seed == 2:                         # the first and last positions
        pos = np.asarray([0, ptab.shape[1] * 4 - 1, 7], np.int32)
    before = pa.launches.count
    out = _port(q, pools, ptab, pos, Hk, 4, window, torch.float16)
    ref = np.asarray(pk.paged_attention_decode(
        jnp.asarray(q), *(jnp.asarray(p).astype(jnp.float16) for p in pools),
        jnp.asarray(ptab), jnp.asarray(pos), page_size=4, n_kv_heads=Hk,
        window=window, interpret=True))
    assert out.dtype == np.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(out, ref, **PAGED_TOL)
    assert pa.launches.count == before        # CPU: the plain version
    exact = _port(q, pools, ptab, pos, Hk, 4, window, torch.float32)
    np.testing.assert_allclose(out, exact, rtol=0, atol=F16_ROUNDING_ATOL)
    assert np.abs(out - exact).max() > 0      # the pool was rounded


def test_validation_takes_float16_and_refuses_mixed_pools():
    q, pools, ptab, pos = _case(3)
    kp, vp = (torch.from_numpy(p).half() for p in pools)
    assert pa._POOL_DTYPES[torch.float16] == (2, "f16_pool")
    assert pa._validate(torch.from_numpy(q), kp, vp, torch.from_numpy(ptab),
                        torch.from_numpy(pos), 4, 2) == 2
    with pytest.raises(ValueError, match="differ"):
        pa.paged_attention_decode(torch.from_numpy(q), kp, vp.bfloat16(),
                                  torch.from_numpy(ptab),
                                  torch.from_numpy(pos), page_size=4,
                                  n_kv_heads=2)


@pytest.fixture(scope="module")
def lm():
    return serve_pair(seed=23)


def test_f16_cache_engine_matches_jax_engine_greedy(lm):
    """Float32 compute, float16 KV pool on both sides: the port's engine
    gives the JAX engine's greedy tokens, and the port's generate() with
    the same cache dtype gives them too."""
    jwf, jws, pwf, pws = lm
    prompts = np.random.default_rng(4).integers(
        0, SERVE_V, (4, 20)).astype(np.int32)
    kw = dict(slots=4, l_max=64, window_ms=1.0)
    je = JaxEngine(jwf, jws, cache_dtype=jnp.float16, **kw).start()
    try:
        ref = je.generate(prompts, 12, timeout=300)
    finally:
        je.stop()
    pe = DecodeEngine(pwf, pws, cache_dtype=torch.float16, device="cpu",
                      **kw).start()
    try:
        got = pe.generate(prompts, 12, timeout=300)
        st = pe.stats()
    finally:
        pe.stop()
    assert st["cache_dtype"] == "float16"
    assert pe._caches["attn0"]["k"].dtype == torch.float16
    np.testing.assert_array_equal(got, np.asarray(ref))
    gen = generate(pwf, pws, prompts, 12, cache_dtype=torch.float16)
    np.testing.assert_array_equal(gen.numpy(), got)
