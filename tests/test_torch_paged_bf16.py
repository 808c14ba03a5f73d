"""The port's bf16 KV pool on the CPU, held to the JAX package: the plain
paged decode over a bfloat16 pool against ``paged_attention_decode(...,
interpret=True)`` on the same pool (within 1e-5 / 1e-6: both widen the
bf16 rows to float32 exactly, and differ in the summation order only);
an engine with ``cache_dtype=torch.bfloat16`` against the JAX engine
with ``jnp.bfloat16`` on shared weights, greedy tokens equal in float32
compute; ``generate(cache_dtype=)`` the engine's tokens; and VTKV1 blobs
refused across pool dtypes (each entry's dtype is in the header)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.ops import pallas_kernels as pk  # noqa: E402
from veles_tpu.runtime.engine import DecodeEngine as JaxEngine  # noqa: E402
from veles_tpu_torch.ops.kernels import paged_attention as pa  # noqa: E402
from veles_tpu_torch.runtime.engine import (DecodeEngine,  # noqa: E402
                                            prefix_page_hashes)
from veles_tpu_torch.runtime.generate import generate  # noqa: E402

from _torch_helpers import SERVE_V, serve_pair  # noqa: E402

torch.set_num_threads(2)

PAGED_TOL = dict(rtol=1e-5, atol=1e-6)


def _bf16_case(seed, B=3, Hk=2, G=2, Dh=8, psz=4, n_ptab=5):
    """Per-slot page tables over a bf16 pool with one scratch row, mixed
    positions, GQA; the pools as torch bf16 and as exact float32."""
    rng = np.random.default_rng(seed)
    H = Hk * G
    rows = B * n_ptab + 1
    pools = [torch.from_numpy(rng.standard_normal(
        (rows, psz, Hk, Dh)).astype(np.float32)).bfloat16()
        for _ in range(2)]
    ptab = rng.permutation(rows - 1)[:B * n_ptab].reshape(
        B, n_ptab).astype(np.int32)
    pos = rng.integers(0, n_ptab * psz, B).astype(np.int32)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    return q, pools, ptab, pos


def _both(q, pools, ptab, pos, *, Hk=2, psz=4, window=None, q_bf16=False):
    jq = jnp.asarray(q)
    tq = torch.from_numpy(q)
    if q_bf16:
        jq, tq = jq.astype(jnp.bfloat16), tq.bfloat16()
    jpools = [jnp.asarray(p.float().numpy()).astype(jnp.bfloat16)
              for p in pools]
    ref = pk.paged_attention_decode(
        jq, *jpools, jnp.asarray(ptab), jnp.asarray(pos), page_size=psz,
        n_kv_heads=Hk, window=window, interpret=True)
    out = pa.paged_attention_decode(
        tq, *pools, torch.from_numpy(ptab), torch.from_numpy(pos),
        page_size=psz, n_kv_heads=Hk, window=window)
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("window,q_bf16", [(None, False), (6, False),
                                           (None, True)],
                         ids=["full", "window", "bf16_q"])
def test_plain_bf16_pool_matches_jax_kernel(window, q_bf16):
    before = pa.launches.count
    out, ref = _both(*_bf16_case(0), window=window, q_bf16=q_bf16)
    assert out.dtype == np.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(out, ref, **PAGED_TOL)
    assert pa.launches.count == before        # CPU: the plain version


def test_plain_bf16_pool_matches_jax_kernel_gqa4_edges():
    q, pools, ptab, _ = _bf16_case(1, B=3, Hk=1, G=4, Dh=16)
    pos = np.asarray([0, ptab.shape[1] * 4 - 1, 7], np.int32)
    out, ref = _both(q, pools, ptab, pos, Hk=1)
    np.testing.assert_allclose(out, ref, **PAGED_TOL)


def test_plain_refuses_pools_of_two_dtypes():
    q, pools, ptab, pos = _bf16_case(2)
    with pytest.raises(ValueError, match="differ"):
        pa.paged_attention_decode(
            torch.from_numpy(q), pools[0], pools[1].float(),
            torch.from_numpy(ptab), torch.from_numpy(pos), page_size=4,
            n_kv_heads=2)


# -- the engine with a bf16 KV cache --------------------------------------

@pytest.fixture(scope="module")
def lm():
    return serve_pair(seed=21)


def _prompts(seed, B=4, P=20):
    return np.random.default_rng(seed).integers(
        0, SERVE_V, (B, P)).astype(np.int32)


def test_bf16_cache_engine_matches_jax_engine_greedy(lm):
    """Float32 compute, bf16 KV pool on both sides: the port's engine
    gives the JAX engine's greedy tokens, and the port's generate() with
    the same cache dtype gives them too."""
    jwf, jws, pwf, pws = lm
    prompts = _prompts(3)
    kw = dict(slots=4, l_max=64, window_ms=1.0)
    je = JaxEngine(jwf, jws, cache_dtype=jnp.bfloat16, **kw).start()
    try:
        ref = je.generate(prompts, 12, timeout=300)
    finally:
        je.stop()
    pe = DecodeEngine(pwf, pws, cache_dtype=torch.bfloat16, device="cpu",
                      **kw).start()
    try:
        got = pe.generate(prompts, 12, timeout=300)
        st = pe.stats()
    finally:
        pe.stop()
    assert st["cache_dtype"] == "bfloat16"
    assert pe._caches["attn0"]["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got, np.asarray(ref))
    gen = generate(pwf, pws, prompts, 12, cache_dtype=torch.bfloat16)
    np.testing.assert_array_equal(gen.numpy(), got)


def _export(pwf, pws, prompt, cache_dtype):
    eng = DecodeEngine(pwf, pws, slots=2, l_max=64, window_ms=1.0,
                       cache_dtype=cache_dtype, device="cpu").start()
    try:
        eng.generate(prompt[None], 2, timeout=120)
        return eng.export_pages(prefix_page_hashes(prompt, eng.page_size))
    finally:
        eng.stop()


@pytest.mark.parametrize("src,dst", [(torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16)],
                         ids=["bf16_into_f32", "f32_into_bf16"])
def test_vtkv1_blob_refused_across_pool_dtypes(lm, src, dst):
    *_, pwf, pws = lm
    prompt = _prompts(5, B=1, P=32)[0]
    blob = _export(pwf, pws, prompt, src)
    eng = DecodeEngine(pwf, pws, slots=2, l_max=64, window_ms=1.0,
                       cache_dtype=dst, device="cpu")
    before = {n: {k: t.clone() for k, t in c.items()}
              for n, c in eng._caches.items()}
    with pytest.raises(ValueError, match="layout mismatch"):
        eng.import_pages(blob)
    assert all(torch.equal(eng._caches[n][k], t)
               for n, c in before.items() for k, t in c.items())


def test_vtkv1_bf16_pages_round_trip_and_serve(lm):
    """bf16 pages exported by one engine serve in another bf16 engine:
    the shared page hits and the tokens are the exporter's."""
    *_, pwf, pws = lm
    prompt = _prompts(6, B=1, P=32)[0]
    blob = _export(pwf, pws, prompt, torch.bfloat16)
    kw = dict(slots=2, l_max=64, window_ms=1.0, cache_dtype=torch.bfloat16,
              device="cpu")
    ref_eng = DecodeEngine(pwf, pws, **kw).start()
    try:
        ref = ref_eng.generate(prompt[None], 6, timeout=120)
    finally:
        ref_eng.stop()
    eng = DecodeEngine(pwf, pws, **kw).start()
    try:
        assert eng.import_pages(blob)["imported"] == 32 // eng.page_size
        got = eng.generate(prompt[None], 6, timeout=120)
        hits = eng.stats()["pages"]["prefix_hit_pages"]
    finally:
        eng.stop()
    # the second page holds the prompt's last token, which recomputes
    assert hits == 1
    np.testing.assert_array_equal(got, ref)
