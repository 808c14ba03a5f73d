"""The port's paged prefix cache on the CPU, held against the JAX
package's engine on shared weights (float32, greedy tokens exact): a
shared prefix with a mid-page divergence admits copy-on-write
(tests/test_paged.py:128), retired pages recycle and the LRU cached page
is evicted (:247), the pool answers 429 at low slot occupancy (:195) and
discounts prefix hits (:309); and, within the port, a sampled prefix hit
is bitwise a cold prefill."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.runtime.engine import DecodeEngine as JaxEngine  # noqa: E402
from veles_tpu.runtime.generate import generate as jax_generate  # noqa: E402
from veles_tpu_torch.runtime.engine import (DecodeEngine,  # noqa: E402
                                            EngineOverloaded,
                                            prefix_page_hashes)
from veles_tpu_torch.runtime.generate import generate  # noqa: E402

from _torch_helpers import SERVE_V as V  # noqa: E402
from _torch_helpers import held, serve_pair, wait_for  # noqa: E402

torch.set_num_threads(2)

#: page-pool counters both packages' stats()["pages"] report
PAGE_KEYS = ("used", "cached", "free", "prefix_hit_pages",
             "prefix_miss_pages", "prefix_hit_rate", "evictions",
             "cow_admissions", "pool_rejected")


@pytest.fixture(scope="module")
def lm():
    return serve_pair()


def _run_both(lm, prompts, n, **kw):
    """The same serial requests through the JAX engine and the port's:
    (tokens of each package, page stats of each)."""
    jwf, jws, pwf, pws = lm
    out = {}
    for name, eng in (("jax", JaxEngine(jwf, jws, **kw)),
                      ("port", DecodeEngine(pwf, pws, device="cpu", **kw))):
        eng.start()
        try:
            toks = [eng.generate(p[None], n, timeout=180) for p in prompts]
            st = eng.stats()
        finally:
            eng.stop()
        out[name] = (toks, {k: st["pages"][k] for k in PAGE_KEYS}, st)
    return out


def test_prefix_page_hashes_match_the_jax_package(rng):
    from veles_tpu.runtime.engine import prefix_page_hashes as jax_hashes
    p = rng.integers(0, V, 37)
    assert prefix_page_hashes(p, 16) == jax_hashes(p, 16)
    assert len(prefix_page_hashes(p, 4)) == 9


def test_shared_prefix_cow_matches_jax_engine(rng, lm):
    """A, then B sharing A's prompt to a mid-page divergence, then A
    again: B maps A's two full prefix pages read-only and recomputes from
    the divergent page into private pages; A's shared pages are
    uncorrupted (A's resubmit is bitwise).  Tokens and page counters are
    the JAX engine's: 4 prefix-hit pages, 2 COW admissions."""
    sysp = rng.integers(0, V, 32).astype(np.int32)        # 2 full pages
    a = np.concatenate([sysp, rng.integers(0, V, 7).astype(np.int32)])
    b = np.concatenate([a[:36], rng.integers(0, V, 5).astype(np.int32)])
    out = _run_both(lm, [a, b, a], 6, slots=4, l_max=64, window_ms=1.0)
    (jt, jpg, _), (pt, ppg, st) = out["jax"], out["port"]
    for j, p in zip(jt, pt):
        np.testing.assert_array_equal(p, j)
    np.testing.assert_array_equal(pt[0], pt[2])
    _, _, pwf, pws = lm
    np.testing.assert_array_equal(pt[1], generate(pwf, pws, b[None],
                                                  6).numpy())
    assert ppg["prefix_hit_pages"] == 4 and ppg["cow_admissions"] == 2
    assert ppg == jpg
    assert st["compile"]["recompiles"] == 0 and st["compile"]["compiles"] == 3


def test_page_reclamation_and_lru_eviction_matches_jax_engine(rng, lm):
    """A pool of 4 pages under 6 serial 2-page requests: retired pages
    recycle, the cached prefix pages are evicted least recently used
    first, and the first prompt, evicted, still serves — the JAX
    engine's tokens and eviction count."""
    prompts = [rng.integers(0, V, 20).astype(np.int32) for _ in range(6)]
    out = _run_both(lm, prompts + prompts[:1], 6, slots=2, l_max=64,
                    pages=4, window_ms=0.0)
    (jt, jpg, _), (pt, ppg, st) = out["jax"], out["port"]
    for j, p in zip(jt, pt):
        np.testing.assert_array_equal(p, j)
    assert ppg["evictions"] > 0 and ppg == jpg
    assert st["compile"]["recompiles"] == 0


def test_pool_exhaustion_answers_429_at_low_slot_occupancy(rng, lm):
    """Long prompts take the whole pool while most slots are free: a
    one-page request is refused with 429 and Retry-After >= 1, counted in
    pool_rejected; the held requests serve the JAX package's tokens and,
    once the pool drains, the same request admits."""
    jwf, jws, pwf, pws = lm
    eng = DecodeEngine(pwf, pws, slots=4, l_max=80, pages=10,
                       window_ms=0.0, device="cpu").start()
    prompts = [rng.integers(0, V, 48).astype(np.int32) for _ in range(2)]
    try:
        with held(eng):
            with held(eng, "_admit"):           # both admitted together
                reqs = [eng.submit(p, 30) for p in prompts]  # 5 pages each
            wait_for(lambda: eng.stats()["occupancy"] == 2, 60, "admission")
            st = eng.stats()
            assert st["pages"]["free"] == 0 and st["occupancy"] < st["slots"]
            with pytest.raises(EngineOverloaded) as ei:
                eng.submit(rng.integers(0, V, 8), 8)
            assert ei.value.retry_after_s >= 1.0
            assert eng.stats()["pages"]["pool_rejected"] == 1
        for p, r in zip(prompts, reqs):
            assert r.done.wait(180) and r.error is None
            np.testing.assert_array_equal(
                r.result, np.asarray(jax_generate(jwf, jws, p[None], 30))[0])
        out = eng.generate(rng.integers(0, V, (1, 8)).astype(np.int32), 8,
                           timeout=120)
        assert out.shape == (1, 16)
    finally:
        eng.stop()


def test_pool_backpressure_discounts_prefix_hits(rng, lm):
    """With 7 of 8 pages taken at occupancy 2, a cold 3-page request is
    refused while one whose 2 leading pages are the cached system prompt
    admits through its hits, with the JAX package's tokens."""
    jwf, jws, pwf, pws = lm
    eng = DecodeEngine(pwf, pws, slots=4, l_max=64, pages=8,
                       window_ms=0.0, device="cpu").start()
    sysp = rng.integers(0, V, 32).astype(np.int32)
    try:
        with held(eng):
            with held(eng, "_admit"):           # both admitted together
                a = eng.submit(np.concatenate(
                    [sysp, rng.integers(0, V, 1).astype(np.int32)]), 14)
                b = eng.submit(rng.integers(0, V, 48), 15)
            wait_for(lambda: eng.stats()["occupancy"] == 2, 60, "admission")
            assert eng.stats()["pages"]["used"] == 7
            with pytest.raises(EngineOverloaded):
                eng.submit(rng.integers(0, V, 36), 4)
            c_prompt = np.concatenate(
                [sysp, rng.integers(0, V, 4).astype(np.int32)])
            c = eng.submit(c_prompt, 4)
        assert c.done.wait(180) and c.error is None
        np.testing.assert_array_equal(
            c.result,
            np.asarray(jax_generate(jwf, jws, c_prompt[None], 4))[0])
        assert eng.stats()["pages"]["prefix_hit_pages"] >= 2
        for r in (a, b):
            assert r.done.wait(180) and r.error is None
    finally:
        eng.stop()


@pytest.mark.parametrize("P,hits", [(37, 2), (32, 1)])
def test_sampled_prefix_hit_is_bitwise_a_cold_prefill(rng, lm, P, hits):
    """The second admission of a sampled prompt starts at its prefix-hit
    boundary; the fold positions are global, so its tokens are the cold
    admission's and generate()'s, bit for bit.  A prompt of whole pages
    keeps its last page out of the hit: its last token's logits give the
    first token."""
    _, _, pwf, pws = lm
    prompt = rng.integers(0, V, (1, P)).astype(np.int32)
    kw = dict(temperature=1.3, top_k=9, top_p=0.95, seed=5)
    ref = generate(pwf, pws, prompt, 8, **kw).numpy()
    eng = DecodeEngine(pwf, pws, slots=2, l_max=64, window_ms=0.0,
                       device="cpu").start()
    try:
        cold = eng.generate(prompt, 8, timeout=120, **kw)
        assert eng.stats()["pages"]["prefix_hit_pages"] == 0
        hit = eng.generate(prompt, 8, timeout=120, **kw)
        assert eng.stats()["pages"]["prefix_hit_pages"] == hits
    finally:
        eng.stop()
    np.testing.assert_array_equal(cold, ref)
    np.testing.assert_array_equal(hit, ref)


def test_a_chain_without_prefix_reuse_takes_no_shortcut(rng, lm):
    """The ``_prefix_ok`` rule (a recurrent chain's carry is not paged):
    with it off, identical prompts admit cold and still serve bitwise."""
    _, _, pwf, pws = lm
    prompt = rng.integers(0, V, (1, 37)).astype(np.int32)
    eng = DecodeEngine(pwf, pws, slots=2, l_max=64, window_ms=0.0,
                       device="cpu")
    eng._prefix_ok = False
    eng.start()
    try:
        first = eng.generate(prompt, 5, timeout=120)
        np.testing.assert_array_equal(eng.generate(prompt, 5, timeout=120),
                                      first)
        pg = eng.stats()["pages"]
        assert pg["prefix_hit_pages"] == 0 and pg["cow_admissions"] == 0
    finally:
        eng.stop()
