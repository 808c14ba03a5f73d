"""The port's overload survival on the CPU: chunked prefill, priority
classes with displacement, preemption and resume — greedy tokens against
the JAX package's engine on shared weights (float32, exact), sampled
streams bitwise within the port (tests/test_overload.py:74-487); a decode
step leaves inactive rows untouched (:169); and the capture counters stay
flat through all of it, the CPU naming itself as the reason nothing is
captured."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.runtime.engine import DecodeEngine as JaxEngine  # noqa: E402
from veles_tpu.runtime.generate import generate as jax_generate  # noqa: E402
from veles_tpu_torch.runtime.engine import (DecodeEngine,  # noqa: E402
                                            EngineOverloaded, _PrioQueue,
                                            _Request)
from veles_tpu_torch.runtime.generate import generate  # noqa: E402

from _torch_helpers import SERVE_V as V  # noqa: E402
from _torch_helpers import held, serve_pair, wait_busy, wait_for  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lm():
    return serve_pair()


def _engine(lm, **kw):
    _, _, pwf, pws = lm
    kw.setdefault("window_ms", 0.0)
    return DecodeEngine(pwf, pws, device="cpu", **kw).start()


# -- chunked prefill ----------------------------------------------------------

@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_chunked_prefill_while_a_slot_decodes_matches_jax_engine(rng, lm,
                                                                 paged):
    """A 40-token prompt in 8-token slices interleaved with the decode
    steps of a request already decoding in the other slot: its tokens are
    the JAX engine's under the same traffic (and generate()'s), and the
    long request finishes before the decoy."""
    jwf, jws, _, _ = lm
    long_p = rng.integers(1, V, 40).astype(np.int32)
    decoy_p = rng.integers(1, V, 4).astype(np.int32)
    results = {}
    for name in ("jax", "port"):
        eng = (JaxEngine(jwf, jws, slots=2, l_max=64, window_ms=0.0,
                         paged=paged, prefill_chunk=8).start()
               if name == "jax" else
               _engine(lm, slots=2, l_max=64, paged=paged, prefill_chunk=8))
        try:
            with held(eng):
                decoy = eng.submit(decoy_p, 55)
                wait_busy(eng)
                lr = eng.submit(long_p, 6)
            assert lr.done.wait(180) and lr.error is None, lr.error
            assert decoy.done.wait(180) and decoy.error is None
            results[name] = (lr.result, decoy.result)
            if name == "port":
                st = eng.stats()
                assert lr.finished_at < decoy.finished_at
                assert st["prefill_calls"] >= 5 + 1     # 5 slices + decoy
                assert st["compile"]["recompiles"] == 0
        finally:
            eng.stop()
    for j, p in zip(results["jax"], results["port"]):
        np.testing.assert_array_equal(p, j)
    np.testing.assert_array_equal(
        results["port"][0], np.asarray(jax_generate(jwf, jws,
                                                    long_p[None], 6))[0])


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_chunked_prefill_is_bitwise_unchunked_sampled(rng, lm, paged):
    """Positions and fold positions are global, so a sampled 24-token
    prompt through 8-token slices streams generate()'s tokens bit for
    bit, as the unchunked engine does."""
    _, _, pwf, pws = lm
    prompt = rng.integers(0, V, (1, 24)).astype(np.int32)
    kw = dict(temperature=1.3, top_k=5, seed=11)
    ref = generate(pwf, pws, prompt, 6, **kw).numpy()
    for chunk in (8, 0):
        eng = _engine(lm, slots=2, l_max=64, paged=paged,
                      prefill_chunk=chunk)
        try:
            np.testing.assert_array_equal(
                eng.generate(prompt, 6, timeout=180, **kw), ref,
                err_msg=f"prefill_chunk {chunk}")
            assert eng.stats()["prefill_calls"] == (3 if chunk else 1)
        finally:
            eng.stop()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_decode_step_leaves_inactive_rows_untouched(lm, paged):
    """One decode step with slot 0 active and slot 1 inactive: slot 1's
    cache (its dense row, or the pages its table maps) keeps its bits —
    a chunk-prefilled slot waits there for its next slice — while slot
    0's position is written."""
    eng = DecodeEngine(lm[2], lm[3], slots=2, l_max=32, page_size=8,
                       paged=paged, device="cpu")
    with torch.no_grad():
        for c in eng._caches.values():
            c["k"].add_(0.125)
            c["v"].add_(0.125)
    if paged:
        eng._ptab[0] = [0, 1, 2, 3]
        eng._ptab[1] = [4, 5, 6, 7]
    before = {n: {k: t.clone() for k, t in c.items()}
              for n, c in eng._caches.items()}
    eng._toks[0, 5], eng._toks[1, 9] = 3, 5
    eng._pos[:] = [5, 9]
    eng._active[:] = [True, False]
    eng._end[:] = 30
    eng._dispatch("decode")
    for name, c in eng._caches.items():
        for k in ("k", "v"):
            b, a = before[name][k], c[k]
            if paged:
                assert torch.equal(a[4:8], b[4:8]), name    # slot 1's
                assert not torch.equal(a[0, 5], b[0, 5])    # slot 0 pos 5
            else:
                assert torch.equal(a[1], b[1]), name
                assert not torch.equal(a[0, 5], b[0, 5])


# -- priority classes ---------------------------------------------------------

def test_priority_queue_jump_ordering(rng, lm):
    """With the one slot held, a class-0 arrival submitted after two
    class-2 requests decodes first; FIFO within a class."""
    eng = _engine(lm, slots=1, l_max=64, queue_depth=8, priorities=3,
                  preempt=False)
    try:
        with held(eng):
            holder = eng.submit(rng.integers(0, V, 4), 6)
            wait_busy(eng)
            low_a = eng.submit(rng.integers(0, V, 4), 2, priority=2)
            low_b = eng.submit(rng.integers(0, V, 4), 2, priority=2)
            high = eng.submit(rng.integers(0, V, 4), 2, priority=0)
        for r in (holder, low_a, low_b, high):
            assert r.done.wait(180) and r.error is None
        assert high.finished_at < low_a.finished_at < low_b.finished_at
    finally:
        eng.stop()


def test_priority_out_of_range_is_loud(rng, lm):
    eng = _engine(lm, slots=1, l_max=32, priorities=2)
    try:
        for bad in (-1, 2, 7):
            with pytest.raises(ValueError, match="priority"):
                eng.submit(rng.integers(0, V, 4), 2, priority=bad)
    finally:
        eng.stop()


def test_hard_full_queue_displaces_lowest_class(rng, lm):
    """On a hard-full queue a class-0 arrival displaces the queued
    class-1 request (which fails with EngineOverloaded, Retry-After >= 1);
    a class-1 arrival there is itself refused."""
    eng = _engine(lm, slots=1, l_max=64, queue_depth=2, priorities=2,
                  preempt=False)
    try:
        with held(eng):
            holder = eng.submit(rng.integers(0, V, 4), 6)
            wait_busy(eng)
            low = eng.submit(rng.integers(0, V, 4), 2, priority=1)
            mid = eng.submit(rng.integers(0, V, 4), 2, priority=0)
            with pytest.raises(EngineOverloaded):
                eng.submit(rng.integers(0, V, 4), 2, priority=1)
            high = eng.submit(rng.integers(0, V, 4), 2, priority=0)
            assert low.done.wait(30)
            assert isinstance(low.error, EngineOverloaded)
            assert low.error.retry_after_s >= 1.0
        for r in (holder, mid, high):
            assert r.done.wait(180) and r.error is None, r.error
        st = eng.stats()
        assert st["admission"]["shed_by_class"] == {"1": 2}
        assert st["rejected"] == 2
    finally:
        eng.stop()


def test_steal_lower_never_displaces_started_work():
    """A preempted resume in the queue holds committed tokens: the
    displacement skips it, takes fresher same-class arrivals, then the
    next class up, then nothing."""
    def mk(priority, preemptions=0):
        r = _Request(np.asarray([1], np.int32), 2, 0.0, None, None, None,
                     0, time.monotonic() + 60, priority=priority)
        r.preemptions = preemptions
        return r

    q = _PrioQueue(3)
    resumed = mk(2, preemptions=1)
    fresh_a, fresh_b, fresh_mid = mk(2), mk(2), mk(1)
    q.appendleft(resumed)
    q.append(fresh_a)
    q.append(fresh_b)
    q.append(fresh_mid)
    assert q.steal_lower(0) is fresh_b
    assert q.steal_lower(0) is fresh_a
    assert q.steal_lower(0) is fresh_mid
    assert q.steal_lower(0) is None
    assert q.popleft() is resumed


# -- preemption ---------------------------------------------------------------

def test_preempt_resume_matches_jax_engine(rng, lm):
    """A class-0 arrival preempts the running class-1 slot (both engines
    held at a decode step while it arrives); the victim
    resumes by re-prefilling prompt + its generated tokens.  Both
    requests' tokens are the JAX engine's under the same traffic (the
    victim's its uninterrupted generate()), and the high request finishes
    first."""
    jwf, jws, _, _ = lm
    vic_p = rng.integers(0, V, 5).astype(np.int32)
    hi_p = rng.integers(0, V, 4).astype(np.int32)
    results = {}
    for name in ("jax", "port"):
        eng = (JaxEngine(jwf, jws, slots=1, l_max=64, window_ms=0.0,
                         priorities=2, preempt=True).start()
               if name == "jax" else
               _engine(lm, slots=1, l_max=64, priorities=2, preempt=True))
        try:
            with held(eng):
                victim = eng.submit(vic_p, 40, priority=1)
                wait_busy(eng)
                high = eng.submit(hi_p, 3, priority=0)
            assert high.done.wait(180) and high.error is None
            assert victim.done.wait(180) and victim.error is None
            assert victim.preemptions >= 1
            assert high.finished_at < victim.finished_at
            results[name] = (victim.result, high.result)
            st = eng.stats()
            assert st["admission"]["preemptions"] >= 1, st
            assert st["compile"]["recompiles"] == 0
        finally:
            eng.stop()
    for j, p in zip(results["jax"], results["port"]):
        np.testing.assert_array_equal(p, j)
    np.testing.assert_array_equal(
        results["port"][0], np.asarray(jax_generate(jwf, jws, vic_p[None],
                                                    40))[0])


def test_preempted_sampled_stream_is_bitwise_uninterrupted(rng, lm):
    """A sampled victim preempted mid-decode: its resumed stream is
    generate()'s under the same seed, bit for bit."""
    _, _, pwf, pws = lm
    vic_p = rng.integers(0, V, (1, 5)).astype(np.int32)
    kw = dict(temperature=1.7, top_k=6, seed=23)
    ref = generate(pwf, pws, vic_p, 40, **kw).numpy()
    eng = _engine(lm, slots=1, l_max=64, priorities=2, preempt=True)
    try:
        with held(eng):
            victim = eng.submit(vic_p[0], 40, priority=1, **kw)
            wait_busy(eng)
            high = eng.submit(rng.integers(0, V, 4), 3, priority=0)
        assert high.done.wait(180) and victim.done.wait(180)
        assert victim.error is None and victim.preemptions >= 1
        np.testing.assert_array_equal(victim.result[None], ref)
    finally:
        eng.stop()


def test_preempt_frees_pages_for_high_priority(rng, lm):
    """A pool of 4 pages hosts one 3-page request at a time: a class-0
    arrival queues instead of a 429, the class-1 page holder is
    preempted, and both serve the JAX package's tokens."""
    jwf, jws, _, _ = lm
    vic_p = rng.integers(0, V, 33).astype(np.int32)
    hi_p = rng.integers(0, V, 30).astype(np.int32)
    eng = _engine(lm, slots=2, l_max=64, page_size=16, pages=4,
                  priorities=2, preempt=True)
    try:
        with held(eng):
            victim = eng.submit(vic_p, 8, priority=1)
            wait_busy(eng)
            high = eng.submit(hi_p, 8, priority=0)
        assert high.done.wait(180) and high.error is None
        assert victim.done.wait(180) and victim.error is None
        for r, p in ((victim, vic_p), (high, hi_p)):
            np.testing.assert_array_equal(
                r.result, np.asarray(jax_generate(jwf, jws, p[None], 8))[0])
        assert eng.stats()["admission"]["preemptions"] >= 1
    finally:
        eng.stop()


def test_no_futile_preemption_when_pages_cannot_suffice(rng, lm):
    """With the pool mostly pinned by a same-class slot, a class-0
    arrival needing more pages than the class-1 victim could free does
    not evict it: the victim runs to the end untouched (the JAX
    package's tokens) and the arrival waits for capacity."""
    jwf, jws, _, _ = lm
    vic_p = rng.integers(0, V, 5).astype(np.int32)
    eng = _engine(lm, slots=2, l_max=64, page_size=8, pages=8,
                  priorities=2, preempt=True)
    try:
        with held(eng):
            with held(eng, "_admit"):       # both admitted together
                pinner = eng.submit(rng.integers(0, V, 4), 36, priority=0)
                victim = eng.submit(vic_p, 20, priority=1)
            wait_for(lambda: eng.stats()["occupancy"] == 2, 60, "both in")
            waiter = eng.submit(rng.integers(0, V, 4), 28, priority=0)
        assert victim.done.wait(180) and victim.error is None
        np.testing.assert_array_equal(
            victim.result, np.asarray(jax_generate(jwf, jws, vic_p[None],
                                                   20))[0])
        assert victim.preemptions == 0
        assert pinner.done.wait(180) and waiter.done.wait(180)
        assert pinner.error is None and waiter.error is None
        assert eng.stats()["admission"]["preemptions"] == 0
    finally:
        eng.stop()


# -- capture counters ---------------------------------------------------------

def test_capture_counters_flat_and_the_cpu_is_named(rng, lm):
    """The paged engine builds its decode (sampling and greedy-only) and
    prefill steps once, when it is built: chunked prefills, preemptions,
    displacement and sheds under concurrent submitters add no build and
    no recapture.  On the
    CPU nothing is captured and stats() says why; the dense layout says
    it stays eager."""
    import threading
    eng = _engine(lm, slots=2, l_max=64, queue_depth=4, priorities=3,
                  preempt=True, prefill_chunk=8)
    try:
        st = eng.stats()
        assert st["capture"] == {
            "decode": {"captured": False, "reason": "cpu"},
            "decode_greedy": {"captured": False, "reason": "cpu"},
            "prefill": {"captured": False, "reason": "cpu"}}
        assert st["compile"]["compiles"] == 3
        ok, shed = [0], [0]
        lock = threading.Lock()

        def worker(i):
            try:
                eng.generate(rng.integers(0, V, (1, 4 + (i % 3) * 10))
                             .astype(np.int32), 2 + i % 3, priority=i % 3,
                             timeout=180)
                with lock:
                    ok[0] += 1
            except EngineOverloaded:
                with lock:
                    shed[0] += 1

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        assert ok[0] + shed[0] == 16 and ok[0] >= 1
        st = eng.stats()
        assert st["compile"]["compiles"] == 3
        assert st["compile"]["recompiles"] == 0
        assert st["compile"]["hits"] == 0
    finally:
        eng.stop()
    dense = DecodeEngine(lm[2], lm[3], slots=1, l_max=16, paged=False,
                         device="cpu")
    assert dense.stats()["capture"]["decode"] == {
        "captured": False, "reason": "dense layout"}


def test_compute_dtype_weights_are_stored_once_with_the_same_bits():
    """A bf16 model's engine stores each weight matrix in bf16 when it is
    built, so its steps cast none: one decode step through those copies
    gives the logits and cache writes of the same step through the
    float32 weights, bit for bit."""
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.units.base import Spec
    from _torch_helpers import SERVE_LAYERS
    wf = StandardWorkflow({"name": "lm", "layers": SERVE_LAYERS,
                           "compute_dtype": "bfloat16"}).workflow
    wf.build({"@input": Spec((2, 12), torch.int32),
              "@labels": Spec((2, 12), torch.int32),
              "@mask": Spec((2,), torch.float32)})
    ws = wf.init_state(3, device="cpu")
    eng = DecodeEngine(wf, ws, slots=2, l_max=32, page_size=8,
                       device="cpu")
    p = eng.params
    assert p["attn0"]["wq"].dtype == p["ffn0"]["w1"].dtype == \
        p["head"]["w"].dtype == torch.bfloat16
    assert p["ffn0"]["b1"].dtype == p["ln0a"]["scale"].dtype == \
        p["emb"]["table"].dtype == torch.float32
    tok = torch.tensor([3, 7])
    pos = torch.tensor([4, 9], dtype=torch.int32)
    ptab = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32)
    out = []
    for params in (eng.params, ws["params"]):
        caches = {n: {k: t.clone() for k, t in c.items()}
                  for n, c in eng._caches.items()}
        logits, _ = eng.plan.step(params, caches, tok, pos, eng._ctx,
                                  pages=(ptab, 8, None))
        out.append((logits, caches))
    assert torch.equal(out[0][0], out[1][0])
    for n in out[0][1]:
        assert torch.equal(out[0][1][n]["k"], out[1][1][n]["k"])
