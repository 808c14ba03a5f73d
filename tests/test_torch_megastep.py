"""The port's megastep decode (runtime/engine.py ``_TokenStep`` with
``kind="megastep"``) on the CPU, held to tests/test_megastep.py's
contract on weights shared with the JAX package: greedy float32 streams
equal the JAX ``generate()``, paged and dense, with fewer dispatches
than decode steps; sampled streams are bitwise the port's N=1 engine and
``generate()``; a slot retiring mid-block leaves every pool row it
wrote as an N=1 run leaves it; a partial batch runs single steps; and
megastep composes with speculative verify and chunked prefill, both
paths taken by construction, with the step cache flat."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.runtime.generate import generate as jax_generate  # noqa: E402
from veles_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from veles_tpu_torch.runtime.generate import generate  # noqa: E402

from _torch_helpers import build_pair, held, wait_for  # noqa: E402

torch.set_num_threads(2)

V = 12

#: tests/test_megastep.py:36-43's LM
LAYERS = [
    {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
    {"type": "attention", "n_heads": 2, "rope": True, "residual": True,
     "name": "a1"},
    {"type": "layer_norm", "name": "n1"},
    {"type": "ffn", "d_hidden": 32, "name": "f1"},
    {"type": "seq_last", "name": "last"},
    {"type": "softmax", "output_size": V, "name": "out"},
]


@pytest.fixture(scope="module")
def lm():
    return build_pair(LAYERS, B=2, T=6, seed=3)


def _engine(lm, **kw):
    return DecodeEngine(lm[2], lm[3], device="cpu", **kw)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_greedy_equals_jax_generate_with_fewer_dispatches(lm, rng, paged):
    jwf, jws, _, _ = lm
    prompt = rng.integers(0, V, (1, 7)).astype(np.int32)
    ref = np.asarray(jax_generate(jwf, jws, prompt, 20))
    eng = _engine(lm, slots=1, l_max=64, paged=paged, megastep=4).start()
    try:
        got = eng.generate(prompt, 20, timeout=180)
        st = eng.stats()
    finally:
        eng.stop()
    np.testing.assert_array_equal(got, ref)
    # the prefill gives token 1, five blocks of 4 the other 19 (the last
    # retires the slot inside the block)
    assert st["megastep"] == {"n": 4, "mega_dispatches": 5}, st
    assert st["decode_steps"] == 20 and st["dispatches"] == 5, st
    assert st["decode_tokens"] == 19
    assert st["compile"]["recompiles"] == 0
    # no live slot samples: only the greedy-only program ran
    assert st["replays"] == {"decode": 0, "decode_greedy": 0,
                             "megastep": 0, "megastep_greedy": 5}, st


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_sampled_is_bitwise_n1_and_generate(lm, rng, paged):
    _, _, pwf, pws = lm
    prompt = rng.integers(0, V, (1, 5)).astype(np.int32)
    cases = ({"temperature": 1.3, "top_k": 6},
             {"temperature": 1.5, "top_p": 0.9},
             {"temperature": 0.7, "top_k": 6, "top_p": 0.8})
    runs = {}
    for n in (1, 4):
        eng = _engine(lm, slots=1, l_max=64, paged=paged,
                      megastep=n).start()
        try:
            runs[n] = [eng.generate(prompt, 14, seed=7, timeout=180, **kw)
                       for kw in cases]
            if n > 1:
                st = eng.stats()
                assert st["megastep"]["mega_dispatches"] > 0
                assert st["replays"]["megastep"] > 0
                assert st["replays"]["megastep_greedy"] == 0
        finally:
            eng.stop()
    for kw, a, b in zip(cases, runs[1], runs[4]):
        ref = generate(pwf, pws, prompt, 14, seed=7, **kw).numpy()
        np.testing.assert_array_equal(a, ref, err_msg=str(kw))
        np.testing.assert_array_equal(b, ref, err_msg=str(kw))


def test_greedy_row_is_the_same_beside_a_sampled_one(lm, rng):
    """A greedy request alone runs the greedy-only programs; beside a
    sampled request, admitted together, the sampling ones: its tokens
    are the same bit for bit, and the sampled row is ``generate()``'s."""
    _, _, pwf, pws = lm
    greedy = rng.integers(0, V, 7).astype(np.int32)
    sampled = rng.integers(0, V, 5).astype(np.int32)
    eng = _engine(lm, slots=2, l_max=64, megastep=4).start()
    try:
        alone = eng.generate(greedy[None], 16, timeout=180)
        st0 = eng.stats()["replays"]
        assert st0["megastep"] == st0["decode"] == 0
        with held(eng, "_admit"):
            reqs = [eng.submit(greedy, 16),
                    eng.submit(sampled, 16, temperature=1.2, top_k=5,
                               seed=9)]
        for r in reqs:
            assert r.done.wait(180) and r.error is None
        st = eng.stats()["replays"]
    finally:
        eng.stop()
    assert st["megastep"] > 0
    np.testing.assert_array_equal(reqs[0].result, alone[0])
    np.testing.assert_array_equal(
        reqs[1].result, generate(pwf, pws, sampled[None], 16, temperature=1.2,
                                 top_k=5, seed=9).numpy()[0])


def _run_to_retirement(lm, prompt, eos, megastep, paged):
    eng = _engine(lm, slots=1, l_max=64, paged=paged, megastep=megastep)
    eng.start()
    try:
        got = eng.generate(prompt, 24, eos_id=eos, timeout=180)
        steps = eng.stats()["decode_steps"]
    finally:
        eng.stop()
    caches = {n: {k: t.clone() for k, t in c.items()}
              for n, c in eng._caches.items()}
    return got, eng._pos.copy(), caches, steps


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_mid_block_eos_freezes_the_retired_slot(lm, rng, paged):
    """The eos lands inside a block of 8: the stream is the JAX
    ``generate(eos_id=)``'s, and the caches after the fused run equal
    the N=1 run's bit for bit — the micro-steps past the retirement
    wrote nothing but the scratch page (paged) or nothing (dense)."""
    jwf, jws, _, _ = lm
    # the first prompt whose greedy continuation first emits a token at
    # a decode micro-step that is not a block's first (index 0 is the
    # prefill's): the latest such token is the eos
    for _ in range(32):
        prompt = rng.integers(0, V, (1, 9)).astype(np.int32)
        full = np.asarray(jax_generate(jwf, jws, prompt, 24))[0, 9:]
        firsts = [int(t) for i, t in enumerate(full)
                  if t not in full[:i] and i % 8]
        if firsts:
            break
    eos = firsts[-1]
    ref = np.asarray(jax_generate(jwf, jws, prompt, 24, eos_id=eos))
    got1, pos1, caches1, _ = _run_to_retirement(lm, prompt, eos, 1, paged)
    got8, pos8, caches8, steps8 = _run_to_retirement(lm, prompt, eos, 8,
                                                     paged)
    np.testing.assert_array_equal(got1, ref)
    np.testing.assert_array_equal(got8, ref)
    np.testing.assert_array_equal(pos8, pos1)
    emitted = int(np.flatnonzero(ref[0, 9:] == eos)[0])
    assert steps8 % 8 == 0 and steps8 > emitted     # retired inside
    for name in caches1:
        for k in ("k", "v"):
            a, b = caches1[name][k], caches8[name][k]
            if paged:                   # the last pool row is the scratch
                a, b = a[:-1], b[:-1]
            assert torch.equal(a, b), (name, k)


def test_partial_batch_drops_to_single_steps(lm, rng):
    """One request on a two-slot engine runs single steps; two admitted
    together fill the batch and fuse."""
    _, _, pwf, pws = lm
    prompt = rng.integers(0, V, (1, 7)).astype(np.int32)
    ref = generate(pwf, pws, prompt, 16).numpy()
    eng = _engine(lm, slots=2, l_max=64, window_ms=0.0, megastep=4).start()
    try:
        np.testing.assert_array_equal(eng.generate(prompt, 16, timeout=180),
                                      ref)
        st = eng.stats()
        assert st["megastep"]["mega_dispatches"] == 0, st
        assert st["dispatches"] == st["decode_steps"] == 15, st
        with held(eng, "_admit"):
            reqs = [eng.submit(prompt[0], 16) for _ in range(2)]
        for r in reqs:
            assert r.done.wait(180) and r.error is None
            np.testing.assert_array_equal(r.result, ref[0])
        st = eng.stats()
        assert st["megastep"]["mega_dispatches"] > 0, st
        assert st["dispatches"] < st["decode_steps"], st
        assert st["compile"]["recompiles"] == 0
    finally:
        eng.stop()


def test_composition_spec_chunked_megastep_counters_frozen(lm, rng):
    """Megastep, speculative verify and chunked prefill on one paged
    engine (tests/test_megastep.py:238's contract).  The reference could
    not confirm it on its own tree (its burst never filled every slot at
    once); here each path runs by construction: a prompt of a repeated
    phrase gives the cold drafter a draft (verify steps), then, with the
    policy parked (its measured walls set so that no verify can pay) and
    the scheduler held while a burst of four is submitted, all four
    slots are admitted together and fuse.  Every stream is the port's
    ``generate()``; seven programs built at construction and no more
    (decode, megastep and verify, each sampling and greedy-only, and
    prefill)."""
    _, _, pwf, pws = lm
    eng = _engine(lm, slots=4, l_max=64, window_ms=1.0, queue_depth=64,
                  spec=True, spec_k=4, prefill_chunk=16, megastep=4).start()
    phrase = rng.integers(0, V, 5).astype(np.int32)
    work = [(np.tile(phrase, 4)[None], 10)] + [
        (rng.integers(0, V, (1, int(p))).astype(np.int32), int(n))
        for p, n in zip(rng.integers(4, 40, 8), rng.integers(6, 18, 8))]
    burst = rng.integers(0, V, (1, 6)).astype(np.int32)
    refs = [generate(pwf, pws, pr, n).numpy() for pr, n in work]
    burst_ref = generate(pwf, pws, burst, 12).numpy()
    try:
        built = eng.stats()["compile"]
        assert built["compiles"] == 7 and built["recompiles"] == 0
        np.testing.assert_array_equal(eng.generate(*work[0], timeout=180),
                                      refs[0])
        assert eng.stats()["spec"]["verify_steps"] > 0
        assert eng.stats()["prefill_calls"] == 2        # 20 = 16 + 4
        wait_for(lambda: eng.stats()["occupancy"] == 0, 60, "idle")
        with held(eng, "_admit"):
            # the scheduler waits inside _admit: its policy state is ours
            eng._verify_wall_ewma, eng._step_wall_ewma = 1.0, 1e-3
            eng._accept_ewma, eng._ticks_since_attempt = 0.0, 0
            reqs = [eng.submit(burst[0], 12) for _ in range(4)]
        for r in reqs:
            assert r.done.wait(180) and r.error is None
            np.testing.assert_array_equal(r.result, burst_ref[0])
        assert eng.stats()["megastep"]["mega_dispatches"] > 0
        results = [None] * len(work)

        def worker(i):
            results[i] = eng.generate(work[i][0], work[i][1], timeout=300)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(work))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            assert not t.is_alive()
        for i, (got, ref) in enumerate(zip(results, refs)):
            np.testing.assert_array_equal(got, ref, err_msg=str(i))
        st = eng.stats()
        assert st["compile"]["compiles"] == 7 and st["compile"]["hits"] == 0
        assert st["compile"]["recompiles"] == 0
        assert st["spec"]["verify_steps"] > 0
        assert st["megastep"]["mega_dispatches"] > 0
    finally:
        eng.stop()


def test_megastep_must_be_positive(lm):
    with pytest.raises(ValueError, match="megastep"):
        _engine(lm, slots=1, l_max=16, megastep=0)
