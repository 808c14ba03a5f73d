"""The port's speculative decoding (runtime/engine.py ``ngram_draft``, the
verify step and the JAX package's payoff policy) on the CPU, held to
tests/test_speculative.py's contract on weights shared with the JAX
package: the drafter equals the JAX drafter; greedy float32 streams
equal the JAX ``generate()``, paged and dense, with prefix-hit
admissions; sampled streams are bitwise the port's non-speculative
engine; an eos inside a verify block retires the slot there (the path
provably taken, which the reference's own test could not confirm on its
tree); the accept-rate gauges reach ``GET /metrics``; the config is
validated; and the paged kernel's route composes with speculation."""

import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.runtime import engine as jax_engine  # noqa: E402
from veles_tpu.runtime.generate import generate as jax_generate  # noqa: E402
from veles_tpu_torch.config import root as port_root  # noqa: E402
from veles_tpu_torch.runtime.engine import (DecodeEngine,  # noqa: E402
                                            ngram_draft)
from veles_tpu_torch.runtime.generate import generate  # noqa: E402
from veles_tpu_torch.runtime.restful import RestfulServer  # noqa: E402

from _torch_helpers import build_pair  # noqa: E402

torch.set_num_threads(2)

V = 12

#: tests/test_speculative.py:27-34's LM
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


def _same_draft(a, b):
    return (a is None and b is None) or (
        a is not None and b is not None and np.array_equal(a, b))


def test_ngram_draft_equals_the_jax_drafter(rng):
    h = np.array([1, 2, 3, 4, 1, 2, 3], np.int32)
    np.testing.assert_array_equal(ngram_draft(h, 5), [4, 1, 2, 3, -1])
    assert ngram_draft(np.arange(8, dtype=np.int32), 3) is None
    assert ngram_draft(np.array([5, 5], np.int32), 3) is None
    cases = [rng.integers(0, V, n).astype(np.int32)
             for n in (1, 2, 3, 5, 9, 30, 200)]
    cases += [np.tile(rng.integers(0, 50, p), r).astype(np.int32)
              for p, r in ((3, 4), (7, 3), (32, 8))]
    # byte-level matches off a 4-byte boundary (256 = bytes 0,1,0,0)
    cases += [np.array([256, 1, 256, 65536, 1, 256], np.int32),
              np.array([1, 256, 7, 65536, 1], np.int32)]
    for hist in cases:
        for k in (1, 4, 6):
            assert _same_draft(ngram_draft(hist, k),
                               jax_engine.ngram_draft(hist, k)), (hist, k)


def _repeat_phrase(rng, n, P):
    return np.resize(rng.integers(0, V, n), P).astype(np.int32)[None]


def _cycling_prompt(lm, rng):
    """A random start and its own greedy continuation, in which a phrase
    of at least three tokens repeats: the drafter's first draft, from
    the first tick, is what greedy decoding emits."""
    _, _, pwf, pws = lm
    for _ in range(32):
        prompt = generate(pwf, pws, rng.integers(0, V, (1, 9)), 16).numpy()
        if len(set(prompt[0, -8:].tolist())) >= 3:
            return prompt
    raise AssertionError("no start settles into a phrase of 3 tokens")


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_greedy_spec_equals_jax_generate(lm, rng, paged):
    """Mixed prompt and step shapes: the drafter changes how many tokens
    one dispatch emits, never which.  The first prompt's drafts are
    accepted from the first tick (:func:`_cycling_prompt`)."""
    jwf, jws, _, _ = lm
    shapes = [(25, 18), (5, 20), (17, 12), (9, 16), (13, 6)]
    prompts = [_cycling_prompt(lm, rng)] + [
        rng.integers(0, V, (1, p)).astype(np.int32) for p, _ in shapes[1:]]
    refs = [np.asarray(jax_generate(jwf, jws, pr, n))
            for pr, (_, n) in zip(prompts, shapes)]
    eng = _engine(lm, slots=4, l_max=64, window_ms=1.0, paged=paged,
                  spec=True, spec_k=4).start()
    try:
        got = [eng.generate(pr, n, timeout=180)
               for pr, (_, n) in zip(prompts, shapes)]
        st = eng.stats()
    finally:
        eng.stop()
    for i, (g, r) in enumerate(zip(got, refs)):
        np.testing.assert_array_equal(g, r, err_msg=f"case {shapes[i]}")
    assert st["spec"]["verify_steps"] > 0 and st["spec"]["accepted"] > 0
    assert st["compile"]["recompiles"] == 0


def test_spec_with_prefix_hit_admissions(lm, rng):
    jwf, jws, _, _ = lm
    eng = _engine(lm, slots=4, l_max=64, window_ms=1.0, spec=True,
                  spec_k=4).start()
    sysp = rng.integers(0, V, 32).astype(np.int32)       # 2 full pages
    a = np.concatenate([sysp, rng.integers(0, V, 3).astype(np.int32)])
    b = np.concatenate([sysp, rng.integers(0, V, 6).astype(np.int32)])
    try:
        for pr, n in ((a[None], 10), (b[None], 8), (a[None], 10)):
            np.testing.assert_array_equal(
                eng.generate(pr, n, timeout=180),
                np.asarray(jax_generate(jwf, jws, pr, n)))
        st = eng.stats()
        assert st["pages"]["prefix_hit_pages"] >= 2
        assert st["spec"]["verify_steps"] > 0
        assert st["compile"]["recompiles"] == 0
    finally:
        eng.stop()


def test_sampled_spec_is_bitwise_the_non_spec_engine(lm, rng):
    """Acceptance is exact-match against the sampler's own pick, so the
    sampled stream under every seed is the non-speculative engine's and
    ``generate()``'s."""
    _, _, pwf, pws = lm
    prompt = _repeat_phrase(rng, 5, 12)
    cases = [dict(temperature=1.3, top_k=6, seed=s) for s in range(6)]
    cases.append(dict(temperature=1.1, top_p=0.9, seed=11))
    runs = {}
    for spec in (False, True):
        eng = _engine(lm, slots=2, l_max=64, spec=spec, spec_k=3).start()
        try:
            runs[spec] = [eng.generate(prompt, 12, timeout=120, **kw)
                          for kw in cases]
            if spec:
                assert eng.stats()["spec"]["verify_steps"] > 0
        finally:
            eng.stop()
    for kw, a, b in zip(cases, runs[False], runs[True]):
        np.testing.assert_array_equal(b, a, err_msg=str(kw))
        np.testing.assert_array_equal(
            a, generate(pwf, pws, prompt, 12, **kw).numpy(), err_msg=str(kw))


def _record_dispatches(eng):
    """Log every dispatch as (kind, request, finished, emitted tokens)."""
    log, orig = [], eng._dispatch

    def dispatch(kind, batch=None):
        old = eng._pos.copy()
        fin, count, emitted = orig(kind, batch)
        for s in np.flatnonzero(emitted):
            p = int(old[s])
            log.append((kind, eng._slot_req[s], bool(fin[s]),
                        eng._toks[s, p + 1:p + 1 + emitted[s]].tolist()))
        return fin, count, emitted

    eng._dispatch = dispatch
    return log


def test_mid_block_eos_retires_inside_the_verify_step(lm, rng):
    """The prompt repeats a phrase of its greedy continuation
    (:func:`_cycling_prompt`), so the drafter fires from the first tick
    and its drafts are accepted.  A run without eos shows which tokens
    each verify step emitted; the eos is a token first emitted inside a
    verify step, before that step's last token.  With it, the stream is
    the JAX ``generate(eos_id=)``'s and the request finishes in a
    verify step."""
    jwf, jws, _, _ = lm
    prompt = _cycling_prompt(lm, rng)
    P = prompt.shape[1]
    eng = _engine(lm, slots=2, l_max=64, spec=True, spec_k=4).start()
    try:
        log = _record_dispatches(eng)
        full = eng.generate(prompt, 24, timeout=120)[0, P:]
        # the first such token: until the first decode step, whose wall
        # feeds the policy, the dispatches depend on the tokens alone
        seen, eos = {int(full[0])}, None       # full[0]: the prefill's
        for kind, _, _, toks in log:
            for j, t in enumerate(toks):
                if eos is None and t not in seen and kind == "verify" \
                        and j < len(toks) - 1:
                    eos = t
                seen.add(t)
        assert eos is not None, log
        # no decode step before it: the choice does not hang on timing
        first = next(i for i, (_, _, _, toks) in enumerate(log)
                     if eos in toks)
        assert all(kind == "verify" for kind, *_ in log[:first + 1]), log
        ref = np.asarray(jax_generate(jwf, jws, prompt, 24, eos_id=eos))
        log.clear()
        got = eng.generate(prompt, 24, eos_id=eos, timeout=120)
        np.testing.assert_array_equal(got, ref)
        assert got[0, -1] == eos or eos in got[0, P:]
        last = [e for e in log if e[2]]
        assert len(last) == 1 and last[0][0] == "verify", log
        assert last[0][3][-1] == eos
        assert eng.stats()["spec"]["verify_steps"] > 0
    finally:
        eng.stop()


def test_accept_rate_gauges_and_metrics(lm, rng):
    """stats()["spec"], and the spec series and the megastep gauge in
    ``GET /metrics``; ``GET /slo.json`` answers the SLO document."""
    _, _, pwf, pws = lm
    eng = _engine(lm, slots=2, l_max=64, spec=True, spec_k=4,
                  megastep=2)
    srv = RestfulServer(pwf.make_predict_step("out"), pws, 2, (6,),
                        port=0, workflow=pwf, engine=eng,
                        device="cpu").start()
    eng.start()
    try:
        eng.generate(_repeat_phrase(rng, 3, 8), 20, timeout=120)
        st = eng.stats()
        assert st["spec"]["proposed"] > 0
        assert 0.0 <= st["spec"]["accept_rate"] <= 1.0
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        names = {ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
                 if ln and not ln.startswith("#")}
        for name in ("vt_spec_proposed_total", "vt_spec_accepted_total",
                     "vt_spec_accept_rate", "vt_megastep_n",
                     "vt_spec_verify_step_seconds_count"):
            assert name in names, name
        with urllib.request.urlopen(base + "/slo.json", timeout=30) as r:
            assert isinstance(json.loads(r.read()), dict)
    finally:
        srv.stop()
        eng.stop()


def test_spec_config_validation(lm):
    with pytest.raises(ValueError, match="spec.k"):
        _engine(lm, slots=2, l_max=32, spec=True, spec_k=0)
    spec_cfg = port_root.common.serve.spec
    prev = spec_cfg.get("drafter", "ngram")
    spec_cfg.drafter = "llama"
    try:
        with pytest.raises(ValueError, match="drafter"):
            _engine(lm, slots=2, l_max=32, spec=True)
    finally:
        spec_cfg.drafter = prev


def test_paged_kernel_route_composes_with_spec(lm, rng):
    """``paged_kernel`` (its plain version on the CPU) with spec: the
    JAX ``generate()``'s tokens, no recompile; refused on dense."""
    jwf, jws, _, _ = lm
    prompt = rng.integers(0, V, (1, 9)).astype(np.int32)
    ref = np.asarray(jax_generate(jwf, jws, prompt, 8))
    eng = _engine(lm, slots=2, l_max=64, paged_kernel=True, spec=True,
                  spec_k=3).start()
    try:
        np.testing.assert_array_equal(eng.generate(prompt, 8, timeout=180),
                                      ref)
        assert eng.stats()["compile"]["recompiles"] == 0
    finally:
        eng.stop()
    with pytest.raises(ValueError, match="paged_kernel requires"):
        _engine(lm, slots=2, l_max=32, paged=False, paged_kernel=True)
