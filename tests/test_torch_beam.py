"""The port's beam search (runtime/generate.py) on the CPU, held to the JAX package on shared weights: ``generate_beam``'s ids
equal the JAX ``generate_beam``'s and its scores agree within rtol 1e-5
(float32; the two log-softmaxes differ in their last bits) for widths 1,
2 and 4, with and without eos and a length penalty, on a softmax-head LM
and on the bench LM's layer types; ``beams=1`` is greedy ``generate()``;
a covering width bounds every narrower one; eos freezes and pads; a
bfloat16 cache serves beam search as it serves ``generate``; each call
reads fresh params and a fresh seed (tests/test_generate.py:282-460);
and ``/generate`` with ``beams`` serves them with the JAX
package's size guard and refusals."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.runtime.generate import \
    generate_beam as jax_generate_beam  # noqa: E402
from veles_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from veles_tpu_torch.runtime.generate import (generate,  # noqa: E402
                                              generate_beam)
from veles_tpu_torch.runtime.restful import RestfulServer  # noqa: E402

from _torch_helpers import build_pair, narrow_bench_layers  # noqa: E402

torch.set_num_threads(2)

V = 12

#: tests/test_generate.py's "plain" LM
PLAIN = [
    {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
    {"type": "attention", "n_heads": 2, "rope": True, "residual": True,
     "name": "a1"},
    {"type": "layer_norm", "name": "n1"},
    {"type": "ffn", "d_hidden": 32, "name": "f1"},
    {"type": "seq_last", "name": "last"},
    {"type": "softmax", "output_size": V, "name": "out"},
]
BENCH = narrow_bench_layers(blocks=2, E=32, heads=4, kv_heads=2, hidden=64,
                            vocab=V)

SCORE_RTOL = 1e-5


@pytest.fixture(scope="module")
def plain():
    return build_pair(PLAIN, B=2, T=6, seed=5)


@pytest.fixture(scope="module")
def bench():
    return build_pair(BENCH, B=2, T=6, seed=7, per_position=True)


def _biased(pair, token, amount):
    """The same pair with the head's bias of ``token`` raised on both
    sides (so that eos fires within the steps)."""
    jwf, jws, pwf, pws = pair
    jws = dict(jws, params=dict(jws["params"]))
    head = "out" if "out" in jws["params"] else "head"
    jws["params"][head] = dict(jws["params"][head])
    jws["params"][head]["b"] = jws["params"][head]["b"].at[token].add(amount)
    pparams = {u: dict(p) for u, p in pws["params"].items()}
    pparams[head]["b"] = pparams[head]["b"].clone()
    pparams[head]["b"][token] += amount
    return jwf, jws, pwf, dict(pws, params=pparams)


@pytest.mark.parametrize("model", ["plain", "bench"])
@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("eos,lp", [(None, 0.0), (0, 0.6), (None, 1.0)],
                         ids=["raw", "eos_lp", "lp"])
def test_beam_matches_the_jax_package(request, model, W, eos, lp):
    pair = request.getfixturevalue(model)
    if eos is not None:
        pair = _biased(pair, eos, 1.5)
    jwf, jws, pwf, pws = pair
    prompt = np.random.default_rng(W).integers(1, V, (2, 5)).astype(
        np.int32)
    jt, js = jax_generate_beam(jwf, jws, prompt, 7, beams=W, eos_id=eos,
                               length_penalty=lp)
    pt, ps = generate_beam(pwf, pws, prompt, 7, beams=W, eos_id=eos,
                           length_penalty=lp)
    assert pt.dtype == torch.int32 and pt.shape == (2, 12)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=SCORE_RTOL)


def test_beam_width_one_is_greedy(plain, bench):
    for _, _, pwf, pws in (plain, bench):
        prompt = np.random.default_rng(1).integers(0, V, (2, 4)).astype(
            np.int32)
        toks, scores = generate_beam(pwf, pws, prompt, 6, beams=1)
        torch.testing.assert_close(toks, generate(pwf, pws, prompt, 6),
                                   rtol=0, atol=0)
        assert bool(torch.isfinite(scores).all())


def test_beam_covering_width_bounds_all_widths(plain):
    """A width covering the search space (W >= V^(N-1)) is the exact
    maximum, so every narrower width's score is bounded by it."""
    *_, pwf, pws = plain
    prompt = np.random.default_rng(2).integers(0, V, (2, 4)).astype(
        np.int32)
    _, opt = generate_beam(pwf, pws, prompt, 3, beams=V * V)
    for W in (1, 2, 4, 16):
        _, scores = generate_beam(pwf, pws, prompt, 3, beams=W)
        assert bool((scores <= opt + 1e-5).all()), (W, scores, opt)


def test_beam_eos_freezes_and_pads(plain):
    *_, pwf, pws = _biased(plain, 0, 4.0)
    prompt = np.random.default_rng(3).integers(1, V, (2, 3)).astype(
        np.int32)
    toks, _ = generate_beam(pwf, pws, prompt, 8, beams=4, eos_id=0,
                            length_penalty=0.6)
    gen = toks.numpy()[:, 3:]
    for row in gen:
        hit = np.where(row == 0)[0]
        assert len(hit), gen          # the bias makes every row finish
        assert np.all(row[hit[0]:] == 0), row


@pytest.mark.parametrize("model", ["plain", "bench"])
def test_beam_bf16_cache_width_one_is_greedy(request, model):
    """A bfloat16 KV cache (the engine's ``cache_dtype``) runs beam search
    too: finite scores, and width 1 is greedy ``generate`` on the same
    cache dtype, token for token."""
    *_, pwf, pws = request.getfixturevalue(model)
    prompt = np.random.default_rng(8).integers(0, V, (2, 4)).astype(
        np.int32)
    toks, scores = generate_beam(pwf, pws, prompt, 6, beams=1,
                                 cache_dtype=torch.bfloat16)
    torch.testing.assert_close(
        toks, generate(pwf, pws, prompt, 6, cache_dtype=torch.bfloat16),
        rtol=0, atol=0)
    assert bool(torch.isfinite(scores).all())
    _, wide = generate_beam(pwf, pws, prompt, 6, beams=4,
                            cache_dtype=torch.bfloat16)
    assert bool(torch.isfinite(wide).all())


# -- params and seed per call ------------------------------------------------

def test_calls_read_fresh_params_and_seed(plain):
    """Each call reads params and the seed it is given: two seeds give
    two samples, and a greedy call after a weight change serves the new
    weights (beam search too)."""
    *_, pwf, pws = plain
    prompt = np.random.default_rng(6).integers(0, V, (1, 4)).astype(
        np.int32)
    h1 = generate(pwf, pws, prompt, 8, temperature=5.0, seed=1)
    h2 = generate(pwf, pws, prompt, 8, temperature=5.0, seed=2)
    assert not torch.equal(h1, h2)
    g1 = generate(pwf, pws, prompt, 8)
    b1, _ = generate_beam(pwf, pws, prompt, 8, beams=2)
    tgt = (int(g1[0, -1]) + 1) % V
    params = {u: dict(p) for u, p in pws["params"].items()}
    params["out"]["b"] = params["out"]["b"].clone()
    params["out"]["b"][tgt] += 100.0
    ws2 = dict(pws, params=params)
    g2 = generate(pwf, ws2, prompt, 8)
    b2, _ = generate_beam(pwf, ws2, prompt, 8, beams=2)
    assert bool((g2[:, 4:] == tgt).all()), (g1, g2)
    assert bool((b2[:, 4:] == tgt).all()), (b1, b2)


# -- /generate with beams ------------------------------------------------------

def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=180) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read())


@pytest.fixture
def served(plain):
    *_, pwf, pws = plain
    eng = DecodeEngine(pwf, pws, slots=2, l_max=64, window_ms=1.0,
                       device="cpu")
    srv = RestfulServer(pwf.make_predict_step("out"), pws, 2, (6,),
                        workflow=pwf, engine=eng, device="cpu")
    eng.start()
    srv.start()
    yield pwf, pws, srv
    srv.stop()
    eng.stop()


def test_rest_beams_serve_generate_beam(served, plain):
    pwf, pws, srv = served
    jwf, jws = plain[0], plain[1]
    prompt = np.random.default_rng(7).integers(0, V, (2, 5)).astype(
        np.int32)
    code, body = _post(srv.port, {"prompt": prompt.tolist(), "steps": 6,
                                  "beams": 4, "length_penalty": 0.5})
    assert code == 200, body
    jt, js = jax_generate_beam(jwf, jws, prompt, 6, beams=4,
                               length_penalty=0.5)
    np.testing.assert_array_equal(np.asarray(body["tokens"]), np.asarray(jt))
    np.testing.assert_allclose(body["scores"], np.asarray(js),
                               rtol=SCORE_RTOL)
    code, body = _post(srv.port, {"prompt": prompt.tolist(), "steps": 6,
                                  "beams": 1})
    assert code == 200
    np.testing.assert_array_equal(np.asarray(body["tokens"]),
                                  generate(pwf, pws, prompt, 6).numpy())


@pytest.mark.parametrize("extra,match", [
    ({"beams": 0}, "beams must be >= 1"),
    ({"beams": 2, "temperature": 0.7}, "deterministic"),
    ({"beams": 2, "seed": 3}, "deterministic"),
    ({"beams": 2, "priority": 1}, "outside the engine queue"),
    ({"beams": 2, "length_penalty": -1}, "length_penalty"),
    ({"length_penalty": 0.5}, "needs beams > 1"),
    ({"beams": 2048, "steps": 600}, "token-cell cap"),
])
def test_rest_beams_refusals(served, extra, match):
    *_, srv = served
    code, body = _post(srv.port, {"prompt": [[1, 2, 3]], "steps": 4,
                                  **extra})
    assert code == 400 and match in body["error"], body


def test_rest_whole_valued_float_ids_are_ids(served):
    """The unary path takes whole-valued float ids as the JAX package's
    does (restful.py:630-640), with beams too; a fraction is 400."""
    *_, srv = served
    for extra in ({}, {"beams": 2}):
        ints = _post(srv.port, {"prompt": [[1, 2, 3]], "steps": 4, **extra})
        floats = _post(srv.port, {"prompt": [[1.0, 2.0, 3.0]], "steps": 4,
                                  **extra})
        assert ints[0] == floats[0] == 200
        assert ints[1]["tokens"] == floats[1]["tokens"]
    code, body = _post(srv.port, {"prompt": [[1.5, 2]], "steps": 4})
    assert code == 400 and "integers" in body["error"]
