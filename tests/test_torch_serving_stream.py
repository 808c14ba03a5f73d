"""The port's streaming and its REST surface on the CPU
(tests/test_serving.py:929-1075, tests/test_overload.py:645-755 of the
JAX package): stop sequences across a flush boundary and on the first
token, finish reasons, submit validation, the ``emitted_prefix`` resume
bitwise with renumbered frames, a streamed request bitwise its unary
twin, a deadline mid-decode ending in a terminal frame; over HTTP the
NDJSON stream with stop and usage, the X-Priority header and the shed
body with Retry-After, and the refusals of what the port does not serve
yet.  The greedy references are the JAX package's generate() on shared
weights (float32, exact); sampled streams are held within the port."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.runtime.generate import generate as jax_generate  # noqa: E402
from veles_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from veles_tpu_torch.runtime.generate import generate  # noqa: E402
from veles_tpu_torch.runtime.restful import RestfulServer  # noqa: E402

from _torch_helpers import SERVE_V as V  # noqa: E402
from _torch_helpers import held, serve_pair, wait_busy  # noqa: E402

torch.set_num_threads(2)

PROMPT = (np.arange(8) * 7 % V).astype(np.int32)


@pytest.fixture(scope="module")
def lm():
    return serve_pair()


@pytest.fixture
def eng(lm):
    e = DecodeEngine(lm[2], lm[3], slots=2, l_max=64, window_ms=0.0,
                     device="cpu").start()
    yield e
    e.stop()


def _greedy(lm, n):
    jwf, jws, _, _ = lm
    return [int(t) for t in
            np.asarray(jax_generate(jwf, jws, PROMPT[None], n))[0, 8:]]


def _drain(handle, timeout_s=120.0):
    idx, toks, term = [], [], None
    for ev in handle.events(timeout_s=timeout_s):
        if ev[0] == "token":
            idx.append(ev[1])
            toks.append(ev[2])
        else:
            term = ev
    return idx, toks, term


def _novel_pair(gref):
    """The first k whose pair gref[k:k+2] does not occur earlier, so a
    stop on it trims at exactly k + 2."""
    return next(k for k in range(len(gref) - 1)
                if gref[k:k + 2] not in [gref[j:j + 2] for j in range(k)])


def test_stop_sequence_spans_a_flush_boundary(lm, eng):
    """One token a decode step: a 2-token stop sequence always straddles
    two flushes.  The result trims at the earliest match end, the finish
    reason is "stop", and the frames are exactly the kept tokens."""
    N = 12
    gref = _greedy(lm, N)
    k = _novel_pair(gref)
    req = eng.submit(PROMPT, N, stream=True, stop=[gref[k:k + 2]])
    idx, toks, term = _drain(req.stream)
    assert term == ("done", "stop", None), term
    assert req.done.wait(60) and req.error is None
    assert [int(t) for t in req.result[8:]] == gref[:k + 2]
    assert toks == gref[:k + 2] and idx == list(range(k + 2))


def test_stop_sequence_on_the_prefill_first_token(lm, eng):
    first = _greedy(lm, 1)[0]
    req = eng.submit(PROMPT, 6, stream=True, stop=[[first]])
    idx, toks, term = _drain(req.stream)
    assert term == ("done", "stop", None), term
    assert req.done.wait(60) and [int(t) for t in req.result[8:]] == [first]
    assert (idx, toks) == ([0], [first])


def test_finish_reasons_length_and_eos(lm, eng):
    """A full run ends "length" with n_steps frames; an eos id at its
    first occurrence ends "eos" with the frames through it."""
    N = 10
    gref = _greedy(lm, N)
    req = eng.submit(PROMPT, N, stream=True)
    idx, toks, term = _drain(req.stream)
    assert term == ("done", "length", None), term
    assert toks == gref and idx == list(range(N))
    j = max(j for j in range(N) if gref[j] not in gref[:j])
    req = eng.submit(PROMPT, N, stream=True, eos_id=gref[j])
    idx, toks, term = _drain(req.stream)
    assert term == ("done", "eos", None), term
    assert toks == gref[:j + 1] and idx == list(range(j + 1))
    assert eng.stats()["streams"] == 0          # every handle released


def test_submit_validation(eng):
    with pytest.raises(ValueError, match="stream=True"):
        eng.submit(PROMPT, 4, stop=[[1, 2]])
    with pytest.raises(ValueError, match="at most 16"):
        eng.submit(PROMPT, 4, stream=True, stop=[[1]] * 17)
    with pytest.raises(ValueError, match="1..32"):
        eng.submit(PROMPT, 4, stream=True, stop=[list(range(33))])
    with pytest.raises(ValueError, match="emitted_prefix"):
        eng.submit(PROMPT, 4, stream=True, emitted_prefix=[1, 2, 3, 4])
    with pytest.raises(ValueError, match="emitted_prefix token ids"):
        eng.submit(PROMPT, 4, stream=True, emitted_prefix=[V])


def test_resume_from_emitted_prefix_is_bitwise_and_renumbers(lm, eng):
    """The resume form (original prompt, n_steps and seed plus the tokens
    delivered) continues the sampled stream bit for bit, its frames
    numbered from len(emitted_prefix)."""
    _, _, pwf, pws = lm
    N, cut = 12, 5
    kw = dict(temperature=1.3, top_k=5, seed=11)
    ref = generate(pwf, pws, PROMPT[None], N, **kw).numpy()[0]
    gref = [int(t) for t in ref[8:]]
    req = eng.submit(PROMPT, N, stream=True, emitted_prefix=gref[:cut],
                     **kw)
    idx, toks, term = _drain(req.stream)
    assert term == ("done", "length", None), term
    assert idx == list(range(cut, N)) and toks == gref[cut:]
    assert req.done.wait(60) and req.error is None
    np.testing.assert_array_equal(req.result, ref)


def test_streamed_is_bitwise_unary(lm, eng):
    """A sampled request streamed gives its unary twin's tokens, and both
    generate()'s."""
    _, _, pwf, pws = lm
    kw = dict(temperature=0.9, top_p=0.9, seed=3)
    ref = generate(pwf, pws, PROMPT[None], 10, **kw).numpy()
    unary = eng.generate(PROMPT[None], 10, timeout=120, **kw)
    req = eng.submit(PROMPT, 10, stream=True, **kw)
    _, toks, term = _drain(req.stream)
    assert term[1] == "length"
    np.testing.assert_array_equal(unary, ref)
    assert toks == [int(t) for t in ref[0, 8:]]


def test_deadline_mid_decode_yields_a_terminal_frame(eng):
    """A slow decode step pushes a streaming request past its deadline:
    the consumer gets a terminal ("done", "deadline", ...) event, never a
    hang, and the request fails with TimeoutError."""
    step = eng._step_once
    eng._step_once = lambda: (time.sleep(0.4), step())
    req = eng.submit(PROMPT, 30, stream=True, deadline_s=0.2)
    events = list(req.stream.events(timeout_s=60))
    term = events[-1]
    assert term[0] == "done" and term[1] == "deadline", events
    assert "deadline" in term[2]
    assert req.done.wait(60) and isinstance(req.error, TimeoutError)
    assert eng.stats()["timeouts"] == 1 and eng.stats()["streams"] == 0


# -- REST ---------------------------------------------------------------------

@pytest.fixture
def served(lm):
    _, _, pwf, pws = lm
    e = DecodeEngine(pwf, pws, slots=1, l_max=64, window_ms=0.0,
                     queue_depth=2, priorities=3, preempt=False,
                     device="cpu").start()
    srv = RestfulServer(pwf.make_predict_step(), pws, 2, (12,), port=0,
                        workflow=pwf, engine=e, device="cpu").start()
    yield e, srv
    srv.stop()
    e.stop()


def _post(srv, body, headers=()):
    return urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/generate", json.dumps(body).encode(),
        {"Content-Type": "application/json", **dict(headers)}), timeout=120)


def test_rest_ndjson_stream_with_stop_and_usage(lm, served):
    _, srv = served
    N = 10
    gref = _greedy(lm, N)
    k = _novel_pair(gref)
    with _post(srv, {"prompt": PROMPT.tolist(), "steps": N, "stream": True,
                     "stop": [gref[k:k + 2]]}) as r:
        assert r.status == 200
        assert r.headers["Content-Type"] == "application/x-ndjson"
        frames = [json.loads(ln) for ln in r if ln.strip()]
    assert [f["token"] for f in frames[:-1]] == gref[:k + 2]
    assert [f["i"] for f in frames[:-1]] == list(range(k + 2))
    term = frames[-1]
    assert term["done"] and term["finish_reason"] == "stop", term
    assert term["usage"] == {"prompt_tokens": 8,
                             "completion_tokens": k + 2}, term
    for body in ({"stop": [[1]]}, {"emitted_prefix": [1]}):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, {"prompt": [PROMPT.tolist()], "steps": 4, **body})
        assert ei.value.code == 400


def test_rest_deadline_mid_stream_ends_with_a_terminal_frame(served):
    e, srv = served
    step = e._step_once
    e._step_once = lambda: (time.sleep(0.4), step())
    t0 = time.monotonic()
    with _post(srv, {"prompt": PROMPT.tolist(), "steps": 30,
                     "stream": True, "deadline_s": 0.2}) as r:
        frames = [json.loads(ln) for ln in r if ln.strip()]
    assert time.monotonic() - t0 < 30.0
    assert frames[-1]["done"] and frames[-1]["finish_reason"] == "deadline"
    assert "deadline" in frames[-1]["error"]


def test_rest_priority_header_and_shed_body(lm, rng, served):
    """X-Priority and the body's priority reach submit (out of range is a
    400); a shed answers 429 with Retry-After and the adaptive
    retry_after_s in the body."""
    e, srv = served
    jwf, jws, _, _ = lm
    prompt = rng.integers(1, V, (1, 5)).astype(np.int32)
    with _post(srv, {"prompt": prompt.tolist(), "steps": 4},
               [("X-Priority", "1")]) as r:
        np.testing.assert_array_equal(
            np.asarray(json.loads(r.read())["tokens"]),
            np.asarray(jax_generate(jwf, jws, prompt, 4)))
    with _post(srv, {"prompt": prompt.tolist(), "steps": 4,
                     "priority": 2}) as r:
        assert r.status == 200
    for bad in ({"priority": 99}, {"priority": 1.5}):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, {"prompt": prompt.tolist(), "steps": 4, **bad})
        assert ei.value.code == 400
    with held(e):
        holder = e.submit(rng.integers(0, V, 4), 6)
        wait_busy(e)
        queued = [e.submit(rng.integers(0, V, 4), 2, priority=1)
                  for _ in range(2)]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, {"prompt": prompt.tolist(), "steps": 4},
                  [("X-Priority", "2")])
        assert ei.value.code == 429
        assert int(ei.value.headers["Retry-After"]) >= 1
        assert json.loads(ei.value.read())["retry_after_s"] >= 1.0
    for r in (holder, *queued):
        assert r.done.wait(180) and r.error is None
    assert e.stats()["admission"]["shed_by_class"] == {"2": 1}


@pytest.mark.parametrize("body,name", [
    ({"beams": 2}, "beams"), ({"batch": True}, "batch"),
    ({"beams": 2, "stream": True}, "beams"),
    ({"batch": True, "stream": True}, "batch")])
def test_rest_refuses_what_the_port_does_not_serve(served, body, name):
    _, srv = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(srv, {"prompt": [PROMPT.tolist()], "steps": 4, **body})
    assert ei.value.code == 400
    err = json.loads(ei.value.read())["error"]
    assert err.startswith(name) and "ROADMAP.md" in err
