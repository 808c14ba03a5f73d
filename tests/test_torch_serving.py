"""The port's HTTP front on the CPU: POST /predict and POST /generate
answer what the predict step, the JAX package and ``generate()`` answer,
a full queue answers 429 with Retry-After, the health endpoints report,
and the CLI boots the engine-backed server from a JAX-format snapshot."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from veles_tpu.runtime.generate import generate as jax_generate  # noqa: E402
from veles_tpu.runtime.snapshotter import Snapshotter as JaxSnap  # noqa: E402
from veles_tpu_torch.runtime.engine import (DecodeEngine,  # noqa: E402
                                            EngineOverloaded)
from veles_tpu_torch.runtime.restful import RestfulServer  # noqa: E402

from _torch_helpers import (CONFIGS, build_pair,  # noqa: E402
                            narrow_bench_layers, tokens, vocab_of)

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _post(port, path, body, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def served():
    layers = narrow_bench_layers()
    B, T = 2, 12
    jwf, jws, pwf, pws = build_pair(layers, B=B, T=T, seed=21)
    eng = DecodeEngine(pwf, pws, slots=2, l_max=64, window_ms=0.0,
                       queue_depth=2, paged_kernel=True,
                       device="cpu").start()
    srv = RestfulServer(pwf.make_predict_step(), pws, B, (T,), port=0,
                        workflow=pwf, engine=eng, device="cpu").start()
    yield layers, jwf, jws, pwf, pws, eng, srv
    srv.stop()
    eng.stop()


def test_predict_matches_step_and_jax(rng, served):
    layers, jwf, jws, pwf, pws, _, srv = served
    x = tokens(rng, (3, 12), vocab_of(layers))     # 3 rows: 2 chunks
    code, body = _post(srv.port, "/predict", {"input": x.tolist()})
    assert code == 200
    out = np.asarray(body["output"], np.float32)
    step = pwf.make_predict_step()
    ref = np.concatenate([
        step(pws, {"@input": torch.from_numpy(
            np.concatenate([x[i:i + 2],
                            np.zeros((2 - len(x[i:i + 2]), 12), np.int32)]))
        })[:len(x[i:i + 2])].numpy() for i in (0, 2)])
    np.testing.assert_array_equal(out, ref)
    jref = np.concatenate([
        np.asarray(jwf.make_predict_step()(
            jws, {"@input": jnp.asarray(np.concatenate(
                [x[i:i + 2], np.zeros((2 - len(x[i:i + 2]), 12),
                                      np.int32)]))}))[:len(x[i:i + 2])]
        for i in (0, 2)])
    np.testing.assert_allclose(out, jref, rtol=1e-5, atol=1e-5)


def test_generate_matches_generate_and_jax(rng, served):
    layers, jwf, jws, pwf, pws, _, srv = served
    prompt = tokens(rng, (2, 7), vocab_of(layers))
    code, body = _post(srv.port, "/generate",
                       {"prompt": prompt.tolist(), "steps": 8})
    assert code == 200
    ref = np.asarray(jax_generate(jwf, jws, prompt, 8))
    np.testing.assert_array_equal(np.asarray(body["tokens"]), ref)
    code, body = _post(srv.port, "/generate",
                       {"prompt": prompt[:1].tolist(), "steps": 5,
                        "temperature": 0.8, "top_k": 4, "seed": 3})
    from veles_tpu_torch.runtime.generate import generate
    sref = generate(pwf, pws, prompt[:1], 5, temperature=0.8, top_k=4,
                    seed=3).numpy()
    np.testing.assert_array_equal(np.asarray(body["tokens"]), sref)


def test_bad_requests_are_400(served):
    *_, srv = served
    for body in ({"prompt": [[1, 2]], "steps": 0},
                 {"prompt": [[1, 999]], "steps": 2},
                 # beam search is deterministic: no temperature
                 {"prompt": [[1, 2]], "steps": 2, "beams": 3,
                  "temperature": 0.5},
                 {"prompt": [[1, 2]], "steps": 2, "top_k": 3}):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.port, "/generate", body)
        assert ei.value.code == 400, body


def test_health_ready_engine(served):
    *_, srv = served
    assert _get(srv.port, "/healthz") == (200, {"status": "alive"})
    code, body = _get(srv.port, "/ready")
    assert code == 200 and body["ready"] is True
    code, st = _get(srv.port, "/engine")
    assert code == 200 and st["slots"] == 2 and st["paged_kernel"] is True


def _wait_busy(eng, timeout=30.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        st = eng.stats()
        if st["occupancy"] >= eng.slots and st["queue_depth"] == 0:
            return
        time.sleep(0.005)
    raise AssertionError("engine never became busy")


def test_full_queue_answers_429(rng, served, monkeypatch):
    layers, *_, eng, srv = served
    V = vocab_of(layers)
    # hold the scheduler at its next decode step so the slots stay busy
    # and the queue stays full for as long as the test needs
    gate = threading.Event()
    step = eng._step_once
    monkeypatch.setattr(eng, "_step_once",
                        lambda: (gate.wait(60), step()))
    rejected = eng.stats()["rejected"]
    try:
        held = [eng.submit(tokens(rng, 4, V), 20)
                for _ in range(eng.slots)]
        _wait_busy(eng)
        held += [eng.submit(tokens(rng, 4, V), 20) for _ in range(2)]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.port, "/generate",
                  {"prompt": tokens(rng, (1, 4), V).tolist(), "steps": 4})
        assert ei.value.code == 429
        assert int(ei.value.headers["Retry-After"]) >= 1
        with pytest.raises(EngineOverloaded):
            eng.submit(tokens(rng, 4, V), 4)
    finally:
        gate.set()
    for r in held:
        assert r.done.wait(120) and r.error is None
    assert eng.stats()["rejected"] == rejected + 2


def test_cli_serves_a_jax_snapshot(tmp_path):
    """python -m veles_tpu_torch CONFIG --snapshot SNAP --serve 0 --device
    cpu boots from a snapshot the JAX package wrote and answers."""
    cfg_path = os.path.join(CONFIGS, "induction_lm.json")
    with open(cfg_path) as f:
        layers = json.load(f)["workflow"]["layers"]
    jwf, jws, _, _ = build_pair(layers, B=4, T=8, seed=2)
    man = JaxSnap("cli", str(tmp_path)).save("t", {"wstate": jws})
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", cfg_path, "--snapshot",
         man, "--serve", "0", "--device", "cpu",
         "root.common.serve.slots=2", "root.common.serve.l_max=64"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    try:
        banner = json.loads(proc.stdout.readline())
        assert banner["engine"] and banner["device"] == "cpu"
        prompt = np.arange(6, dtype=np.int32)[None] % 16
        code, body = _post(banner["serving"], "/generate",
                           {"prompt": prompt.tolist(), "steps": 5})
        assert code == 200
        np.testing.assert_array_equal(
            np.asarray(body["tokens"]),
            np.asarray(jax_generate(jwf, jws, prompt, 5)))
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
