"""The port's model lifecycle control plane (runtime/deploy.py and the
engine's hot swap and drain) on the CPU, held to tests/test_deploy.py's
contracts and to the JAX package on shared weights: hot swaps under
concurrent load drop no request and build no program; the engine serves
the tensors it is given where they already lie on its device, and a swap
writes into them in place (every storage kept, one staged copy) and
serves the new weights (the JAX package's greedy tokens
on them); a mismatched tree is refused with the old version serving;
drain refuses new work and retires the in-flight; reloads from snapshots
of either package update the registry, failures leave the old version
serving; the REST lifecycle endpoints follow the drain contract; the
watcher swaps with back-off; the gauges reach the status page; a boot
snapshot is reloadable and dedups the watcher; stage / commit / abort;
a swap drops the prefix cache and refuses a VTKV1 blob from before it;
a drain hands its hot pages to a successor; hot swaps under load from
a compiled artifact, an export package of either package (a directory
and a ``.zip``) and a ``forge://`` store, a foreign workflow's refused."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.runtime.generate import generate as jax_generate  # noqa: E402
from veles_tpu.runtime.snapshotter import \
    Snapshotter as JaxSnapshotter  # noqa: E402
from veles_tpu_torch.runtime.deploy import DeployController  # noqa: E402
from veles_tpu_torch.runtime.engine import (DecodeEngine,  # noqa: E402
                                            EngineDraining,
                                            prefix_page_hashes)
from veles_tpu_torch.runtime.generate import generate  # noqa: E402
from veles_tpu_torch.runtime.restful import RestfulServer  # noqa: E402
from veles_tpu_torch.runtime.snapshotter import (Snapshotter,  # noqa: E402
                                                 params_to_numpy)

from _torch_helpers import build_pair  # noqa: E402

torch.set_num_threads(2)

V = 12

#: tests/test_deploy.py:33-40's LM
LAYERS = [
    {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
    {"type": "attention", "n_heads": 2, "rope": True, "residual": True,
     "name": "a1"},
    {"type": "layer_norm", "name": "n1"},
    {"type": "ffn", "d_hidden": 32, "name": "f1"},
    {"type": "seq_last", "name": "last"},
    {"type": "softmax", "output_size": V, "name": "out"},
]
#: the same topology at another width (the embedding's dim)
OTHER = [dict(LAYERS[0], dim=8)] + [dict(d) for d in LAYERS[1:]]


@pytest.fixture(scope="module")
def pair_a():
    return build_pair(LAYERS, B=2, T=6, seed=3)


@pytest.fixture(scope="module")
def pair_b():
    return build_pair(LAYERS, B=2, T=6, seed=11)


def _own(pws):
    """``pws`` with params of its own: an engine serves the host tensors
    it is given, and a swap writes into them."""
    return dict(pws, params={u: {k: t.clone() for k, t in p.items()}
                             for u, p in pws["params"].items()})


def _engine(pwf, pws, **kw):
    """An engine on its own copy of ``pws``'s params (the module's
    fixtures stay as built)."""
    kw = {"slots": 2, "l_max": 32, "window_ms": 0.0, **kw}
    return DecodeEngine(pwf, _own(pws), device="cpu", **kw)


def _snap(tmp_path, pwf, pws, tag, subdir="snaps"):
    """A port snapshot the control plane can load (the Trainer's payload
    shape: wstate + workflow_checksum; the state has no key to save)."""
    return Snapshotter("m", str(tmp_path / subdir)).save(
        tag, {"wstate": {"params": params_to_numpy(pws["params"])},
              "workflow_checksum": pwf.checksum()})


def _served(eng):
    return [(u, k, t) for u, p in eng.params.items() for k, t in p.items()]


# -- the engine's swap -------------------------------------------------------

def test_hot_swap_under_load_zero_drops_flat_compiles(pair_a, pair_b, rng):
    """Mixed-shape concurrent requests across two hot swaps: every
    request completes, the step counters stay flat, and a greedy request
    after the last swap equals the JAX package's on those weights."""
    jwf, jws_a, pwf, pws_a = pair_a
    pws_b = pair_b[3]
    eng = _engine(pwf, pws_a, slots=4, l_max=64).start()
    shapes = [(3, 4), (7, 3), (11, 5), (4, 2), (17, 4), (5, 6)]
    prompts = [rng.integers(0, V, (1, p)).astype(np.int32)
               for p, _ in shapes]
    try:
        for pr, (_, n) in zip(prompts, shapes):
            eng.generate(pr, n, timeout=180)
        compiles_before = eng.stats()["compile"]["compiles"]
        errs, done = [], []
        stop = threading.Event()

        def worker(i):
            while not stop.is_set():
                try:
                    done.append(eng.generate(prompts[i], shapes[i][1],
                                             timeout=180).shape)
                except Exception as e:  # noqa: BLE001
                    errs.append(repr(e))
                    return

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(shapes))]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        while len(done) < 4:
            assert time.monotonic() < deadline, (done, errs)
            time.sleep(0.01)
        eng.swap_params(pws_b["params"])
        while len(done) < 10:
            assert time.monotonic() < deadline, (done, errs)
            time.sleep(0.01)
        eng.swap_params(pws_a["params"])
        stop.set()
        for t in threads:
            t.join(timeout=240)
        assert not errs, errs
        st = eng.stats()
        assert st["swaps"] == 2
        assert st["compile"]["compiles"] == compiles_before, st
        assert st["compile"]["recompiles"] == 0, st
        ref = np.asarray(jax_generate(jwf, jws_a, prompts[0], shapes[0][1]))
        got = eng.generate(prompts[0], shapes[0][1], timeout=120)
        np.testing.assert_array_equal(got, ref)
    finally:
        stop.set()
        eng.stop()


def test_swap_serves_new_weights(pair_a, pair_b, rng):
    """After a swap the greedy tokens are a fresh engine's on the new
    weights, and the JAX package's generate() on them."""
    pwf, pws_a = pair_a[2], pair_a[3]
    jwf, jws_b, _, pws_b = pair_b
    prompt = rng.integers(0, V, (1, 5)).astype(np.int32)
    fresh = _engine(pwf, pws_b).start()
    try:
        ref_b = fresh.generate(prompt, 6, timeout=120)
    finally:
        fresh.stop()
    np.testing.assert_array_equal(
        ref_b, np.asarray(jax_generate(jwf, jws_b, prompt, 6)))
    eng = _engine(pwf, pws_a).start()
    try:
        got_a = eng.generate(prompt, 6, timeout=120)
        eng.swap_params(pws_b["params"])
        got_b = eng.generate(prompt, 6, timeout=120)
    finally:
        eng.stop()
    np.testing.assert_array_equal(got_b, ref_b)
    assert not np.array_equal(got_a, got_b)


@pytest.mark.parametrize("started", [True, False],
                         ids=["running", "stopped"])
def test_swap_keeps_every_served_tensors_storage(pair_a, pair_b, started):
    """The captured steps read fixed addresses: the engine serves the
    caller's tensors (no second copy) and a swap copies into them in
    place (each keeps its storage); the new tree is left as given, and
    numpy leaves stage as tensors do."""
    pwf, pws_b = pair_a[2], pair_b[3]
    mine = _own(pair_a[3])
    b_before = _own(pws_b)["params"]
    eng = DecodeEngine(pwf, mine, slots=2, l_max=32, window_ms=0.0,
                       device="cpu")
    if started:
        eng.start()
    try:
        ptrs = [(u, k, t.data_ptr()) for u, k, t in _served(eng)]
        assert ptrs == [(u, k, mine["params"][u][k].data_ptr())
                        for u, k, _t in _served(eng)]   # no second copy
        assert eng.wstate["params"] is eng.params
        eng.swap_params(pws_b["params"])
        assert [(u, k, t.data_ptr()) for u, k, t in _served(eng)] == ptrs
        for u, k, t in _served(eng):
            assert torch.equal(t, b_before[u][k].to(t.dtype))
            assert torch.equal(pws_b["params"][u][k], b_before[u][k])
        eng.swap_params({u: {k: (t + 1).numpy() for k, t in p.items()}
                         for u, p in b_before.items()})
        for u, k, t in _served(eng):
            assert torch.equal(t, b_before[u][k] + 1)
        assert [(u, k, t.data_ptr()) for u, k, t in _served(eng)] == ptrs
        assert eng.swaps == 2
    finally:
        eng.stop()


def test_swap_rejects_mismatched_tree_old_still_serving(pair_a, rng):
    """Another architecture is refused with the offending leaves named;
    the old version keeps serving, its storage and values untouched."""
    jwf, jws, pwf, pws = pair_a
    pws_small = build_pair(OTHER, B=2, T=6, seed=3)[3]
    eng = _engine(pwf, pws).start()
    prompt = rng.integers(0, V, (1, 4)).astype(np.int32)
    try:
        served = {(u, k): t.clone() for u, k, t in _served(eng)}
        with pytest.raises(ValueError, match=r"hot swap rejected.*emb"):
            eng.swap_params(pws_small["params"])
        assert eng.stats()["swaps"] == 0
        assert all(torch.equal(t, served[(u, k)]) for u, k, t in
                   _served(eng))
        got = eng.generate(prompt, 5, timeout=120)
        np.testing.assert_array_equal(
            got, np.asarray(jax_generate(jwf, jws, prompt, 5)))
    finally:
        eng.stop()


def test_swap_drops_the_prefix_cache_and_old_vtkv1_blobs(pair_a, pair_b,
                                                         rng):
    """Cached prefix pages hold KV of the old weights: a swap drops the
    index (a hit restarts from zero) and bumps the weights version, so a
    blob exported before it is refused."""
    pwf, pws_a = pair_a[2], pair_a[3]
    pws_b = pair_b[3]
    prompt = rng.integers(0, V, 40).astype(np.int32)
    eng = _engine(pwf, pws_a, l_max=64).start()
    try:
        eng.generate(prompt[None], 2, timeout=120)
        blob = eng.export_pages(prefix_page_hashes(prompt, eng.page_size))
        wver = eng.kv_wver
        assert eng.stats()["pages"]["cached"] == 2
        eng.swap_params(pws_b["params"])
        assert eng.kv_wver != wver and eng.kv_wver.endswith(".1")
        assert eng.stats()["pages"]["cached"] == 0
        hits = eng.stats()["pages"]["prefix_hit_pages"]
        eng.generate(prompt[None], 2, timeout=120)
        assert eng.stats()["pages"]["prefix_hit_pages"] == hits
        with pytest.raises(ValueError, match="weights-version mismatch"):
            eng.import_pages(blob)
    finally:
        eng.stop()


def test_engine_drain_refuses_new_work_retires_inflight(pair_a, rng):
    """drain(): a long in-flight request retires cleanly, new submits
    raise EngineDraining, and the engine stops afterwards."""
    pwf, pws = pair_a[2], pair_a[3]
    eng = _engine(pwf, pws, l_max=64).start()
    long_req = eng.submit(rng.integers(0, V, 4), 40)
    deadline = time.monotonic() + 60
    while eng.stats()["occupancy"] == 0:
        assert time.monotonic() < deadline
        time.sleep(0.001)
    drained = {}
    t = threading.Thread(
        target=lambda: drained.setdefault("clean", eng.drain(60)))
    t.start()
    deadline = time.monotonic() + 30
    while not eng.draining:
        assert time.monotonic() < deadline
        time.sleep(0.001)
    with pytest.raises(EngineDraining):
        eng.submit(rng.integers(0, V, 4), 2)
    t.join(timeout=120)
    assert drained.get("clean") is True
    assert long_req.done.is_set() and long_req.error is None
    assert not eng.started


# -- the control plane: registry, reload, rollback ---------------------------

def test_reload_from_snapshot_updates_registry(tmp_path, pair_a, pair_b,
                                               rng):
    """A snapshot the JAX package wrote reloads into the port's engine:
    the registry grows, the swap builds nothing, the tokens are the JAX
    package's on the new weights; versions re-activate from their
    source, the boot state has none, an unknown version is a KeyError."""
    pwf, pws_a = pair_a[2], pair_a[3]
    jwf, jws_b = pair_b[0], pair_b[1]
    path_b = JaxSnapshotter("m", str(tmp_path / "jax")).save(
        "v2", {"wstate": jax.device_get(jws_b),
               "workflow_checksum": jwf.checksum()})
    prompt = rng.integers(0, V, (1, 5)).astype(np.int32)
    ref_b = np.asarray(jax_generate(jwf, jws_b, prompt, 6))
    eng = _engine(pwf, pws_a).start()
    dep = DeployController(engine=eng)
    try:
        doc = dep.models_doc()
        assert doc["active"] == 1 and len(doc["versions"]) == 1
        out = dep.reload(path_b)
        assert out["active"]["version"] == 2
        assert out["active"]["kind"] == "snapshot"
        assert out["active"]["checksum"]
        assert out["compiles_during_swap"] == 0
        assert out["stage_ms"] >= 0 and out["flip_ms"] >= 0
        np.testing.assert_array_equal(eng.generate(prompt, 6, timeout=120),
                                      ref_b)
        doc = dep.models_doc()
        assert doc["active"] == 2 and len(doc["versions"]) == 2
        assert doc["versions"][0]["active"] is False
        dep.reload(version=2)
        assert dep.registry.active_version == 3
        with pytest.raises(ValueError, match="boot"):
            dep.reload(version=1)
        with pytest.raises(KeyError):
            dep.reload(version=99)
    finally:
        eng.stop()


def test_reload_failure_leaves_old_serving(tmp_path, pair_a, rng):
    """Every failure of a reload leaves the active version serving: a
    missing file, another architecture (the signature check names the
    leaves), another workflow's snapshot, and unusable export sources (a
    package directory, a .zip, an artifact, a forge store)."""
    jwf, jws, pwf, pws = pair_a
    small = build_pair(OTHER, B=2, T=6, seed=3)
    bad_arch = _snap(tmp_path, small[2], small[3], "bad")
    other_wf = build_pair(LAYERS[:1] + LAYERS[-2:], B=2, T=6, seed=3)
    foreign = _snap(tmp_path, other_wf[2], pws, "foreign")
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "contents.json").write_text("{}")
    prompt = rng.integers(0, V, (1, 4)).astype(np.int32)
    eng = _engine(pwf, pws).start()
    dep = DeployController(engine=eng)
    try:
        ref = np.asarray(jax_generate(jwf, jws, prompt, 5))
        with pytest.raises(FileNotFoundError):
            dep.reload(str(tmp_path / "nope.json"))
        with pytest.raises(ValueError, match=r"hot swap rejected.*emb"):
            dep.reload(bad_arch)
        with pytest.raises(ValueError, match="different workflow"):
            dep.reload(foreign)
        # the export sources, each unusable here: a package without
        # units, a missing .zip, a directory that is no artifact, a
        # forge store that does not hold the name
        for src, err, match in (
                (str(pkg), ValueError, "missing key 'units'"),
                (str(tmp_path / "m.zip"), FileNotFoundError, "m.zip"),
                ("artifact://" + str(pkg), RuntimeError,
                 "not a compiled artifact"),
                (f"forge://{tmp_path}/store/name", ValueError,
                 "no such package")):
            with pytest.raises(err, match=match):
                dep.reload(src)
        assert dep.registry.active_version == 1
        assert dep.swaps == 0 and dep.last_error
        np.testing.assert_array_equal(eng.generate(prompt, 5, timeout=120),
                                      ref)
    finally:
        eng.stop()


def test_stage_commit_and_abort(tmp_path, pair_a, pair_b, rng):
    """Stage places the new weights without flipping (the old version
    serves), abort withdraws them, commit flips; a commit with another
    token and a second stage are refused."""
    pwf, pws_a = pair_a[2], pair_a[3]
    pwf_b, pws_b = pair_b[2], pair_b[3]
    path_b = _snap(tmp_path, pwf_b, pws_b, "v2")
    prompt = rng.integers(0, V, (1, 5)).astype(np.int32)
    ref_a = np.asarray(generate(pwf, pws_a, prompt, 6))
    ref_b = np.asarray(generate(pwf, pws_b, prompt, 6))
    eng = _engine(pwf, pws_a).start()
    dep = DeployController(engine=eng)
    try:
        tok = dep.stage(path_b)["staged"]
        with pytest.raises(ValueError, match="already staged"):
            dep.stage(path_b)
        np.testing.assert_array_equal(eng.generate(prompt, 6, timeout=60),
                                      ref_a)
        assert dep.abort_staged(tok) == {"aborted": tok}
        assert dep.abort_staged() == {"aborted": None}
        with pytest.raises(ValueError, match="no staged swap"):
            dep.commit_staged(tok)
        np.testing.assert_array_equal(eng.generate(prompt, 6, timeout=60),
                                      ref_a)
        assert eng.swaps == 0 and dep.registry.active_version == 1
        tok = dep.stage(path_b)["staged"]
        with pytest.raises(ValueError, match="no staged swap"):
            dep.commit_staged("stage-999")
        out = dep.commit_staged(tok)
        assert out["active"]["version"] == 2 and eng.swaps == 1
        np.testing.assert_array_equal(eng.generate(prompt, 6, timeout=60),
                                      ref_b)
    finally:
        eng.stop()


# -- REST -------------------------------------------------------------------

def _body(raw):
    try:
        return json.loads(raw)
    except ValueError:
        return raw


def _post(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=180) as r:
            return r.status, _body(r.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, _body(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, _body(r.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, _body(e.read())


def test_healthz_ready_without_engine(pair_a):
    """Liveness and readiness answer on a plain predict server: no
    engine, no workflow, no deploy controller (/models and /admin/* are
    404 then)."""
    pwf, pws = pair_a[2], pair_a[3]
    srv = RestfulServer(pwf.make_predict_step("out"), pws, 2, (6,),
                        device="cpu").start()
    try:
        code, doc = _get(srv.port, "/healthz")
        assert code == 200 and doc["status"] == "alive"
        code, doc = _get(srv.port, "/ready")
        assert code == 200 and doc["ready"] is True
        assert _get(srv.port, "/models")[0] == 404
        assert _post(srv.port, "/admin/reload", {"path": "x"})[0] == 404
    finally:
        srv.stop()


def test_rest_reload_under_load_and_drain(tmp_path, pair_a, pair_b, rng):
    """The scenario end to end: under concurrent load POST /admin/reload
    drops no request and builds no program; the next greedy tokens are
    the new weights'; a bad reload answers 409 with the active version;
    POST /admin/drain answers 202, /ready 503, the in-flight request
    retires, new work gets 503, /healthz stays 200."""
    pwf, pws_a = pair_a[2], pair_a[3]
    jwf, jws_b, pwf_b, pws_b = pair_b
    path_b = _snap(tmp_path, pwf_b, pws_b, "v2")
    eng = _engine(pwf, pws_a, slots=4, l_max=64, queue_depth=64)
    srv = RestfulServer(pwf.make_predict_step("out"), pws_a, 2, (6,),
                        workflow=pwf, engine=eng, device="cpu")
    eng.start()
    srv.start()
    dep = DeployController(server=srv)
    prompt = rng.integers(0, V, (1, 5)).astype(np.int32)
    try:
        assert srv.deploy is dep and dep.engine is eng
        code, doc = _get(srv.port, "/ready")
        assert code == 200 and doc["ready"], doc
        _post(srv.port, "/generate", {"prompt": prompt.tolist(), "steps": 4})
        compiles_before = eng.stats()["compile"]["compiles"]
        codes, stop = [], threading.Event()
        lock = threading.Lock()

        def hammer():
            while not stop.is_set():
                code, _ = _post(srv.port, "/generate",
                                {"prompt": prompt.tolist(), "steps": 4})
                with lock:
                    codes.append(code)

        threads = [threading.Thread(target=hammer) for _ in range(3)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        while len(codes) < 3:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        code, out = _post(srv.port, "/admin/reload", {"path": path_b})
        assert code == 200, out
        assert out["active"]["version"] == 2
        # the engine's own count at the flip: at most the 3 clients'
        assert 0 <= out["in_flight_at_flip"] <= 3, out
        assert eng.stats()["swap_in_flight"] == out["in_flight_at_flip"]
        n_at_swap = len(codes)
        while len(codes) < n_at_swap + 3:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        assert codes and all(c == 200 for c in codes), set(codes)
        st = eng.stats()
        assert st["compile"]["compiles"] == compiles_before, st
        assert st["compile"]["recompiles"] == 0, st
        code, out = _post(srv.port, "/generate",
                          {"prompt": prompt.tolist(), "steps": 4})
        np.testing.assert_array_equal(
            np.asarray(out["tokens"]),
            np.asarray(jax_generate(jwf, jws_b, prompt, 4)))
        code, doc = _get(srv.port, "/models")
        assert code == 200 and doc["active"] == 2 and doc["swaps"] == 1
        code, out = _post(srv.port, "/admin/reload",
                          {"path": str(tmp_path / "missing.json")})
        assert code == 409 and out["active"] == 2, out
        assert _post(srv.port, "/admin/reload", {})[0] == 400
        assert _post(srv.port, "/admin/reload", {"version": 42})[0] == 404

        slow = threading.Thread(
            target=lambda: _post(srv.port, "/generate",
                                 {"prompt": prompt.tolist(), "steps": 40}))
        slow.start()
        deadline = time.monotonic() + 60
        while eng.stats()["occupancy"] == 0:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        code, doc = _post(srv.port, "/admin/drain")
        assert code == 202 and doc["draining"] is True
        code, doc = _get(srv.port, "/ready")
        assert code == 503 and doc["reason"] == "draining", doc
        assert dep.wait(timeout=120)
        slow.join(timeout=60)
        assert not eng.started
        assert _get(srv.port, "/healthz")[0] == 200
        code, out = _post(srv.port, "/generate",
                          {"prompt": prompt.tolist(), "steps": 2})
        assert code == 503, out
        code, out = _post(srv.port, "/admin/reload", {"path": path_b})
        assert code == 503, out
    finally:
        stop.set()
        srv.stop()
        eng.stop()


def test_rest_stage_commit_abort(tmp_path, pair_a, pair_b):
    pwf, pws_a = pair_a[2], pair_a[3]
    path_b = _snap(tmp_path, pair_b[2], pair_b[3], "v2")
    eng = _engine(pwf, pws_a)
    srv = RestfulServer(pwf.make_predict_step("out"), pws_a, 2, (6,),
                        workflow=pwf, engine=eng, device="cpu")
    eng.start()
    srv.start()
    DeployController(server=srv)
    try:
        code, doc = _post(srv.port, "/admin/stage", {"path": path_b})
        assert code == 200 and doc["staged"] == "stage-1"
        assert _post(srv.port, "/admin/stage", {"path": path_b})[0] == 409
        assert _post(srv.port, "/admin/commit", {})[0] == 400
        code, doc = _post(srv.port, "/admin/abort", {"token": "stage-1"})
        assert code == 200 and doc == {"aborted": "stage-1"}
        assert _post(srv.port, "/admin/commit",
                     {"token": "stage-1"})[0] == 409
        tok = _post(srv.port, "/admin/stage", {"path": path_b})[1]["staged"]
        code, doc = _post(srv.port, "/admin/commit", {"token": tok})
        assert code == 200 and doc["active"]["version"] == 2
        assert eng.swaps == 1
    finally:
        srv.stop()
        eng.stop()


def test_drain_hands_its_hot_pages_to_a_successor(pair_a, rng):
    """``begin_drain(handoff=url)`` pushes the engine's hottest prefix
    pages through the successor's PUT /kv/pages before the engine stops;
    the successor then hits them."""
    pwf, pws = pair_a[2], pair_a[3]
    prompt = rng.integers(0, V, 40).astype(np.int32)
    a = _engine(pwf, pws, l_max=64).start()
    b = _engine(pwf, pws, l_max=64)
    srv_b = RestfulServer(pwf.make_predict_step("out"), pws, 2, (6,),
                          workflow=pwf, engine=b, device="cpu")
    b.start()
    srv_b.start()
    try:
        a.generate(prompt[None], 2, timeout=120)
        dep = DeployController(engine=a)
        dep.begin_drain(handoff=f"http://127.0.0.1:{srv_b.port}")
        assert dep.wait(timeout=120)
        assert not a.started
        assert b.stats()["kv_transfer"]["imported_pages"] == 2
        b.generate(prompt[None], 2, timeout=120)
        assert b.stats()["pages"]["prefix_hit_pages"] == 2
    finally:
        srv_b.stop()
        b.stop()
        a.stop()


# -- watcher, status, boot ----------------------------------------------------

def test_watcher_autoswaps_and_backs_off(tmp_path, pair_a, pair_b, rng):
    """The watcher survives a corrupt newest snapshot (back-off, retry)
    and swaps on its own once a good one lands, and not again after."""
    pwf, pws_a = pair_a[2], pair_a[3]
    pwf_b, pws_b = pair_b[2], pair_b[3]
    model_dir = tmp_path / "models"
    model_dir.mkdir()
    (model_dir / "m_bad.json").write_text(
        json.dumps({"tensors": "missing.npz", "saved_at": time.time()}))
    prompt = rng.integers(0, V, (1, 5)).astype(np.int32)
    ref_b = np.asarray(generate(pwf, pws_b, prompt, 6))
    eng = _engine(pwf, pws_a).start()
    dep = DeployController(engine=eng, model_dir=str(model_dir),
                           watch_interval_s=0.05, watch_backoff_max_s=0.2)
    try:
        dep.start_watcher()
        deadline = time.monotonic() + 60
        while dep.last_error is None:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert dep.registry.active_version == 1
        _snap(tmp_path, pwf_b, pws_b, "v2", subdir="models")
        while dep.registry.active_version == 1:
            assert time.monotonic() < deadline, dep.last_error
            time.sleep(0.01)
        assert dep.swaps == 1
        np.testing.assert_array_equal(eng.generate(prompt, 6, timeout=120),
                                      ref_b)
        time.sleep(0.3)
        assert dep.swaps == 1
    finally:
        dep.stop_watcher()
        eng.stop()


def test_deploy_gauges_reach_status(tmp_path, pair_a, pair_b):
    """The swap and version gauges ride the status path: update() gets a
    deploy group and record_event ships the swap history; the engine's
    stats reach the page on its scheduler's tick."""
    from veles_tpu_torch.runtime.status import StatusReporter
    rep = StatusReporter(str(tmp_path / "status.json"), name="deploy")
    pwf, pws_a = pair_a[2], pair_a[3]
    path_b = _snap(tmp_path, pair_b[2], pair_b[3], "v2")
    eng = _engine(pwf, pws_a, status=rep).start()
    dep = DeployController(engine=eng, status=rep)
    try:
        dep.reload(path_b)
        doc = rep.read()
        assert doc["deploy"]["active_version"] == 2
        assert doc["deploy"]["swaps"] == 1
        assert any(e["kind"] == "swap" and e["version"] == 2
                   for e in doc["events"])
        deadline = time.monotonic() + 30
        while rep.read().get("engine", {}).get("swaps") != 1:
            assert time.monotonic() < deadline, rep.read().get("engine")
            time.sleep(0.05)
    finally:
        eng.stop()


def test_boot_snapshot_registers_reloadable_and_dedups_watcher(tmp_path,
                                                               pair_a):
    """A boot source that is a snapshot registers version 1 with its
    checksum: the watcher does not re-swap the snapshot the process
    booted from, and {"version": 1} reloads are legal."""
    pwf, pws_a = pair_a[2], pair_a[3]
    path_a = _snap(tmp_path, pwf, pws_a, "v1", subdir="models")
    eng = _engine(pwf, pws_a).start()
    dep = DeployController(engine=eng, model_dir=str(tmp_path / "models"),
                           boot_source=path_a, watch_interval_s=0.05)
    try:
        boot = dep.registry.get(1)
        assert boot["kind"] == "snapshot" and boot["checksum"]
        dep.start_watcher()
        time.sleep(0.5)
        assert dep.swaps == 0
        dep.reload(version=1)
        assert dep.swaps == 1 and dep.registry.active_version == 2
    finally:
        dep.stop_watcher()
        eng.stop()


# -- the CLI ------------------------------------------------------------------

def test_cli_lifecycle_flags(tmp_path):
    """``python -m veles_tpu_torch CONFIG --snapshot SNAP --serve 0
    --model-dir DIR --status-port 0 --trace-out F``: the banner names the
    model dir and the status port, ``POST /admin/reload`` swaps to a JAX
    package snapshot (its greedy tokens then), the status page shows the
    deploy group, ``POST /admin/drain`` ends the process with 0 and the
    trace file holds the request spans; ``--watch`` without
    ``--model-dir`` is refused."""
    import os
    import subprocess
    import sys
    repo = os.path.join(os.path.dirname(__file__), os.pardir)
    cfg = os.path.join(repo, "configs", "induction_lm.json")
    with open(cfg) as f:
        layers = json.load(f)["workflow"]["layers"]
    jwf, jws_a = build_pair(layers, B=4, T=8, seed=2)[:2]
    jws_b = build_pair(layers, B=4, T=8, seed=5)[1]
    snap = {tag: JaxSnapshotter("cli", str(tmp_path / "models")).save(
        tag, {"wstate": jax.device_get(ws),
              "workflow_checksum": jwf.checksum()})
        for tag, ws in (("a", jws_a), ("b", jws_b))}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    base = [sys.executable, "-m", "veles_tpu_torch", cfg, "--snapshot",
            snap["a"], "--serve", "0", "--device", "cpu",
            "root.common.serve.slots=2", "root.common.serve.l_max=64",
            f"root.common.cache_dir={tmp_path / 'cache'}"]
    r = subprocess.run(base + ["--watch"], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "--watch needs --model-dir" in r.stderr
    trace = tmp_path / "trace.json"
    proc = subprocess.Popen(
        base + ["--model-dir", str(tmp_path / "models"), "--status-port",
                "0", "--trace-out", str(trace)],
        cwd=repo, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        banner = json.loads(proc.stdout.readline())
        port = banner["serving"]
        assert banner["model_dir"] == str(tmp_path / "models")
        assert "/memory.json" in banner["observe"]
        prompt = (np.arange(6, dtype=np.int32)[None] % 16)
        code, out = _post(port, "/admin/reload", {"path": snap["b"]})
        assert code == 200 and out["active"]["version"] == 2, out
        code, out = _post(port, "/generate",
                          {"prompt": prompt.tolist(), "steps": 5})
        np.testing.assert_array_equal(
            np.asarray(out["tokens"]),
            np.asarray(jax_generate(jwf, jws_b, prompt, 5)))
        code, st = _get(banner["status_port"], "/status.json")
        assert code == 200 and st["deploy"]["active_version"] == 2
        assert _post(port, "/admin/drain")[0] == 202
        assert proc.wait(120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    doc = json.loads(trace.read_text())
    assert any(e.get("name") == "request" for e in doc["traceEvents"])


def test_reload_from_export_sources_under_load(tmp_path, pair_a, pair_b,
                                               rng):
    """A live engine hot-swapped under concurrent load from a compiled
    artifact (``artifact://`` and the bare directory), the JAX package's
    export package directory, the port's ``.zip`` and a ``forge://``
    store: no request fails, nothing is built, each version serves the
    JAX package's greedy tokens on its weights and the registry records
    each source's kind; another workflow's package is refused (409)."""
    from veles_tpu.export import export_package as jax_export_package
    from veles_tpu_torch.export.compiled import export_compiled
    from veles_tpu_torch.export.package import export_package
    from veles_tpu_torch.forge.store import ForgeStore
    jwf, jws_a, pwf, pws_a = pair_a
    jws_b, pws_b = pair_b[1], pair_b[3]
    art = str(tmp_path / "art")
    export_compiled(pwf, pws_b, art, slots=2, l_max=32, megastep=1,
                    spec=False)
    jax_pkg = jax_export_package(jwf, jws_a, str(tmp_path / "jax_pkg"))
    zpkg = export_package(pwf, pws_b, str(tmp_path / "port.zip"))
    fpkg = export_package(pwf, pws_a, str(tmp_path / "fpkg"))
    store = str(tmp_path / "forge")
    ForgeStore(store).add(ForgeStore.pack_dir(fpkg, {
        "name": "lm", "workflow": "contents.json",
        "configuration": "contents.json", "author": "tests",
        "short_description": "pair a"}))
    eng = _engine(pwf, pws_a, slots=4, l_max=64).start()
    dep = DeployController(engine=eng)
    prompt = rng.integers(0, V, (1, 5)).astype(np.int32)
    load = [rng.integers(0, V, (1, n)).astype(np.int32) for n in (3, 6, 9)]
    errs, done, stop = [], [], threading.Event()

    def worker(p):
        while not stop.is_set():
            try:
                done.append(eng.generate(p, 3, timeout=180).shape)
            except Exception as e:  # noqa: BLE001
                errs.append(repr(e))
                return

    threads = [threading.Thread(target=worker, args=(p,)) for p in load]
    try:
        eng.generate(prompt, 4, timeout=120)
        compiles = eng.stats()["compile"]["compiles"]
        for t in threads:
            t.start()
        for src, jws, kind in (
                ("artifact://" + art, jws_b, "artifact"),
                (jax_pkg, jws_a, "package"), (art, jws_b, "artifact"),
                (zpkg, jws_b, "package"), (f"forge://{store}/lm", jws_a,
                                           "forge")):
            n = len(done)
            dep.reload(src)
            deadline = time.monotonic() + 120
            while len(done) < n + len(load):
                assert time.monotonic() < deadline, errs
                time.sleep(0.01)
            assert dep.registry.active["kind"] == kind
            np.testing.assert_array_equal(
                eng.generate(prompt, 4, timeout=120),
                np.asarray(jax_generate(jwf, jws, prompt, 4)))
        other = build_pair(LAYERS[:1] + LAYERS[-2:], B=2, T=6, seed=3)
        foreign = export_package(other[2], other[3], str(tmp_path / "fw"))
        with pytest.raises(ValueError, match="different workflow"):
            dep.reload(foreign)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=240)
        eng.stop()
    assert not errs, errs
    assert dep.swaps == 5
    assert dep.registry.active["source"] == f"forge://{store}/lm@1"
    st = eng.stats()
    assert st["compile"]["compiles"] == compiles
    assert st["compile"]["recompiles"] == 0
