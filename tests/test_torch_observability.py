"""The port's observability surface on the CPU (runtime/metrics.py's
span ring, runtime/memory.py, runtime/status.py, runtime/profiler.py),
held to tests/test_observability.py and tests/test_perf_observability.py:
the span ring is bounded and sorted; every finished request leaves a
request span with queue-wait, prefill and decode children on its own
track, served by ``/trace.json`` on both servers and by ``--trace-out``;
the memory ledger's components equal numpy's byte arithmetic exactly
(``/memory.json``, ``stats()["memory"]``; no device part without a
card); the status page escapes keys, values and plot names, embeds the
plots and keeps them inside their directory; event bursts coalesce; and
``POST /debug/profile`` captures once at a time (409 while one runs),
bounded, into its own directory, 413 over the body cap."""

import http.client
import json
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from veles_tpu_torch.config import root  # noqa: E402
from veles_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from veles_tpu_torch.runtime.memory import (memory_monitor,  # noqa: E402
                                            tree_bytes)
from veles_tpu_torch.runtime.metrics import (SpanRing,  # noqa: E402
                                             registry, span_ring,
                                             write_chrome_trace)
from veles_tpu_torch.runtime.profiler import profiler  # noqa: E402
from veles_tpu_torch.runtime.restful import RestfulServer  # noqa: E402
from veles_tpu_torch.runtime.status import (StatusReporter,  # noqa: E402
                                            StatusServer)

from _torch_helpers import build_pair  # noqa: E402

torch.set_num_threads(2)

V = 12
LAYERS = [
    {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
    {"type": "attention", "n_heads": 2, "rope": True, "residual": True,
     "name": "a1"},
    {"type": "seq_last", "name": "last"},
    {"type": "softmax", "output_size": V, "name": "out"},
]


@pytest.fixture(scope="module")
def lm():
    return build_pair(LAYERS, B=2, T=6, seed=3)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read()


# -- the span ring ------------------------------------------------------------

def test_span_ring_bounded_and_sorted():
    ring = SpanRing(capacity=8)
    t0 = time.monotonic()
    for i in range(30):
        ring.add(f"s{i}", t0 + i * 0.001, 0.0005, tid=i)
    assert len(ring) == 8
    events = ring.snapshot()
    assert [e["name"] for e in events] == [f"s{i}" for i in range(22, 30)]
    assert events == sorted(events, key=lambda e: e["ts"])
    doc = ring.chrome_trace()
    assert doc["traceEvents"][0]["ph"] == "M"
    json.loads(json.dumps(doc))


def _nested(events, want):
    """Every queue_wait / prefill / decode span inside its request span
    on the same track; the count checked and the request spans."""
    reqs = {e["tid"]: e for e in events
            if e.get("name") == "request" and e.get("ph") == "X"}
    checked = 0
    for e in events:
        if e.get("name") not in ("queue_wait", "prefill", "decode"):
            continue
        parent = reqs.get(e["tid"])
        if parent is None:
            continue
        assert e["ts"] >= parent["ts"] - 2.0, e
        assert e["ts"] + e.get("dur", 0) \
            <= parent["ts"] + parent["dur"] + 2.0, e
        checked += 1
    assert checked >= want
    return reqs


def test_trace_json_loads_and_nests(lm, rng, tmp_path):
    """GET /trace.json on the REST server and on the status server: one
    request span per finished request, its three phases nested on its
    track, the reference's args."""
    *_, pwf, pws = lm
    eng = DecodeEngine(pwf, pws, slots=2, l_max=32, device="cpu")
    srv = RestfulServer(pwf.make_predict_step("out"), pws, 2, (6,),
                        workflow=pwf, engine=eng, device="cpu")
    eng.start()
    srv.start()
    ssrv = StatusServer(StatusReporter(str(tmp_path / "s.json"))).start()
    try:
        ids = []
        for _ in range(3):
            r = eng.submit(rng.integers(0, V, 5), 3)
            assert r.done.wait(120) and r.error is None
            ids.append(r.trace_id)
        for port in (srv.port, ssrv.port):
            doc = json.loads(_get(f"http://127.0.0.1:{port}/trace.json"))
            reqs = _nested(doc["traceEvents"], 9)
            for i in ids:
                args = reqs[i]["args"]
                assert args["id"] == i and args["outcome"] == "ok"
                assert args["prompt_tokens"] == 5 and args["n_steps"] == 3
                assert "slot" in args and "prefix_start" in args
    finally:
        ssrv.stop()
        srv.stop()
        eng.stop()


def test_shed_request_leaves_a_queue_wait_span(lm):
    """A request that never reached a slot (the engine stopped with it
    queued) leaves its request span and a queue-wait child covering its
    whole life."""
    *_, pwf, pws = lm
    eng = DecodeEngine(pwf, pws, slots=1, l_max=32, window_ms=0.0,
                       device="cpu")
    eng._thread = threading.current_thread()    # submit() wants a runner
    try:
        req = eng.submit(np.asarray([1, 2, 3]), 4)
    finally:
        eng._thread = None
    eng._fail_all(RuntimeError("stopped"))
    spans = [e for e in span_ring().snapshot() if e["tid"] == req.trace_id]
    assert {e["name"] for e in spans} == {"request", "queue_wait"}
    req_span = next(e for e in spans if e["name"] == "request")
    assert req_span["args"]["outcome"] == "stopped"


def test_trace_out_cli_helper(tmp_path):
    span_ring().add("marker", time.monotonic(), 0.001, tid=999)
    out = write_chrome_trace(str(tmp_path / "trace.json"))
    doc = json.loads(open(out).read())
    assert any(e.get("name") == "marker" for e in doc["traceEvents"])


# -- the memory ledger --------------------------------------------------------

def test_tree_bytes_matches_numpy_arithmetic():
    tree = {"a": np.zeros((3, 5), np.float32),
            "b": {"c": torch.zeros(7, dtype=torch.int32),
                  "d": torch.zeros((2, 2, 2), dtype=torch.bfloat16)},
            "e": 1.5, "f": [torch.zeros(3, dtype=torch.int64), None]}
    # 3*5*4 + 7*4 + 8*2 + 8 (a python float is a float64 scalar) + 3*8
    assert tree_bytes(tree) == 60 + 28 + 16 + 8 + 24


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32_pool", "bf16_pool"])
def test_memory_json_engine_components_exact_on_cpu(lm, cache_dtype):
    """/memory.json's component bytes equal numpy's shape x itemsize
    arithmetic exactly, and the engine's stats() carries its own copy."""
    jws, pwf, pws = lm[1], lm[2], lm[3]
    eng = DecodeEngine(pwf, pws, slots=2, l_max=32, page_size=16,
                       cache_dtype=cache_dtype, device="cpu")
    srv = RestfulServer(pwf.make_predict_step("out"), pws, 2, (6,),
                        workflow=pwf, engine=eng, device="cpu").start()
    try:
        # n_ptab = 32 / 16 = 2, pages = 2 x 2 = 4, pool rows 5 (scratch);
        # one attention unit of 2 kv heads of 16 / 2 = 8: k and v are
        # (5, 16, 2, 8) each
        item = 4 if cache_dtype == torch.float32 else 2
        kv = 2 * 5 * 16 * 2 * 8 * item
        # the int32 state buffer: serial, pos, active, temp, top-k, top-p,
        # eos, end (2 each) and the (2, 2) page table
        slot_state = (8 * 2 + 2 * 2) * 4
        tokens = 2 * 32 * 4                  # (2, 32) int32
        keys = 2 * 32 * 8                    # (2, 32) int64
        params = sum(int(np.prod(np.shape(x))) * np.dtype(x.dtype).itemsize
                     for x in jax.tree.leaves(jax.device_get(
                         jws["params"])))
        # the served tree shares the caller's host tensors: one copy
        want = {"serving_params": params,
                "kv_cache": kv, "slot_state": slot_state,
                "token_matrix": tokens, "fold_keys": keys}
        assert eng.stats()["memory"] == want
        doc = json.loads(_get(f"http://127.0.0.1:{srv.port}/memory.json"))
        for k, v in want.items():
            assert doc["components"][f"engine.{k}"] == v
        assert doc["component_total_bytes"] == sum(
            doc["components"].values())
        assert doc["engine"]["pages"] == 4
        assert doc["engine"]["cache_dtype"] == str(cache_dtype).split(".")[1]
        assert doc["device"] is None          # no card: no device part
    finally:
        srv.stop()


def test_memory_gauges_and_a_freed_engine_leaves_the_ledger(lm):
    *_, pwf, pws = lm
    eng = DecodeEngine(pwf, pws, slots=2, l_max=32, device="cpu")
    kv = eng.stats()["memory"]["kv_cache"]
    gauge = registry().get("vt_memory_component_bytes")
    assert gauge.labels(component="engine.kv_cache").value == kv
    eng._mem_finalizer()          # what the engine's collection runs
    assert "engine.kv_cache" not in memory_monitor().components()
    assert gauge.labels(component="engine.kv_cache").value == 0


def _finishes(fn, seconds=10.0):
    """Run ``fn`` on a daemon thread; True when it returned in time (a
    thread that deadlocked on its own lock never does)."""
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    t.join(seconds)
    return not t.is_alive()


def test_a_finalizer_reentering_a_ledger_update_does_not_deadlock(
        monkeypatch):
    """A garbage collection inside ``set_component`` (an allocation under
    the monitor's lock; here in the gauge's ``labels``) runs a dead
    registrant's finalizer, ``drop_stamped_components``, on the same
    thread: it re-enters the monitor, which must not deadlock (a run of
    the tests once hung there).  A monitor of its own, so a regression
    blocks no other test."""
    from veles_tpu_torch.runtime.memory import MemoryMonitor
    mon = MemoryMonitor()
    dead = mon.set_component("test.reenter.dead", 1)
    gauge = mon._g_comp
    real = gauge.labels
    fired = []

    def labels(**kv):
        if not fired:             # the finalizer, mid-update
            fired.append(1)
            mon.drop_component("test.reenter.dead", dead)
        return real(**kv)

    monkeypatch.setattr(gauge, "labels", labels)
    assert _finishes(lambda: mon.set_component("test.reenter.live", 2))
    monkeypatch.undo()
    assert fired
    assert mon.components() == {"test.reenter.live": 2}
    mon.drop_component("test.reenter.live")


def test_a_metric_labelled_again_while_making_a_child_does_not_deadlock(
        monkeypatch):
    """Making a labelled child allocates under the metric's lock; a
    finalizer run by a collection there may label the same metric again
    on the same thread (the memory ledger's gauge does)."""
    g = registry().gauge("vt_test_reentrant_labels", "test", labels=("k",))
    real = g._make_child
    made = []

    def make():
        if not made:
            made.append(1)
            g.labels(k="inner").set(1)
        return real()

    monkeypatch.setattr(g, "_make_child", make)
    assert _finishes(lambda: g.labels(k="outer").set(2))
    assert g.labels(k="inner").value == 1
    assert g.labels(k="outer").value == 2


def test_memory_poller_stops_and_joins(monkeypatch):
    """The device poller leaves its wait at once when stopped (what the
    monitor's exit hook runs, so no poller is inside a CUDA call when
    the interpreter finalizes), and a later ensure_poller starts a new
    one.  The card is stood in for by a sampler that counts its calls."""
    mon = memory_monitor()
    calls = []
    monkeypatch.setattr(mon, "sample_device",
                        lambda: calls.append(1) or {})
    mon.stop_poller()
    for _ in range(2):
        assert mon.ensure_poller(interval_s=0.001)
        poller = mon._poller
        deadline = time.monotonic() + 60
        n0 = len(calls)
        while len(calls) < n0 + 3:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        t0 = time.monotonic()
        mon.stop_poller()
        assert not poller.is_alive()
        assert mon._poller is None
        assert time.monotonic() - t0 < 5
    mon.stop_poller()                 # stopping twice is harmless


# -- the status page ------------------------------------------------------------

def test_status_server(tmp_path):
    rep = StatusReporter(str(tmp_path / "status.json"), name="t")
    rep.update(epoch=3, error_pct=1.5)
    srv = StatusServer(rep).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        assert json.loads(_get(url + "/status.json"))["epoch"] == 3
        page = _get(url + "/").decode()
        assert "veles_tpu_torch" in page and "error_pct" in page
        assert "/memory.json" in page and "/trace.json" in page
        assert b"vt_" in _get(url + "/metrics")
        assert "components" in json.loads(_get(url + "/memory.json"))
    finally:
        srv.stop()


def test_status_page_live_plots_stay_in_their_directory(tmp_path):
    plots = tmp_path / "plots"
    plots.mkdir()
    png = b"\x89PNG\r\n\x1a\n" + b"1" * 16
    (plots / "run.png").write_bytes(png)
    rep = StatusReporter(str(tmp_path / "status.json"), name="live",
                         plots_dir=str(plots))
    rep.update(epoch=0)
    srv = StatusServer(rep).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        assert '<img src="/plots/run.png' in _get(url).decode()
        assert _get(url + "/plots/run.png") == png
        with pytest.raises(urllib.error.HTTPError):
            _get(url + "/plots/../status.json")
    finally:
        srv.stop()


def test_status_page_escapes_keys_values_and_plot_names(tmp_path):
    plots = tmp_path / "plots"
    plots.mkdir()
    png = b"\x89PNG\r\n\x1a\n" + b"0" * 16
    evil_name = 'we"ird<1>&.png'
    (plots / evil_name).write_bytes(png)
    rep = StatusReporter(str(tmp_path / "status.json"),
                         name="<b>bad</b>", plots_dir=str(plots))
    rep.update(**{"<script>k": 'v<img src="x">&'})
    srv = StatusServer(rep).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        page = _get(url).decode()
        assert "<script>k" not in page
        assert "&lt;script&gt;k" in page
        assert 'v<img src="x">' not in page
        assert "&lt;b&gt;bad&lt;/b&gt;" in page
        assert evil_name not in page
        quoted = urllib.parse.quote(evil_name)
        assert quoted in page
        assert _get(f"{url}/plots/{quoted}") == png
    finally:
        srv.stop()


def test_record_event_bursts_coalesce_but_final_state_lands(tmp_path):
    reg = registry()
    rep = StatusReporter(str(tmp_path / "status.json"), name="burst",
                         events_max=100, flush_interval_s=0.2)
    flushes = reg.get("vt_status_flushes_total")
    rep.update(epoch=0)
    before = flushes.value
    for i in range(50):
        rep.record_event("retire_storm", i=i)
    assert flushes.value - before <= 3
    assert reg.get("vt_status_flushes_coalesced_total").value > 0
    deadline = time.monotonic() + 2.0
    last = None
    while time.monotonic() < deadline:
        events = rep.read().get("events", [])
        if events and events[-1].get("i") == 49:
            last = events[-1]
            break
        time.sleep(0.02)
    assert last is not None, "final event never flushed"
    n0 = flushes.value
    rep.update(epoch=1)
    assert flushes.value == n0 + 1 and rep.read()["epoch"] == 1
    # events land on the /trace.json timeline as instants too
    assert any(e.get("name") == "retire_storm" and e.get("ph") == "i"
               for e in span_ring().snapshot())


# -- the on-demand profiler ------------------------------------------------------

def _post_profile(url, dur):
    return urllib.request.urlopen(urllib.request.Request(
        url + "/debug/profile", json.dumps({"duration_s": dur}).encode(),
        {"Content-Type": "application/json"}), timeout=60)


@pytest.mark.parametrize("server", ["status", "rest"])
def test_profiler_endpoint_lifecycle(tmp_path, lm, server):
    """Capture -> a Chrome trace on disk -> a second POST mid-capture
    answers 409 with the active path -> the next capture succeeds; the
    duration is capped; 413 over the body cap."""
    old = (root.common.observe.get("profile_dir", ""),
           root.common.observe.get("profile_max_s", 30.0))
    if server == "status":
        rep = StatusReporter(str(tmp_path / "status.json"), name="prof")
        rep.update(epoch=0)
        srv = StatusServer(rep).start()
    else:
        *_, pwf, pws = lm
        srv = RestfulServer(pwf.make_predict_step("out"), pws, 2, (6,),
                            device="cpu").start()
    url = f"http://127.0.0.1:{srv.port}"
    try:
        root.common.observe.profile_dir = str(tmp_path / "profs")
        root.common.observe.profile_max_s = 0.8
        res = {}
        t = threading.Thread(target=lambda: res.setdefault(
            "doc", json.loads(_post_profile(url, 5.0).read())))
        t.start()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not profiler().active:
            time.sleep(0.01)
        assert profiler().active, "capture never started"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_profile(url, 0.05)
        assert ei.value.code == 409
        body = json.loads(ei.value.read())
        assert body["active"].startswith(str(tmp_path / "profs"))
        t.join(60)
        doc = res["doc"]
        assert doc["duration_s"] == 0.8          # capped
        assert os.path.isfile(os.path.join(doc["path"], "trace.json"))
        assert os.path.isfile(os.path.join(doc["path"], "kernels.json"))
        assert doc["path"].startswith(str(tmp_path / "profs"))
        json.loads(open(os.path.join(doc["path"], "trace.json")).read())
        doc2 = json.loads(_post_profile(url, 0.05).read())
        assert doc2["path"] != doc["path"]
        if server == "status":
            page = _get(url).decode()
            assert "last profile" in page
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        conn.putrequest("POST", "/debug/profile")
        conn.putheader("Content-Length", str(10 ** 12))
        conn.endheaders()
        assert conn.getresponse().status == 413
        conn.close()
    finally:
        srv.stop()
        root.common.observe.profile_dir, \
            root.common.observe.profile_max_s = old
