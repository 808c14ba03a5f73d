"""The port's fleet router (veles_tpu_torch/runtime/fleet.py) on the CPU,
held to tests/test_fleet.py's contracts, the fleet half of
tests/test_disagg.py, the fleet CLI guards of tests/test_cli.py, and to
the JAX package on shared weights: the router's prefix hashes are the
JAX function's, the scrape parsers read /metrics text as the JAX ones
do, the merged SLO quantiles match numpy, and a two-replica fleet's
greedy tokens are the JAX ``generate()``'s.

Replicas are real serving stacks (RestfulServer over DecodeEngine with a
DeployController) on ephemeral local ports, each with its own copy of
the weights; every router and replica a test starts is stopped in its
``finally``, every wait has a deadline, and the scrape interval is
short."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.runtime import metrics as jax_metrics  # noqa: E402
from veles_tpu.runtime.engine import \
    prefix_page_hashes as jax_prefix_page_hashes  # noqa: E402
from veles_tpu.runtime.generate import generate as jax_generate  # noqa: E402
from veles_tpu_torch.config import root  # noqa: E402
from veles_tpu_torch.runtime import faults  # noqa: E402
from veles_tpu_torch.runtime.deploy import DeployController  # noqa: E402
from veles_tpu_torch.runtime.engine import (DecodeEngine,  # noqa: E402
                                            prefix_page_hashes)
from veles_tpu_torch.runtime.fleet import (ACTIVE, DRAINING,  # noqa: E402
                                           EJECTED, FleetRouter,
                                           FleetServer, InProcessReplica)
from veles_tpu_torch.runtime.fleet_client import \
    ReplicaUnavailable  # noqa: E402
from veles_tpu_torch.runtime.generate import generate  # noqa: E402
from veles_tpu_torch.runtime.metrics import (  # noqa: E402
    DEFAULT_BUCKETS, MetricsRegistry, cumulative_buckets, parse_samples)
from veles_tpu_torch.runtime.restful import RestfulServer  # noqa: E402
from veles_tpu_torch.runtime.snapshotter import (Snapshotter,  # noqa: E402
                                                 params_to_numpy)

from _torch_helpers import build_pair, wait_for  # noqa: E402

pytestmark = pytest.mark.fleet

torch.set_num_threads(2)

V = 12

#: tests/test_fleet.py:40-46's LM
LAYERS = [
    {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
    {"type": "attention", "n_heads": 2, "rope": True,
     "residual": True, "name": "a1"},
    {"type": "seq_last", "name": "last"},
    {"type": "softmax", "output_size": V, "name": "out"},
]


@pytest.fixture(scope="module")
def lm():
    """(jax_wf, jax_ws_a, port_wf, port_ws_a, port_ws_b): seeds 3 and 11
    (tests/test_fleet.py:49-57), the JAX weights carried into the port."""
    jwf, jws_a, pwf, pws_a = build_pair(LAYERS, B=2, T=6, seed=3)
    pws_b = build_pair(LAYERS, B=2, T=6, seed=11)[3]
    return jwf, jws_a, pwf, pws_a, pws_b


@pytest.fixture
def fast_scrape():
    """Tight scrape cadence so health and load converge quickly."""
    fleet = root.common.serve.fleet
    prev = fleet.get("scrape_interval_s", 0.5)
    fleet.scrape_interval_s = 0.05
    yield
    fleet.scrape_interval_s = prev


def own(pws):
    """``pws`` with params of its own: an engine serves the tensors it
    is given, and a swap writes into them."""
    return dict(pws, params={u: {k: t.clone() for k, t in p.items()}
                             for u, p in pws["params"].items()})


def make_factory(pwf, pws, **engine_kw):
    """One in-process replica stack: engine (started) + REST + deploy,
    on its own weights — the ``--serve --fleet`` factory shape."""
    kw = dict(slots=2, l_max=64, window_ms=0.0, device="cpu")
    kw.update(engine_kw)
    boot_source = kw.pop("boot_source", "live")

    def factory():
        eng = DecodeEngine(pwf, own(pws), **kw).start()
        srv = RestfulServer(pwf.make_predict_step("out"), eng.wstate, 2,
                            (6,), port=0, workflow=pwf, engine=eng,
                            device="cpu")
        DeployController(server=srv, boot_source=boot_source)
        return srv.start()

    return factory


def make_fleet(pwf, pws, n=3, router_kw=(), roles=None, **engine_kw):
    """n replicas + a started router -> (router, replicas)."""
    roles = roles or ["mixed"] * n
    replicas = [InProcessReplica(make_factory(pwf, pws, **engine_kw))
                for _ in roles]
    router = FleetRouter(**dict(router_kw))
    for rep, role in zip(replicas, roles):
        router.add_replica(url=rep.url, registry_key="in-process",
                           restart=rep.restart, kill=rep.kill, role=role)
    router.start()
    return router, replicas


def teardown(router, replicas, fsrv=None):
    if fsrv is not None:
        fsrv.stop()
    else:
        router.stop()
    for rep in replicas:
        rep.stop()


def post(base, path, body):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read())


def get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, json.loads(r.read())


def snap(tmp_path, pwf, pws, tag):
    return Snapshotter("m", str(tmp_path / "snaps")).save(
        tag, {"wstate": {"params": params_to_numpy(pws["params"])},
              "workflow_checksum": pwf.checksum()})


# -- parity with the JAX package ---------------------------------------------

@pytest.mark.parametrize("n,psz", [(32, 16), (35, 16), (50, 8), (7, 16)])
def test_prefix_hashes_equal_jax(n, psz):
    """The router's affinity keys are the port engine's chained page
    hashes, which equal the JAX function's on the same seeded prompts
    (so a JAX and a port replica index the same prefix alike)."""
    prompt = np.random.default_rng(n).integers(0, 1000, n)
    got = prefix_page_hashes(prompt, psz)
    assert got == jax_prefix_page_hashes(prompt, psz)
    assert len(got) == n // psz


def test_metrics_parsers_equal_jax():
    """``parse_samples`` and ``cumulative_buckets`` read the same
    /metrics text (a labelled histogram, counters, gauges, escapes,
    comments and a malformed line) exactly as the JAX ones do."""
    reg = MetricsRegistry()
    h = reg.histogram("vt_request_ttft_seconds", "ttft", labels=("bucket",))
    rng = np.random.default_rng(5)
    for lab in ("16", "32"):
        for v in rng.uniform(0.0001, 3.0, 50):
            h.labels(bucket=lab).observe(float(v))
    reg.counter("vt_requests_total", "n", labels=("outcome",)).labels(
        outcome="ok").inc(7)
    reg.gauge("vt_queue", "q").set(2.5)
    text = reg.render() + ('weird{a="x\\\\ny",b="q\\"z"} 3\n'
                           "not a sample line\n# comment\n")
    got = parse_samples(text)
    assert got == jax_metrics.parse_samples(text)
    assert len(got) > 20
    for name in ("vt_request_ttft_seconds", "vt_requests_total"):
        assert cumulative_buckets(got, name) == \
            jax_metrics.cumulative_buckets(got, name)
    pairs = cumulative_buckets(got, "vt_request_ttft_seconds")
    assert pairs[-1] == (float("inf"), 100.0)


def test_fleet_greedy_tokens_equal_jax_generate(lm, fast_scrape, rng):
    """A two-replica CPU fleet answers greedy requests with the JAX
    package's ``generate()`` tokens on the same weights, whichever
    replica serves them (unary, batch-lane and streamed)."""
    jwf, jws, pwf, pws, _ = lm
    router, replicas = make_fleet(pwf, pws, n=2)
    try:
        for P, n in ((4, 5), (6, 3), (9, 6)):
            prompt = rng.integers(0, V, (1, P)).astype(np.int32)
            ref = np.asarray(jax_generate(jwf, jws, prompt, n)).tolist()
            st, doc, _h = router.handle_generate(
                {"prompt": prompt.tolist(), "steps": n})
            assert st == 200 and doc["tokens"] == ref, (doc, ref)
            st, doc, _h = router.handle_generate(
                {"prompt": prompt.tolist(), "steps": n, "batch": True})
            assert st == 200 and doc["tokens"] == ref, (doc, ref)
            code, frames, _h = router.handle_generate_stream(
                {"prompt": prompt.tolist(), "steps": n, "stream": True})
            assert code == 200
            toks = [f["token"] for f in frames if not f.get("done")]
            assert toks == ref[0][P:]
    finally:
        teardown(router, replicas)


# -- prefix-affinity dispatch ------------------------------------------------

def test_affinity_routes_warm_prefix_to_page_holder(lm, fast_scrape, rng):
    """Same-system-prompt requests land on the replica already holding
    the shared pages: the first seeds the affinity map, the rest follow
    it, and the holder's own prefix cache serves the shared head."""
    _, _, pwf, pws, _ = lm
    router, replicas = make_fleet(pwf, pws, n=3, paged=True, page_size=16,
                                  l_max=128)
    head = rng.integers(1, V, 32).tolist()     # two full 16-token pages
    try:
        for _ in range(6):
            tail = rng.integers(1, V, 3).tolist()
            status, doc, _h = router.handle_generate(
                {"prompt": [head + tail], "steps": 2})
            assert status == 200, doc
        fd = router.fleet_doc()
        aff = fd["affinity"]
        assert aff["requests"] == 6
        assert aff["hits"] >= 5, fd
        assert aff["hit_rate"] >= 0.83
        by_dispatch = sorted(fd["replicas"], key=lambda r: -r["dispatched"])
        assert by_dispatch[0]["dispatched"] == 6, fd
        assert by_dispatch[1]["dispatched"] == 0
        holder = next(r for r in replicas
                      if r.url == by_dispatch[0]["url"])
        pages = holder.srv.engine.stats()["pages"]
        assert pages["prefix_hit_rate"] > 0, pages
        assert pages["prefix_tokens_reused"] >= 5 * 32, pages
    finally:
        teardown(router, replicas)


def test_affinity_hashes_match_engine_prefix_identity():
    """Head hashes of a prompt equal the engine-side hashes of any
    longer prompt sharing that head, and diverge inside the first
    page."""
    page = list(range(1, 17))
    a = prefix_page_hashes(np.asarray(page * 2), 16)
    b = prefix_page_hashes(np.asarray(page * 2 + [7, 8, 9]), 16)
    assert a == b[:2]
    c = prefix_page_hashes(np.asarray([9] + page[1:] + page), 16)
    assert c[0] != a[0]
    router = FleetRouter(page_size=16, affinity_pages=1)
    assert router._head_hashes([page * 2 + [3]]) == a[:1]


# -- coordinated hot swap ----------------------------------------------------

def test_coordinated_swap_atomicity_and_rollback(lm, tmp_path, rng):
    """One replica's flip failure rolls the whole fleet back (every
    replica serves the boot weights, bitwise); without the sabotage the
    same swap commits everywhere."""
    _, _, pwf, pws_a, pws_b = lm
    snap_a = snap(tmp_path, pwf, pws_a, "a")
    snap_b = snap(tmp_path, pwf, pws_b, "b")
    router, replicas = make_fleet(pwf, pws_a, n=3, boot_source=snap_a)
    prompt = rng.integers(1, V, (1, 5)).astype(np.int32)
    try:
        ref_a = router.handle_generate(
            {"prompt": prompt.tolist(), "steps": 4})[1]["tokens"]
        victim = replicas[1].srv.engine
        real_swap = victim.swap_params

        def boom(params, **kw):
            raise RuntimeError("injected flip failure")

        victim.swap_params = boom
        out = router.coordinated_swap(source=snap_b)
        assert out["swapped"] is False and out["phase"] == "commit"
        assert out["errors"], out
        assert "r0" in out["rolled_back"], out
        for rep in replicas:
            st, models = get(rep.url, "/models")
            active = next(v for v in models["versions"] if v["active"])
            assert active["checksum"] == \
                models["versions"][0]["checksum"], models
            st, doc = post(rep.url, "/generate",
                           {"prompt": prompt.tolist(), "steps": 4})
            assert st == 200 and doc["tokens"] == ref_a, doc
            assert rep.srv.deploy.staged_token is None
        victim.swap_params = real_swap
        out = router.coordinated_swap(source=snap_b)
        assert out["swapped"] is True, out
        ref_b = None
        for rep in replicas:
            st, models = get(rep.url, "/models")
            assert models["versions"][-1]["active"], models
            st, doc = post(rep.url, "/generate",
                           {"prompt": prompt.tolist(), "steps": 4})
            assert st == 200
            ref_b = ref_b or doc["tokens"]
            assert doc["tokens"] == ref_b
        assert ref_b != ref_a
        assert router.fleet_doc()["last_swap"]["swapped"] is True
    finally:
        teardown(router, replicas)


def test_coordinated_swap_resolves_lost_commit_reply(lm, tmp_path, rng):
    """A commit whose reply is lost after the flip landed is resolved by
    probing the replica's registry: the flipped replica is rolled back
    with the rest, never left mixed."""
    _, _, pwf, pws_a, pws_b = lm
    snap_a = snap(tmp_path, pwf, pws_a, "a")
    snap_b = snap(tmp_path, pwf, pws_b, "b")
    router, replicas = make_fleet(pwf, pws_a, n=2, boot_source=snap_a)
    prompt = rng.integers(1, V, (1, 5)).astype(np.int32)
    try:
        ref_a = router.handle_generate(
            {"prompt": prompt.tolist(), "steps": 4})[1]["tokens"]
        r0 = router.replicas()[0]
        real_commit = r0.client.commit

        def lossy_commit(token, timeout=None):
            real_commit(token)          # the flip lands server-side
            raise ReplicaUnavailable("reply lost after the flip")

        r0.client.commit = lossy_commit
        out = router.coordinated_swap(source=snap_b)
        assert out["swapped"] is False and out["phase"] == "commit"
        assert "r0" in out["rolled_back"], out
        for rep in replicas:
            st, doc = post(rep.url, "/generate",
                           {"prompt": prompt.tolist(), "steps": 4})
            assert st == 200 and doc["tokens"] == ref_a, doc
            assert rep.srv.deploy.staged_token is None
    finally:
        teardown(router, replicas)


def test_stage_abort_leaves_old_serving(lm, tmp_path):
    """The two-phase REST surface on one replica: stage places without
    flipping, a second stage is refused, abort withdraws, a commit of
    the aborted token is refused, and a fresh stage + commit flips."""
    _, _, pwf, pws_a, pws_b = lm
    snap_b = snap(tmp_path, pwf, pws_b, "b")
    rep = InProcessReplica(make_factory(pwf, pws_a))
    base = rep.url
    try:
        st, doc = post(base, "/admin/stage", {"source": snap_b})
        assert st == 200 and doc["staged"], doc
        token = doc["staged"]
        assert get(base, "/models")[1]["active"] == 1
        assert post(base, "/admin/stage", {"source": snap_b})[0] == 409
        st, doc2 = post(base, "/admin/abort", {"token": token})
        assert st == 200 and doc2["aborted"] == token
        assert post(base, "/admin/commit", {"token": token})[0] == 409
        assert get(base, "/models")[1]["active"] == 1
        st, doc = post(base, "/admin/stage", {"source": snap_b})
        assert st == 200
        st, doc = post(base, "/admin/commit", {"token": doc["staged"]})
        assert st == 200 and doc["active"]["version"] == 2, doc
    finally:
        rep.stop()


# -- rolling drain -----------------------------------------------------------

def test_rolling_drain_under_load_zero_dropped(lm, fast_scrape, rng):
    """A rolling-drain cycle under concurrent load: every replica
    drains, restarts and is readmitted while workers keep submitting
    through the router, with zero failed requests and no step program
    rebuilt on any restarted replica."""
    _, _, pwf, pws, _ = lm
    router, replicas = make_fleet(pwf, pws, n=3)
    prompt = rng.integers(1, V, (1, 5)).tolist()
    errs, done = [], []
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            status, doc, _h = router.handle_generate(
                {"prompt": prompt, "steps": 3})
            (done if status == 200 else errs).append((status, doc))

    threads = [threading.Thread(target=worker) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        wait_for(lambda: len(done) >= 5 or errs, 120, "load to flow")
        summary = router.rolling_drain()
        assert summary["completed"] is True, summary
        assert all(r["restarted"] and r["readmitted"]
                   for r in summary["replicas"]), summary
        n_after = len(done)
        wait_for(lambda: len(done) >= n_after + 5 or errs, 120,
                 "load after the cycle")
        stop.set()
        for t in threads:
            t.join(120)
        assert not errs, errs
        fd = router.fleet_doc()
        assert [r["state"] for r in fd["replicas"]] == [ACTIVE] * 3
        for rep in replicas:
            assert rep.srv.engine.stats()["compile"]["recompiles"] == 0
        assert fd["last_rolling_drain"]["completed"] is True
    finally:
        stop.set()
        for t in threads:
            t.join(120)
        teardown(router, replicas)


# -- ejection / resubmission / backpressure ---------------------------------

def test_replica_kill_ejects_and_resubmits(lm, fast_scrape, rng):
    """Killing the replica that serves a stream of dispatches: the next
    request fails over to a survivor (one 200, never an error), the
    dead replica is ejected, and a rolling drain repairs it."""
    _, _, pwf, pws, _ = lm
    router, replicas = make_fleet(pwf, pws, n=2,
                                  router_kw={"eject_failures": 1})
    prompt = rng.integers(1, V, (1, 4)).tolist()
    try:
        for _ in range(2):
            status, doc, _h = router.handle_generate(
                {"prompt": prompt, "steps": 2})
            assert status == 200
        fd = router.fleet_doc()
        busy_url = max(fd["replicas"], key=lambda r: r["dispatched"])["url"]
        victim = next(r for r in replicas if r.url == busy_url)
        victim.kill()
        status, doc, _h = router.handle_generate(
            {"prompt": prompt, "steps": 2})
        assert status == 200, doc
        states = {r["url"]: r["state"] for r in router.fleet_doc()["replicas"]}
        assert states[busy_url] == EJECTED
        summary = router.rolling_drain()
        assert summary["completed"] is True, summary
        fd = router.fleet_doc()
        assert [r["state"] for r in fd["replicas"]] == [ACTIVE] * 2, fd
    finally:
        teardown(router, replicas)


class SheddingReplica:
    """A stub replica that 429s every /generate with a fixed hint (no
    engine): the backpressure fixture of tests/test_fleet.py:418-476."""

    def __init__(self, retry_after_s=7.5):
        import http.server
        outer = self
        self.generate_calls = 0

        class H(http.server.BaseHTTPRequestHandler):
            def _reply(self, obj, code=200, headers=()):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                if path == "/ready":
                    self._reply({"ready": True})
                elif path == "/engine":
                    self._reply({"slots": 1, "queue_depth": 0,
                                 "occupancy": 0,
                                 "admission": {"burn": 9.0}})
                elif path == "/metrics":
                    self._reply({})
                else:
                    self.send_error(404)

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                outer.generate_calls += 1
                self._reply({"error": "shedding",
                             "retry_after_s": retry_after_s}, code=429,
                            headers=(("Retry-After",
                                      str(int(retry_after_s))),))

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(10)


def test_429_honored_as_router_backpressure():
    """A replica's 429 opens its Retry-After window: the next low-class
    request is refused at the router with the replica's hint and no
    dispatch, while class 0 is still dispatched (to the least-burned
    replica)."""
    stubs = [SheddingReplica(retry_after_s=7.5) for _ in range(2)]
    router = FleetRouter()
    for s in stubs:
        router.add_replica(url=s.url, registry_key=s.url)
    try:
        router.start()
        body = {"prompt": [[1, 2, 3]], "steps": 1, "priority": 1}
        status, doc, headers = router.handle_generate(body)
        assert status == 429
        assert doc["retry_after_s"] == pytest.approx(7.5)
        assert dict(headers).get("Retry-After") == "8"
        calls = sum(s.generate_calls for s in stubs)
        assert calls == 2
        status, doc, _h = router.handle_generate(body)
        assert status == 429
        assert sum(s.generate_calls for s in stubs) == calls
        status, doc, _h = router.handle_generate(
            {"prompt": [[1, 2, 3]], "steps": 1, "priority": 0})
        assert status == 429
        assert sum(s.generate_calls for s in stubs) > calls
        assert all(r["backoff_remaining_s"] > 0
                   for r in router.fleet_doc()["replicas"])
    finally:
        router.stop()
        for s in stubs:
            s.stop()


def test_batch_429_does_not_backpressure_interactive():
    """A 429 on a batch dispatch (trough closed) goes back to the job
    manager without opening a backoff window: the next interactive
    request still reaches a replica."""
    stubs = [SheddingReplica(retry_after_s=0.05) for _ in range(2)]
    router = FleetRouter()
    for s in stubs:
        router.add_replica(url=s.url, registry_key=s.url)
    try:
        router.start()
        status, doc, _h = router.handle_generate(
            {"prompt": [[1, 2, 3]], "steps": 1, "batch": True})
        assert status == 429
        calls = sum(s.generate_calls for s in stubs)
        assert calls == 2
        assert all(r["backoff_remaining_s"] == 0
                   for r in router.fleet_doc()["replicas"])
        router.handle_generate(
            {"prompt": [[1, 2, 3]], "steps": 1, "priority": 1})
        assert sum(s.generate_calls for s in stubs) > calls
    finally:
        router.stop()
        for s in stubs:
            s.stop()


# -- merged /slo.json --------------------------------------------------------

def render_ttft(samples):
    """One process's /metrics text holding ``samples`` in its TTFT
    histogram (the port's registry and exposition)."""
    reg = MetricsRegistry()
    h = reg.histogram("vt_request_ttft_seconds", "ttft", labels=("bucket",))
    for v in samples:
        h.labels(bucket="16").observe(float(v))
    return reg.render()


def test_merged_slo_quantiles_vs_numpy():
    """The fleet /slo.json quantiles equal numpy's over the union of the
    replicas' samples within one bucket, and replicas sharing a
    registry key are counted once."""
    rng = np.random.default_rng(7)
    samples_a = rng.uniform(0.001, 0.4, 300)
    samples_b = rng.uniform(0.05, 2.0, 200)
    router = FleetRouter()
    r0 = router.add_replica(url="http://127.0.0.1:9", registry_key="proc-a")
    r1 = router.add_replica(url="http://127.0.0.1:9", registry_key="proc-b")
    r2 = router.add_replica(url="http://127.0.0.1:9", registry_key="proc-b")
    for w in router._slo_windows.values():
        w.tick()                                # zero baseline slice
    with router._lock:
        r0.metrics_text = render_ttft(samples_a)
        r1.metrics_text = render_ttft(samples_b)
        r2.metrics_text = r1.metrics_text       # the shared registry
    doc = router.merged_slo_doc()
    assert doc["replica_groups"] == 2
    merged = np.concatenate([samples_a, samples_b])
    got = doc["metrics"]["ttft"]
    assert got["count"] == merged.size
    assert got["sum_seconds"] == pytest.approx(merged.sum(), rel=1e-4)
    uppers = (0.0,) + tuple(DEFAULT_BUCKETS) + (float("inf"),)
    for q, key in ((0.5, "p50_ms"), (0.95, "p95_ms"), (0.99, "p99_ms")):
        true = float(np.quantile(merged, q))
        i = next(i for i in range(1, len(uppers)) if true <= uppers[i])
        assert abs(got[key] / 1e3 - true) <= uppers[i] - uppers[i - 1] \
            + 1e-9, (key, got[key], true)


def test_merged_slo_survives_replica_restart_reset():
    """A replica process restart re-exposes zeroed buckets; the merge
    stays monotonic: the window sees the new work, not a negative
    delta."""
    rng = np.random.default_rng(11)
    router = FleetRouter()
    ra = router.add_replica(url="http://127.0.0.1:9", registry_key="proc-a")
    rb = router.add_replica(url="http://127.0.0.1:9", registry_key="proc-b")
    with router._lock:
        ra.metrics_text = render_ttft(rng.uniform(0.01, 0.2, 300))
        rb.metrics_text = render_ttft(rng.uniform(0.01, 0.2, 200))
    for w in router._slo_windows.values():
        w.tick()
    with router._lock:
        rb.metrics_text = render_ttft([0.05] * 10)
    got = router.merged_slo_doc()["metrics"]["ttft"]
    assert got["count"] == 10, got
    assert got["p50_ms"] > 0, got


def test_group_text_prefers_live_member_over_ejected_leader():
    """The SLO merge reads a live member's scrape, not an ejected
    leader's frozen text; an all-dead group keeps its last sight."""
    router = FleetRouter()
    r0 = router.add_replica(url="http://127.0.0.1:9", registry_key="shared")
    r1 = router.add_replica(url="http://127.0.0.1:9", registry_key="shared")
    with router._lock:
        r0.metrics_text = "stale"
        r1.metrics_text = "fresh"
        r0.state = EJECTED
    assert router._group_items() == [("shared", "fresh")]
    with router._lock:
        r1.state = EJECTED
    assert router._group_items() == [("shared", "stale")]


def test_fleet_server_endpoints(lm, fast_scrape, rng):
    """The router's HTTP front: /generate dispatches (X-Priority
    honoured), /fleet.json, the merged /slo.json and /ready render, and
    /admin/join adds a live replica that takes traffic once the first
    drains."""
    _, _, pwf, pws, _ = lm
    router, replicas = make_fleet(pwf, pws, n=1)
    fsrv = FleetServer(router, port=0).start()
    base = f"http://127.0.0.1:{fsrv.port}"
    joined = InProcessReplica(make_factory(pwf, pws))
    prompt = rng.integers(1, V, (1, 4)).tolist()
    try:
        st, doc = post(base, "/generate", {"prompt": prompt, "steps": 2})
        assert st == 200 and len(doc["tokens"][0]) == 6
        st, rd = get(base, "/ready")
        assert st == 200 and rd["ready"] is True
        st, fd = get(base, "/fleet.json")
        assert fd["role"] == "fleet-router" and len(fd["replicas"]) == 1
        st, slo = get(base, "/slo.json")
        assert slo["fleet"] is True and "ttft" in slo["metrics"]
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            assert "vt_fleet_requests_total" in r.read().decode()
        st, jd = post(base, "/admin/join", {"url": joined.url,
                                            "registry_key": "in-process"})
        assert st == 200 and jd["joined"] == "r1"
        assert len(get(base, "/fleet.json")[1]["replicas"]) == 2
        replicas[0].srv.deploy.begin_drain()
        wait_for(lambda: post(base, "/generate",
                              {"prompt": prompt, "steps": 2})[0] == 200,
                 60, "a 200 through the joined replica")
        served = {r["url"]: r["dispatched"]
                  for r in get(base, "/fleet.json")[1]["replicas"]}
        assert served[joined.url] >= 1, served
        assert post(base, "/admin/join", {})[0] == 400
    finally:
        teardown(router, replicas, fsrv)
        joined.stop()


# -- streaming relay + mid-stream failover -----------------------------------

def stream_ref(pwf, pws, prompt, n, **kw):
    """The port's ``generate()`` tokens after ``prompt`` (one row)."""
    return generate(pwf, pws, prompt[None], n, **kw)[0, prompt.size:] \
        .tolist()


@pytest.mark.streaming
def test_stream_relay_clean_and_cut_resume(lm, fast_scrape):
    """The router relays a replica's NDJSON stream frame for frame; a
    severed leg (``stream_cut_at_token``) resumes the suffix on a
    survivor, and the spliced stream is gapless, duplicate-free and
    bitwise the uninterrupted sampled sequence."""
    _, _, pwf, pws, _ = lm
    router, replicas = make_fleet(pwf, pws, n=3)
    prompt = (np.arange(8) % V).astype(np.int32)
    N = 12
    try:
        gref = stream_ref(pwf, pws, prompt, N, temperature=1.3, top_k=5,
                          seed=11)
        body = {"prompt": prompt.tolist(), "steps": N, "stream": True,
                "temperature": 1.3, "top_k": 5, "seed": 11}
        code, frames, _h = router.handle_generate_stream(dict(body))
        assert code == 200
        out = list(frames)
        assert [f["i"] for f in out[:-1]] == list(range(N))
        assert [f["token"] for f in out[:-1]] == gref
        assert out[-1]["finish_reason"] == "length", out[-1]
        resubs0 = router._m_resubmissions.value
        resumes0 = router._m_stream_resumes.value
        faults.configure(stream_cut_at_token=4)
        code, frames, _h = router.handle_generate_stream(dict(body))
        assert code == 200
        out = list(frames)
        assert [f["i"] for f in out[:-1]] == list(range(N))
        assert [f["token"] for f in out[:-1]] == gref
        assert out[-1]["finish_reason"] == "length", out[-1]
        assert router._m_stream_resumes.value == resumes0 + 1
        assert router._m_resubmissions.value >= resubs0 + 1
    finally:
        faults.reset()
        teardown(router, replicas)


@pytest.mark.streaming
@pytest.mark.faults
def test_stream_retry_budget_bounds_total_outage(lm, fast_scrape):
    """Every replica dies mid-stream: the resume budget bounds the
    failover and the consumer gets one terminal error frame, never a
    hang."""
    _, _, pwf, pws, _ = lm
    stream_cfg = root.common.serve.stream
    prev = {k: stream_cfg.get(k) for k in
            ("retry_budget", "backoff_s", "backoff_max_s")}
    stream_cfg.retry_budget = 2
    stream_cfg.backoff_s = 0.01
    stream_cfg.backoff_max_s = 0.05
    router, replicas = make_fleet(pwf, pws, n=2)
    try:
        prompt = (np.arange(8) % V).astype(np.int32)
        faults.configure(stream_cut_at_token=2)
        code, frames, _h = router.handle_generate_stream(
            {"prompt": prompt.tolist(), "steps": 12, "stream": True,
             "deadline_s": 60.0})
        assert code == 200
        exhausted0 = router._m_stream_retry_exhausted.value
        got = [next(frames), next(frames)]
        assert [f["i"] for f in got] == [0, 1]
        for rep in replicas:                 # total fleet outage
            rep.stop()
        rest = list(frames)
        assert len(rest) == 1 and rest[0].get("done"), rest
        assert rest[0]["finish_reason"] == "error", rest
        assert "retry budget" in rest[0]["error"], rest
        assert router._m_stream_retry_exhausted.value == exhausted0 + 1
    finally:
        faults.reset()
        teardown(router, replicas)
        for k, v in prev.items():
            if v is None:
                if k in stream_cfg:
                    delattr(stream_cfg, k)
            else:
                setattr(stream_cfg, k, v)


@pytest.mark.streaming
@pytest.mark.faults
def test_stream_deadline_propagates_through_router(lm, fast_scrape):
    """A decode stall expires a streamed request's deadline on the
    replica; the engine's terminal "deadline" frame is relayed as the
    request's answer, not resumed."""
    _, _, pwf, pws, _ = lm
    router, replicas = make_fleet(pwf, pws, n=2)
    prompt = (np.arange(8) % V).astype(np.int32)
    try:
        code, frames, _h = router.handle_generate_stream(
            {"prompt": prompt.tolist(), "steps": 2, "stream": True})
        assert code == 200 and list(frames)[-1]["done"]
        faults.configure(decode_stall_ms=400.0)
        code, frames, _h = router.handle_generate_stream(
            {"prompt": prompt.tolist(), "steps": 30, "stream": True,
             "deadline_s": 0.2})
        assert code == 200
        term = list(frames)[-1]
        assert term.get("done") and term["finish_reason"] == "deadline", \
            term
    finally:
        faults.reset()
        teardown(router, replicas)


# -- KV-page placement (tests/test_disagg.py:462-587) ------------------------

#: three full 16-token pages
FLEET_PROMPT = [[(i * 5 + 3) % V for i in range(48)]]


def engine_kvt(rep):
    return get(rep.client.base_url, "/engine")[1]["kv_transfer"]


def holder_and_other(router):
    with router._lock:
        holder_id = router._affinity[next(iter(router._affinity))]
        holder = next(r for r in router._replicas if r.id == holder_id)
        other = next(r for r in router._replicas if r.id != holder_id)
        # divert the next request off the holder (its 429 window)
        holder.backoff_until = time.monotonic() + 60
    return holder, other


@pytest.mark.disagg
def test_fleet_fetches_pages_before_cold_dispatch(lm, fast_scrape):
    """A request diverted off its affinity holder lands on a replica the
    router just warmed with the holder's pages: the same tokens, remote
    hits on the cold replica, a measured transfer in /fleet.json."""
    _, _, pwf, pws, _ = lm
    router, replicas = make_fleet(pwf, pws, n=2)
    try:
        body = {"prompt": FLEET_PROMPT, "steps": 4}
        st, doc, _ = router.handle_generate(dict(body))
        assert st == 200, doc
        _, other = holder_and_other(router)
        st2, doc2, _ = router.handle_generate(dict(body, priority=1))
        assert st2 == 200 and doc2["tokens"] == doc["tokens"], doc2
        kvt = engine_kvt(other)
        assert kvt["imported_pages"] == 3, kvt
        assert kvt["remote_hit_pages"] >= 2, kvt
        fd = router.fleet_doc()
        assert fd["kv_transfer"]["transfers"] >= 1, fd["kv_transfer"]
        assert fd["kv_transfer"]["bandwidth_Bps"] > 0
    finally:
        teardown(router, replicas)


@pytest.mark.disagg
@pytest.mark.faults
def test_fetch_failure_falls_back_to_local_prefill(lm, fast_scrape):
    """A transfer that fails mid-fetch: the request still answers 200
    with the same tokens through local prefill, and nothing was
    imported anywhere."""
    _, _, pwf, pws, _ = lm
    router, replicas = make_fleet(pwf, pws, n=2)
    try:
        body = {"prompt": FLEET_PROMPT, "steps": 4}
        st, doc, _ = router.handle_generate(dict(body))
        assert st == 200, doc
        _, other = holder_and_other(router)
        faults.configure(kv_transfer_drop=5, kv_transfer_slow_ms=1.0)
        try:
            st2, doc2, _ = router.handle_generate(dict(body, priority=1))
        finally:
            faults.reset()
        assert st2 == 200 and doc2["tokens"] == doc["tokens"], doc2
        assert engine_kvt(other)["imported_pages"] == 0
        assert router.fleet_doc()["kv_transfer"]["transfers"] == 0
    finally:
        teardown(router, replicas)


@pytest.mark.disagg
def test_prefill_role_runs_leg_and_ships_pages(lm, fast_scrape):
    """The prefill-class replica runs the prefill leg and ships the
    pages; the decode replica serves through the import (the JAX
    package's greedy tokens) and the prefill replica takes no normal
    dispatch."""
    jwf, jws, pwf, pws, _ = lm
    router, replicas = make_fleet(pwf, pws, roles=["prefill", "decode"])
    try:
        st, doc, _ = router.handle_generate(
            {"prompt": FLEET_PROMPT, "steps": 4})
        assert st == 200, doc
        ref = np.asarray(jax_generate(
            jwf, jws, np.asarray(FLEET_PROMPT, np.int32), 4))
        assert doc["tokens"] == ref.tolist()
        with router._lock:
            dec = next(r for r in router._replicas if r.role == "decode")
            pre = next(r for r in router._replicas if r.role == "prefill")
        kvt = engine_kvt(dec)
        assert kvt["imported_pages"] == 3, kvt
        assert kvt["remote_hit_pages"] >= 2, kvt
        assert engine_kvt(pre)["exported_pages"] == 3
        fd = router.fleet_doc()
        assert fd["roles"] == {"prefill": 1, "decode": 1}, fd["roles"]
        assert dec.dispatched >= 1 and pre.dispatched == 0
    finally:
        teardown(router, replicas)


@pytest.mark.disagg
def test_rolling_drain_prewarms_successor(lm, fast_scrape):
    """Before routing stops, the drained replica's hot pages ship to the
    least-loaded survivor and the affinity map repoints: the same prefix
    after the drain hits warm pages."""
    _, _, pwf, pws, _ = lm
    router, replicas = make_fleet(pwf, pws, n=2)
    try:
        body = {"prompt": FLEET_PROMPT, "steps": 4}
        st, doc, _ = router.handle_generate(dict(body))
        assert st == 200, doc
        summary = router.rolling_drain()
        assert summary["completed"], summary
        prewarms = [e.get("prewarm") for e in summary["replicas"]]
        assert any(p and p["pages"] == 3 for p in prewarms), prewarms
        st2, doc2, _ = router.handle_generate(dict(body))
        assert st2 == 200 and doc2["tokens"] == doc["tokens"]
        fd = router.fleet_doc()
        assert fd["affinity"]["hits"] >= 1, fd["affinity"]
        assert {r["state"] for r in fd["replicas"]} == {ACTIVE}
    finally:
        teardown(router, replicas)


# -- the CLI (tests/test_cli.py:472-518) -------------------------------------

def test_cli_fleet_flag_guards(tmp_path):
    """--fleet/--join need --serve; --fleet conflicts with --join and
    with --watch; --join with --watch.  Every guard fires before any
    model work; ``_serve_fleet`` re-checks the role conflicts before a
    replica is built."""
    from veles_tpu_torch.__main__ import _serve_fleet, build_parser, main
    cfg = "configs/induction_lm.json"

    def rejects(argv, needle):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert needle in str(e.value), (argv, e.value)

    rejects([cfg, "--fleet", "2"], "--serve")
    rejects([cfg, "--join", "http://127.0.0.1:1"], "--serve")
    rejects([cfg, "--serve", "0", "--join", "http://127.0.0.1:1",
             "--watch", "--model-dir", str(tmp_path)], "--watch")
    rejects([cfg, "--serve", "0", "--fleet", "2", "--watch",
             "--model-dir", str(tmp_path)], "--watch")
    rejects([cfg, "--serve", "0", "--fleet", "2", "--join",
             "http://127.0.0.1:1"], "--join")

    def boom():
        raise AssertionError("factory must not run on a flag guard")

    for extra, needle in ((["--join", "http://127.0.0.1:1"], "--join"),
                          (["--watch"], "--watch")):
        args = build_parser().parse_args(
            [cfg, "--serve", "0", "--fleet", "2"] + extra)
        with pytest.raises(SystemExit) as e:
            _serve_fleet(args, boom, {})
        assert needle in str(e.value)


def test_cli_fleet_serve_mode(tmp_path):
    """``--serve 0 --fleet 2 --device cpu``: the banner names the router
    port and both replica URLs, /generate dispatches through it (the
    port's greedy tokens on the snapshot's weights), /fleet.json shows
    both replicas, and POST /admin/drain exits the process 0."""
    import os
    import subprocess
    import sys
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.units.base import Spec
    from veles_tpu_torch.units.workflow import new_state

    repo = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                        os.pardir))
    cfg = os.path.join(repo, "configs", "induction_lm.json")
    with open(cfg) as f:
        layers = json.load(f)["workflow"]["layers"]
    sw = StandardWorkflow({"name": "InductionLM", "layers": layers})
    wf = sw.workflow
    wf.build({"@input": Spec((2, 8), torch.int32),
              "@labels": Spec((2,), torch.int32),
              "@mask": Spec((2,), torch.float32)})
    rng = np.random.default_rng(3)
    params = {u: {k: torch.from_numpy(rng.uniform(
        -0.3, 0.3, s).astype(np.float32)) for k, s in p.items()}
        for u, p in wf.param_shapes().items()}
    snap_path = Snapshotter("cli", str(tmp_path)).save(
        "s", {"wstate": {"params": params_to_numpy(params)},
              "workflow_checksum": wf.checksum()})
    prompt = np.asarray([[1, 2, 3]], np.int32)
    ref = generate(wf, new_state(params, {}, {}, 0, None), prompt, 4)

    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    # the child's log into a file: an unread pipe would stall it
    err = open(tmp_path / "fleet.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", cfg, "--snapshot",
         snap_path, "--serve", "0", "--fleet", "2", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=err, text=True,
        env=env, cwd=str(tmp_path))
    try:
        banner = None
        deadline = time.time() + 240
        while time.time() < deadline and banner is None:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                err.seek(0)
                raise AssertionError(
                    f"fleet died rc={proc.returncode}: {err.read()[-2000:]}")
            if line.startswith("{"):
                banner = json.loads(line)
        assert banner and banner["fleet"] == 2, banner
        assert len(banner["replicas"]) == 2
        base = f"http://127.0.0.1:{banner['serving']}"
        st, doc = post(base, "/generate",
                       {"prompt": prompt.tolist(), "steps": 4})
        assert st == 200 and doc["tokens"] == ref.tolist(), doc
        fd = get(base, "/fleet.json")[1]
        assert len(fd["replicas"]) == 2
        assert sum(r["dispatched"] for r in fd["replicas"]) >= 1
        assert post(base, "/admin/drain", {})[0] == 202
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()
        err.close()


def test_draining_holder_still_serves_kv_fetch_source(lm, fast_scrape):
    """A DRAINING replica stays a valid page source for a remote fetch
    (``_maybe_fetch_remote`` accepts ACTIVE or DRAINING holders), while
    routing never picks it."""
    _, _, pwf, pws, _ = lm
    router, replicas = make_fleet(pwf, pws, n=2)
    try:
        st, doc, _ = router.handle_generate({"prompt": FLEET_PROMPT,
                                             "steps": 4})
        assert st == 200
        holder, other = holder_and_other(router)
        with router._lock:
            holder.state = DRAINING
            holder.backoff_until = 0.0
        st2, doc2, _ = router.handle_generate({"prompt": FLEET_PROMPT,
                                               "steps": 4})
        assert st2 == 200 and doc2["tokens"] == doc["tokens"]
        assert engine_kvt(other)["imported_pages"] == 3
        assert holder.dispatched == 1 and other.dispatched == 1
    finally:
        teardown(router, replicas)


# -- repairs ------------------------------------------------------------------

@pytest.mark.disagg
def test_import_staged_before_a_swap_is_refused(lm):
    """A VTKV1 import validated under the served weights but applied
    after a hot swap flipped them is refused whole (400 at the REST
    layer): its pages hold the old weights' KV.  The engine once applied
    such a blob into the new weights' prefix cache, and a fleet serving
    through a coordinated swap then answered with tokens of neither
    version."""
    _, _, pwf, pws_a, pws_b = lm
    src = DecodeEngine(pwf, own(pws_a), slots=2, l_max=64, window_ms=0.0,
                       device="cpu").start()
    dst = DecodeEngine(pwf, own(pws_a), slots=2, l_max=64, window_ms=0.0,
                       device="cpu")
    try:
        prompt = np.asarray([[(i * 5 + 3) % V for i in range(48)]],
                            np.int32)
        src.generate(prompt, 2, timeout=120)
        blob = src.export_pages(prefix_page_hashes(prompt[0], 16))
        decode = dst._decode_pages_blob

        def validate_then_swap(b):
            pages = decode(b)               # validated: wver matches
            dst.swap_params(own(pws_b)["params"])   # stopped: flips now
            return pages

        dst._decode_pages_blob = validate_then_swap
        with pytest.raises(ValueError, match="weights-version changed"):
            dst.import_pages(blob)
        assert dst.stats()["kv_transfer"]["imported_pages"] == 0
        assert dst.stats()["pages"]["cached"] == 0
        dst._decode_pages_blob = decode
        with pytest.raises(ValueError, match="weights-version"):
            dst.import_pages(blob)          # refused at validation now
    finally:
        src.stop()
        dst.stop()


@pytest.mark.disagg
def test_prefill_leg_binds_affinity_to_the_decode_target(lm, fast_scrape):
    """After the prefill role's leg shipped a session's pages to the
    decode replica, the session's next request is an affinity hit there
    and pays no second leg (a binding to the prefill replica, which
    routing cannot pick, would miss every time)."""
    _, _, pwf, pws, _ = lm
    router, replicas = make_fleet(pwf, pws, roles=["prefill", "decode"])
    try:
        tails = ([1, 2, 3], [4, 5, 6], [7, 8, 9])
        for tail in tails:
            st, doc, _ = router.handle_generate(
                {"prompt": [FLEET_PROMPT[0] + tail], "steps": 3})
            assert st == 200, doc
        fd = router.fleet_doc()
        assert fd["affinity"]["requests"] == 3
        assert fd["affinity"]["hits"] == 2, fd["affinity"]
        with router._lock:
            pre = next(r for r in router._replicas if r.role == "prefill")
        assert engine_kvt(pre)["exported_pages"] == 3       # one leg
        assert fd["kv_transfer"]["transfers"] == 1
    finally:
        teardown(router, replicas)
