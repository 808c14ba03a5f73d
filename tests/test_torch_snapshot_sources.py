"""The port's sqlite and http(s) snapshot sources against the JAX
package's (tests/test_frontend_db.py:85-102, test_cli.py's http restore,
test_deploy.py's reloads): ``SnapshotterToDB`` rows read back by id,
``#best``, ``#current`` and the latest row; either package reads the
other's database; an ``http://`` manifest loads bitwise the file it
serves, under the size cap, with transient failures retried; the
trainer and the deploy control plane take both URIs."""

import functools
import http.server
import threading
import types
import urllib.error

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from veles_tpu.runtime.generate import generate as jax_generate  # noqa: E402
from veles_tpu.runtime.snapshotter import Snapshotter as JaxSnapshotter  # noqa: E402
from veles_tpu.runtime.snapshotter import \
    SnapshotterToDB as JaxSnapshotterToDB  # noqa: E402
from veles_tpu_torch.config import root  # noqa: E402
from veles_tpu_torch.runtime import deploy  # noqa: E402
from veles_tpu_torch.runtime.deploy import (DeployController,  # noqa: E402
                                            http_retry)
from veles_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from veles_tpu_torch.runtime.snapshotter import (Snapshotter,  # noqa: E402
                                                 SnapshotterToDB,
                                                 compare_snapshots,
                                                 params_to_numpy,
                                                 restore_with_walkback)

from _torch_helpers import build_pair  # noqa: E402

torch.set_num_threads(2)

V = 12
LAYERS = [
    {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
    {"type": "attention", "n_heads": 2, "rope": True, "residual": True,
     "name": "a1"},
    {"type": "layer_norm", "name": "n1"},
    {"type": "ffn", "d_hidden": 32, "name": "f1"},
    {"type": "seq_last", "name": "last"},
    {"type": "softmax", "output_size": V, "name": "out"},
]


def _payload(seed):
    rng = np.random.default_rng(seed)
    return {"wstate": {"params": {"fc": {
        "w": rng.standard_normal((2, 3)).astype(np.float32),
        "b": rng.standard_normal(3).astype(np.float32)}},
        "step": np.int64(seed)},
        "decision": {"best_value": float(seed)},
        "workflow_checksum": "abc"}


def _same(a, b):
    fa, fb = a["wstate"]["params"]["fc"], b["wstate"]["params"]["fc"]
    return all(np.array_equal(fa[k], fb[k]) and fa[k].dtype == fb[k].dtype
               for k in ("w", "b"))


class _Quiet(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass


@pytest.fixture
def served_dir(tmp_path):
    """A ``ThreadingHTTPServer`` on 127.0.0.1 serving ``tmp_path``."""
    handler = functools.partial(_Quiet, directory=str(tmp_path))
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield tmp_path, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        t.join(timeout=10)


def test_sqlite_round_trip_by_id_best_current_and_latest(tmp_path):
    db = str(tmp_path / "snaps.sqlite")
    snap = SnapshotterToDB("m", db)
    p0, p1, p2 = _payload(0), _payload(1), _payload(2)
    uri = snap.save("ep0", p0, best=True)
    assert uri == f"sqlite://{db}#1" and snap.last_path == uri
    snap.save("ep1", p1)
    snap.save("ep2", p2)
    assert _same(Snapshotter.load(uri), p0)
    assert Snapshotter.load(uri)["decision"]["best_value"] == 0.0
    assert Snapshotter.load(uri)["workflow_checksum"] == "abc"
    assert _same(Snapshotter.load(f"sqlite://{db}#2"), p1)
    assert _same(Snapshotter.load(f"sqlite://{db}#best"), p0)
    assert _same(Snapshotter.load(f"sqlite://{db}#current"), p2)
    assert _same(Snapshotter.load(f"sqlite://{db}"), p2)
    # bitwise the file snapshot of the same payload
    man = Snapshotter("m", str(tmp_path / "files")).save("ep2", p2)
    assert _same(Snapshotter.load(man), Snapshotter.load(f"sqlite://{db}"))
    with pytest.raises(FileNotFoundError):
        Snapshotter.load(f"sqlite://{db}#99")
    with pytest.raises(FileNotFoundError):
        Snapshotter.load(f"sqlite://{tmp_path}/missing.sqlite")
    # remote URIs load directly: nothing to walk back through
    payload, used, skipped = restore_with_walkback(f"sqlite://{db}#best")
    assert _same(payload, p0) and used == f"sqlite://{db}#best"
    assert skipped == []


def test_each_package_reads_the_others_database(tmp_path):
    db = str(tmp_path / "shared.sqlite")
    jax_uri = JaxSnapshotterToDB("m", db).save("jax", _payload(3),
                                               best=True)
    port_uri = SnapshotterToDB("m", db).save("port", _payload(4))
    assert _same(Snapshotter.load(jax_uri), _payload(3))
    assert _same(JaxSnapshotter.load(port_uri), _payload(4))
    assert _same(JaxSnapshotter.load(f"sqlite://{db}#best"), _payload(3))
    assert _same(Snapshotter.load(f"sqlite://{db}#current"), _payload(4))


def test_http_manifest_loads_bitwise_the_file(served_dir):
    root_dir, base = served_dir
    man = Snapshotter("m", str(root_dir)).save("ep1", _payload(5))
    name = man.split("/")[-1]
    got = Snapshotter.load(f"{base}/{name}")
    assert _same(got, Snapshotter.load(man))
    assert got["workflow_checksum"] == "abc"
    # a JAX-written manifest over http, and compare_snapshots on a URL
    jman = JaxSnapshotter("j", str(root_dir)).save("ep1", _payload(5))
    assert _same(Snapshotter.load(f"{base}/{jman.split('/')[-1]}"),
                 _payload(5))
    rep = compare_snapshots(f"{base}/{name}", man)
    assert rep["only_a"] == rep["only_b"] == []
    assert all(r["max_abs"] == 0.0 for r in rep["rows"])
    with pytest.raises(urllib.error.HTTPError):    # 404: not retried
        Snapshotter.load(f"{base}/missing.json")


def test_http_size_cap(served_dir):
    root_dir, base = served_dir
    big = {"wstate": {"params": {"fc": {"w": np.random.default_rng(0)
                                        .standard_normal(300_000)}}}}
    man = Snapshotter("m", str(root_dir), compression=False).save("big",
                                                                  big)
    old = root.common.snapshot_http_max_mb
    root.common.snapshot_http_max_mb = 1
    try:
        with pytest.raises(ValueError,
                           match="root.common.snapshot_http_max_mb"):
            Snapshotter.load(f"{base}/{man.split('/')[-1]}")
    finally:
        root.common.snapshot_http_max_mb = old

    class Chunked:       # declares nothing, sends more than the cap
        headers = {}

        def __init__(self):
            self.left = 3

        def read(self, n):
            self.left -= 1
            return b"x" * 600 if self.left >= 0 else b""

    with pytest.raises(ValueError, match="exceeded the 1000-byte cap"):
        Snapshotter._read_capped(Chunked(), 1000, "blob", "knob")
    assert Snapshotter._read_capped(Chunked(), 2000, "blob", "k") \
        == b"x" * 1800


def test_http_retry_backs_off_on_transient_failures(monkeypatch):
    sleeps = []
    monkeypatch.setattr(deploy, "time",
                        types.SimpleNamespace(sleep=sleeps.append))
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise urllib.error.URLError("connection refused")
        return "ok"

    assert http_retry(flaky, retries=3) == "ok" and len(calls) == 3
    assert len(sleeps) == 2
    # exponential with at most BACKOFF_JITTER of spread
    assert deploy.HTTP_RETRY_BASE_S <= sleeps[0] \
        <= deploy.HTTP_RETRY_BASE_S * (1 + deploy.BACKOFF_JITTER)
    assert sleeps[1] >= deploy.HTTP_RETRY_BASE_S * deploy.BACKOFF_FACTOR

    def status(code):
        def fn():
            calls.append(code)
            raise urllib.error.HTTPError("u", code, "x", {}, None)
        return fn

    calls.clear()
    with pytest.raises(urllib.error.HTTPError):
        http_retry(status(404), retries=3)
    assert calls == [404]                    # a 4xx is not retried
    calls.clear()
    old = root.common.net.http_retries
    root.common.net.http_retries = 2
    try:
        with pytest.raises(urllib.error.HTTPError):
            http_retry(status(503))
    finally:
        root.common.net.http_retries = old
    assert calls == [503] * 3                # 1 + root.common.net's 2


def test_deploy_reloads_from_sqlite_and_http(tmp_path, served_dir, rng):
    """A running engine hot-swaps from a ``sqlite://...#best`` row and an
    ``http://`` manifest; the tokens are the JAX package's on each
    source's weights, the registry records each source (checksum
    unknown), and the swaps build nothing."""
    _, jws_a, pwf, pws_a = build_pair(LAYERS, B=2, T=6, seed=3)
    jwf, jws_b, _, pws_b = build_pair(LAYERS, B=2, T=6, seed=11)
    db = str(tmp_path / "m.sqlite")
    SnapshotterToDB("m", db).save(
        "b", {"wstate": {"params": params_to_numpy(pws_b["params"])},
              "workflow_checksum": pwf.checksum()}, best=True)
    root_dir, base = served_dir
    man = Snapshotter("m", str(root_dir / "http")).save(
        "a", {"wstate": {"params": params_to_numpy(pws_a["params"])},
              "workflow_checksum": pwf.checksum()})
    url = f"{base}/http/{man.split('/')[-1]}"
    prompt = rng.integers(0, V, (1, 5)).astype(np.int32)
    ref = {k: np.asarray(jax_generate(jwf, ws, prompt, 6))
           for k, ws in (("a", jws_a), ("b", jws_b))}
    own = dict(pws_a, params={u: {k: t.clone() for k, t in p.items()}
                              for u, p in pws_a["params"].items()})
    eng = DecodeEngine(pwf, own, slots=2, l_max=32, window_ms=0.0,
                       device="cpu").start()
    dep = DeployController(engine=eng)
    try:
        for source, want in ((f"sqlite://{db}#best", "b"), (url, "a")):
            out = dep.reload(source)
            assert out["compiles_during_swap"] == 0
            assert out["active"]["source"] == source
            assert out["active"]["kind"] == "snapshot"
            assert out["active"]["checksum"] == ""
            np.testing.assert_array_equal(
                eng.generate(prompt, 6, timeout=120), ref[want])
        assert dep.reload(version=2)["active"]["source"] \
            == f"sqlite://{db}#best"
        np.testing.assert_array_equal(eng.generate(prompt, 6, timeout=120),
                                      ref["b"])
        # a remote boot source registers as a reloadable version 1
        boot = DeployController(engine=eng, boot_source=url)
        first = boot.models_doc()["versions"][0]
        assert first["kind"] == "snapshot" and first["source"] == url
        boot.reload(version=1)
        np.testing.assert_array_equal(eng.generate(prompt, 6, timeout=120),
                                      ref["a"])
    finally:
        eng.stop()


def test_trainer_restores_from_a_sqlite_row(tmp_path):
    """``Trainer.restore`` from a ``sqlite://...#best`` row of a trainer's
    payload writes the same weights, loader and decision state as from
    the file snapshot of that payload."""
    from veles_tpu_torch.loader.base import TRAIN, VALID, ArrayLoader
    from veles_tpu_torch.models.standard import build_workflow
    from veles_tpu_torch.ops import optimizers as popt
    from veles_tpu_torch.runtime.decision import Decision
    from veles_tpu_torch.runtime.trainer import Trainer

    rng = np.random.default_rng(0)
    d = rng.integers(0, V, (16, 6)).astype(np.int32)
    lab = rng.integers(0, V, 16).astype(np.int32)

    def trainer():
        return Trainer(build_workflow("r", LAYERS),
                       ArrayLoader({TRAIN: d, VALID: d[:8]},
                                   {TRAIN: lab, VALID: lab[:8]},
                                   minibatch_size=8),
                       popt.SGD(0.1), Decision(max_epochs=1), device="cpu")

    tr = trainer()
    tr.initialize(seed=1)
    tr.run()
    payload = tr._payload()
    uri = SnapshotterToDB("r", str(tmp_path / "t.sqlite")).save(
        "ep0", payload, best=True)
    man = Snapshotter("r", str(tmp_path)).save("ep0", payload)
    a, b = trainer(), trainer()
    a.initialize(seed=2)
    b.initialize(seed=2)
    a.restore(uri.rsplit("#", 1)[0] + "#best")
    b.restore(man)
    for u, p in a.wstate["params"].items():
        for k, t in p.items():
            assert torch.equal(t, b.wstate["params"][u][k])
            assert torch.equal(t, tr.wstate["params"][u][k])
    assert a.loader.epoch_number == b.loader.epoch_number == 1
