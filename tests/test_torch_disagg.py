"""The port's KV-page transfer (VTKV1, runtime/engine.py ``export_pages``
/ ``import_pages``, runtime/restful.py ``/kv/pages``) on the CPU, held to
tests/test_disagg.py:87-352's contract: pages round-trip between two
port engines and serve bitwise, greedy and sampled; every malformed
blob, a foreign weights version and a blob the JAX engine exported are
refused with the pool tensors unchanged; imported pages live the
refcount lifecycle of local ones; an import builds no program; and the
port's blob header and page hashes are the JAX engine's on the same
weights, its rows within 1e-5 of the JAX rows."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.runtime.engine import DecodeEngine as JaxEngine  # noqa: E402
from veles_tpu.runtime.generate import generate as jax_generate  # noqa: E402
from veles_tpu_torch.config import root as port_root  # noqa: E402
from veles_tpu_torch.runtime.engine import (DecodeEngine,  # noqa: E402
                                            prefix_page_hashes)
from veles_tpu_torch.runtime.generate import generate  # noqa: E402
from veles_tpu_torch.runtime.restful import RestfulServer  # noqa: E402

from _torch_helpers import build_pair  # noqa: E402

torch.set_num_threads(2)

V = 12

#: tests/test_disagg.py:41-48's LM
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
    kw = {"slots": 4, "l_max": 64, "window_ms": 1.0, **kw}
    return DecodeEngine(lm[2], lm[3], device="cpu", **kw)


def _prompt(rng, n_tokens=48):
    """Three full pages at page_size 16."""
    return rng.integers(0, V, (1, n_tokens)).astype(np.int32)


def _warm_export(lm, prompt, steps=4, **kw):
    """Prefill ``prompt`` on a fresh engine A and export its full pages:
    (blob, hashes, A's tokens)."""
    a = _engine(lm).start()
    try:
        toks = a.generate(prompt, steps, timeout=120, **kw)
        hashes = prefix_page_hashes(prompt[0], a.page_size)
        blob = a.export_pages(hashes)
    finally:
        a.stop()
    return blob, hashes, toks


def _pools(eng):
    return {(n, k): t.clone() for n, c in eng._caches.items()
            for k, t in c.items()}


def _pools_equal(eng, before):
    return all(torch.equal(eng._caches[n][k], t)
               for (n, k), t in before.items())


def _header(blob):
    n = int.from_bytes(blob[6:10], "little")
    return json.loads(blob[10:10 + n]), 10 + n


def _with_header(blob, **changes):
    """The blob with header fields replaced (page sha256s unchanged)."""
    hdr, off = _header(blob)
    hdr.update(changes)
    raw = json.dumps(hdr).encode()
    return blob[:6] + len(raw).to_bytes(4, "little") + raw + blob[off:]


def test_export_import_roundtrip_counts(lm, rng):
    blob, hashes, _ = _warm_export(lm, _prompt(rng))
    assert len(hashes) == 3
    b = _engine(lm).start()
    try:
        doc = b.import_pages(blob)
        assert doc["imported"] == 3 and doc["dropped"] == 0, doc
        assert doc["hashes"] == [h.hex() for h in hashes]
        again = b.import_pages(blob)
        assert again["imported"] == 0 and again["skipped"] == 3, again
        kvt = b.stats()["kv_transfer"]
        assert kvt["imported_pages"] == 3
        assert kvt["import_bytes"] == 2 * len(blob)
        # k and v: 16 positions x 2 kv heads x 8 dims of float32
        assert kvt["page_bytes"] == 2 * 16 * 2 * 8 * 4
        empty = b.export_pages([bytes(32)])
        assert b.import_pages(empty)["imported"] == 0
        assert b.stats()["kv_transfer"]["exported_pages"] == 0
    finally:
        b.stop()


def test_imported_pages_serve_bitwise_greedy(lm, rng):
    """A cold engine that imported A's pages serves A's greedy tokens
    (and the JAX ``generate()``'s), its admission hitting them."""
    jwf, jws, _, _ = lm
    prompt = _prompt(rng)
    blob, _, toks_a = _warm_export(lm, prompt)
    np.testing.assert_array_equal(
        toks_a, np.asarray(jax_generate(jwf, jws, prompt, 4)))
    b = _engine(lm).start()
    try:
        assert b.import_pages(blob)["imported"] == 3
        np.testing.assert_array_equal(b.generate(prompt, 4, timeout=120),
                                      toks_a)
        kvt = b.stats()["kv_transfer"]
        assert kvt["remote_hit_pages"] == 2, kvt   # the tail page re-runs
        assert b.stats()["prefill_tokens"] == 16
    finally:
        b.stop()


def test_imported_pages_serve_bitwise_sampled(lm, rng):
    _, _, pwf, pws = lm
    prompt = _prompt(rng)
    kw = {"temperature": 1.5, "top_k": 4, "seed": 7}
    blob, _, toks_a = _warm_export(lm, prompt, 5, **kw)
    np.testing.assert_array_equal(
        toks_a, generate(pwf, pws, prompt, 5, **kw).numpy())
    b = _engine(lm).start()
    try:
        assert b.import_pages(blob)["imported"] == 3
        np.testing.assert_array_equal(
            b.generate(prompt, 5, timeout=120, **kw), toks_a)
        assert b.stats()["kv_transfer"]["remote_hit_pages"] == 2
    finally:
        b.stop()


def test_dense_engine_rejects_transfer_loudly(lm):
    eng = _engine(lm, slots=2, l_max=32, paged=False)
    with pytest.raises(ValueError, match="paged KV layout"):
        eng.export_pages([])
    with pytest.raises(ValueError, match="paged KV layout"):
        eng.import_pages(b"VTKV1\x00whatever")
    with pytest.raises(ValueError, match="paged KV layout"):
        eng.hot_page_hashes(4)
    assert "kv_transfer" not in eng.stats()


def test_corrupt_and_malformed_blobs_reject_pool_unchanged(lm, rng):
    """Bad magic, a truncated blob, a torn header, a flipped payload
    byte, a short payload, another page size, another entry layout: each
    a ValueError, and the pool tensors, prefix index and free list are
    as before."""
    blob, _, _ = _warm_export(lm, _prompt(rng))
    b = _engine(lm).start()
    try:
        before = _pools(b)
        flipped = bytearray(blob)
        flipped[-1] ^= 0xFF
        hdr, off = _header(blob)
        entries = [list(e) for e in hdr["entries"]]
        entries[0][2] = "bfloat16"
        cases = [(b"NOTKV" + blob, "bad magic"),
                 (blob[:8], "truncated"),
                 (blob[:10] + b"{" * (off - 10) + blob[off:],
                  "corrupt KV-page header"),
                 (bytes(flipped), "integrity"),
                 (blob[:-4], "payload size"),
                 (_with_header(blob, page_size=8), "page_size"),
                 (_with_header(blob, entries=entries), "layout")]
        for bad, msg in cases:
            with pytest.raises(ValueError, match=msg):
                b.import_pages(bad)
        assert _pools_equal(b, before)
        with b._page_lock:
            assert not b._prefix_index and not b._imported_pages
            assert len(b._page_free) == b.pages
        assert b.stats()["kv_transfer"]["imported_pages"] == 0
    finally:
        b.stop()


def test_weights_version_mismatch_rejects_a_jax_blob(lm, rng):
    """Another weights version — a blob stamped with one, or any blob
    the JAX engine exported (its signature names no port) — is refused
    with the pool unchanged: the two frameworks' rows differ in their
    last bits, and an imported page must serve what a local prefill
    would."""
    jwf, jws, _, _ = lm
    prompt = _prompt(rng)
    blob, _, _ = _warm_export(lm, prompt)
    a = JaxEngine(jwf, jws, slots=4, l_max=64, window_ms=1.0).start()
    try:
        a.generate(prompt, 2, timeout=120)
        jax_blob = a.export_pages(prefix_page_hashes(prompt[0], 16))
    finally:
        a.stop()
    b = _engine(lm).start()
    try:
        before = _pools(b)
        for bad in (jax_blob, _with_header(blob, wver=b.kv_wver[:-1] + "1")):
            with pytest.raises(ValueError, match="weights-version"):
                b.import_pages(bad)
        assert _pools_equal(b, before)
        assert b.stats()["pages"]["cached"] == 0
        assert b.import_pages(blob)["imported"] == 3
    finally:
        b.stop()


def test_imported_page_refcount_lifecycle(lm, rng):
    """Imported pages are cached (refcount 0), an admission through them
    pins them like local ones, retirement returns them to cached, and
    eviction recycles them and drops their import attribution."""
    prompt = _prompt(rng)
    blob, hashes, _ = _warm_export(lm, prompt)
    b = _engine(lm, slots=1, pages=4).start()
    try:
        assert b.import_pages(blob)["imported"] == 3
        with b._page_lock:
            pids = [b._prefix_index[h] for h in hashes]
            assert all(b._page_ref[p] == 0 for p in pids)
            assert set(pids) == b._imported_pages
        pg = b.stats()["pages"]
        assert pg["cached"] == 3 and pg["used"] == 0
        b.generate(prompt, 3, timeout=120)
        pg = b.stats()["pages"]
        assert pg["used"] == 0 and pg["cached"] == 3
        # a 4-page request on a 4-page pool evicts every cached page
        b.generate(_prompt(rng, 60), 3, timeout=120)
        with b._page_lock:
            assert not b._imported_pages
            assert not set(hashes) & set(b._prefix_index)
        assert b.stats()["pages"]["evictions"] >= 3
    finally:
        b.stop()


def test_import_keeps_the_step_cache_flat(lm, rng):
    prompt = _prompt(rng)
    blob, _, toks_a = _warm_export(lm, prompt)
    b = _engine(lm).start()
    try:
        b.generate(_prompt(rng), 4, timeout=120)
        st0 = b.stats()["compile"]
        assert b.import_pages(blob)["imported"] == 3
        np.testing.assert_array_equal(b.generate(prompt, 4, timeout=120),
                                      toks_a)
        st = b.stats()["compile"]
        assert st["compiles"] == st0["compiles"] == 3
        assert st["recompiles"] == 0
    finally:
        b.stop()


def test_hot_page_hashes_ranks_resident_pages(lm, rng):
    prompt = _prompt(rng)
    a = _engine(lm).start()
    try:
        a.generate(prompt, 3, timeout=120)
        hashes = prefix_page_hashes(prompt[0], a.page_size)
        hot = a.hot_page_hashes(16)
        assert set(hashes) <= set(hot)
        # the same refcount: the most recently touched first
        assert hot[:3] == hashes[::-1]
        assert len(a.hot_page_hashes(2)) == 2 and a.hot_page_hashes(0) == []
    finally:
        a.stop()


def _rest_server(lm, **engine_kw):
    _, _, pwf, pws = lm
    eng = _engine(lm, **engine_kw)
    srv = RestfulServer(pwf.make_predict_step("out"), pws, 2, (6,), port=0,
                        workflow=pwf, engine=eng, device="cpu")
    eng.start()
    return srv.start(), eng


def _http(url, data=None, method=None):
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/octet-stream")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.headers.get("Content-Type"), e.read()


def test_rest_kv_pages_roundtrip_and_rejections(lm, rng):
    """GET /kv/pages?hashes= and ?top= answer the octet-stream blob, PUT
    imports it; a corrupt body is 400, one over serve.max_body_mb 413, an
    unknown path 404; a dense replica answers 400 on both verbs."""
    prompt = _prompt(rng)
    srv_a, eng_a = _rest_server(lm)
    srv_b, eng_b = _rest_server(lm)
    base_a = f"http://127.0.0.1:{srv_a.port}"
    base_b = f"http://127.0.0.1:{srv_b.port}"
    try:
        ref = eng_a.generate(prompt, 3, timeout=120)
        hx = ",".join(h.hex() for h in prefix_page_hashes(prompt[0], 16))
        st, ctype, blob = _http(base_a + "/kv/pages?hashes=" + hx)
        assert st == 200 and ctype == "application/octet-stream"
        st, _, top_blob = _http(base_a + "/kv/pages?top=8")
        assert st == 200 and len(top_blob) >= len(blob)
        assert _http(base_a + "/kv/pages?hashes=zz")[0] == 400
        assert _http(base_a + "/kv/pages?top=x")[0] == 400
        st, _, body = _http(base_b + "/kv/pages", data=blob, method="PUT")
        assert st == 200 and json.loads(body)["imported"] == 3
        np.testing.assert_array_equal(eng_b.generate(prompt, 3, timeout=120),
                                      ref)
        assert eng_b.stats()["kv_transfer"]["remote_hit_pages"] == 2
        bad = bytearray(blob)
        bad[-1] ^= 0xFF
        st, _, body = _http(base_b + "/kv/pages", data=bytes(bad),
                            method="PUT")
        assert st == 400 and b"integrity" in body
        assert _http(base_b + "/kv/other", data=blob, method="PUT")[0] == 404
        prev = port_root.common.serve.get("max_body_mb", 64)
        port_root.common.serve.max_body_mb = len(blob) / 2 ** 20 / 2
        try:
            st, _, body = _http(base_b + "/kv/pages", data=blob,
                                method="PUT")
            assert st == 413 and b"max_body_mb" in body
        finally:
            port_root.common.serve.max_body_mb = prev
    finally:
        srv_a.stop()
        srv_b.stop()
        eng_a.stop()
        eng_b.stop()
    srv_d, eng_d = _rest_server(lm, paged=False)
    base_d = f"http://127.0.0.1:{srv_d.port}"
    try:
        st, _, body = _http(base_d + "/kv/pages?top=4")
        assert st == 400 and b"paged" in body
        st, _, body = _http(base_d + "/kv/pages", data=blob, method="PUT")
        assert st == 400 and b"paged" in body
    finally:
        srv_d.stop()
        eng_d.stop()


def test_blob_header_and_rows_match_the_jax_engine(lm, rng):
    """The same prefill on the same weights in both packages: the port's
    header (page size, entries) and page hashes are the JAX engine's,
    and every page row is within 1e-5 of the JAX row."""
    jwf, jws, _, _ = lm
    prompt = _prompt(rng)
    hashes = prefix_page_hashes(prompt[0], 16)
    a = JaxEngine(jwf, jws, slots=4, l_max=64, window_ms=1.0).start()
    try:
        a.generate(prompt, 2, timeout=120)
        jax_blob = a.export_pages(hashes)
    finally:
        a.stop()
    blob, _, _ = _warm_export(lm, prompt, 2)
    (jh, joff), (ph, poff) = _header(jax_blob), _header(blob)
    assert ph["page_size"] == jh["page_size"] == 16
    assert ph["entries"] == jh["entries"]
    assert [p["hash"] for p in ph["pages"]] == \
        [p["hash"] for p in jh["pages"]] == [h.hex() for h in hashes]
    assert ph["wver"] != jh["wver"]
    jrows = np.frombuffer(jax_blob[joff:], np.float32)
    prows = np.frombuffer(blob[poff:], np.float32)
    assert prows.shape == jrows.shape
    np.testing.assert_allclose(prows, jrows, rtol=0, atol=1e-5)
