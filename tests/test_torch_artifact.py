"""The port's sealed compiled artifact (``veles_tpu_torch/export/
compiled.py``, ``runtime/artifact.py``) on the CPU, the weights carried
from the JAX package: one export of a narrow bench LM (2 blocks, dim 32,
GQA RoPE attention, vocab 64; 4 slots, l_max 64, page 16, megastep 2,
spec k 2) served by an ``ArtifactRunner``, whose greedy tokens equal the
live engine's and the JAX package's ``generate()`` with flat capture
counters, whose sampled stream, megastep, verify and forward are
bitwise the live engine's (or its own plain decode); forward-only and
cache-free artifacts; every kind of damage refused at load with its own
error; a runner booted in a subprocess that imports no model code;
serving without a workflow over REST; hot swaps of a runner under load
from an artifact, a package and a forge store."""

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import zipfile

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from veles_tpu.runtime.generate import generate as jax_generate  # noqa: E402
from veles_tpu_torch.export.compiled import (FORMAT,  # noqa: E402
                                             MANIFEST, export_compiled,
                                             manifest_summary)
from veles_tpu_torch.export.package import export_package  # noqa: E402
from veles_tpu_torch.ops.optimizers import tree_map  # noqa: E402
from veles_tpu_torch.runtime.artifact import (  # noqa: E402
    ArtifactError, ArtifactRunner, ArtifactVersionError, load_forward,
    read_manifest)
from veles_tpu_torch.runtime.deploy import DeployController  # noqa: E402
from veles_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from veles_tpu_torch.runtime.snapshotter import (  # noqa: E402
    SnapshotCorruptError, _flatten, sha256_files)

from _torch_helpers import SERVE_LAYERS, SERVE_V, build_pair  # noqa: E402
from _torch_helpers import port_autotune_off  # noqa: E402,F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
GEO = dict(slots=4, l_max=64, page_size=16)
V = SERVE_V


def _copy(ws):
    return dict(ws, params=tree_map(lambda t: t.clone(), ws["params"]))


def _live(pwf, ws, **kw):
    return DecodeEngine(pwf, _copy(ws), device="cpu", window_ms=0.0,
                        **GEO, **kw)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    jwf, jws, pwf, pws = build_pair(SERVE_LAYERS, B=2, T=12, seed=21)
    art = str(tmp_path_factory.mktemp("art") / "lm")
    man = export_compiled(pwf, pws, art, megastep=2, spec=True, spec_k=2,
                          eos_id=None, **GEO)
    return jwf, jws, pwf, pws, art, man


@pytest.fixture(scope="module")
def runner(exported):
    """The module's one runner, stopped between tests: a test that needs
    its scheduler starts it (:func:`_serving`), a driven test leaves it
    stopped."""
    r = ArtifactRunner(exported[4], window_ms=0.0, device="cpu")
    yield r
    r.stop()


@contextlib.contextmanager
def _serving(eng):
    eng.start()
    try:
        yield eng
    finally:
        eng.stop()


def _drive(eng, prompts, new, advance, kws=None):
    """Every prompt admitted and prefilled, then ``advance(eng)`` until
    every slot retired, on this thread; the token rows."""
    eng._thread = threading.current_thread()
    try:
        reqs = [eng.submit(p, new, **(kws[i] if kws else {}))
                for i, p in enumerate(prompts)]
        eng._admit()
        while eng._chunking:
            eng._advance_prefills()
        while eng._active.any():
            advance(eng)
    finally:
        eng._thread = None
    assert all(r.done.is_set() and r.error is None for r in reqs)
    return np.stack([r.result for r in reqs])


def test_manifest_records_the_sealed_program_set(exported):
    """Format and version, the program set with each one's inputs and
    sha256, the geometry, the exporting device and torch, the served
    dtypes; weights in the blob only (no program holds a parameter)."""
    _, jws, pwf, pws, art, man = exported
    assert man["format"] == FORMAT and man["format_version"] == 1
    assert sorted(man["programs"]) == sorted(
        ["decode", "decode_greedy", "megastep", "megastep_greedy", "verify",
         "verify_greedy", "prefill", "forward"])
    assert man["device"] == {"type": "cpu", "name": "cpu",
                             "capability": None}
    assert man["torch_version"] == torch.__version__
    assert (man["slots"], man["l_max"], man["page_size"], man["pages"]) \
        == (4, 64, 16, 16)
    assert man["spec_decode"] == {"k": 2} and man["megastep"] == {"n": 2}
    assert man["vocab"] == V and man["input_vocab"] == V
    assert man["workflow_checksum"] == pwf.checksum()
    assert man["prefix_reuse"] and "decode_unsupported" not in man
    assert man == read_manifest(art)
    with np.load(os.path.join(art, "tensors.npz")) as z:
        flat = _flatten({"params": pws["params"]})
        assert set(z.files) >= set(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(z[k], v)
    n_params = sum(t.numel() for t in torch.utils._pytree.tree_leaves(
        pws["params"]))
    for name, info in man["programs"].items():
        assert sha256_files([os.path.join(art, info["file"])]) \
            == info["sha256"]
        with zipfile.ZipFile(os.path.join(art, info["file"])) as z:
            names = z.namelist()
            # the example inputs (which hold the weights) are dropped
            assert all(z.getinfo(n).file_size == 0 for n in names
                       if "sample_inputs" in n), name
            const = sum(z.getinfo(n).file_size for n in names
                        if "/data/" in n)
        # the step's row and offset indices at most: no weight
        assert const < n_params, name
    summary = manifest_summary(man)
    assert summary["programs"] == sorted(
        p["file"] for p in man["programs"].values())


def test_greedy_equals_the_live_engine_and_jax_with_flat_counters(
        exported, runner, rng):
    """Greedy tokens of the runner equal the live engine's on the same
    weights and the JAX package's ``generate()``; nothing is built after
    load, over requests of every length."""
    jwf, jws, pwf, pws, art, man = exported
    comp0 = dict(runner.stats()["compile"])
    prompt = rng.integers(0, V, (3, 12)).astype(np.int32)
    with _serving(runner):
        got = runner.generate(prompt, 9, timeout=120)
        runner.generate(rng.integers(0, V, (1, 40)).astype(np.int32), 5,
                        timeout=120)
    live = _live(pwf, pws).start()
    try:
        want = live.generate(prompt, 9, timeout=120)
    finally:
        live.stop()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jax_generate(jwf, jws, prompt, 9)))
    comp = runner.stats()["compile"]
    assert comp["compiles"] == comp0["compiles"] == 7
    assert comp["recompiles"] == 0
    assert runner.stats()["artifact"]["programs"] == 8


def test_sampled_stream_equals_the_live_engine(exported, runner, rng):
    """A sampled row (temperature, top-k, top-p, seed) through the sealed
    sampling program: the live engine's stream, token for token."""
    _, _, pwf, pws, _, _ = exported
    prompt = rng.integers(0, V, (1, 10)).astype(np.int32)
    kw = dict(temperature=0.8, top_k=20, top_p=0.9, seed=4)
    with _serving(runner):
        got = runner.generate(prompt, 12, timeout=120, **kw)
    live = _live(pwf, pws).start()
    try:
        want = live.generate(prompt, 12, timeout=120, **kw)
    finally:
        live.stop()
    np.testing.assert_array_equal(got, want)


def test_megastep_and_verify_equal_the_runners_plain_decode(runner, rng):
    """The sealed megastep and verify programs (a sampled row among the
    greedy ones) give the runner's own plain decode, bit for bit."""
    r = runner
    st0 = r.stats()
    phrase = rng.integers(0, V, (4, 6))
    prompts = np.stack([np.resize(p, 24) for p in phrase]).astype(np.int32)
    kws = [{}] * 3 + [dict(temperature=0.9, top_k=16, seed=2)]
    plain = _drive(r, prompts, 10, lambda e: e._step_once(), kws)
    mega = _drive(r, prompts, 10, lambda e: e._megastep_once(), kws)
    verify = _drive(r, prompts, 10, lambda e: e._verify_once(
        e._spec_drafts() if e._spec_drafts() is not None
        else np.full((e.slots, e.spec_k), -1, np.int32)), kws)
    np.testing.assert_array_equal(mega, plain)
    np.testing.assert_array_equal(verify, plain)
    st = r.stats()
    assert st["megastep"]["mega_dispatches"] \
        > st0["megastep"]["mega_dispatches"]
    assert st["spec"]["verify_steps"] > st0["spec"]["verify_steps"]
    assert st["compile"]["compiles"] == 7


def test_forward_program_matches_predict(exported, runner, rng):
    """The sealed forward: bitwise the port's predict, and the JAX
    package's within float32 rounding."""
    jwf, jws, pwf, pws, _, _ = exported
    import jax.numpy as jnp
    x = rng.integers(0, V, (2, 12)).astype(np.int32)
    got = runner.predict(runner.wstate, {"@input": torch.from_numpy(x)})
    want = pwf.make_predict_step()(pws, {"@input": torch.from_numpy(x)})
    assert torch.equal(got, want)
    ref = np.asarray(jwf.make_predict_step()(jws, {"@input": jnp.asarray(x)}))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_forward_only_artifact(tmp_path, rng):
    """A chain DecodePlan refuses (a mean/disp normalizer, conv, pooling,
    LRN, softmax) seals its forward alone, the reason recorded; the
    runner refuses it, ``load_forward`` serves it bitwise the predict."""
    from test_torch_export_package import _pair
    _, _, pwf, pws = _pair("conv")
    art = str(tmp_path / "conv")
    man = export_compiled(pwf, pws, art)
    assert sorted(man["programs"]) == ["forward"]
    assert "Embedding" in man["decode_unsupported"]
    with pytest.raises(ArtifactError, match="load_forward"):
        ArtifactRunner(art, device="cpu")
    predict, ws, _ = load_forward(art, device="cpu")
    x = torch.from_numpy(rng.standard_normal((4, 16, 16, 3)).astype(
        np.float32))
    assert torch.equal(predict(ws, {"@input": x}),
                       pwf.make_predict_step()(pws, {"@input": x}))


def test_a_program_export_refuses_ships_forward_only(exported, tmp_path,
                                                     monkeypatch):
    """When ``torch.export`` refuses a decode program, the artifact ships
    its forward alone, the reason under ``decode_unsupported``, and no
    blob of the refused program set stays on disk."""
    from veles_tpu_torch.export import compiled
    pwf, pws = exported[2], exported[3]
    real = compiled._export

    def refusing(fn, params, state, inputs):
        if "x" not in inputs:               # every program but forward
            raise RuntimeError("data-dependent guard")
        return real(fn, params, state, inputs)

    monkeypatch.setattr(compiled, "_export", refusing)
    art = str(tmp_path / "fwd")
    man = export_compiled(pwf, pws, art, megastep=1, spec=False, **GEO)
    assert sorted(man["programs"]) == ["forward"]
    assert man["decode_unsupported"].startswith(
        "torch.export: RuntimeError: data-dependent guard")
    assert man["paged"] is False and man["caches"] == []
    assert os.listdir(os.path.join(art, "programs")) == ["forward.pt2"]


def test_cache_free_chain_roundtrip(tmp_path, rng):
    """A chain with no attention or recurrent unit (embedding, layer norm,
    per-position head) seals an empty cache set and still serves the
    live engine's tokens."""
    layers = [{"type": "embedding", "vocab": 16, "dim": 8, "name": "emb"},
              {"type": "layer_norm", "name": "ln"},
              {"type": "all2all", "output_size": 16, "per_position": True,
               "name": "head"}]
    _, _, pwf, pws = build_pair(layers, B=2, T=6, seed=2)
    art = str(tmp_path / "free")
    man = export_compiled(pwf, pws, art, megastep=1, spec=False, **GEO)
    assert man["caches"] == [] and man["attn_units"] == []
    r = ArtifactRunner(art, window_ms=0.0, device="cpu").start()
    live = _live(pwf, pws).start()
    try:
        prompt = rng.integers(0, 16, (2, 5)).astype(np.int32)
        np.testing.assert_array_equal(r.generate(prompt, 6, timeout=120),
                                      live.generate(prompt, 6, timeout=120))
    finally:
        r.stop()
        live.stop()


def test_out_of_vocab_eos_is_refused_before_export(exported, tmp_path):
    pwf, pws = exported[2], exported[3]
    with pytest.raises(ValueError, match="vocabulary"):
        export_compiled(pwf, pws, str(tmp_path / "bad"), eos_id=V, **GEO)
    assert not os.path.exists(tmp_path / "bad" / MANIFEST)


def _clone(art, dst):
    shutil.copytree(art, dst)
    return str(dst)


def _edit_manifest(art, fn):
    path = os.path.join(art, MANIFEST)
    with open(path) as f:
        man = json.load(f)
    fn(man)
    with open(path, "w") as f:
        json.dump(man, f)
    return man


def _flip(path, offset=200):
    with open(path, "rb+") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def _damage(kind, art):
    if kind == "tensors":
        _flip(os.path.join(art, "tensors.npz"))
    elif kind == "program":
        _flip(os.path.join(art, "programs", "decode.pt2"))
    elif kind == "manifest":
        _edit_manifest(art, lambda m: m.pop("served"))
    elif kind == "unparseable":
        with open(os.path.join(art, MANIFEST), "w") as f:
            f.write("{not json")
    elif kind == "newer":
        _edit_manifest(art, lambda m: m.update(format_version=2))
    elif kind == "device":
        _edit_manifest(art, lambda m: m.update(device={
            "type": "cuda", "name": "NVIDIA H100 80GB HBM3",
            "capability": [9, 0]}))
    elif kind == "jax":
        _edit_manifest(art, lambda m: m.update(
            format="veles-tpu-compiled-artifact"))
    elif kind == "torch":
        # bytes this torch cannot load, their checksum sealed as a newer
        # exporter's would be
        path = os.path.join(art, "programs", "decode.pt2")
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04 not an export archive of this torch")
        sha = sha256_files([path])

        def seal(m):
            m["programs"]["decode"]["sha256"] = sha
            m["torch_version"] = "99.0.0"
        _edit_manifest(art, seal)


@pytest.mark.parametrize("kind,err,match", [
    ("tensors", SnapshotCorruptError, "checksum mismatch"),
    ("program", SnapshotCorruptError, "checksum mismatch"),
    ("manifest", SnapshotCorruptError, "damaged"),
    ("unparseable", SnapshotCorruptError, "unparseable"),
    ("newer", ArtifactVersionError, "newer"),
    ("device", ArtifactError, "re-export on the serving device"),
    ("jax", ArtifactVersionError, "JAX package"),
    ("torch", ArtifactVersionError,
     r"99\.0\.0.*" + re.escape(torch.__version__)),
])
def test_damage_is_refused_at_load_with_its_own_error(exported, tmp_path,
                                                      kind, err, match):
    art = _clone(exported[4], tmp_path / kind)
    _damage(kind, art)
    with pytest.raises(err, match=match):
        ArtifactRunner(art, device="cpu")


def test_runner_boots_in_a_subprocess_without_model_code(exported, runner,
                                                         rng):
    """A fresh process that imports the runner alone (no config, no
    workflow code) serves the runner's tokens."""
    art = exported[4]
    prompt = rng.integers(0, V, (2, 8)).astype(np.int32)
    code = (
        "import json, sys, numpy as np\n"
        "from veles_tpu_torch.runtime.artifact import ArtifactRunner\n"
        f"r = ArtifactRunner({art!r}, device='cpu').start()\n"
        f"t = r.generate(np.asarray({prompt.tolist()}, np.int32), 6)\n"
        "r.stop()\n"
        "print(json.dumps({'tokens': t.tolist(), 'model_code': sorted(\n"
        "    m for m in sys.modules if m.startswith(\n"
        "        ('veles_tpu_torch.models', 'veles_tpu_torch.config'))\n"
        "    and m != 'veles_tpu_torch.config')}))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["model_code"] == []
    with _serving(runner):
        np.testing.assert_array_equal(
            out["tokens"], runner.generate(prompt, 6, timeout=120))


def _post(port, path, body):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_rest_serving_without_workflow(exported, runner, rng):
    """``RestfulServer`` with the runner as its engine and the sealed
    forward as its predict, no workflow: /generate answers the runner's
    tokens, /predict the forward's output, an out-of-vocab prompt 400."""
    from veles_tpu_torch.runtime.restful import RestfulServer
    man = exported[5]
    shape = man["input_spec"]["shape"]
    srv = RestfulServer(runner.predict, runner.wstate, shape[0],
                        tuple(shape[1:]), port=0, engine=runner,
                        device="cpu", vocab_size=man["input_vocab"]).start()
    runner.start()
    try:
        prompt = rng.integers(0, V, (2, 7)).astype(np.int32)
        code, doc = _post(srv.port, "/generate",
                          {"prompt": prompt.tolist(), "steps": 5})
        assert code == 200
        np.testing.assert_array_equal(
            doc["tokens"], runner.generate(prompt, 5, timeout=120))
        x = rng.integers(0, V, (1, shape[1])).astype(np.int32)
        code, doc = _post(srv.port, "/predict", {"input": x.tolist()})
        assert code == 200
        pad = np.concatenate([x, np.zeros((shape[0] - 1, shape[1]),
                                          np.int32)])
        want = runner.predict(runner.wstate,
                              {"@input": torch.from_numpy(pad)})[:1]
        np.testing.assert_array_equal(np.asarray(doc["output"], np.float32),
                                      want.numpy())
        code, doc = _post(srv.port, "/generate",
                          {"prompt": [[V]], "steps": 2})
        assert code == 400 and "token ids" in doc["error"]
    finally:
        srv.stop()
        runner.stop()


def _reweighted(art, dst, params):
    """A copy of ``art`` whose weights blob holds ``params`` (its sha256
    sealed anew): the same programs, another weight version."""
    out = _clone(art, dst)
    flat = _flatten({"params": params})
    np.savez(os.path.join(out, "tensors.npz"), **flat)
    sha = sha256_files([os.path.join(out, "tensors.npz")])
    _edit_manifest(out, lambda m: m.update(tensors_sha256=sha))
    return out


def test_runner_hot_swaps_under_load_from_artifact_package_and_forge(
        exported, runner, tmp_path, rng):
    """A runner behind a REST server and a deploy controller hot-swaps
    from a second artifact, an export package (directory and .zip) and a
    forge store while clients hammer it: no request fails, nothing is
    built after load, and each swap serves the live engine's tokens on
    the swapped weights; another workflow's package is refused (409)."""
    from veles_tpu_torch.forge.store import ForgeStore
    from veles_tpu_torch.runtime.restful import RestfulServer
    _, _, pwf, pws, art, man = exported
    others = [build_pair(SERVE_LAYERS, B=2, T=12, seed=s)[3]
              for s in (31, 32, 33, 34)]
    art2 = _reweighted(art, tmp_path / "art2", others[0]["params"])
    pkg = export_package(pwf, others[1], str(tmp_path / "pkg"))
    pkz = export_package(pwf, others[2], str(tmp_path / "pkg.zip"))
    fpk = export_package(pwf, others[3], str(tmp_path / "fpkg"))
    store = str(tmp_path / "forge")
    ForgeStore(store).add(ForgeStore.pack_dir(fpk, {
        "name": "lm", "workflow": "contents.json",
        "configuration": "contents.json", "author": "tests",
        "short_description": "seed 34"}))
    r = runner
    srv = RestfulServer(r.predict, r.wstate, 2, (12,), port=0, engine=r,
                        device="cpu")
    r.start()
    srv.start()
    dep = DeployController(server=srv, boot_source=art)
    assert dep.registry.active["kind"] == "artifact"
    comp0 = dict(r.stats()["compile"])
    probe = rng.integers(0, V, (1, 9)).astype(np.int32)
    load = rng.integers(0, V, (6, 9)).astype(np.int32)
    codes, stop = [], threading.Event()

    def hammer(row):
        while not stop.is_set():
            codes.append(_post(srv.port, "/generate",
                               {"prompt": [row.tolist()], "steps": 4})[0])

    threads = [threading.Thread(target=hammer, args=(row,)) for row in load]
    for t in threads:
        t.start()
    try:
        for src, ws in ((art2, others[0]), (pkg, others[1]),
                        (pkz, others[2]), (f"forge://{store}/lm", others[3])):
            n = len(codes)
            dep.reload(src)
            while len(codes) < n + len(load):
                threading.Event().wait(0.01)
            live = _live(pwf, ws).start()
            try:
                np.testing.assert_array_equal(
                    r.generate(probe, 6, timeout=120),
                    live.generate(probe, 6, timeout=120))
            finally:
                live.stop()
        other = build_pair(SERVE_LAYERS[:1] + SERVE_LAYERS[-1:], B=2, T=12,
                           seed=3)
        foreign = export_package(other[2], other[3], str(tmp_path / "fw"))
        with pytest.raises(ValueError, match="different workflow"):
            dep.reload(foreign)
        # the boot version back: the module's runner serves its weights
        dep.reload(version=1)
    finally:
        stop.set()
        for t in threads:
            t.join(120)
        srv.stop()
        r.stop()
    assert codes and set(codes) == {200}
    assert dep.swaps == 5
    comp = r.stats()["compile"]
    assert comp["compiles"] == comp0["compiles"] and comp["recompiles"] == 0
