"""Weights and hygiene of the port: snapshots move between the two
packages with byte-identical tensors, the weight-carrying function takes
every JAX layout and refuses what does not fit, the port imports neither
``jax`` nor ``veles_tpu``, and its entry points refuse to run on the CPU
unless asked to."""

import ast
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from veles_tpu.runtime.snapshotter import Snapshotter as JaxSnap  # noqa: E402
from veles_tpu_torch.runtime.snapshotter import (  # noqa: E402
    Snapshotter, SnapshotCorruptError, params_from_jax, params_to_numpy,
    wstate_from_snapshot)
from veles_tpu_torch.units.workflow import seed_key  # noqa: E402

from _torch_helpers import (build_pair, narrow_bench_layers,  # noqa: E402
                            tokens, vocab_of)
from _torch_helpers import port_autotune_off  # noqa: E402,F401

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
PORT = os.path.join(REPO, "veles_tpu_torch")


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def test_jax_snapshot_loads_byte_identical(tmp_path):
    jwf, jws, pwf, _ = build_pair(narrow_bench_layers(), seed=4)
    man = JaxSnap("jx", str(tmp_path)).save("t", {"wstate": jws,
                                                  "epoch": 3})
    payload = Snapshotter.load(man)
    assert payload["epoch"] == 3
    ws = wstate_from_snapshot(man, pwf, device="cpu")
    ref = jax.device_get(jws["params"])
    for unit, sub in ref.items():
        for name, arr in sub.items():
            assert _same_bytes(ws["params"][unit][name].numpy(), arr), \
                f"{unit}/{name}"
    # the optimizer state and step ride along as data
    assert int(ws["step"]) == 0


def test_port_snapshot_loads_back_into_jax(rng, tmp_path):
    layers = narrow_bench_layers()
    jwf, jws, pwf, pws = build_pair(layers, seed=6)
    man = Snapshotter("pt", str(tmp_path)).save(
        "t", {"wstate": {"params": pws["params"], "state": {},
                         "opt_state": {}, "step": np.int32(0),
                         "key": seed_key(6)}})
    loaded = JaxSnap.load(man)                       # sha256-verified
    for unit, sub in params_to_numpy(pws["params"]).items():
        for name, arr in sub.items():
            assert _same_bytes(loaded["wstate"]["params"][unit][name], arr)
    x = tokens(rng, (2, 12), vocab_of(layers))
    jx = dict(jws, params=jax.tree.map(jnp.asarray,
                                       loaded["wstate"]["params"]))
    ref = jwf.make_predict_step()(jx, {"@input": jnp.asarray(x)})
    out = pwf.make_predict_step()(pws, {"@input": torch.from_numpy(x)})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_snapshot_checksum_is_verified(tmp_path):
    man = Snapshotter("pt", str(tmp_path)).save(
        "t", {"wstate": {"params": {"u": {"w": np.ones(3, np.float32)}}}})
    npz = os.path.join(str(tmp_path), "pt_t.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    with pytest.raises(SnapshotCorruptError):
        Snapshotter.load(man)


def test_params_from_jax_layouts_and_checks():
    jwf, jws, pwf, _ = build_pair(narrow_bench_layers(), seed=8)
    nested = jax.device_get(jws["params"])
    flat = {f"{u}/{k}": v for u, sub in nested.items()
            for k, v in sub.items()}
    prefixed = {f"params/{k}": v for k, v in flat.items()}
    for tree in (nested, flat, prefixed, jax.device_get(jws)):
        p = params_from_jax(tree, pwf, device="cpu")
        assert _same_bytes(p["attn0"]["wq"].numpy(), nested["attn0"]["wq"])
    # (in, out) layout kept: a transposed matrix is refused, never
    # silently transposed back
    bad = dict(flat, **{"attn0/wo": flat["attn0/wo"].T.copy()})
    bad["ffn0/w1"] = flat["ffn0/w1"].T.copy()
    with pytest.raises(ValueError, match="ffn0/w1"):
        params_from_jax(bad, pwf, device="cpu")
    missing = {k: v for k, v in flat.items() if k != "head/b"}
    with pytest.raises(ValueError, match="head/b"):
        params_from_jax(missing, pwf, device="cpu")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for base, _dirs, files in os.walk(PORT):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return out


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "veles_tpu")


def test_port_never_imports_jax_or_the_jax_package():
    """AST scan of every port module and chip_smoke.py: no import of jax
    or of veles_tpu, in any form."""
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.Call) and node.args and isinstance(
                    node.args[0], ast.Constant) and isinstance(
                    node.args[0].value, str) and getattr(
                    node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
                names = [node.args[0].value]
            offenders += [f"{os.path.relpath(path, REPO)}:{node.lineno} "
                          f"{n}" for n in names if _forbidden(n)]
    assert not offenders, offenders


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import veles_tpu_torch, veles_tpu_torch.__main__\n"
        "import veles_tpu_torch.runtime.restful, veles_tpu_torch.runtime."
        "engine, veles_tpu_torch.runtime.generate\n"
        "import veles_tpu_torch.ops.kernels\n"
        "import veles_tpu_torch.models.alexnet, veles_tpu_torch.loader\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'veles_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_parallel_modules_are_scanned_and_load_no_jax():
    """The parallel modules (mesh, process group, launcher, MoE, the
    pipeline schedules) are among the scanned sources, and importing them
    loads neither jax nor the JAX package."""
    mods = ("mesh", "distributed", "launcher", "moe", "pipeline",
            "pipeline_compile")
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    for m in mods:
        assert os.path.join("veles_tpu_torch", "parallel",
                            f"{m}.py") in scanned
    code = ("import sys\n"
            + "".join(f"import veles_tpu_torch.parallel.{m}\n"
                      for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'veles_tpu'))\n"
              "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_fleet_modules_are_scanned_and_load_no_jax():
    """The fleet router, its replica client and the job manager (copies
    of JAX-free modules of the JAX package) are among the scanned
    sources, and importing them loads neither jax nor the JAX
    package."""
    mods = ("fleet", "fleet_client", "jobs")
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    for m in mods:
        assert os.path.join("veles_tpu_torch", "runtime",
                            f"{m}.py") in scanned
    code = ("import sys\n"
            + "".join(f"import veles_tpu_torch.runtime.{m}\n"
                      for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'veles_tpu'))\n"
              "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_refuse_cpu_by_default(monkeypatch):
    """With no CUDA card and no explicit device='cpu', every entry point
    raises instead of carrying on on the host."""
    from veles_tpu_torch.ops import kernel_route, resolve_device
    from veles_tpu_torch.runtime.engine import DecodeEngine
    from veles_tpu_torch.runtime.restful import RestfulServer
    jwf, jws, pwf, pws = build_pair(narrow_bench_layers(), seed=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(pwf, pws)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pwf.init_state(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(jax.device_get(jws["params"]), pwf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RestfulServer(pwf.make_predict_step(), pws, 2, (12,), port=0)
    assert resolve_device("cpu").type == "cpu"
    assert kernel_route(torch.zeros(1), "any") is False


def test_export_forge_and_artifact_modules_are_scanned_and_load_no_jax():
    """The export package and compiled artifact, the forge store, the
    artifact runner and autotune are among the scanned sources, and
    importing them loads neither jax nor the JAX package."""
    mods = ("export.package", "export.compiled", "forge.store",
            "runtime.artifact", "runtime.autotune")
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    for m in mods:
        assert os.path.join("veles_tpu_torch",
                            *m.split(".")) + ".py" in scanned
    code = ("import sys\n"
            + "".join(f"import veles_tpu_torch.{m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'veles_tpu'))\n"
              "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_a_jax_snapshot_exports_the_jax_package(tmp_path):
    """A JAX-written snapshot carried into the port
    (``wstate_from_snapshot``) and exported by the port's
    ``export_package``: the package the JAX package writes from the same
    snapshot, ``contents.json`` and every npy byte."""
    from veles_tpu.export import export_package as jax_export
    from veles_tpu_torch.export.package import export_package
    from veles_tpu_torch.runtime.snapshotter import wstate_from_snapshot
    jwf, jws, pwf, _ = build_pair(narrow_bench_layers(), B=2, T=12, seed=9)
    snap = JaxSnap("lm", str(tmp_path / "snaps")).save(
        "best", {"wstate": jax.device_get(jws),
                 "workflow_checksum": jwf.checksum()})
    jws_back = JaxSnap.load(snap)["wstate"]
    jax_export(jwf, jws_back, str(tmp_path / "jax"))
    export_package(pwf, wstate_from_snapshot(snap, pwf, device="cpu"),
                   str(tmp_path / "port"))
    want = (tmp_path / "jax" / "contents.json").read_text()
    got = (tmp_path / "port" / "contents.json").read_text()
    assert got == want
    for u in json.loads(got)["units"]:
        for fname in u["weights"].values():
            assert (tmp_path / "port" / fname).read_bytes() == \
                (tmp_path / "jax" / fname).read_bytes()
