"""The port's autotune (``veles_tpu_torch/runtime/autotune.py``) on the
CPU, the contracts of tests/test_autotune.py: ``pick`` measures once and
persists the winner under the ``autotune`` key of the per-device-kind DB,
answers a repeat from its memo and a fresh process from the DB, measures
again for a new candidate set, gives the default when disabled or when a
candidate fails; ``LRN(method="auto")`` resolves to a measured method at
the workflow's init (never "auto"), a second unit reads the DB, and with
autotune off it is "cumsum" at build, as the JAX package's; the device
benchmark measures when the DB holds winners but no rating."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from veles_tpu_torch.config import root  # noqa: E402
from veles_tpu_torch.runtime import autotune  # noqa: E402
from veles_tpu_torch.runtime.benchmark import benchmark_device  # noqa: E402
from veles_tpu_torch.units import nn  # noqa: E402
from veles_tpu_torch.units.base import Spec  # noqa: E402

from _torch_helpers import port_autotune_off  # noqa: E402,F401


@pytest.fixture
def tuned(tmp_path, monkeypatch):
    monkeypatch.setattr(root.common, "autotune", True)
    monkeypatch.setattr(root.common, "cache_dir", str(tmp_path))
    autotune._memo.clear()
    yield str(tmp_path)
    autotune._memo.clear()


def _toys(calls):
    def fast(x):
        calls["fast"] += 1
        return x + 1.0

    def slow(x):
        calls["slow"] += 1
        for _ in range(40):
            x = x @ x * 1e-3
        return x

    return {"slow": slow, "fast": fast}


def _db(path):
    with open(os.path.join(path, "device_infos.json")) as f:
        return json.load(f)


def test_pick_measures_and_persists(tuned):
    calls = {"fast": 0, "slow": 0}
    cands = _toys(calls)
    x = torch.randn(128, 128)
    assert autotune.pick("toy_op", cands, [x]) == "fast"
    db = _db(tuned)
    assert list(db) == ["cpu"]
    (key,) = db["cpu"]["autotune"]
    assert key == "toy_op|128x128:float32"
    rec = db["cpu"]["autotune"][key]
    assert rec["winner"] == "fast" and set(rec["ms"]) == {"fast", "slow"}
    assert rec["ms"]["fast"] < rec["ms"]["slow"]
    # the memo answers without measuring
    calls.update(fast=0, slow=0)
    assert autotune.pick("toy_op", cands, [x]) == "fast"
    assert calls == {"fast": 0, "slow": 0}
    # a fresh process: the DB answers without measuring
    autotune._memo.clear()
    assert autotune.pick("toy_op", cands, [x]) == "fast"
    assert calls == {"fast": 0, "slow": 0}


def test_a_new_candidate_is_measured_again(tuned):
    calls = {"fast": 0, "slow": 0}
    cands = _toys(calls)
    x = torch.randn(64, 64)
    autotune.pick("toy_op2", cands, [x])
    calls.update(fast=0, slow=0)

    def faster(x):
        return x

    assert autotune.pick("toy_op2", dict(cands, faster=faster), [x]) \
        in ("faster", "fast")
    assert calls["fast"] > 0 and calls["slow"] > 0
    rec = _db(tuned)["cpu"]["autotune"]["toy_op2|64x64:float32"]
    assert set(rec["ms"]) == {"fast", "slow", "faster"}


def test_pick_disabled_returns_default(tuned):
    root.common.autotune = False

    def never(x):
        raise AssertionError("must not measure when disabled")

    assert autotune.pick("op2", {"a": never, "b": never}, [torch.ones(4)],
                         default="b") == "b"


def test_pick_failure_falls_back(tuned):
    def broken(x):
        raise RuntimeError("boom")

    def ok(x):
        return x * 2

    assert autotune.pick("op3", {"ok": ok, "broken": broken},
                         [torch.ones(4, 4)], default="ok") == "ok"
    assert not os.path.exists(os.path.join(tuned, "device_infos.json"))


def test_lrn_auto_resolves_and_a_second_unit_reads_the_db(tuned,
                                                          monkeypatch):
    """``prepare`` measures the three formulations (forward plus
    backward) once; a second unit of the same shape, in a fresh process
    (memo cleared), reads the DB and measures nothing."""
    spec = Spec((4, 6, 6, 32), torch.float32)
    u = nn.LRN(method="auto", name="lrn")
    u.prepare([spec], "cpu")
    assert u.method in ("cumsum", "band", "band_bf16")
    rec = _db(tuned)["cpu"]["autotune"][
        "lrn_fwd_bwd_n5_b0.75|4x6x6x32:float32"]
    assert set(rec["ms"]) == {"cumsum", "band", "band_bf16"}
    assert rec["winner"] == u.method
    autotune._memo.clear()
    monkeypatch.setattr(autotune, "measure", lambda *a, **k: pytest.fail(
        "the second build measured"))
    u2 = nn.LRN(method="auto", name="lrn2")
    u2.prepare([spec], "cpu")
    assert u2.method == u.method


def test_lrn_auto_resolves_at_init_and_exports_the_pick(tuned, tmp_path):
    """A workflow's ``init_state`` on a device resolves its LRN units;
    the export package writes the resolved method."""
    from veles_tpu_torch.export.package import export_package, load_package
    from veles_tpu_torch.models.standard import build_workflow
    wf = build_workflow("lrn", [
        {"type": "conv_relu", "n_kernels": 8, "kx": 3, "padding": 1,
         "name": "conv"},
        {"type": "lrn", "method": "auto", "name": "lrn"},
        {"type": "softmax", "output_size": 4, "name": "out"}])
    wf.build({"@input": Spec((2, 8, 8, 3), torch.float32),
              "@labels": Spec((2,), torch.int32),
              "@mask": Spec((2,), torch.float32)})
    lrn = next(u for u in wf.units if u.name == "lrn")
    assert lrn.method == "auto"
    ws = wf.init_state(0, device="cpu")
    assert lrn.method in ("cumsum", "band", "band_bf16")
    pkg = load_package(export_package(wf, ws, str(tmp_path / "p")))
    assert next(u for u in pkg["units"] if u["name"] == "lrn")[
        "config"]["method"] == lrn.method


def test_lrn_auto_disabled_is_cumsum_at_build():
    """Autotune off (the tests' default): "auto" is "cumsum" once the
    workflow is built, as the JAX package resolves it."""
    u = nn.LRN(method="auto", name="lrn")
    u.output_spec([Spec((2, 4, 4, 16), torch.float32)])
    assert u.method == "cumsum"


def test_device_benchmark_measures_past_a_winners_only_record(tuned):
    """A DB record holding autotune winners alone is no rating: the
    device benchmark measures and keeps the winners."""
    autotune.pick("toy_op", _toys({"fast": 0, "slow": 0}),
                  [torch.randn(32, 32)])
    info = benchmark_device(tuned, device="cpu", sizes=(64,),
                            dtypes=("float32",), reps=1)
    assert info["results"] and info["results"][0]["size"] == 64
    rec = _db(tuned)["cpu"]
    assert rec["results"] and "toy_op|32x32:float32" in rec["autotune"]


def test_lrn_methods_agree_with_the_jax_package(rng):
    """The three formulations the pick chooses among are the JAX
    package's: each within float32 rounding of its counterpart."""
    import jax.numpy as jnp
    from veles_tpu.ops import local_response_norm as jax_lrn
    from veles_tpu_torch.ops.lrn import local_response_norm
    x = rng.standard_normal((2, 5, 5, 24)).astype(np.float32)
    for method in ("cumsum", "band", "band_bf16"):
        got = local_response_norm(torch.from_numpy(x), method=method)
        want = np.asarray(jax_lrn(jnp.asarray(x), method=method))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
