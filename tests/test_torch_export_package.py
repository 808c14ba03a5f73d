"""The port's export package (``veles_tpu_torch/export/package.py``)
against the JAX package's on shared weights: ``contents.json`` equal as
JSON and every array bitwise (a language model, a conv chain with a
mean/disp normalizer and an LRN, both pipeline-stack forms exported
unstacked), each package's ``load_package`` reading the other's (a
directory and a ``.zip``), and ``serving/veles_serve``, built by ``make``
in a copy of ``serving/`` under a temporary directory, golden-matching the
port's ``generate()`` token for token and its forward within the
reference test's tolerance (rtol 1e-3, atol 1e-4: the C++ runtime sums
in another order)."""

import json
import os
import shutil
import subprocess

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from veles_tpu.export import export_package as jax_export  # noqa: E402
from veles_tpu.export import load_package as jax_load  # noqa: E402
from veles_tpu_torch.export.package import (export_package,  # noqa: E402
                                            load_package)
from veles_tpu_torch.runtime.generate import generate  # noqa: E402

from _torch_helpers import SERVE_LAYERS, build_pair  # noqa: E402
from _torch_helpers import port_autotune_off  # noqa: E402,F401
from test_torch_pipeline_stack import STACKS  # noqa: E402

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)

CONV_LAYERS = [
    {"type": "norm", "name": "norm0"},
    {"type": "conv_relu", "n_kernels": 8, "kx": 5, "padding": 2,
     "name": "conv1"},
    {"type": "max_pooling", "window": 2, "name": "pool1"},
    {"type": "lrn", "name": "lrn1", "method": "auto"},
    {"type": "all2all_tanh", "output_size": 32, "name": "fc1"},
    {"type": "dropout", "dropout_ratio": 0.5, "name": "drop1"},
    {"type": "softmax", "output_size": 10, "name": "out"},
]

CHAINS = {"lm": (SERVE_LAYERS, 12), "conv": (CONV_LAYERS, None),
          **{f"pp_{k}": (v, 6) for k, v in STACKS.items()}}


def _pair(name):
    layers, T = CHAINS[name]
    if T is not None:
        return build_pair(layers, B=2, T=T, seed=5)
    import jax.numpy as jnp
    import veles_tpu as vt
    from veles_tpu.models.standard import build_workflow as jax_build
    from veles_tpu.ops import optimizers as jax_opt
    from veles_tpu_torch.models.standard import build_workflow as port_build
    from veles_tpu_torch.runtime.snapshotter import wstate_from_jax
    from veles_tpu_torch.units.base import Spec
    import jax
    jwf = jax_build("conv", layers)
    jwf.build({"@input": vt.Spec((4, 16, 16, 3), jnp.float32),
               "@labels": vt.Spec((4,), jnp.int32),
               "@mask": vt.Spec((4,), jnp.float32)})
    jws = jwf.init_state(jax.random.key(3), jax_opt.SGD(0.01))
    pwf = port_build("conv", layers)
    pwf.build({"@input": Spec((4, 16, 16, 3), torch.float32),
               "@labels": Spec((4,), torch.int32),
               "@mask": Spec((4,), torch.float32)})
    host = jax.device_get({"params": jws["params"], "state": jws["state"],
                           "step": jws["step"]})
    return jwf, jws, pwf, wstate_from_jax(host, pwf, device="cpu")


def _tensors(contents):
    return {(u["name"], k): v for u in contents["units"]
            for k, v in u["tensors"].items()}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_package_equals_the_jax_package(tmp_path, chain):
    """The same weights exported by both packages: ``contents.json``
    equal as JSON (class names, configs, inputs, content-addressed blob
    names, the checksum) and every npy entry byte for byte."""
    jwf, jws, pwf, pws = _pair(chain)
    jax_export(jwf, jws, str(tmp_path / "jax"))
    export_package(pwf, pws, str(tmp_path / "port"))
    with open(tmp_path / "jax" / "contents.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "contents.json") as f:
        got = json.load(f)
    assert got == want
    for u in got["units"]:
        for fname in u["weights"].values():
            assert (tmp_path / "port" / fname).read_bytes() == \
                (tmp_path / "jax" / fname).read_bytes(), fname
    if chain.startswith("pp_"):
        # the stack exports unstacked: no pipeline_stack entry remains
        assert "PipelineStack" not in {u["class"] for u in got["units"]}


@pytest.mark.parametrize("suffix", ["", ".zip"], ids=["dir", "zip"])
def test_each_load_package_reads_the_other(tmp_path, suffix):
    """A package written by either package loads in the other with the
    same units and the same arrays."""
    jwf, jws, pwf, pws = _pair("lm")
    jp, pp = str(tmp_path / f"jax{suffix}"), str(tmp_path / f"port{suffix}")
    jax_export(jwf, jws, jp)
    export_package(pwf, pws, pp)
    for a, b in ((load_package(jp), jax_load(jp)),
                 (jax_load(pp), load_package(pp))):
        assert [u["name"] for u in a["units"]] == \
            [u["name"] for u in b["units"]]
        ta, tb = _tensors(a), _tensors(b)
        assert ta.keys() == tb.keys()
        for k in ta:
            np.testing.assert_array_equal(ta[k], tb[k])


def test_lrn_auto_is_written_as_its_resolved_method(tmp_path):
    """An ``LRN(method="auto")`` unit exports the method it resolved to,
    never "auto" (the native runtime has no autotuner)."""
    _, _, pwf, pws = _pair("conv")
    contents = load_package(export_package(pwf, pws, str(tmp_path / "p")))
    lrn = next(u for u in contents["units"] if u["class"] == "LRN")
    assert lrn["config"]["method"] == "cumsum"


@pytest.fixture(scope="module")
def binary(tmp_path_factory):
    """``serving/veles_serve`` built by ``make`` in a copy of ``serving/``
    (so it races no in-tree build of the reference tests)."""
    src = os.path.join(REPO, "serving")
    dst = tmp_path_factory.mktemp("serving")
    for name in ("Makefile", "main.cc"):
        shutil.copy(os.path.join(src, name), dst / name)
    shutil.copytree(os.path.join(src, "src"), dst / "src")
    r = subprocess.run(["make", "-s"], cwd=dst, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return str(dst / "veles_serve")


def test_veles_serve_golden_matches_the_port_generate(binary, tmp_path,
                                                      rng):
    """``veles_serve --generate`` on the port's package of a GQA + RoPE
    LM: greedy tokens equal to the port's ``generate()``."""
    _, _, pwf, pws = _pair("lm")
    N = 7
    prompt = rng.integers(0, SERVE_LAYERS[0]["vocab"], (2, 12)).astype(
        np.int32)
    ref = generate(pwf, pws, prompt, N).cpu().numpy()
    pkg = str(tmp_path / "pkg")
    export_package(pwf, pws, pkg,
                   input_spec={"shape": [2, 12], "dtype": "float32"})
    np.save(tmp_path / "p.npy", prompt.astype(np.float32))
    r = subprocess.run([binary, pkg, str(tmp_path / "p.npy"),
                        str(tmp_path / "t.npy"), "--generate", str(N)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    np.testing.assert_array_equal(
        np.load(tmp_path / "t.npy").astype(np.int32), ref)


def test_veles_serve_forward_matches_the_port_predict(binary, tmp_path,
                                                      rng):
    """``veles_serve`` on the port's package of the conv chain (mean/disp
    normalizer, conv, pool, LRN, dropout, softmax head): the head's
    output of the port's predict within rtol 1e-3, atol 1e-4."""
    _, _, pwf, pws = _pair("conv")
    pkg = str(tmp_path / "pkg")
    export_package(pwf, pws, pkg,
                   input_spec={"shape": [4, 16, 16, 3], "dtype": "float32"})
    x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    r = subprocess.run([binary, pkg, str(tmp_path / "x.npy"),
                        str(tmp_path / "y.npy"), "--output-unit", "out"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    ref = pwf.make_predict_step("out")(pws, {"@input": torch.from_numpy(x)})
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"),
                               ref.numpy(), rtol=1e-3, atol=1e-4)
