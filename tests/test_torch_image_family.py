"""The image/conv config family on the CPU, the port against the JAX
package: the normalizers, the synthetic datasets and the mnist / cifar /
stl loaders' arrays, the unpooling ops and the Flatten, Reshape, Depool,
StochasticAbsPooling, Deconv and MSE-evaluator units, ``deconv2d``,
``matrix_reduce``, three train steps of a narrowed synthdigits_conv and
of the conv autoencoder through both Trainers, the loader's normalizer
state through a port snapshot into the JAX package and back, and every
``configs/synth*.json`` through ``python -m veles_tpu_torch``.

Tolerances: the normalizers, datasets, loader arrays and batches
bitwise (host numpy on both sides); Flatten, Reshape, Depool,
StochasticAbsPooling, the unpooling ops and ``matrix_reduce`` exact;
``deconv2d`` and the Deconv unit, forward and gradient, float32 rtol 1e-5
/ atol 1e-6; EvaluatorMSE's loss and rmse rtol 1e-6; the trainers'
epoch losses rtol 1e-4 and gradient norms rtol 1e-3 (float32, different
summation orders)."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import veles_tpu as vt  # noqa: E402
from veles_tpu import normalization as jnorm  # noqa: E402
from veles_tpu.models import cifar as jcifar  # noqa: E402
from veles_tpu.models import mnist as jmnist  # noqa: E402
from veles_tpu.models import stl as jstl  # noqa: E402
from veles_tpu.models import synth_data as jsynth  # noqa: E402
from veles_tpu.models.standard import StandardWorkflow as JaxStandard  # noqa: E402,E501
from veles_tpu.ops import convolution as jconv  # noqa: E402
from veles_tpu.ops import pooling as jpool  # noqa: E402
from veles_tpu.ops import reduce as jreduce  # noqa: E402
from veles_tpu.runtime.decision import Decision as JaxDecision  # noqa: E402
from veles_tpu.runtime.snapshotter import Snapshotter as JaxSnapshotter  # noqa: E402,E501
from veles_tpu.runtime.snapshotter import _to_numpy as jax_host  # noqa: E402
from veles_tpu.runtime.trainer import (  # noqa: E402
    aggregate_epoch_metrics as jax_aggregate)
from veles_tpu.units import nn as jnn  # noqa: E402
from veles_tpu.units.base import Context as JaxContext  # noqa: E402
from veles_tpu_torch import normalization as pnorm  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.__main__ import LOADERS, PENDING_LOADERS  # noqa: E402
from veles_tpu_torch.loader.base import TRAIN, VALID  # noqa: E402
from veles_tpu_torch.models import cifar, mnist, stl, synth_data  # noqa: E402
from veles_tpu_torch.models.autoencoder import (  # noqa: E402
    MNIST_AE_CONFIG, mnist_autoencoder_workflow)
from veles_tpu_torch.models.standard import (LAYER_TYPES,  # noqa: E402
                                             PENDING_TYPES,
                                             StandardWorkflow)
from veles_tpu_torch.ops import convolution as pconv  # noqa: E402
from veles_tpu_torch.ops import pooling as ppool  # noqa: E402
from veles_tpu_torch.ops.reduce import matrix_reduce  # noqa: E402
from veles_tpu_torch.runtime.decision import Decision  # noqa: E402
from veles_tpu_torch.runtime.snapshotter import (  # noqa: E402
    Snapshotter, wstate_from_jax)
from veles_tpu_torch.runtime.trainer import aggregate_epoch_metrics  # noqa: E402,E501
from veles_tpu_torch.units import nn  # noqa: E402
from veles_tpu_torch.units.base import Context, Spec  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
DECONV_TOL = dict(rtol=1e-5, atol=1e-6)
MSE_RTOL = 1e-6
EPOCH_LOSS_RTOL = 1e-4
EPOCH_GRAD_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _reset_prng():
    prng.streams.reset()
    vt.prng.streams.reset()
    yield
    prng.streams.reset()
    vt.prng.streams.reset()


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Each package's dataset cache in its own empty directory, and no
    local real dataset: both sides render the synthetic stand-ins."""
    monkeypatch.setattr(jsynth, "CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("VELES_TORCH_CACHE", str(tmp_path / "port"))
    for mod in (jmnist, jcifar, jstl, mnist, cifar, stl):
        monkeypatch.setattr(mod, "DATA_DIRS", [])
    return tmp_path


def _t(a):
    return torch.from_numpy(np.array(a))


# -- normalizers ----------------------------------------------------------------

NORMALIZERS = {"none": {}, "linear": {}, "range_linear": {},
               "mean_disp": {}, "exp": {}, "pointwise": {},
               "external_mean": {"scale": 0.5}}


@pytest.mark.parametrize("name", sorted(NORMALIZERS))
def test_normalizers_match_jax_bitwise(name):
    """analyze (on train), normalize, denormalize, and the state through
    ``state()`` / ``set_state()`` of a fresh instance: bitwise the JAX
    package's numpy."""
    rng = np.random.default_rng(len(name))
    train = rng.integers(0, 256, (40, 6, 6)).astype(np.float32)
    other = rng.integers(0, 256, (10, 6, 6)).astype(np.float32)
    kw = dict(NORMALIZERS[name])
    if name == "external_mean":
        kw["mean"] = rng.uniform(100, 150, (6, 6)).astype(np.float32)
    assert sorted(pnorm.NormalizerRegistry.names()) == sorted(
        jnorm.NormalizerRegistry.names())
    jn = jnorm.NormalizerRegistry.create(name, **kw)
    pn = pnorm.NormalizerRegistry.create(name, **kw)
    jn.analyze(train)
    pn.analyze(train)
    for data in (train, other):
        jy, py = jn.normalize(data), pn.normalize(data)
        assert py.dtype == jy.dtype and py.tobytes() == jy.tobytes()
        assert pn.denormalize(py).tobytes() == jn.denormalize(jy).tobytes()
    st = pn.state()
    assert sorted(st) == sorted(jn.state())
    fresh = pnorm.NormalizerRegistry.create(name, **(
        {"mean": None} if name == "external_mean" else {}))
    fresh.set_state(st)
    assert fresh.normalize(other).tobytes() == jn.normalize(other).tobytes()


# -- synthetic datasets ----------------------------------------------------------

def test_synth_digits_and_shapes_match_jax_bitwise():
    for port, ref in ((synth_data.synth_digits(64, 16, cache=False),
                       jsynth.synth_digits(64, 16, cache=False)),
                      (synth_data.synth_shapes(64, 16, cache=False),
                       jsynth.synth_shapes(64, 16, cache=False)),
                      (synth_data.synth_shapes(6, 3, seed=5, cache=False,
                                               size=96),
                       jsynth.synth_shapes(6, 3, seed=5, cache=False,
                                           size=96))):
        for p, j in zip(port, ref):
            assert p.dtype == j.dtype and p.shape == j.shape
            assert p.tobytes() == j.tobytes()


def test_port_cache_is_its_own(caches):
    """The port writes its npz under its own directory, never the JAX
    package's, and a second call reads it back bitwise."""
    a = synth_data.synth_digits(20, 8)
    files = os.listdir(caches / "port" / "datasets")
    assert files == ["synthdigits_v3_20_8_20260729.npz"]
    assert not (caches / "jax").exists()
    b = synth_data.synth_digits(20, 8)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))


LOADER_CASES = {
    "mnist": (jmnist.MnistLoader, mnist.MnistLoader,
              dict(minibatch_size=16, n_train=48, n_valid=16)),
    "cifar": (jcifar.CifarLoader, cifar.CifarLoader,
              dict(minibatch_size=8, n_train=24, n_valid=8)),
    "stl": (jstl.StlLoader, stl.StlLoader,
            dict(minibatch_size=4, n_train=8, n_valid=4)),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_family_loaders_match_jax_bitwise(caches, case):
    """The normalized arrays each loader holds, its labels, its state
    (the normalizer's statistics) and its first train batch: bitwise the
    JAX loader's; the port's loader is card-resident (here ``device=
    "cpu"``) and gathers the batch in one call."""
    jcls, pcls, kw = LOADER_CASES[case]
    jl, pl = jcls(**kw), pcls(device="cpu", **kw)
    assert pl.synthetic and jl.synthetic
    jl.initialize()
    pl.initialize()
    assert pl.on_device and pl.class_lengths == jl.class_lengths
    for klass in (TRAIN, VALID):
        for mine, ref in ((pl._data, jl._data), (pl._labels, jl._labels)):
            assert mine[klass].dtype == ref[klass].dtype
            assert mine[klass].tobytes() == ref[klass].tobytes()
    assert json.dumps(pl.state(), sort_keys=True) == json.dumps(
        jl.state(), sort_keys=True)
    jb = next(jl.iter_epoch(TRAIN, 0))
    pb = next(pl.iter_epoch(TRAIN, 0))
    for k in jb:
        assert np.asarray(pb[k]).tobytes() == np.asarray(jb[k]).tobytes(), k


# -- ops and units ------------------------------------------------------------------

def _ints(rng, shape):
    """Small integer-valued float32 data: every sum is exact."""
    return rng.integers(-8, 9, shape).astype(np.float32)


@pytest.mark.parametrize("op", ["sum", "max", "min", "mean"])
@pytest.mark.parametrize("axis", [0, 1])
def test_matrix_reduce_exact(op, axis):
    x = _ints(np.random.default_rng(0), (16, 24))
    got = matrix_reduce(_t(x), axis=axis, op=op).numpy()
    ref = np.asarray(jreduce.matrix_reduce(jnp.asarray(x), axis=axis, op=op))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("window,stride,hw", [(2, None, 8), (2, None, 7),
                                              (3, 2, 9)],
                         ids=["2x2", "odd_size", "3s2"])
def test_unpooling_ops_exact(window, stride, hw):
    x = np.random.default_rng(1).standard_normal((2, hw, hw, 3)).astype(
        np.float32)
    jp, jsw = jpool.max_pool_with_argmax(jnp.asarray(x), window, stride)
    pp, psw = ppool.max_pool_with_argmax(_t(x), window, stride)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(psw.numpy(), np.asarray(jsw))
    if stride is None:
        np.testing.assert_array_equal(
            ppool.max_unpool(pp, psw, window).numpy(),
            np.asarray(jpool.max_unpool(jp, jsw, window)))
    np.testing.assert_array_equal(
        ppool.avg_unpool(pp, window, out_hw=(hw, hw)).numpy(),
        np.asarray(jpool.avg_unpool(jp, window, out_hw=(hw, hw))))


def _unit_pair(jcls, pcls, spec_shape, **kw):
    ju, pu = jcls(name="u", **kw), pcls(name="u", **kw)
    js = ju.output_spec([vt.Spec(spec_shape, jnp.float32)])
    ps = pu.output_spec([Spec(spec_shape, torch.float32)])
    assert ps.shape == tuple(js.shape)
    return ju, pu


@pytest.mark.parametrize("unit,kw,shape", [
    ("Flatten", {}, (3, 4, 5, 2)),
    ("Reshape", {"shape": (28, 28, 1)}, (3, 784)),
    ("Depool", {"window": 2}, (2, 5, 5, 3)),
    ("Depool", {"window": (2, 3)}, (2, 4, 3, 2)),
    ("StochasticAbsPooling", {"window": 2}, (2, 8, 8, 3)),
    ("StochasticAbsPooling", {"window": 3, "stride": 2}, (2, 9, 9, 2))],
    ids=["flatten", "reshape", "depool", "depool_2x3", "sap", "sap_3s2"])
def test_shape_and_pooling_units_exact(unit, kw, shape):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    ju, pu = _unit_pair(getattr(jnn, unit), getattr(nn, unit), shape, **kw)
    jy, _ = ju.apply({}, {}, [jnp.asarray(x)], JaxContext())
    py, _ = pu.apply({}, {}, [_t(x)], Context())
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))


def test_reshape_refuses_another_size():
    with pytest.raises(ValueError, match="cannot reshape"):
        nn.Reshape((5, 5), name="r").output_spec([Spec((2, 24),
                                                       torch.float32)])


DECONV_CASES = [(1, "SAME", 3), (2, "SAME", 3), (2, "VALID", 3),
                (2, 1, 5), (1, "VALID", 5), (2, "SAME", 4), (3, 0, 3)]


@pytest.mark.parametrize("stride,padding,k", DECONV_CASES,
                         ids=[f"s{s}_{p}_k{k}" for s, p, k in DECONV_CASES])
def test_deconv2d_matches_jax_forward_and_gradient(stride, padding, k):
    """``jax.lax.conv_transpose`` without a kernel flip and with JAX's
    transpose padding, held at strides 1-3, SAME / VALID / an integer
    padding, odd and even kernels: forward, and the gradients of input
    and weights."""
    rng = np.random.default_rng(k + stride)
    x = rng.standard_normal((2, 6, 5, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)

    def jf(x_, w_):
        return jconv.deconv2d(x_, w_, b, stride=stride, padding=padding,
                              precision=jax.lax.Precision.HIGHEST)

    jy, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    g = rng.standard_normal(jy.shape).astype(np.float32)
    jgx, jgw = vjp(jnp.asarray(g))
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    ty = pconv.deconv2d(tx, tw, _t(b), stride=stride, padding=padding)
    gx, gw = torch.autograd.grad(ty, (tx, tw), _t(g))
    assert tuple(ty.shape) == tuple(jy.shape)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               **DECONV_TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **DECONV_TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), **DECONV_TOL)


def test_deconv_unit_matches_jax():
    """The Deconv unit with the JAX unit's initial weights: spec, output
    and weight gradient."""
    rng = np.random.default_rng(5)
    shape = (2, 7, 7, 4)
    kw = dict(n_kernels=3, kx=3, stride=2, padding="SAME",
              activation="tanh")
    ju, pu = _unit_pair(jnn.Deconv, nn.Deconv, shape, **kw)
    jp, _ = ju.init(jax.random.key(1), [vt.Spec(shape, jnp.float32)])
    x = rng.standard_normal(shape).astype(np.float32)

    def jloss(params):
        y, _ = ju.apply(params, {}, [jnp.asarray(x)], JaxContext())
        return jnp.sum(y * y), y

    (jl, jy), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    pp = {k: _t(np.asarray(v)).requires_grad_(True) for k, v in jp.items()}
    py, _ = pu.apply(pp, {}, [_t(x)], Context())
    pg = torch.autograd.grad((py * py).sum(), [pp["w"], pp["b"]])
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy),
                               **DECONV_TOL)
    for got, k in zip(pg, ("w", "b")):
        np.testing.assert_allclose(got.numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_evaluator_mse_loss_and_rmse_match_jax(masked):
    rng = np.random.default_rng(6)
    out = rng.standard_normal((10, 12)).astype(np.float32)
    tgt = rng.standard_normal((10, 12)).astype(np.float32)
    mask = (rng.random(10) < 0.7).astype(np.float32) if masked \
        else np.ones(10, np.float32)
    je = jnn.EvaluatorMSE(name="ev")
    pe = nn.EvaluatorMSE(name="ev")
    jm = je.metrics({}, {}, [jnp.asarray(out), jnp.asarray(tgt),
                             jnp.asarray(mask)], JaxContext())
    pm = pe.metrics({}, {}, [_t(out), _t(tgt), _t(mask)], Context())
    assert sorted(pm) == sorted(jm) == ["loss", "mse_sum", "n_samples"]
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                   rtol=MSE_RTOL, err_msg=k)
    sums = {k: float(v) for k, v in pm.items()}
    np.testing.assert_allclose(
        aggregate_epoch_metrics(sums)["rmse"],
        jax_aggregate({k: float(v) for k, v in jm.items()})["rmse"],
        rtol=MSE_RTOL)
    assert aggregate_epoch_metrics(sums)["rmse"] == pytest.approx(
        np.sqrt(sums["mse_sum"] / sums["n_samples"]))


def test_layer_types_and_losses():
    for ltype in ("deconv", "depool", "stochastic_abs_pooling", "flatten",
                  "reshape"):
        assert ltype in LAYER_TYPES and ltype not in PENDING_TYPES
    assert PENDING_TYPES == {}
    for ltype in ("moe", "pipeline_stack"):
        assert ltype in LAYER_TYPES
    for ltype in ("rnn", "gru", "lstm"):
        assert ltype in LAYER_TYPES
    assert PENDING_LOADERS == {}
    assert sorted(LOADERS) == ["cifar", "imagenet_synthetic", "induction",
                               "mnist", "stl"]
    ae = StandardWorkflow(MNIST_AE_CONFIG).workflow
    assert isinstance(ae.evaluator, nn.EvaluatorMSE)
    assert ae.evaluator.inputs == ("dec", "@input", "@mask")
    reg = StandardWorkflow({**MNIST_AE_CONFIG, "loss": "mse"}).workflow
    assert reg.evaluator.inputs == ("dec", "@targets", "@mask")


# -- three train steps against the JAX Trainer ----------------------------------

def _conv_layers():
    """configs/synthdigits_conv.json narrowed (8 and 16 kernels, fc 32);
    the dropout through the JAX package's kernel on both sides."""
    with open(os.path.join(REPO, "configs", "synthdigits_conv.json")) as f:
        layers = json.load(f)["workflow"]["layers"]
    widths = {"conv1": 8, "conv2": 16}
    out = []
    for layer in layers:
        layer = dict(layer)
        if layer["name"] in widths:
            layer["n_kernels"] = widths[layer["name"]]
        if layer["name"] == "fc3":
            layer["output_size"] = 32
        if layer["type"] == "dropout":
            layer["use_pallas"] = True
        out.append(layer)
    return out


CONV_AE_LAYERS = [
    {"type": "reshape", "shape": [28, 28, 1], "name": "img"},
    {"type": "conv_relu", "n_kernels": 8, "kx": 3, "padding": 1,
     "name": "enc_conv"},
    {"type": "max_pooling", "window": 2, "stride": 2, "name": "enc_pool"},
    {"type": "depool", "window": 2, "name": "dec_depool"},
    {"type": "deconv", "n_kernels": 1, "kx": 3, "padding": "SAME",
     "name": "dec_deconv"},
    {"type": "flatten", "name": "flat"},
]

TRAINER_CASES = {
    "synthdigits_conv": dict(layers=_conv_layers(), loss="softmax",
                             optimizer="momentum",
                             optimizer_args={"lr": 0.02, "momentum": 0.9,
                                             "l2": 1e-4}),
    "conv_autoencoder": dict(layers=CONV_AE_LAYERS, loss="mse_input",
                             optimizer="adadelta",
                             optimizer_args={"lr": 1.0}),
}


@pytest.mark.parametrize("case", sorted(TRAINER_CASES))
def test_three_train_steps_match_the_jax_trainer(caches, case):
    """One epoch of 3 train steps (minibatch 20 of 60 SynthDigits) and
    its eval through both packages' Trainers over the mnist loader, from
    the JAX trainer's initial state: every epoch sum and gauge within
    its bound, the error counts equal."""
    cfg = {"name": case, **TRAINER_CASES[case], "max_epochs": 1}
    loader_kw = dict(minibatch_size=20, n_train=60, n_valid=20)
    jtr = JaxStandard(cfg).make_trainer(jmnist.MnistLoader(**loader_kw),
                                        JaxDecision(max_epochs=1))
    jtr.initialize(seed=3)
    psw = StandardWorkflow(cfg)
    ptr = psw.make_trainer(mnist.MnistLoader(device="cpu", **loader_kw),
                           Decision(max_epochs=1), device="cpu")
    ptr.initialize(seed=0)
    ptr.wstate = wstate_from_jax(jax_host(jtr.wstate), psw.workflow,
                                 optimizer=psw.optimizer, device="cpu")
    jtr.run()
    ptr.run()
    (je,), (pe,) = jtr.decision.history, ptr.decision.history
    assert pe["metric"] == je["metric"] == (
        "rmse" if case == "conv_autoencoder" else "error_pct")
    assert pe["train"]["n_batches"] == je["train"]["n_batches"] == 3
    for split in ("train", "valid"):
        for k in ("n_samples", "n_err"):
            if k in je[split]:
                assert pe[split][k] == je[split][k], (split, k)
        for k in ("loss", "rmse", "mse_sum"):
            if k in je[split]:
                np.testing.assert_allclose(pe[split][k], je[split][k],
                                           rtol=EPOCH_LOSS_RTOL,
                                           err_msg=f"{split}/{k}")
    np.testing.assert_allclose(pe["train"]["grad_norm"],
                               je["train"]["grad_norm"],
                               rtol=EPOCH_GRAD_RTOL)
    assert ptr.wstate["step"] == int(jtr.wstate["step"]) == 3


def test_normalizer_state_crosses_snapshots_both_ways(caches, tmp_path):
    """A port snapshot's loader state (the cifar loader's mean/disp
    statistics) restores into the JAX loader, and the JAX loader's
    snapshot back into a fresh port loader, under the same keys and
    bitwise; a JAX-side ``range_linear`` state too."""
    kw = dict(minibatch_size=8, n_train=16, n_valid=8)
    pl = cifar.CifarLoader(device="cpu", **kw)
    pl.initialize()
    payload = {"wstate": {"params": {"u": {"w": np.ones(2, np.float32)}},
                          "step": 0}, "loader": pl.state()}
    path = Snapshotter("p", str(tmp_path / "port")).save("e0", payload)
    jl = jcifar.CifarLoader(**kw)
    jl.set_state(JaxSnapshotter.load(path)["loader"])
    for k in ("mean", "disp"):
        assert jl.normalizer.__dict__[k].tobytes() == \
            pl.normalizer.__dict__[k].tobytes(), k
    mkw = dict(minibatch_size=8, n_train=16, n_valid=8)
    data = np.random.default_rng(7).integers(0, 256, (4, 32, 32, 3)).astype(
        np.float32)
    for jcls, pcls, src_kw in ((jcifar.CifarLoader, cifar.CifarLoader, kw),
                               (jmnist.MnistLoader, mnist.MnistLoader, mkw)):
        src = jl if jcls is jcifar.CifarLoader else jcls(**src_kw)
        jpath = JaxSnapshotter("j", str(tmp_path / "jax")).save(
            "e0", {"wstate": payload["wstate"], "loader": src.state()})
        dst = pcls(device="cpu", **src_kw)
        dst.set_state(Snapshotter.load(jpath)["loader"])
        ref = jcls(**src_kw)            # the JAX loader restored alike
        ref.set_state(JaxSnapshotter.load(jpath)["loader"])
        assert type(dst.normalizer).MAPPING == type(src.normalizer).MAPPING
        assert json.dumps(dst.state(), sort_keys=True) == json.dumps(
            ref.state(), sort_keys=True)
        x = data if jcls is jcifar.CifarLoader else data[..., 0].reshape(
            4, -1)
        assert dst.normalizer.normalize(x).tobytes() == \
            src.normalizer.normalize(x).tobytes()


def test_autoencoder_factory_trains_an_epoch(caches):
    sw = mnist_autoencoder_workflow(
        minibatch_size=20, loader_args=dict(n_train=40, n_valid=20,
                                            device="cpu"))
    tr = sw.make_trainer(sw.loader, Decision(max_epochs=1), device="cpu")
    tr.initialize(seed=0)
    tr.run()
    (ep,) = tr.decision.history
    assert ep["metric"] == "rmse" and np.isfinite(ep["value"])
    assert ep["valid"]["rmse"] == ep["value"]


# -- every configs/synth*.json through the CLI ------------------------------------

SYNTH_CONFIGS = sorted(f for f in os.listdir(os.path.join(REPO, "configs"))
                       if f.startswith("synth") and f.endswith(".json"))


@pytest.mark.parametrize("config", SYNTH_CONFIGS)
def test_cli_builds_and_steps_each_synth_config(tmp_path, config):
    """``python -m veles_tpu_torch CONFIG --device cpu`` with a small
    ``n_train``: the run ends, one epoch, a finite gauge, the JAX
    workflow's checksum."""
    with open(os.path.join(REPO, "configs", config)) as f:
        wcfg = json.load(f)["workflow"]
    cmd = [sys.executable, "-m", "veles_tpu_torch",
           os.path.join("configs", config), "root.loader.n_train=40",
           "root.loader.n_valid=20", "--max-epochs", "1",
           "--device", "cpu"]
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "VELES_TORCH_CACHE": str(tmp_path), "VELES_DATA_DIR": ""}
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["workflow"] == wcfg["name"] and res["epochs"] == 1
    assert np.isfinite(res["best_value"])
    assert res["checksum"] == JaxStandard(wcfg).workflow.checksum()
