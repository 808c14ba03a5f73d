"""The image slice of the port on the CPU against the JAX package: the ops
(``conv2d``, ``max_pool``/``avg_pool``, LRN), the image units, a small
AlexNet-shaped workflow trained three steps in both packages, the
``FullBatchAugmentedLoader``, snapshots carrying the normalizer's unit
state, and the layer types still to come.

Bounds (float32 unless said): ``conv2d`` rtol 1e-5 / atol 1e-5, its
gradients rtol 1e-4 / atol 1e-5 (sums over more terms, in other orders);
``conv2d`` under the bf16 policy within 2 bf16 units (2^-7) of the
largest |output| (the two frameworks' bf16 convolutions round at other
points); ``max_pool`` bitwise, its gradient bitwise; ``avg_pool`` rtol
1e-6, gradient rtol 1e-6; LRN (all three methods) rtol 1e-5 / atol
1e-6, gradients rtol 1e-4 / atol 1e-6 (``band_bf16``'s within 2^-8 of
the largest |gradient|: its window-sum cotangent passes a bf16 rounding,
placed before or after the band product by the two frameworks); the
workflow: keys equal after every step, dropout zero patterns identical,
loss rtol 1e-5, parameters after three steps rtol 1e-4 / atol 1e-6, eval
and predict outputs rtol 1e-5; loader batches bitwise."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import veles_tpu as vt  # noqa: E402
from veles_tpu import prng as jprng  # noqa: E402
from veles_tpu.loader.fullbatch import (  # noqa: E402
    FullBatchAugmentedLoader as JaxAugLoader)
from veles_tpu.models.standard import StandardWorkflow as JaxStandard  # noqa: E402,E501
from veles_tpu.ops import convolution as jconv  # noqa: E402
from veles_tpu.ops import lrn as jlrn  # noqa: E402
from veles_tpu.ops import pooling as jpool  # noqa: E402
from veles_tpu.runtime.decision import Decision as JaxDecision  # noqa: E402
from veles_tpu.runtime.snapshotter import Snapshotter as JaxSnapshotter  # noqa: E402,E501
from veles_tpu.runtime.snapshotter import _to_numpy as jax_host  # noqa: E402
from veles_tpu.units.base import Context as JaxContext  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.loader.base import TRAIN, VALID  # noqa: E402
from veles_tpu_torch.loader.fullbatch import FullBatchAugmentedLoader  # noqa: E402,E501
from veles_tpu_torch.models import alexnet  # noqa: E402
from veles_tpu_torch.models.standard import StandardWorkflow  # noqa: E402
from veles_tpu_torch.ops import convolution, lrn, pooling  # noqa: E402
from veles_tpu_torch.runtime.decision import Decision  # noqa: E402
from veles_tpu_torch.runtime.snapshotter import (  # noqa: E402
    Snapshotter, wstate_from_jax, wstate_from_snapshot, wstate_to_numpy)
from veles_tpu_torch.runtime.snapshotter import _flatten  # noqa: E402
from veles_tpu_torch.units.base import Context, Spec  # noqa: E402
from _torch_helpers import port_autotune_off  # noqa: E402,F401

torch.set_num_threads(2)

CONV_TOL = dict(rtol=1e-5, atol=1e-5)
CONV_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LRN_TOL = dict(rtol=1e-5, atol=1e-6)
LRN_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-5
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
OUT_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_port_prng():
    prng.streams.reset()
    yield
    prng.streams.reset()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().numpy()


# -- ops ----------------------------------------------------------------------

CONV_CASES = {
    "same_s1_k3": ((2, 9, 9, 3), (3, 3, 3, 4), 1, "SAME"),
    "same_s2_k3_asym": ((2, 8, 8, 3), (3, 3, 3, 4), 2, "SAME"),
    "same_s4_k11_asym": ((1, 22, 22, 3), (11, 11, 3, 5), 4, "SAME"),
    "valid_s4_k11": ((2, 27, 27, 3), (11, 11, 3, 6), 4, "VALID"),
    "valid_s2_k5": ((2, 19, 19, 3), (5, 5, 3, 8), 2, "VALID"),
    "int_pad2_k5": ((2, 7, 7, 4), (5, 5, 4, 6), 1, 2),
    "int_pad1_s2": ((2, 9, 9, 4), (3, 3, 4, 5), 2, 1),
    "explicit_pad_k5x3": ((2, 8, 9, 3), (5, 3, 3, 4), (1, 2),
                          ((1, 2), (0, 1))),
}


def _conv_pair(case, rng):
    xs, ws, stride, padding = CONV_CASES[case]
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) / np.sqrt(np.prod(ws[:3]))).astype(
        np.float32)
    b = rng.standard_normal(ws[-1]).astype(np.float32)
    return x, w, b, stride, padding


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_matches_jax_f32_with_gradients(case):
    rng = np.random.default_rng(len(case))
    x, w, b, stride, padding = _conv_pair(case, rng)

    def jf(x_, w_, b_):
        return jconv.conv2d(x_, w_, b_, stride=stride, padding=padding)

    jy, vjp = jax.vjp(jf, x, w, b)
    g = rng.standard_normal(jy.shape).astype(np.float32)
    jgrads = vjp(g)
    tx, tw, tb = (_t(a).requires_grad_(True) for a in (x, w, b))
    ty = convolution.conv2d(tx, tw, tb, stride=stride, padding=padding)
    assert tuple(ty.shape) == jy.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **CONV_TOL)
    tgrads = torch.autograd.grad(ty, (tx, tw, tb), _t(g))
    for name, tg, jg in zip("xwb", tgrads, jgrads):
        np.testing.assert_allclose(_np(tg), np.asarray(jg), err_msg=name,
                                   **CONV_GRAD_TOL)


@pytest.mark.parametrize("case", ["valid_s4_k11", "int_pad2_k5",
                                  "same_s2_k3_asym"])
def test_conv2d_bf16_policy_matches_jax(case):
    rng = np.random.default_rng(len(case))
    x, w, b, stride, padding = _conv_pair(case, rng)
    jy = np.asarray(jconv.conv2d(x, w, b, stride=stride, padding=padding,
                                 compute_dtype=jnp.bfloat16))
    ty = convolution.conv2d(_t(x), _t(w), _t(b), stride=stride,
                            padding=padding, compute_dtype=torch.bfloat16)
    assert ty.dtype == torch.float32 and jy.dtype == np.float32
    bound = 2.0 ** -7 * float(np.abs(jy).max())
    np.testing.assert_allclose(_np(ty), jy, rtol=0, atol=bound)


@pytest.mark.parametrize("window,stride,shape", [
    (3, 2, (2, 9, 9, 4)), (2, None, (2, 8, 6, 3)), ((3, 2), (1, 2),
                                                     (1, 7, 7, 2))])
def test_pools_match_jax_with_gradients(window, stride, shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    x = np.maximum(x, 0)           # ReLU'd input: ties at 0 in the windows
    for jfn, pfn, exact in ((jpool.max_pool, pooling.max_pool, True),
                            (jpool.avg_pool, pooling.avg_pool, False)):
        jy, vjp = jax.vjp(lambda a: jfn(a, window, stride), x)
        g = rng.standard_normal(jy.shape).astype(np.float32)
        (jg,) = vjp(g)
        tx = _t(x).requires_grad_(True)
        ty = pfn(tx, window, stride)
        (tg,) = torch.autograd.grad(ty, tx, _t(g))
        assert tuple(ty.shape) == jy.shape
        if exact:
            np.testing.assert_array_equal(_np(ty), np.asarray(jy))
            np.testing.assert_array_equal(_np(tg), np.asarray(jg))
        else:
            np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-6)
            np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=1e-6)
    with pytest.raises(NotImplementedError, match="VALID"):
        pooling.max_pool(_t(x), 2, padding="SAME")


@pytest.mark.parametrize("method", ["cumsum", "band", "band_bf16"])
@pytest.mark.parametrize("n,beta", [(5, 0.75), (4, 0.75), (3, 0.5),
                                    (5, 1.0), (5, 0.6)])
def test_lrn_matches_jax_with_gradients(method, n, beta):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((2, 5, 5, 24)) * 8).astype(np.float32)
    kw = dict(n=n, k=2.0, alpha=1e-2, beta=beta, method=method)
    jy, vjp = jax.vjp(lambda a: jlrn.local_response_norm(a, **kw), x)
    g = rng.standard_normal(jy.shape).astype(np.float32)
    (jg,) = vjp(g)
    tx = _t(x).requires_grad_(True)
    ty = lrn.local_response_norm(tx, **kw)
    (tg,) = torch.autograd.grad(ty, tx, _t(g))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **LRN_TOL)
    if method == "band_bf16":
        # the window sum's cotangent passes a bf16 rounding, which the two
        # frameworks place before or after the band product
        bound = 2.0 ** -8 * float(np.abs(np.asarray(jg)).max())
        np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=0,
                                   atol=bound)
    else:
        np.testing.assert_allclose(_np(tg), np.asarray(jg), **LRN_GRAD_TOL)


def test_lrn_wide_channels_window_sum_matches_jax():
    """Above 2048 channels the band forms take the windowed sum."""
    x = np.random.default_rng(1).standard_normal((1, 1, 2, 2100)).astype(
        np.float32)
    jy = jlrn.local_response_norm(x, method="band")
    ty = lrn.local_response_norm(_t(x), method="band")
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **LRN_TOL)
    with pytest.raises(ValueError, match="method"):
        lrn.local_response_norm(_t(x), method="nope")


# -- units, the small workflow ------------------------------------------------

HW, B, CLASSES = 19, 8, 10


def small_layers(rng):
    """An AlexNet-shaped workflow at 19 x 19 x 3 uint8: norm -> conv_relu
    k5 s2 VALID x8 -> lrn -> max_pool 3/2 -> conv_relu k3 p1 x16 -> lrn
    -> max_pool 3/2 -> all2all_relu 32 -> dropout 0.5 -> all2all_relu 32
    -> dropout 0.5 -> softmax 10."""
    return [
        {"type": "norm", "name": "norm0",
         "mean": rng.uniform(100, 150, (HW, HW, 3)).astype(np.float32),
         "rdisp": rng.uniform(0.01, 0.02, (HW, HW, 3)).astype(np.float32)},
        {"type": "conv_relu", "n_kernels": 8, "kx": 5, "stride": 2,
         "padding": "VALID", "name": "conv1"},
        {"type": "lrn", "name": "lrn1", "method": "cumsum"},
        {"type": "max_pooling", "window": 3, "stride": 2, "name": "pool1"},
        {"type": "conv_relu", "n_kernels": 16, "kx": 3, "padding": 1,
         "name": "conv2"},
        {"type": "lrn", "name": "lrn2", "method": "cumsum"},
        {"type": "max_pooling", "window": 3, "stride": 2, "name": "pool2"},
        {"type": "all2all_relu", "output_size": 32, "name": "fc6"},
        {"type": "dropout", "dropout_ratio": 0.5, "name": "drop6",
         "use_pallas": True},
        {"type": "all2all_relu", "output_size": 32, "name": "fc7"},
        {"type": "dropout", "dropout_ratio": 0.5, "name": "drop7",
         "use_pallas": True},
        {"type": "softmax", "output_size": CLASSES, "name": "fc8"},
    ]


def small_config(rng, **over):
    return {"name": "SmallAlex", "layers": small_layers(rng),
            "optimizer": "momentum",
            "optimizer_args": {"lr": 0.01, "momentum": 0.9, "l2": 5e-4},
            **over}


def _specs(hw=HW, n=B):
    return ({"@input": vt.Spec((n, hw, hw, 3), jnp.uint8),
             "@labels": vt.Spec((n,), jnp.int32),
             "@mask": vt.Spec((n,), jnp.float32)},
            {"@input": Spec((n, hw, hw, 3), torch.uint8),
             "@labels": Spec((n,), torch.int32),
             "@mask": Spec((n,), torch.float32)})


def small_pair(seed=0, key=5):
    """(jax StandardWorkflow, its wstate, port StandardWorkflow, its
    wstate): the JAX package initializes, ``wstate_from_jax`` carries
    params, unit state and key across; both optimizers start fresh."""
    cfg = small_config(np.random.default_rng(seed))
    jsw, psw = JaxStandard(cfg), StandardWorkflow(cfg)
    jspec, pspec = _specs()
    jsw.workflow.build(jspec)
    psw.workflow.build(pspec)
    jws = jsw.workflow.init_state(jax.random.key(key), jsw.optimizer)
    pws = wstate_from_jax(jax_host(jws), psw.workflow,
                          optimizer=psw.optimizer, device="cpu")
    return jsw, jws, psw, pws


def _batch(rng, n=B, hw=HW):
    mask = np.ones(n, np.float32)
    mask[-1] = 0.0
    return {"@input": rng.integers(0, 256, (n, hw, hw, 3)).astype(np.uint8),
            "@labels": rng.integers(0, CLASSES, n).astype(np.int32),
            "@mask": mask}


def test_unit_specs_and_param_shapes_match_jax():
    jsw, jws, psw, pws = small_pair()
    jwf, pwf = jsw.workflow, psw.workflow
    for name, js in jwf._specs.items():
        if name.startswith("@"):
            continue
        ps = pwf.specs[name]
        assert ps.shape == tuple(js.shape), name
        assert str(ps.dtype).split(".")[-1] == str(js.dtype), name
    jp = jax_host(jws["params"])
    assert pwf.param_shapes() == {u: {k: v.shape for k, v in p.items()}
                                  for u, p in jp.items()}
    assert pwf.state_shapes() == {"norm0": {"mean": (HW, HW, 3),
                                            "rdisp": (HW, HW, 3)}}
    assert pwf.checksum() == jwf.checksum()


def test_alexnet_specs_at_full_width():
    """The port's AlexNet e2e config at 227 x 227: the classic shapes
    (conv1 55x55x96, pool5 6x6x256, fc6 fan-in 9216), built on the meta
    device (nothing allocated)."""
    sw = StandardWorkflow(alexnet._e2e_config())
    _, pspec = _specs(alexnet.INPUT_HW, 4)
    specs = sw.workflow.build(pspec)
    assert specs["norm0"].shape == (4, 227, 227, 3)
    assert specs["norm0"].dtype == torch.float32
    assert specs["conv1"].shape == (4, 55, 55, 96)
    assert specs["pool1"].shape == (4, 27, 27, 96)
    assert specs["conv2"].shape == (4, 27, 27, 256)
    assert specs["pool2"].shape == (4, 13, 13, 256)
    assert specs["pool5"].shape == (4, 6, 6, 256)
    assert specs["fc8"].shape == (4, 1000)
    shapes = sw.workflow.param_shapes()
    assert shapes["fc6"]["w"] == (9216, 4096)
    assert shapes["conv1"]["w"] == (11, 11, 3, 96)
    lrn_units = [u for u in sw.workflow.units if u.name.startswith("lrn")]
    assert [u.method for u in lrn_units] == ["cumsum", "cumsum"]
    assert [u.name for u in sw.workflow.units][-2:] == ["fc8", "evaluator"]


def test_small_workflow_three_steps_match_jax():
    """Same weights, unit state and key; three momentum steps: keys equal
    after every step, the dropout units' zero patterns identical, loss
    rtol 1e-5, parameters and momentum slots rtol 1e-4 / atol 1e-6, then
    eval metrics and predict outputs rtol 1e-5."""
    rng = np.random.default_rng(3)
    jsw, jws, psw, pws = small_pair()
    jwf, pwf = jsw.workflow, psw.workflow
    for name in ("mean", "rdisp"):
        assert _np(pws["state"]["norm0"][name]).tobytes() == np.asarray(
            jws["state"]["norm0"][name]).tobytes()
    jstep = jwf.make_train_step(jsw.optimizer, donate=False)
    pstep = pwf.make_train_step(psw.optimizer)
    for i in range(3):
        b = _batch(rng)
        pb = {k: _t(v) for k, v in b.items()}
        # the step's forward as the step draws it: sub of split(key)
        jsub = jax.random.split(jws["key"])[1]
        jout, _ = jwf.forward(jws["params"], jws["state"], b,
                              JaxContext(train=True, key=jsub))
        pout, _ = pwf.forward(pws["params"], pws["state"], pb,
                              Context(train=True, key=tuple(
                                  int(v) for v in jax.random.key_data(jsub))))
        for name in ("drop6", "drop7"):
            jd, pd = np.asarray(jout[name]), _np(pout[name])
            np.testing.assert_array_equal(pd == 0, jd == 0, err_msg=name)
            assert 0 < (jd == 0).mean() < 1, name
            np.testing.assert_allclose(pd, jd, rtol=1e-4, atol=1e-6,
                                       err_msg=name)
        jws, jm = jstep(jws, b)
        pws, pm = pstep(pws, pb)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        assert float(pm["n_err"]) == float(jm["n_err"])
        assert tuple(int(v) for v in pws["key"]) == tuple(
            int(v) for v in jax.random.key_data(jws["key"])), i
    assert pws["step"] == int(jws["step"]) == 3
    jh = jax_host(jws)
    for part in ("params", "opt_state", "state"):
        pf = _flatten(wstate_to_numpy(pws)[part])
        jf = _flatten(jh[part])
        assert sorted(pf) == sorted(jf), part
        for key in jf:
            np.testing.assert_allclose(pf[key], jf[key], err_msg=key,
                                       **STATE_TOL)
    b = _batch(rng)
    pb = {k: _t(v) for k, v in b.items()}
    jm = jwf.make_eval_step()(jws, b)
    pm = pwf.make_eval_step()(pws, pb)
    for k in ("loss", "n_err", "n_samples"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                   rtol=OUT_RTOL, err_msg=k)
    for unit in ("fc8", "drop7"):
        jy = np.asarray(jwf.make_predict_step(unit)(jws, b))
        py = _np(pwf.make_predict_step(unit)(pws, pb))
        np.testing.assert_allclose(py, jy, rtol=OUT_RTOL, atol=1e-6)


def test_dropout_unit_rules():
    from veles_tpu_torch.units import nn
    with pytest.raises(NotImplementedError, match="Bernoulli"):
        nn.Dropout(0.5, name="d", use_pallas=False)
    d = nn.Dropout(0.5, name="d")
    x = torch.ones(4, 6)
    assert d.apply({}, {}, [x], Context(train=False))[0] is x
    assert nn.Dropout(0.0, name="d").apply(
        {}, {}, [x], Context(train=True, key=(1, 2)))[0] is x
    with pytest.raises(ValueError, match="step key"):
        d.apply({}, {}, [x], Context(train=True))
    y, _ = d.apply({}, {}, [x], Context(train=True, key=(1, 2)))
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}


def test_deferred_layer_types_name_their_slice():
    """The image family's five layer types build now; the types still
    pending name the slice that brings them."""
    from veles_tpu_torch.models.standard import build_workflow
    for ltype, kw in (("deconv", {"n_kernels": 4}), ("depool", {}),
                      ("stochastic_abs_pooling", {}), ("flatten", {}),
                      ("reshape", {"shape": (4,)})):
        wf = build_workflow("x", [{"type": ltype, **kw}])
        assert type(wf.units[0]).__name__.lower().replace("_", "") == \
            ltype.replace("_", "")
    # moe and pipeline_stack (ROADMAP slice 8) build now; a type still
    # pending would name its slice
    wf = build_workflow("x", [{"type": "moe", "n_experts": 2,
                               "d_hidden": 4},
                              {"type": "pipeline_stack", "n_stages": 2,
                               "d_hidden": 4}])
    assert [type(u).__name__ for u in wf.units[:2]] == ["MoEFFN",
                                                     "PipelineStack"]
    from veles_tpu_torch.models import standard
    standard.PENDING_TYPES["later"] = "item 99"
    try:
        with pytest.raises(NotImplementedError, match="item 99"):
            build_workflow("x", [{"type": "later"}])
    finally:
        del standard.PENDING_TYPES["later"]
    # the recurrent family (ROADMAP slice 7) builds now
    for ltype in ("rnn", "gru", "lstm"):
        wf = build_workflow("x", [{"type": ltype, "hidden": 4}])
        assert type(wf.units[0]).__name__.lower() == ltype


# -- trainer over the augmented loader ----------------------------------------

def _stores(seed, n_train, n_valid, hw):
    rng = np.random.default_rng(seed)
    store = rng.integers(0, 256, (n_train + n_valid, hw, hw, 3), np.uint8)
    labels = (np.arange(n_train + n_valid) % CLASSES).astype(np.int32)
    return ({TRAIN: store[n_valid:], VALID: store[:n_valid]},
            {TRAIN: labels[n_valid:], VALID: labels[:n_valid]})


def _seed_loader_streams(seed=77):
    jprng.seed("loader", seed)
    prng.seed("loader", seed)


def test_augmented_loader_batches_match_jax():
    """Crops, flips, labels and masks of two epochs (train) and the center
    crop (valid), bitwise; the port's host form equals its device form."""
    _seed_loader_streams()
    data, labels = _stores(1, 20, 7, 12)
    kw = dict(minibatch_size=6, crop_hw=(9, 9), mirror=True)
    jl = JaxAugLoader(data, labels, **kw)
    pl = FullBatchAugmentedLoader(data, labels, device="cpu", **kw)
    hl = FullBatchAugmentedLoader(data, labels, device="cpu",
                                  force_host=True, **kw)
    for ld in (jl, pl, hl):
        ld.initialize()
    assert jl.on_device and pl.on_device and not hl.on_device
    flips_seen = 0
    for klass, epochs in ((TRAIN, (0, 1)), (VALID, (0,))):
        for epoch in epochs:
            for jb, pb, hb in zip(jl.iter_epoch(klass, epoch),
                                  pl.iter_epoch(klass, epoch),
                                  hl.iter_epoch(klass, epoch), strict=True):
                jb = {k: np.asarray(v) for k, v in jb.items()}
                for other in (pb, hb):
                    other = {k: np.asarray(v) for k, v in other.items()}
                    assert sorted(other) == sorted(jb)
                    for key in jb:
                        assert other[key].dtype == jb[key].dtype, key
                        assert other[key].shape == jb[key].shape, key
                        assert other[key].tobytes() == jb[key].tobytes(), key
                assert jb["@input"].shape == (6, 9, 9, 3)
                flips_seen += int(klass == TRAIN)
    assert flips_seen == 8
    with pytest.raises(ValueError, match="crop_hw"):
        FullBatchAugmentedLoader(data, labels, minibatch_size=6,
                                 crop_hw=(13, 9), device="cpu").initialize()


def test_trainer_epoch_over_the_augmented_loader_matches_jax():
    """The slice as a whole at a small size: one epoch and its validation
    through both Trainers over FullBatchAugmentedLoader, from the same
    weights, unit state and key: epoch loss and grad norm rtol 1e-4,
    error counts exact, keys equal after the epoch."""
    _seed_loader_streams(5)
    cfg = small_config(np.random.default_rng(4))
    data, labels = _stores(2, 32, 16, 24)
    kw = dict(minibatch_size=B, crop_hw=(HW, HW), mirror=True)
    jsw, psw = JaxStandard(cfg), StandardWorkflow(cfg)
    jtr = jsw.make_trainer(JaxAugLoader(data, labels, **kw),
                           JaxDecision(max_epochs=1))
    ptr = psw.make_trainer(FullBatchAugmentedLoader(data, labels,
                                                    device="cpu", **kw),
                           Decision(max_epochs=1), device="cpu")
    jtr.initialize(seed=9)
    ptr.initialize(seed=0)
    ptr.wstate = wstate_from_jax(jax_host(jtr.wstate), psw.workflow,
                                 optimizer=psw.optimizer, device="cpu")
    jtr.run()
    ptr.run()
    (je,), (pe,) = jtr.decision.history, ptr.decision.history
    for split in ("train", "valid"):
        for k in ("n_err", "n_samples", "n_batches"):
            assert pe[split][k] == je[split][k], (split, k)
        keys = ("loss", "grad_norm") if split == "train" else ("loss",)
        for k in keys:
            np.testing.assert_allclose(pe[split][k], je[split][k],
                                       rtol=1e-4, err_msg=f"{split}/{k}")
    assert pe["train"]["n_batches"] == 4
    assert tuple(int(v) for v in ptr.wstate["key"]) == tuple(
        int(v) for v in jax.random.key_data(jtr.wstate["key"]))


# -- snapshots carry the unit state -------------------------------------------

def test_unit_state_crosses_snapshots_both_ways(tmp_path):
    """A JAX snapshot of a workflow with a norm unit restores in the port
    with byte-identical mean/rdisp (and key), and a port snapshot
    restores in the JAX package likewise."""
    jsw, jws, psw, _ = small_pair(seed=1, key=8)
    jpath = JaxSnapshotter("j", str(tmp_path / "j")).save(
        "t", {"wstate": jws})
    pws = wstate_from_snapshot(jpath, psw.workflow, device="cpu")
    jh = jax_host(jws)
    for name in ("mean", "rdisp"):
        assert _np(pws["state"]["norm0"][name]).tobytes() == \
            jh["state"]["norm0"][name].tobytes()
    assert pws["key"].tobytes() == jh["key"].tobytes()
    assert pws["step"] == 0

    # the reverse: port state (statistics changed) -> JAX restore
    pws["state"]["norm0"]["mean"] += 1.5
    ppath = Snapshotter("p", str(tmp_path / "p")).save(
        "t", {"wstate": wstate_to_numpy({**pws, "opt_state": {}})})
    back = JaxSnapshotter.load(ppath)["wstate"]
    restored = JaxSnapshotter.restore_wstate(
        {"wstate": back}, like={**jws, "opt_state": {}})
    assert np.asarray(restored["state"]["norm0"]["mean"]).tobytes() == \
        _np(pws["state"]["norm0"]["mean"]).tobytes()
    assert np.asarray(jax.random.key_data(restored["key"])).tobytes() == \
        pws["key"].tobytes()


def test_wstate_from_jax_checks_the_unit_state():
    jsw, jws, psw, _ = small_pair()
    tree = jax_host(jws)
    tree["state"]["norm0"]["mean"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="state/norm0/mean"):
        wstate_from_jax(tree, psw.workflow, device="cpu")
