"""The port's self-organizing units (units/kohonen.py, units/rbm.py) and
utility units (units/base.py) against the JAX package: the contracts of
tests/test_selforg.py and tests/test_workflow.py.

Where the JAX result does not depend on its threefry draws the port must
equal it from the same state: the SOM's winner map, quantization error
and batch update; the RBM's hidden probabilities, free energy,
reconstruction error, and a CD step given the JAX step's own uniform
draws passed in as arrays.  Tolerance: rtol 1e-5 / atol 1e-6 (float32,
different summation orders); winner maps exact."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import veles_tpu as vt  # noqa: E402
from veles_tpu.units import KohonenForward as JaxSOM  # noqa: E402
from veles_tpu.units import RBM as JaxRBM  # noqa: E402
from veles_tpu.units.base import Context as JaxContext  # noqa: E402
from veles_tpu_torch.ops import optimizers as popt  # noqa: E402
from veles_tpu_torch.units import (RBM, Avatar, InputJoiner,  # noqa: E402
                                   KohonenForward, LambdaUnit, TrivialUnit,
                                   UnitRegistry, Workflow, WorkflowError)
from veles_tpu_torch.units.base import Context, Spec  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _np(tree):
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in tree.items()}


def _blobs(rng, n=256, feat=8):
    centers = rng.standard_normal((4, feat)) * 2
    lab = rng.integers(0, 4, n)
    return (centers[lab] + 0.1 * rng.standard_normal((n, feat))).astype(
        np.float32)


def _som_workflow(shape, batch, feat, **kw):
    wf = Workflow("som")
    som = wf.add(KohonenForward(shape, name="som", **kw))
    wf.build({"@input": Spec((batch, feat), torch.float32)})
    return wf, som


def test_som_quantization_error_decreases(rng):
    """30 epochs of the port's train step halve the quantization error
    (the reference contract)."""
    x = _blobs(rng)
    wf, som = _som_workflow((6, 6), 64, 8, init_lr=0.5, decay_steps=200)
    ws = wf.init_state(0, device="cpu")
    step = wf.make_train_step(popt.SGD(0.0))
    e0 = float(som.quantization_error(ws["state"]["som"], x))
    for _ in range(30):
        for i in range(0, 256, 64):
            ws, mets = step(ws, {"@input": torch.from_numpy(x[i:i + 64])})
    assert mets == {}
    e1 = float(som.quantization_error(ws["state"]["som"], x))
    assert e1 < e0 * 0.5, (e0, e1)
    assert float(ws["state"]["som"]["t"]) == 120.0


def test_som_matches_jax_from_the_same_codebook(rng):
    """From the JAX codebook: the winner map, the quantization error and
    three batch updates equal the JAX package's."""
    x = _blobs(rng, 128)
    ju = JaxSOM((5, 4), init_lr=0.4, decay_steps=50, name="som")
    jst = ju.init(jax.random.key(3), [vt.Spec((64, 8), jnp.float32)])[1]
    pu = KohonenForward((5, 4), init_lr=0.4, decay_steps=50, name="som")
    pst = _t(jax.device_get(jst))
    jw, _ = ju.apply({}, jst, [jnp.asarray(x)], JaxContext())
    pw, _ = pu.apply({}, pst, [torch.from_numpy(x)], Context())
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(float(pu.quantization_error(pst, x)),
                               float(ju.quantization_error(jst, x)), **TOL)
    for i in range(0, 128, 64):
        xb = x[i:i + 64]
        jst = ju.update_state({}, jst, [jnp.asarray(xb)], JaxContext())
        pst = pu.update_state({}, pst, [torch.from_numpy(xb)], Context())
    for k, v in _np(pst).items():
        np.testing.assert_allclose(v, np.asarray(jst[k]), err_msg=k, **TOL)


def test_som_winner_output_shape():
    wf, _ = _som_workflow((4, 4), 8, 5)
    ws = wf.init_state(1, device="cpu")
    y = wf.make_predict_step("som")(ws, {"@input": torch.ones((8, 5))})
    assert tuple(y.shape) == (8,) and y.dtype == torch.int32
    assert int(y.max()) < 16


def test_rbm_reconstruction_improves(rng):
    """20 epochs of CD-1 through the port's train step (the Gibbs draws
    from the step's generator) cut the reconstruction error by 30 %."""
    protos = (rng.random((2, 16)) > 0.5).astype(np.float32)
    idx = rng.integers(0, 2, 512)
    x = np.clip(protos[idx] + 0.05 * rng.standard_normal((512, 16)), 0, 1
                ).astype(np.float32)
    wf = Workflow("rbm")
    rbm = wf.add(RBM(8, lr=0.1, name="rbm"))
    wf.build({"@input": Spec((64, 16), torch.float32)})
    ws = wf.init_state(0, device="cpu")
    step = wf.make_train_step(popt.SGD(0.0))
    e0 = float(rbm.reconstruction_error(ws["state"]["rbm"], x))
    for _ in range(20):
        for i in range(0, 512, 64):
            ws, _ = step(ws, {"@input": torch.from_numpy(x[i:i + 64])})
    e1 = float(rbm.reconstruction_error(ws["state"]["rbm"], x))
    assert e1 < e0 * 0.7, (e0, e1)


def _jax_uniforms(key, shape, cd_k):
    """The uniform draws of the JAX RBM's ``update_state`` from its unit
    key, in its order."""
    out = [np.asarray(jax.random.uniform(key, shape))]
    for _ in range(cd_k):
        key, k1 = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(k1, shape)))
    return out


@pytest.mark.parametrize("cd_k", [1, 2])
def test_rbm_matches_jax_given_the_draws(rng, cd_k):
    """From the JAX state: hidden probabilities, free energy and
    reconstruction error equal JAX's, and a CD-k step fed the JAX step's
    own uniform draws leaves JAX's state."""
    x = rng.random((16, 8)).astype(np.float32)
    ju = JaxRBM(4, lr=0.1, cd_k=cd_k, name="rbm")
    jst = ju.init(jax.random.key(0), [vt.Spec((16, 8), jnp.float32)])[1]
    pu = RBM(4, lr=0.1, cd_k=cd_k, name="rbm")
    pst = _t(jax.device_get(jst))
    jh, _ = ju.apply({}, jst, [jnp.asarray(x)], JaxContext())
    ph, _ = pu.apply({}, pst, [torch.from_numpy(x)], Context())
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **TOL)
    jfe = (-(jnp.asarray(x) @ jst["vbias"]) - jax.nn.softplus(
        jnp.asarray(x) @ jst["w"] + jst["hbias"]).sum(1))
    np.testing.assert_allclose(pu.free_energy(pst, torch.from_numpy(x))
                               .numpy(), np.asarray(jfe), **TOL)
    np.testing.assert_allclose(float(pu.reconstruction_error(pst, x)),
                               float(ju.reconstruction_error(jst, x)),
                               **TOL)
    ctx = JaxContext(train=True, key=jax.random.key(42))
    new_j = ju.update_state({}, jst, [jnp.asarray(x)], ctx)
    draws = _jax_uniforms(ctx.unit_key("rbm"), (16, 4), cd_k)
    new_p = pu.update_state({}, pst, [torch.from_numpy(x)], None,
                            uniforms=draws)
    for k, v in _np(new_p).items():
        np.testing.assert_allclose(v, np.asarray(new_j[k]), err_msg=k,
                                   **TOL)


def test_rbm_update_deterministic_given_key(rng):
    """The same step key gives the same generator draws and update."""
    x = torch.from_numpy(rng.random((16, 8)).astype(np.float32))
    rbm = RBM(4, name="rbm")
    _, st = rbm.init(torch.Generator().manual_seed(0),
                     [Spec((16, 8), torch.float32)], "cpu")

    def ctx():
        return Context(train=True, make_generator=lambda:
                       torch.Generator().manual_seed(42))

    s1 = rbm.update_state({}, st, [x], ctx())
    s2 = rbm.update_state({}, st, [x], ctx())
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k


def test_utility_units_and_registry():
    """TrivialUnit, Avatar, LambdaUnit and InputJoiner as in
    tests/test_workflow.py: wiring checks, specs from meta tensors, the
    forward; every unit class is in the registry."""
    wf = Workflow("t")
    wf.add(TrivialUnit(name="a", inputs=("b",)))
    wf.add(TrivialUnit(name="b", inputs=("a",)))
    with pytest.raises(WorkflowError, match="cycle"):
        wf.topo_order()
    wf = Workflow("t")
    wf.add(TrivialUnit(name="a", inputs=("nope",)))
    with pytest.raises(WorkflowError, match="unknown source"):
        wf.topo_order()
    wf = Workflow("j")
    wf.add(TrivialUnit(name="a"))
    wf.add(Avatar(name="b"))
    wf.add(InputJoiner(name="join", inputs=("a", "b")))
    wf.add(LambdaUnit(lambda x: x * 2.0, name="dbl", inputs=("join",)))
    specs = wf.build({"@input": Spec((4, 3), torch.float32)})
    assert specs["join"].shape == (4, 6) and specs["dbl"].shape == (4, 6)
    assert specs["dbl"].dtype == torch.float32
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    out, _ = wf.forward({}, {}, {"@input": x}, Context())
    assert torch.equal(out["dbl"], torch.cat([x, x], 1) * 2.0)
    lu = LambdaUnit(lambda x: x.sum(-1), out_spec=lambda s: Spec(
        s[0].shape[:1], s[0].dtype))
    assert lu.output_spec([Spec((5, 2), torch.float32)]).shape == (5,)
    for name in ("TrivialUnit", "Avatar", "LambdaUnit", "InputJoiner",
                 "KohonenForward", "RBM", "GRU", "LSTM", "RNN", "All2All"):
        assert name in UnitRegistry.names(), name
    assert UnitRegistry.get("RBM") is RBM
