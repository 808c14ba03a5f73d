"""The port's recurrent cells, scans and units (veles_tpu_torch/ops/
recurrent.py, units/recurrent.py) against the JAX package's on the same
numpy-seeded inputs and weights: the seven tests of tests/test_recurrent.py,
each held to the JAX function.

Tolerances: float32 forward rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 /
atol 1e-5 (the two sides sum in different orders); the bf16 compute dtype
(operands rounded to bf16, float32 products) atol 2e-3 against JAX's bf16
and within 0.05 of float32, as the reference test allows."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import veles_tpu as vt  # noqa: E402
from veles_tpu.ops import recurrent as jrec  # noqa: E402
from veles_tpu.units import recurrent as junits  # noqa: E402
from veles_tpu_torch.loader.base import TRAIN, VALID, ArrayLoader  # noqa: E402,E501
from veles_tpu_torch.models.standard import StandardWorkflow  # noqa: E402
from veles_tpu_torch.ops import optimizers as popt  # noqa: E402
from veles_tpu_torch.ops import recurrent as rec  # noqa: E402
from veles_tpu_torch.runtime.decision import Decision  # noqa: E402
from veles_tpu_torch.runtime.trainer import Trainer  # noqa: E402
from veles_tpu_torch.units import nn  # noqa: E402
from veles_tpu_torch.units.base import Context, Spec  # noqa: E402
from veles_tpu_torch.units.recurrent import GRU, LSTM, RNN  # noqa: E402
from veles_tpu_torch.units.workflow import Workflow  # noqa: E402

from _torch_helpers import build_pair  # noqa: E402

torch.set_num_threads(2)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
N_GATES = {"rnn": 1, "gru": 3, "lstm": 4}


def _inputs(rng, cell, T=5, B=3, F=4, H=6):
    g = N_GATES[cell]
    xs = rng.normal(size=(T, B, F)).astype(np.float32)
    w = rng.normal(scale=0.4, size=(F + H, g * H)).astype(np.float32)
    b = rng.normal(scale=0.1, size=(g * H,)).astype(np.float32)
    return xs, np.zeros((B, H), np.float32), w, b


def _jax_scan(cell, xs, h0, w, b, **kw):
    if cell == "rnn":
        return jrec.rnn_scan(xs, h0, w, b, **kw)
    if cell == "gru":
        return jrec.gru_scan(xs, h0, w, b, **kw)
    ys, (h, _) = jrec.lstm_scan(xs, h0, jnp.zeros_like(h0), w, b, **kw)
    return ys, h


def _port_scan(cell, xs, h0, w, b, **kw):
    if cell == "rnn":
        return rec.rnn_scan(xs, h0, w, b, **kw)
    if cell == "gru":
        return rec.gru_scan(xs, h0, w, b, **kw)
    ys, (h, _) = rec.lstm_scan(xs, h0, torch.zeros_like(h0), w, b, **kw)
    return ys, h


@pytest.mark.parametrize("cell", sorted(N_GATES))
def test_rnn_scan_matches_reference(rng, cell):
    """Each scan and its final carry equal JAX's; the Elman scan also
    equals the float64 numpy reference."""
    xs, h0, w, b = _inputs(rng, cell)
    jys, jh = _jax_scan(cell, *map(jnp.asarray, (xs, h0, w, b)))
    pys, ph = _port_scan(cell, *map(torch.from_numpy, (xs, h0, w, b)))
    np.testing.assert_allclose(pys.numpy(), np.asarray(jys), **FWD)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **FWD)
    if cell == "rnn":
        ys_ref, h_ref = rec.rnn_reference(xs, h0, w, b)
        np.testing.assert_allclose(pys.numpy(), ys_ref, atol=1e-5)
        np.testing.assert_allclose(ph.numpy(), h_ref, atol=1e-5)


@pytest.mark.parametrize("cell", sorted(N_GATES))
def test_numeric_gradient(rng, cell):
    """Autograd through the port's scan equals ``jax.grad`` through the
    JAX scan for the weight, the bias and the inputs, and agrees with
    central differences (the NumDiff pattern of the reference test)."""
    xs, h0, w, b = _inputs(rng, cell, T=3, B=2, F=3, H=4)

    def jloss(xs, w, b):
        ys, _ = _jax_scan(cell, xs, jnp.asarray(h0), w, b)
        return jnp.sum(ys ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (xs, w, b)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (xs, w, b)]
    ys, _ = _port_scan(cell, leaves[0], torch.from_numpy(h0), *leaves[1:])
    loss = (ys ** 2).sum()
    pg = torch.autograd.grad(loss, leaves)
    for name, p, j in zip(("xs", "w", "b"), pg, jg):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), err_msg=name,
                                   **GRAD)
    eps, w64 = 1e-3, w.astype(np.float64)
    for idx in [(0, 0), (w.shape[0] - 1, w.shape[1] - 1), (2, 1)]:
        wp, wm = w64.copy(), w64.copy()
        wp[idx] += eps
        wm[idx] -= eps
        f = [float((_port_scan(cell, torch.from_numpy(xs).double(),
                               torch.from_numpy(h0).double(),
                               torch.from_numpy(ww),
                               torch.from_numpy(b).double())[0] ** 2).sum())
             for ww in (wp, wm)]
        num = (f[0] - f[1]) / (2 * eps)
        assert abs(float(pg[1][idx]) - num) < 3e-2 * max(1.0, abs(num))


@pytest.mark.parametrize("name", ["RNN", "GRU", "LSTM"])
def test_unit_shapes(rng, name):
    """Output specs and the forward of each unit, both return modes,
    on the JAX unit's initial weights."""
    B, T, F, H = 4, 7, 5, 8
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    for return_sequences, want in [(True, (B, T, H)), (False, (B, H))]:
        ju = getattr(junits, name)(H, return_sequences=return_sequences)
        pu = {"RNN": RNN, "GRU": GRU, "LSTM": LSTM}[name](
            H, return_sequences=return_sequences)
        assert pu.output_spec([Spec((B, T, F), torch.float32)]).shape \
            == want
        jparams, _ = ju.init(jax.random.key(0),
                             [vt.Spec((B, T, F), jnp.float32)])
        pparams, _ = pu.init(torch.Generator().manual_seed(0),
                             [Spec((B, T, F), torch.float32)], "cpu")
        assert {k: tuple(v.shape) for k, v in pparams.items()} == \
            {k: tuple(v.shape) for k, v in jparams.items()}
        jy, _ = ju.apply(jparams, {}, [jnp.asarray(x)], vt.units.Context())
        py, _ = pu.apply({k: torch.from_numpy(np.array(v))
                          for k, v in jparams.items()}, {},
                         [torch.from_numpy(x)], Context())
        assert tuple(py.shape) == want
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), **FWD)


def test_unit_rejects_2d_input():
    with pytest.raises(ValueError, match="batch, time"):
        LSTM(4).output_spec([Spec((8, 16), torch.float32)])


def test_lstm_bf16_compute_close_to_f32(rng):
    """The bf16 compute dtype: operands rounded to bf16, the carry
    float32; against JAX's bf16 LSTM and within the reference test's
    0.05 of the float32 result."""
    B, T, F, H = 4, 6, 8, 16
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    jparams, _ = junits.LSTM(H).init(jax.random.key(1),
                                     [vt.Spec((B, T, F), jnp.float32)])
    params = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    y32, _ = LSTM(H).apply(params, {}, [torch.from_numpy(x)], Context())
    y16, _ = LSTM(H, compute_dtype="bfloat16").apply(
        params, {}, [torch.from_numpy(x)], Context())
    jy16, _ = junits.LSTM(H, compute_dtype="bfloat16").apply(
        jparams, {}, [jnp.asarray(x)], vt.units.Context())
    assert float((y32 - y16).abs().max()) < 0.05
    np.testing.assert_allclose(y16.numpy(), np.asarray(jy16), atol=2e-3)


def _sequence_dataset(rng, n, T=12, F=6):
    """Class = whether the sum of feature 0 over time is positive: the
    model must integrate over time."""
    x = rng.normal(size=(n, T, F)).astype(np.float32)
    y = (x[:, :, 0].sum(axis=1) > 0).astype(np.int32)
    return x, y


@pytest.mark.parametrize("unit_cls", [GRU, LSTM])
def test_sequence_classification_end_to_end(rng, unit_cls):
    """The port's Trainer learns the task (chance is 50 %)."""
    xtr, ytr = _sequence_dataset(rng, 256)
    xva, yva = _sequence_dataset(rng, 128)
    loader = ArrayLoader({TRAIN: xtr, VALID: xva},
                         {TRAIN: ytr, VALID: yva}, minibatch_size=32)
    wf = Workflow(f"seq_{unit_cls.__name__}")
    wf.add(unit_cls(16, return_sequences=False, name="rec"))
    wf.add(nn.All2AllSoftmax(2, name="out", inputs=("rec",)))
    wf.add(nn.EvaluatorSoftmax(name="ev",
                               inputs=("out", "@labels", "@mask")))
    trainer = Trainer(wf, loader, popt.AdaGrad(0.08),
                      Decision(max_epochs=12), device="cpu")
    trainer.initialize(seed=11)
    results = trainer.run()
    assert results["best_value"] < 25.0, results


@pytest.mark.parametrize("kind", ["rnn", "gru", "lstm"])
def test_recurrent_layers_from_standard_config(rng, kind):
    """rnn/gru/lstm build from a StandardWorkflow config; on the JAX
    package's initial weights one SGD step gives JAX's loss and updated
    weights."""
    layers = [{"type": "embedding", "vocab": 10, "dim": 8, "name": "emb"},
              {"type": kind, "hidden": 12, "name": "rec",
               "return_sequences": False},
              {"type": "softmax", "output_size": 3, "name": "out"}]
    sw = StandardWorkflow({"name": f"{kind}_model", "layers": layers,
                           "optimizer": "sgd",
                           "optimizer_args": {"lr": 0.1}})
    assert type(sw.workflow.units[1]).__name__ == kind.upper()
    jwf, jws, pwf, pws = build_pair(
        layers, B=4, T=6, seed=0,
        optimizers=(vt.optimizers.SGD(0.1), popt.SGD(0.1)))
    x = rng.integers(0, 10, (4, 6)).astype(np.int32)
    labels = rng.integers(0, 3, (4,)).astype(np.int32)
    mask = np.ones(4, np.float32)
    jws, jm = jwf.make_train_step(vt.optimizers.SGD(0.1), donate=False)(
        jws, {"@input": jnp.asarray(x), "@labels": jnp.asarray(labels),
              "@mask": jnp.asarray(mask)})
    pws, pm = pwf.make_train_step(popt.SGD(0.1))(
        pws, {"@input": torch.from_numpy(x),
              "@labels": torch.from_numpy(labels),
              "@mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    for name in ("w", "b"):
        np.testing.assert_allclose(
            pws["params"]["rec"][name].numpy(),
            np.asarray(jws["params"]["rec"][name]), err_msg=name, **GRAD)
