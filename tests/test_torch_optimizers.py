"""The port's optimizers (veles_tpu_torch/ops/optimizers.py) against the
JAX package's on the same parameter tree and the same gradients.

Each optimizer and each lr policy runs 3 steps from the same tree and
must give the JAX package's parameters and slots within rtol 1e-6 (both
compute in float32; the elementwise order is the same, only transcendental
functions may differ in the last bit).  Also: the anomaly guard on a NaN
loss, global and per-unit gradient clipping, per-layer hyperparams from a
layer config, and the opt_state snapshot keys."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from veles_tpu.models.standard import build_optimizer as jax_build_opt  # noqa: E402,E501
from veles_tpu.ops import optimizers as jopt  # noqa: E402
from veles_tpu.runtime.snapshotter import _flatten as jax_flatten  # noqa: E402,E501
from veles_tpu_torch.models.standard import build_optimizer  # noqa: E402
from veles_tpu_torch.ops import optimizers as popt  # noqa: E402
from veles_tpu_torch.runtime.snapshotter import (  # noqa: E402
    _flatten, wstate_to_numpy)

RTOL = dict(rtol=1e-6, atol=1e-7)

SHAPES = {"fc1": {"w": (5, 4), "b": (4,)}, "fc2": {"w": (4, 3), "b": (3,)}}


def _tree(rng, scale=1.0):
    return {u: {k: (scale * rng.standard_normal(s)).astype(np.float32)
                for k, s in sub.items()} for u, sub in SHAPES.items()}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_port(tree):
    return popt.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(port_tree, jax_tree, **tol):
    pf = _flatten(wstate_to_numpy({"x": port_tree, "step": 0})["x"])
    jf = jax_flatten(jax.device_get(jax_tree))
    assert sorted(pf) == sorted(jf)
    for key in jf:
        np.testing.assert_allclose(pf[key], jf[key], err_msg=key,
                                   **(tol or RTOL))


def _run_both(jo, po, rng, steps=3, grads=None, loss=None):
    params = _tree(rng)
    jp, pp = _to_jax(params), _to_port(params)
    js, ps = jo.init(jp), po.init(pp)
    for step in range(steps):
        g = _tree(rng, 0.5) if grads is None else grads[step]
        jg, pg = _to_jax(g), _to_port(g)
        jp, js = jo.update(jg, js, jp, jnp.asarray(step, jnp.int32))
        pp, ps = po.update(pg, ps, pp, step)
    return jp, js, pp, ps


OPTIMIZERS = {
    "sgd": {"lr": 0.1},
    "momentum": {"lr": 0.05, "momentum": 0.8},
    "adagrad": {"lr": 0.1},
    "adadelta": {"lr": 1.0},
    "adam": {"lr": 1e-3},
    "adamw": {"lr": 1e-3, "weight_decay": 0.05},
}


@pytest.mark.parametrize("kind", list(OPTIMIZERS), ids=list(OPTIMIZERS))
def test_optimizer_matches_jax_for_3_steps(rng, kind):
    jo = jopt.OPTIMIZERS[kind](**OPTIMIZERS[kind])
    po = popt.OPTIMIZERS[kind](**OPTIMIZERS[kind])
    jp, js, pp, ps = _run_both(jo, po, rng)
    _close(pp, jp)
    _close(ps, js)


POLICIES = {
    "fixed": {"type": "fixed"},
    "exp": {"type": "exp", "gamma": 0.5, "step_size": 2},
    "inv": {"type": "inv", "gamma": 0.3, "power": 0.75},
    "step": {"type": "step", "boundaries": [1, 2], "values": [0.05, 0.01]},
    "warmup_cosine": {"type": "warmup_cosine", "warmup_steps": 1,
                      "total_steps": 3, "final_scale": 0.1},
}


@pytest.mark.parametrize("policy", list(POLICIES), ids=list(POLICIES))
def test_lr_policy_matches_jax_for_3_steps(rng, policy):
    layers = [{"type": "all2all", "output_size": 4, "name": "fc1"}]
    cfg = dict(POLICIES[policy])
    jo = jax_build_opt("momentum", layers, lr=0.1, lr_policy=dict(cfg))
    po = build_optimizer("momentum", layers, lr=0.1, lr_policy=dict(cfg))
    for step in range(6):
        np.testing.assert_allclose(float(po.schedule(step)),
                                   float(jo.schedule(jnp.int32(step))),
                                   rtol=1e-6)
    jp, js, pp, ps = _run_both(jo, po, rng)
    _close(pp, jp)


def test_guarded_update_skips_a_nan_step_and_counts_it(rng):
    jo, po = jopt.Adam(1e-2), popt.Adam(1e-2)
    params = _tree(rng)
    jp, pp = _to_jax(params), _to_port(params)
    js, ps = jo.init(jp), po.init(pp)
    g = _tree(rng)
    for step, loss in enumerate((float("nan"), float("nan"), 1.0)):
        jp, js, jok, _ = jopt.guarded_update(
            jo, _to_jax(g), js, jp, jnp.int32(step), jnp.float32(loss))
        new_pp, ps, pok, _ = popt.guarded_update(
            po, _to_port(g), ps, pp, step, torch.tensor(loss))
        assert bool(pok) == bool(jok) == (loss == 1.0)
        if loss != 1.0:
            # params and slots carried through unchanged
            for u in params:
                for k in params[u]:
                    assert torch.equal(new_pp[u][k], pp[u][k])
            assert float(ps["fc1"]["w"][2]) == 0.0      # Adam's t
        pp = new_pp
        _close(ps, js)
    assert int(ps[popt.ANOM_SKIP_KEY]) == 2
    assert int(ps[popt.ANOM_CONSEC_KEY]) == 0
    _close(pp, jp)


@pytest.mark.parametrize("where", ["guard", "optimizer", "per_unit"])
def test_clip_norm_matches_jax(rng, where):
    if where == "guard":
        jo, po = jopt.SGD(0.1), popt.SGD(0.1)
    elif where == "optimizer":
        jo, po = jopt.SGD(0.1, clip_norm=0.3), popt.SGD(0.1, clip_norm=0.3)
    else:
        hp = {"fc1": dict(clip_norm=0.2)}
        jo = jopt.SGD(0.1, per_unit={k: jopt.HyperParams(**v)
                                     for k, v in hp.items()})
        po = popt.SGD(0.1, per_unit={k: popt.HyperParams(**v)
                                     for k, v in hp.items()})
    params, g = _tree(rng), _tree(rng, 3.0)
    jp, pp = _to_jax(params), _to_port(params)
    clip = 0.5 if where == "guard" else 0.0
    jp, _, _, jn = jopt.guarded_update(jo, _to_jax(g), jo.init(jp), jp,
                                       jnp.int32(0), jnp.float32(1.0),
                                       clip_norm=clip)
    pp, _, _, pn = popt.guarded_update(po, _to_port(g), po.init(pp), pp, 0,
                                       torch.tensor(1.0), clip_norm=clip)
    np.testing.assert_allclose(float(pn), float(jn), rtol=1e-6)
    _close(pp, jp)


def test_per_layer_hyperparams_from_config_match_jax(rng):
    layers = [{"type": "all2all", "output_size": 4, "name": "fc1",
               "hyperparams": {"lr_scale": 0.5, "bias_lr_scale": 2.0,
                               "l2": 0.01, "momentum": 0.0}},
              {"type": "softmax", "output_size": 3, "name": "fc2",
               "hyperparams": {"l1": 0.001, "momentum": 0.5}}]
    jo = jax_build_opt("momentum", layers, lr=0.1, momentum=0.9)
    po = build_optimizer("momentum", layers, lr=0.1, momentum=0.9)
    assert po.per_unit["fc1"] == popt.HyperParams(
        lr_scale=0.5, bias_lr_scale=2.0, l2=0.01, momentum=0.0)
    jp, js, pp, ps = _run_both(jo, po, rng)
    _close(pp, jp)
    _close(ps, js)


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_opt_state_snapshot_keys_round_trip(rng, kind):
    """The port's opt_state flattens to the JAX package's snapshot keys
    and dtypes (Adam's (m, v, t) slot, the reserved scalars), and a JAX
    opt_state restores into the port's tree."""
    from veles_tpu_torch.runtime.snapshotter import Snapshotter
    jo = jopt.OPTIMIZERS[kind](**OPTIMIZERS[kind])
    po = popt.OPTIMIZERS[kind](**OPTIMIZERS[kind])
    params = _tree(rng)
    jf = jax_flatten(jax.device_get(jo.init(_to_jax(params))))
    ps = po.init(_to_port(params))
    pf = _flatten(wstate_to_numpy({"o": ps, "step": 0})["o"])
    assert sorted(pf) == sorted(jf)
    for key in jf:
        assert pf[key].dtype == jf[key].dtype and \
            pf[key].shape == jf[key].shape, key
    # JAX state, after a step, into the port's live tree
    jp = _to_jax(params)
    _, js = jo.update(_to_jax(_tree(rng)), jo.init(jp), jp, jnp.int32(0))
    from veles_tpu.runtime.snapshotter import _unflatten
    back = Snapshotter.restore_wstate(
        {"wstate": _unflatten(jax_flatten(jax.device_get(js)))}, like=ps)
    _close(back, js, rtol=0, atol=0)
