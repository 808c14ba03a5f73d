"""The port's mixture-of-experts layer (parallel/moe.py, units/
parallel_nn.py ``MoEFFN``) and the train step's aux-loss channel on the
CPU, against the JAX package on shared float32 weights.

Tolerances: ``moe_apply`` outputs rtol 1e-5 / atol 1e-6 and its aux
loss atol 1e-6 (both sides route alike; only summation orders differ);
router and expert gradients rtol 1e-4 / atol 1e-6; three train steps of
a MoE LM: the loss rtol 1e-4, the gradient norm rtol 1e-3, the aux
metric rtol 1e-4.  The contracts of tests/test_pipeline_moe.py:147
(capacity drops), :205 (top-2 slot priority) and :240 (router
gradients) hold in the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import build_pair, tokens  # noqa: E402
from veles_tpu.ops import optimizers as jopt  # noqa: E402
from veles_tpu.parallel.moe import init_moe_params as jax_init  # noqa: E402
from veles_tpu.parallel.moe import moe_apply as jax_moe  # noqa: E402
from veles_tpu.runtime.snapshotter import _flatten as jax_flatten  # noqa: E402,E501
from veles_tpu.runtime.snapshotter import _to_numpy as jax_host  # noqa: E402,E501
from veles_tpu_torch.ops import optimizers as popt  # noqa: E402
from veles_tpu_torch.parallel.moe import capacity, moe_apply  # noqa: E402
from veles_tpu_torch.runtime.snapshotter import (  # noqa: E402
    _flatten, wstate_from_jax, wstate_to_numpy)

torch.set_num_threads(2)

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _params(seed, E, D, H):
    jp = jax_init(jax.random.key(seed), E, D, H)
    return jp, {k: torch.from_numpy(np.asarray(v).copy())
                for k, v in jp.items()}


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["ample", "tight"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("mode", ["sort", "dense"])
def test_moe_apply_matches_jax(rng, mode, top_k, cf):
    """Outputs, the aux loss and every gradient equal the JAX package's,
    with routes dropped (``tight``) and without."""
    T, D, H, E = 24, 8, 12, 4
    jp, pp = _params(top_k, E, D, H)
    x = rng.standard_normal((T, D)).astype(np.float32)
    jy, jaux = jax_moe(jp, jnp.asarray(x), capacity_factor=cf,
                       top_k=top_k, dispatch_mode=mode)
    live = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe_apply(live, xt, capacity_factor=cf, top_k=top_k,
                       dispatch_mode=mode)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               **OUT_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=0,
                               atol=1e-6)
    w = rng.standard_normal((T, D)).astype(np.float32)

    def jloss(p, x):
        y, a = jax_moe(p, x, capacity_factor=cf, top_k=top_k,
                       dispatch_mode=mode)
        return jnp.sum(y * w) + a

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    (y * torch.from_numpy(w)).sum().add(aux).backward()
    for k in pp:
        np.testing.assert_allclose(live[k].grad.numpy(), np.asarray(jg[k]),
                                   err_msg=k, **GRAD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx),
                               **GRAD_TOL)


def test_capacity_drops_tokens(rng):
    """tests/test_pipeline_moe.py:147: over capacity a token's route
    contributes nothing; kept tokens equal the dropless output."""
    T, D, H, E = 16, 8, 12, 2
    _, pp = _params(0, E, D, H)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    y_full, _ = moe_apply(pp, x, capacity_factor=8.0)
    y_cap, _ = moe_apply(pp, x, capacity_factor=0.25)    # C=2 an expert
    assert capacity(0.25, T, 1, E) == 2
    dropped = (y_cap == 0).all(-1)
    assert int(dropped.sum()) >= T - 2 * E * 2
    np.testing.assert_allclose(y_cap[~dropped].numpy(),
                               y_full[~dropped].numpy(), rtol=1e-4,
                               atol=1e-5)


def test_top2_slot_priority_under_capacity(rng):
    """tests/test_pipeline_moe.py:205: every first choice queues before
    any second choice, so at C = T/2 every primary route survives and
    every secondary one drops."""
    T, D, H, E = 8, 4, 12, 2
    _, pp = _params(2, E, D, H)
    router = np.zeros((D, E), np.float32)
    router[0, 0], router[0, 1] = 2.0, 1.0
    pp["router"] = torch.from_numpy(router)
    x = np.abs(rng.standard_normal((T, D))).astype(np.float32)
    x[T // 2:, 0] *= -1.0
    y, _ = moe_apply(pp, torch.from_numpy(x), capacity_factor=0.5, top_k=2)
    probs = torch.softmax(torch.from_numpy(x @ router), -1).numpy()
    prim = probs.argmax(-1)
    srt = np.sort(probs, -1)[:, ::-1]
    g0 = srt[:, 0] / srt.sum(-1)
    w1, w2 = pp["w1"].numpy(), pp["w2"].numpy()
    expect = np.stack([np.maximum(x[t] @ w1[prim[t]], 0) @ w2[prim[t]]
                       * g0[t] for t in range(T)])
    np.testing.assert_allclose(y.numpy(), expect, rtol=1e-4, atol=1e-5)


def test_top_k_ties_take_the_lower_expert():
    """Equal router probabilities route to the lower expert index first,
    as ``jax.lax.top_k`` orders them."""
    from veles_tpu_torch.parallel.moe import _top_k
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    _, idx = _top_k(probs, 2)
    assert idx.tolist() == [[0, 1], [1, 2]]
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert np.asarray(jidx).tolist() == idx.tolist()


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_grads_flow(rng, top_k):
    """tests/test_pipeline_moe.py:240: the router receives a gradient
    (Switch keeps the raw top-1 probability), equal to JAX's."""
    T, D, H, E = 16, 8, 12, 4
    jp, pp = _params(3, E, D, H)
    x = rng.standard_normal((T, D)).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(jax_moe(
        p, jnp.asarray(x), top_k=top_k)[0] ** 2))(jp)
    live = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
    (moe_apply(live, torch.from_numpy(x), top_k=top_k)[0] ** 2).sum() \
        .backward()
    assert float(live["router"].grad.abs().sum()) > 0
    np.testing.assert_allclose(live["router"].grad.numpy(),
                               np.asarray(jg["router"]), **GRAD_TOL)


V = 12
MOE_LM = [
    {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
    {"type": "attention", "n_heads": 2, "rope": True, "residual": True,
     "name": "a1"},
    {"type": "moe", "n_experts": 4, "d_hidden": 32, "top_k": 2,
     "aux_weight": 0.05, "name": "moe"},
    {"type": "seq_last", "name": "last"},
    {"type": "softmax", "output_size": V, "name": "out"},
]


def test_moe_ffn_trains_with_its_aux_loss(rng):
    """Three Adam steps of a MoE LM (capacity 1.25: routes drop) through
    both train steps: the aux loss joins the training loss with its
    weight, ``aux_moe`` is reported and lands in the unit state."""
    B, T = 4, 8
    jo, po = jopt.Adam(3e-3), popt.Adam(3e-3)
    jwf, jws, pwf, _ = build_pair(MOE_LM, B=B, T=T, seed=5,
                                  optimizers=(jo, po))
    pws = wstate_from_jax(jax_host(jws), pwf, optimizer=po, device="cpu")
    assert set(pws["state"]["moe"]) == {"aux_loss"}
    jstep = jwf.make_train_step(jo, donate=False)
    pstep = pwf.make_train_step(po)
    for _ in range(3):
        b = {"@input": tokens(rng, (B, T), V),
             "@labels": tokens(rng, (B,), V),
             "@mask": np.ones((B,), np.float32)}
        jws, jm = jstep(jws, b)
        pws, pm = pstep(pws, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(float(pm["aux_moe"]),
                                   float(jm["aux_moe"]), rtol=1e-4)
        np.testing.assert_allclose(
            float(pws["state"]["moe"]["aux_loss"]),
            float(jws["state"]["moe"]["aux_loss"]), rtol=1e-4)
    pf = _flatten(wstate_to_numpy(pws)["params"])
    jf = jax_flatten(jax.device_get(jws["params"]))
    assert sorted(pf) == sorted(jf)
    for k in jf:
        np.testing.assert_allclose(pf[k], jf[k], rtol=1e-3, atol=1e-5,
                                   err_msg=k)


def test_moe_decode_runs_dropless():
    """Decode routes every token (capacity_factor = n_experts): a
    tight-capacity unit's decode output equals its dropless forward."""
    from veles_tpu_torch.units.base import Context
    from veles_tpu_torch.units.parallel_nn import MoEFFN
    u = MoEFFN(4, 8, name="m", capacity_factor=0.1)
    from veles_tpu_torch.units.base import Spec
    p, _ = u.init(torch.Generator().manual_seed(0),
                  [Spec((6, 8), torch.float32)], "cpu")
    x = torch.randn(6, 8, generator=torch.Generator().manual_seed(1))
    y_tight, _ = u.apply(p, {}, [x], Context())
    y_free, _ = u.apply(p, {}, [x], Context(), capacity_factor=4.0)
    ref, _ = moe_apply(p, x, capacity_factor=4.0, top_k=2)
    assert torch.equal(y_free, ref)
    assert not torch.equal(y_tight, y_free)
