"""The port's ``PipelineStack`` (units/parallel_nn.py) run sequentially
(no mesh) on the CPU, against the JAX package on shared float32 weights.

Both stack forms (homogeneous ``stage_w1``/``stage_w2`` and config
stages, heterogeneous and with an MoE stage): the forward rtol 1e-5 /
atol 1e-6 and every gradient rtol 1e-4 / atol 1e-6.  The four
``configs/induction_lm_pp*.json`` workflows build in both packages from
one JAX state carried across (the weights, the MoE aux state, the key),
and three train steps at batch 8 agree: the loss rtol 1e-4, the
gradient norm rtol 1e-3, the parameters after them rtol 1e-3 / atol
1e-4; in ``induction_lm_pp_moe.json`` both packages
draw the dropout masks of the kernel formulation (``use_pallas`` set in
the test's copy of the config), and the stages' dropout zero patterns
are compared bit for bit."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import CONFIGS, build_pair, tokens  # noqa: E402
from veles_tpu.models.standard import StandardWorkflow as JaxStandard  # noqa: E402,E501
from veles_tpu.runtime.snapshotter import _flatten as jax_flatten  # noqa: E402,E501
from veles_tpu.runtime.snapshotter import _to_numpy as jax_host  # noqa: E402,E501
from veles_tpu.units import Spec as JSpec  # noqa: E402
from veles_tpu.units.base import Context as JaxContext  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.models.standard import StandardWorkflow  # noqa: E402
from veles_tpu_torch.ops import optimizers as popt  # noqa: E402
from veles_tpu_torch.runtime.snapshotter import (  # noqa: E402
    _flatten, params_from_jax, wstate_from_jax, wstate_to_numpy)
from veles_tpu_torch.units.base import Context, Spec  # noqa: E402
from veles_tpu_torch.units.parallel_nn import PipelineStack  # noqa: E402

torch.set_num_threads(2)

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
V = 12

STACKS = {
    "homogeneous": [
        {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
        {"type": "pipeline_stack", "n_stages": 3, "d_hidden": 24,
         "name": "stack"},
        {"type": "seq_last", "name": "last"},
        {"type": "softmax", "output_size": V, "name": "out"}],
    "config_stages": [
        {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
        {"type": "pipeline_stack", "name": "stack", "stages": [
            [{"type": "attention", "n_heads": 2, "rope": True,
              "residual": True}, {"type": "layer_norm"}],
            [{"type": "ffn", "d_hidden": 32}],
            [{"type": "moe", "n_experts": 4, "d_hidden": 24, "top_k": 2,
              "aux_weight": 0.1}, {"type": "layer_norm"}]]},
        {"type": "seq_last", "name": "last"},
        {"type": "softmax", "output_size": V, "name": "out"}],
}


def _names(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        p = f"{prefix}/{k}" if prefix else k
        out += _names(v, p) if isinstance(v, dict) else [p]
    return out


@pytest.mark.parametrize("form", sorted(STACKS))
def test_stack_forms_match_jax(rng, form):
    """The stack's sequential forward and its gradients (the aux loss of
    an MoE stage included) equal the JAX package's."""
    B, T = 3, 6
    jwf, jws, pwf, pws = build_pair(STACKS[form], B=B, T=T, seed=4)
    x = tokens(rng, (B, T), V)
    batch = {"@input": x, "@labels": tokens(rng, (B,), V),
             "@mask": np.ones((B,), np.float32)}
    stack = pwf._by_name["stack"]
    assert isinstance(stack, PipelineStack)
    assert _names(pws["params"]) == sorted(
        jax_flatten(jax.device_get(jws["params"])))

    def jax_obj(params):
        out, ns = jwf.forward(params, jws["state"], batch,
                              JaxContext(train=False))
        aux = ns.get("stack", {}).get("aux_loss", 0.0)
        return out[jwf.evaluator.name] + aux, (out["stack"], aux)

    (jl, (jy, jaux)), jg = jax.value_and_grad(jax_obj, has_aux=True)(
        jws["params"])
    live = popt.tree_map(lambda t: t.detach().requires_grad_(True),
                         pws["params"])
    out, ns = pwf.forward(live, {}, {k: torch.from_numpy(v)
                                     for k, v in batch.items()},
                          Context(train=False))
    paux = ns.get("stack", {}).get("aux_loss", torch.zeros(()))
    pl = out[pwf.evaluator.name] + paux
    np.testing.assert_allclose(out["stack"].detach().numpy(),
                               np.asarray(jy), **FWD_TOL)
    np.testing.assert_allclose(float(paux.detach()), float(jaux),
                               **FWD_TOL)
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-5)
    grads = torch.autograd.grad(pl, popt.tree_leaves(live))
    jflat = jax_flatten(jax.device_get(jg))
    for name, g in zip(_names(live), grads, strict=True):
        np.testing.assert_allclose(g.numpy(), jflat[name], err_msg=name,
                                   **GRAD_TOL)
    if form == "config_stages":
        assert stack.has_aux_loss and [u.name for u in stack.sub_units()] \
            == ["s0u0_attention", "s0u1_layer_norm", "s1u0_ffn",
                "s2u0_moe", "s2u1_layer_norm"]


PP_CONFIGS = ["induction_lm_pp", "induction_lm_pp_moe", "induction_lm_pp_sp",
              "induction_lm_pp_sp_interleaved"]


def _config(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        cfg = json.load(f)
    wf = copy.deepcopy(cfg["workflow"])
    for layer in wf["layers"]:
        for stage in layer.get("stages", []):
            for spec in stage:
                if spec["type"] == "dropout":
                    # the kernel formulation in both packages
                    spec["use_pallas"] = True
    return wf, cfg["loader"]


def _built_pair(name, B):
    wf_cfg, loader = _config(name)
    T = loader["seq_len"]
    lab = (B, T) if loader.get("per_position") else (B,)
    jsw, psw = JaxStandard(wf_cfg), StandardWorkflow(wf_cfg)
    jsw.workflow.build({"@input": JSpec((B, T), jnp.int32),
                        "@labels": JSpec(lab, jnp.int32),
                        "@mask": JSpec(lab, jnp.float32)})
    psw.workflow.build({"@input": Spec((B, T), torch.int32),
                        "@labels": Spec(lab, torch.int32),
                        "@mask": Spec(lab, torch.float32)})
    jws = jsw.workflow.init_state(jax.random.key(11), jsw.optimizer)
    pws = wstate_from_jax(jax_host(jws), psw.workflow,
                          optimizer=psw.optimizer, device="cpu")
    return jsw, jws, psw, pws, T, lab


@pytest.mark.parametrize("name", PP_CONFIGS)
def test_pp_config_trains_like_jax(rng, name):
    """Three train steps at batch 8 of the config, no mesh (the stack
    runs sequentially in both packages): the loss, the gradient norm and
    the aux metric agree step by step, and the state after them."""
    prng.streams.reset()
    B = 8
    jsw, jws, psw, pws, T, lab = _built_pair(name, B)
    jstep = jsw.workflow.make_train_step(jsw.optimizer, donate=False)
    pstep = psw.workflow.make_train_step(psw.optimizer)
    for _ in range(3):
        mask = np.ones(lab, np.float32)
        mask[-1] = 0.0                                  # a padded row
        b = {"@input": tokens(rng, (B, T), 16),
             "@labels": tokens(rng, lab, 16), "@mask": mask}
        jws, jm = jstep(jws, b)
        pws, pm = pstep(pws, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
        assert float(pm["n_err"]) == float(jm["n_err"])
        assert sorted(k for k in pm if k.startswith("aux_")) == sorted(
            k for k in jm if k.startswith("aux_"))
        for k in (k for k in jm if k.startswith("aux_")):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=1e-4)
    pf = _flatten(wstate_to_numpy(pws)["params"])
    jf = jax_flatten(jax.device_get(jws["params"]))
    assert sorted(pf) == sorted(jf)
    for k in jf:
        # Adam's normalized steps magnify summation-order differences
        # of near-zero gradients
        np.testing.assert_allclose(pf[k], jf[k], rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def test_pp_moe_dropout_masks_bitwise(rng):
    """``induction_lm_pp_moe.json``'s stage dropouts: the same step key
    gives the same zero pattern in both packages (the unit's seed is
    ``bits32(fold_in(key, hash(name)))`` in both)."""
    B = 8
    jsw, jws, psw, pws, T, _ = _built_pair("induction_lm_pp_moe", B)
    jstack = jsw.workflow._by_name["stack"]
    pstack = psw.workflow._by_name["stack"]
    x = rng.standard_normal((B, T, 64)).astype(np.float32)
    key = jax.random.key(5)
    pkey = tuple(int(v) for v in jax.random.key_data(key))
    for i in (0, 1):
        jun, pun = jstack._stage_units[i], pstack._stage_units[i]
        jp = jws["params"]["stack"][f"s{i}"]
        pp = pws["params"]["stack"][f"s{i}"]
        jx, px = jnp.asarray(x), torch.from_numpy(x)
        for ju, pu in zip(jun[:2], pun[:2]):          # attention, dropout
            jx, _ = ju.apply(jp.get(ju.name, {}), {}, [jx],
                             JaxContext(train=True, key=key))
            px, _ = pu.apply(pp.get(pu.name, {}), {}, [px],
                             Context(train=True, key=pkey))
        assert pun[1].draws_seed
        np.testing.assert_array_equal(px.numpy() == 0, np.asarray(jx) == 0)
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-5,
                                   atol=1e-5)
    # the train step gives each stage dropout a seed slot
    step = psw.workflow.make_train_step(psw.optimizer)
    assert step.seeded == ["s0u1_dropout", "s1u1_dropout"]


def test_snapshot_round_trip_of_stack_and_moe_state(tmp_path):
    """A stack's ``s<i>/<unit>/<param>`` params and its ``aux_loss``
    state survive a port snapshot and load back in the JAX layout."""
    from veles_tpu_torch.runtime.snapshotter import Snapshotter
    jsw, jws, psw, pws, _, _ = _built_pair("induction_lm_pp_moe", 8)
    pws["state"]["stack"]["aux_loss"].fill_(0.375)
    snap = Snapshotter("pp", str(tmp_path))
    path = snap.save("ep0", {"wstate": wstate_to_numpy(pws)})
    back = Snapshotter.load(path)["wstate"]
    assert float(back["state"]["stack"]["aux_loss"]) == 0.375
    params = params_from_jax(back["params"], psw.workflow, device="cpu")
    want = _flatten(wstate_to_numpy(pws)["params"])
    got = _flatten(popt.tree_map(lambda t: t.numpy(), params))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jf = jax_flatten(jax.device_get(jws["params"]))
    assert sorted(jf) == sorted(_flatten(back["params"]))
    assert "stack/s3/moe/router" in jf and \
        "stack/s0/s0u0_attention/wq" in jf
