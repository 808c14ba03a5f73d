"""The port's LM units and its predict step against the JAX package, on
shared float32 weights and the same numpy inputs.  Tolerance 1e-5
(relative and absolute): both sides compute in float32 and differ only in
summation order (matmul blocking, the attention scan)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import veles_tpu as vt  # noqa: E402
from veles_tpu.models.standard import LAYER_TYPES as JAX_TYPES  # noqa: E402
from veles_tpu.units.base import Context as JaxContext  # noqa: E402
from veles_tpu_torch.models.standard import \
    LAYER_TYPES as PORT_TYPES  # noqa: E402
from veles_tpu_torch.runtime.snapshotter import \
    params_from_jax  # noqa: E402
from veles_tpu_torch.units.base import Context, Spec  # noqa: E402

from _torch_helpers import (build_pair, induction_layers,  # noqa: E402
                            narrow_bench_layers, tokens, vocab_of)

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)

# (layer spec, input kind, input shape)
UNIT_CASES = {
    "embedding": ({"type": "embedding", "vocab": 20, "dim": 16}, "tok",
                  (3, 7)),
    "all2all_per_position": ({"type": "all2all", "output_size": 10,
                              "per_position": True}, "x", (3, 7, 16)),
    "all2all_flat_tanh": ({"type": "all2all_tanh", "output_size": 10},
                          "x", (3, 7, 4)),
    "softmax_head": ({"type": "softmax", "output_size": 12}, "x", (4, 16)),
    "layer_norm": ({"type": "layer_norm"}, "x", (3, 7, 16)),
    "ffn": ({"type": "ffn", "d_hidden": 24}, "x", (3, 7, 16)),
    "seq_last": ({"type": "seq_last"}, "x", (3, 7, 16)),
    "attention_rope_residual": ({"type": "attention", "n_heads": 4,
                                 "rope": True, "residual": True}, "x",
                                (2, 19, 32)),
    "attention_gqa_window": ({"type": "attention", "n_heads": 4,
                              "n_kv_heads": 2, "window": 5, "rope": True},
                             "x", (2, 19, 32)),
    "attention_noncausal": ({"type": "attention", "n_heads": 2,
                             "causal": False}, "x", (2, 9, 16)),
}


@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_unit_matches_jax(rng, case):
    spec, kind, shape = UNIT_CASES[case]
    spec = dict(spec)
    ltype = spec.pop("type")
    ju = JAX_TYPES[ltype](name="u", **spec)
    pu = PORT_TYPES[ltype](name="u", **spec)
    if kind == "tok":
        x = tokens(rng, shape, spec["vocab"])
        jspec = vt.Spec(shape, jnp.int32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
        jspec = vt.Spec(shape, jnp.float32)
    params, state = ju.init(jax.random.key(3), [jspec])
    ref, _ = ju.apply(params, state, [jnp.asarray(x)],
                      JaxContext(train=False))
    assert ju.output_spec([jspec]).shape == ref.shape
    pspec = Spec(shape, torch.int32 if kind == "tok" else torch.float32)
    assert pu.output_spec([pspec]).shape == tuple(ref.shape)
    pparams = params_from_jax({"u": jax.device_get(params)},
                              device="cpu").get("u", {})
    out, _ = pu.apply(pparams, {}, [torch.from_numpy(x)], Context())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("layers", [induction_layers(),
                                    narrow_bench_layers()],
                         ids=["induction_lm", "narrow_bench_lm"])
def test_predict_step_matches_jax(rng, layers):
    B, T = 3, 16
    jwf, jws, pwf, pws = build_pair(layers, B=B, T=T, seed=5)
    x = tokens(rng, (B, T), vocab_of(layers))
    ref = jwf.make_predict_step()(jws, {"@input": jnp.asarray(x)})
    out = pwf.make_predict_step()(pws, {"@input": torch.from_numpy(x)})
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # same topology, same digest
    assert pwf.checksum() == jwf.checksum()


def test_unported_layer_type_names_its_slice():
    from veles_tpu_torch.models.standard import build_workflow
    # gru (ROADMAP slice 7) and moe (slice 8) layers build now; a type
    # still pending names its slice, in a pipeline stage too
    from veles_tpu_torch.models import standard
    wf = build_workflow("x", [{"type": "embedding", "vocab": 4, "dim": 4},
                              {"type": "gru", "hidden": 4},
                              {"type": "moe", "n_experts": 2,
                               "d_hidden": 4}])
    assert [type(u).__name__ for u in wf.units[1:3]] == ["GRU", "MoEFFN"]
    standard.PENDING_TYPES["later"] = "item 99"
    try:
        for layer in ({"type": "later"},
                      {"type": "pipeline_stack",
                       "stages": [[{"type": "later"}]]}):
            with pytest.raises(NotImplementedError, match="item 99"):
                build_workflow("x", [{"type": "embedding", "vocab": 4,
                                      "dim": 4}, layer])
    finally:
        del standard.PENDING_TYPES["later"]


def test_evaluator_builds_but_names_training_slice():
    """The training slice has come: the config's optimizer is built and
    the evaluator computes the masked softmax cross-entropy."""
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.ops import optimizers
    sw = StandardWorkflow({"layers": induction_layers(),
                           "optimizer": "adam",
                           "optimizer_args": {"lr": 1e-3}})
    assert isinstance(sw.optimizer, optimizers.Adam)
    assert float(sw.optimizer.schedule(0)) == pytest.approx(1e-3)
    logits = torch.tensor([[2.0, 0.0], [0.0, 2.0], [5.0, 0.0]])
    labels = torch.tensor([0, 0, 1], dtype=torch.int32)
    mask = torch.tensor([1.0, 1.0, 0.0])
    loss, _ = sw.workflow.evaluator.apply({}, {}, [logits, labels, mask],
                                          Context())
    ref = torch.nn.functional.cross_entropy(logits[:2], labels[:2].long())
    assert float(loss) == pytest.approx(float(ref), rel=1e-6)
    mets = sw.workflow.evaluator.metrics({}, {}, [logits, labels, mask],
                                         Context())
    assert (float(mets["n_err"]), float(mets["n_samples"])) == (1.0, 2.0)
