"""Decoding and serving chains with mixture-of-experts units and pipeline
stacks in the port (runtime/generate.py, runtime/engine.py) on the CPU,
on float32 weights shared with the JAX package.

Against JAX: greedy ``generate()`` of tests/test_generate.py's
``moe_block``, ``moe_in_stack`` and ``recurrent_in_stack`` chains
(:115-147) token for token, and beam search's tokens (scores rtol
1e-5).  Within the port, bitwise: the engine's tokens equal
``generate()``'s on the paged and the dense layout, greedy and sampled,
a megastep (N=4) engine and a speculative (k=3) engine equal the N=1
engine, and a stack's sub-units decode from their own caches (the stack
flattened into the plan's handlers).  MoE decodes dropless
(``capacity_factor = n_experts``, veles_tpu/runtime/generate.py:494-506)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.runtime.generate import generate as jax_generate  # noqa: E402
from veles_tpu.runtime.generate import (  # noqa: E402
    generate_beam as jax_generate_beam)
from veles_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from veles_tpu_torch.runtime.generate import (  # noqa: E402
    DecodePlan, generate, generate_beam)

from _torch_helpers import build_pair  # noqa: E402

torch.set_num_threads(2)

V = 12

#: tests/test_generate.py:115-147
CHAINS = {
    "recurrent_in_stack": [
        {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
        {"type": "pipeline_stack", "stages": [
            [{"type": "gru", "hidden": 16}],
            [{"type": "rnn", "hidden": 16}, {"type": "layer_norm"}],
        ], "name": "stack"},
        {"type": "seq_last", "name": "last"},
        {"type": "softmax", "output_size": V, "name": "out"}],
    "moe_block": [
        {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
        {"type": "attention", "n_heads": 2, "rope": True,
         "residual": True, "name": "a1"},
        {"type": "moe", "n_experts": 4, "d_hidden": 32, "top_k": 2,
         "capacity_factor": 8.0, "name": "moe"},
        {"type": "seq_last", "name": "last"},
        {"type": "softmax", "output_size": V, "name": "out"}],
    "moe_in_stack": [
        {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
        {"type": "pipeline_stack", "stages": [
            [{"type": "attention", "n_heads": 2, "rope": True,
              "residual": True}],
            [{"type": "moe", "n_experts": 2, "d_hidden": 32,
              "top_k": 1, "capacity_factor": 4.0},
             {"type": "layer_norm"}],
        ], "name": "stack"},
        {"type": "seq_last", "name": "last"},
        {"type": "softmax", "output_size": V, "name": "out"}],
}

#: induction_lm_pp_moe.json's stack at a narrow width: two attention
#: stages (a dropout in each, the identity at decode), the MoE stage
#: with the training capacity (decode overrides it), an LM head
PP_MOE = [
    {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
    {"type": "pipeline_stack", "name": "stack", "n_microbatches": 4,
     "stages": [
         [{"type": "attention", "n_heads": 2, "rope": True,
           "residual": True}, {"type": "dropout", "dropout_ratio": 0.05},
          {"type": "layer_norm"}],
         [{"type": "attention", "n_heads": 2, "rope": True,
           "residual": True}, {"type": "layer_norm"}],
         [{"type": "moe", "n_experts": 4, "d_hidden": 32, "top_k": 2,
           "aux_weight": 0.01, "name": "moe"}, {"type": "layer_norm"}]]},
    {"type": "seq_last", "name": "last"},
    {"type": "softmax", "output_size": V, "name": "out"}]


@pytest.fixture(scope="module")
def pp_moe():
    return build_pair(PP_MOE, B=2, T=6, seed=9)


def _engine(lm, **kw):
    kw.setdefault("window_ms", 0.0)
    return DecodeEngine(lm[2], lm[3], device="cpu", **kw)


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_generate_matches_jax(rng, chain):
    """Greedy tokens equal JAX's ``generate()``; beam search's tokens
    too, its scores at rtol 1e-5."""
    jwf, jws, pwf, pws = build_pair(CHAINS[chain], B=2, T=8, seed=0)
    prompt = rng.integers(0, V, (2, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        generate(pwf, pws, prompt, 7).numpy(),
        np.asarray(jax_generate(jwf, jws, prompt, 7)))
    jt, js = jax_generate_beam(jwf, jws, prompt[:1], 5, beams=3)
    pt, ps = generate_beam(pwf, pws, prompt[:1], 5, beams=3)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5)


def test_plan_flattens_the_stack(pp_moe):
    """The stack's sub-units are the plan's handlers, in stage order,
    each reading its params under ``stack/s<i>``."""
    plan = DecodePlan(pp_moe[2])
    assert [(k, u.name) for k, u in plan.seq_handlers] == [
        ("attn", "s0u0_attention"), ("pointwise", "s0u1_dropout"),
        ("pointwise", "s0u2_layer_norm"), ("attn", "s1u0_attention"),
        ("pointwise", "s1u1_layer_norm"), ("moe", "moe"),
        ("pointwise", "s2u1_layer_norm")]
    assert plan.param_paths["moe"] == ("stack", "s2", "moe")
    assert sorted(plan.attn_keys()) == ["s0u0_attention", "s1u0_attention"]


def test_pp_moe_chain_matches_jax(rng, pp_moe):
    jwf, jws, pwf, pws = pp_moe
    prompt = rng.integers(0, V, (3, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        generate(pwf, pws, prompt, 9).numpy(),
        np.asarray(jax_generate(jwf, jws, prompt, 9)))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_engine_equals_generate(rng, pp_moe, paged):
    """Mixed prompt lengths on a 4-slot engine, greedy and sampled: every
    request's tokens are its ``generate()``'s."""
    _, _, pwf, pws = pp_moe
    shapes = [(3, 5), (7, 4), (11, 6), (4, 3), (9, 5)]
    prompts = [rng.integers(0, V, (1, p)).astype(np.int32)
               for p, _ in shapes]
    kws = [{}, {"temperature": 1.3, "top_k": 5, "seed": 7}]
    eng = _engine(pp_moe, slots=4, l_max=48, paged=paged).start()
    try:
        for kw in kws:
            reqs = [eng.submit(pr[0], n, **kw)
                    for pr, (_, n) in zip(prompts, shapes)]
            for r, pr, (_, n) in zip(reqs, prompts, shapes):
                assert r.done.wait(180) and r.error is None
                np.testing.assert_array_equal(
                    r.result, generate(pwf, pws, pr, n, **kw).numpy()[0],
                    err_msg=str(kw))
        st = eng.stats()
    finally:
        eng.stop()
    assert st["compile"]["recompiles"] == 0


def test_megastep_and_speculative_equal_n1(rng, pp_moe):
    """Megastep (N=4) and speculative verify (k=3) engines give the N=1
    engine's tokens bit for bit, greedy and sampled."""
    _, _, pwf, pws = pp_moe
    prompt = np.resize(rng.integers(0, V, 4), 11).astype(np.int32)[None]
    cases = [{}, {"temperature": 1.4, "top_k": 5, "seed": 11}]
    runs = {}
    for name, kw in (("n1", {}), ("mega", {"megastep": 4}),
                     ("spec", {"spec": True, "spec_k": 3})):
        eng = _engine(pp_moe, slots=1, l_max=64, **kw).start()
        try:
            runs[name] = [eng.generate(prompt, 18, timeout=180, **c)
                          for c in cases]
            st = eng.stats()
        finally:
            eng.stop()
        if name == "mega":
            assert st["megastep"]["mega_dispatches"] > 0, st
        if name == "spec":
            assert st["spec"]["verify_steps"] > 0, st
    for c, ref in zip(cases, runs["n1"]):
        np.testing.assert_array_equal(
            ref, generate(pwf, pws, prompt, 18, **c).numpy())
    for name in ("mega", "spec"):
        for a, b in zip(runs[name], runs["n1"]):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_hot_swap_into_a_stack_engine(pp_moe):
    """The served tree nests (``stack/s<i>/<unit>``): a swap writes into
    the served tensors in place and the engine then decodes the new
    weights' tokens."""
    from veles_tpu_torch.ops.optimizers import tree_leaves, tree_map
    _, _, pwf, pws = pp_moe
    other = build_pair(PP_MOE, B=2, T=6, seed=10)[3]
    prompt = np.arange(5, dtype=np.int32)[None] % V
    eng = _engine(pp_moe, slots=2, l_max=32).start()
    try:
        ptrs = [t.data_ptr() for t in tree_leaves(eng.params)]
        eng.swap_params(tree_map(lambda t: t.clone(), other["params"]))
        got = eng.generate(prompt, 6, timeout=120)
        assert [t.data_ptr() for t in tree_leaves(eng.params)] == ptrs
    finally:
        eng.stop()
    np.testing.assert_array_equal(
        got, generate(pwf, other, prompt, 6).numpy())
