"""Greedy decode of the port against the JAX package on shared float32
weights: the port's ``generate()``, its engine on three cache layouts
(paged read through the paged-decode wrapper — on the CPU its plain
version —, paged gather, dense), the JAX ``generate()`` and the JAX
``DecodeEngine`` must emit identical tokens.  Sampled streams cannot
match across frameworks (threefry vs torch generators); inside the port
the engine must reproduce ``generate()`` bitwise for the same seed."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from veles_tpu.runtime.engine import DecodeEngine as JaxEngine  # noqa: E402
from veles_tpu.runtime.generate import generate as jax_generate  # noqa: E402
from veles_tpu_torch.ops.kernels import paged_attention  # noqa: E402
from veles_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from veles_tpu_torch.runtime.generate import generate  # noqa: E402

from _torch_helpers import (build_pair, induction_layers,  # noqa: E402
                            narrow_bench_layers, tokens, vocab_of)

torch.set_num_threads(2)

LAYOUTS = {"paged_kernel": dict(paged=True, paged_kernel=True),
           "paged_gather": dict(paged=True, paged_kernel=False),
           "dense": dict(paged=False)}


@pytest.fixture(scope="module", params=["induction_lm", "narrow_bench_lm"])
def model(request):
    layers = (induction_layers() if request.param == "induction_lm"
              else narrow_bench_layers())
    return (layers,) + build_pair(layers, B=2, T=12, seed=11)


def _port_engine(pwf, pws, **kw):
    return DecodeEngine(pwf, pws, slots=3, l_max=32, window_ms=0.0,
                        device="cpu", **kw).start()


def test_greedy_tokens_identical_across_packages(rng, model):
    layers, jwf, jws, pwf, pws = model
    prompt = tokens(rng, (2, 6), vocab_of(layers))
    n = 9
    ref = np.asarray(jax_generate(jwf, jws, prompt, n))
    np.testing.assert_array_equal(generate(pwf, pws, prompt, n).numpy(),
                                  ref)
    jeng = JaxEngine(jwf, jws, slots=2, l_max=32, window_ms=0.0).start()
    try:
        np.testing.assert_array_equal(jeng.generate(prompt, n, timeout=120),
                                      ref)
    finally:
        jeng.stop()
    for name, kw in LAYOUTS.items():
        eng = _port_engine(pwf, pws, **kw)
        try:
            launches = paged_attention.launches.count
            out = eng.generate(prompt, n, timeout=120)
            np.testing.assert_array_equal(out, ref, err_msg=name)
            # CPU tensors: the wrapper ran its plain version, no kernel
            assert paged_attention.launches.count == launches
            st = eng.stats()
            assert st["retired"] == 2 and st["decode_tokens"] > 0, st
            if kw["paged"]:
                assert st["pages"]["used"] == 0, st   # all released
        finally:
            eng.stop()


def test_eos_padding_matches_jax(rng, model):
    layers, jwf, jws, pwf, pws = model
    prompt = tokens(rng, (2, 5), vocab_of(layers))
    free = np.asarray(jax_generate(jwf, jws, prompt, 6))
    eos = int(free[0, 6])                  # row 0 emits it at step 2
    ref = np.asarray(jax_generate(jwf, jws, prompt, 6, eos_id=eos))
    out = generate(pwf, pws, prompt, 6, eos_id=eos).numpy()
    np.testing.assert_array_equal(out, ref)
    eng = _port_engine(pwf, pws)
    try:
        np.testing.assert_array_equal(
            eng.generate(prompt, 6, eos_id=eos, timeout=120), ref)
    finally:
        eng.stop()


@pytest.mark.parametrize("B", [1, 2])
def test_sampled_engine_is_generate_bitwise(rng, model, B):
    layers, _, _, pwf, pws = model
    prompt = tokens(rng, (B, 4), vocab_of(layers))
    kw = dict(temperature=0.9, top_k=5, top_p=0.9, seed=7)
    ref = generate(pwf, pws, prompt, 7, **kw).numpy()
    eng = _port_engine(pwf, pws)
    try:
        np.testing.assert_array_equal(
            eng.generate(prompt, 7, timeout=120, **kw), ref)
    finally:
        eng.stop()
    assert (ref[:, 4:] >= 0).all() and (ref < vocab_of(layers)).all()
