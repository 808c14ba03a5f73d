"""The decode engine's guard on prompt token ids, against the JAX
package on shared float32 weights: an id outside ``[0, input_vocab)``
(the REST guard's bound) is refused by ``DecodeEngine.submit`` with
ValueError before anything is enqueued (on the card it would reach the
embedding gather as a device-side assert and end the scheduler), and the
engine then serves the next valid request token for token as the JAX
package's ``generate()`` does."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from veles_tpu.runtime.generate import generate as jax_generate  # noqa: E402
from veles_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402

from _torch_helpers import (build_pair, induction_layers,  # noqa: E402
                            narrow_bench_layers, tokens, vocab_of)

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["induction_lm", "narrow_bench_lm"])
def model(request):
    layers = (induction_layers() if request.param == "induction_lm"
              else narrow_bench_layers())
    return (layers,) + build_pair(layers, B=2, T=12, seed=11)


def _port_engine(pwf, pws, **kw):
    return DecodeEngine(pwf, pws, slots=3, l_max=32, window_ms=0.0,
                        device="cpu", **kw).start()


def test_engine_refuses_out_of_vocab_prompt_then_serves(rng, model):
    """An id outside [0, input_vocab) is refused by ``submit`` with
    ValueError before anything is enqueued (on the card it would reach
    the embedding gather as a device-side assert); the engine then serves
    the next valid request as the JAX package's does."""
    layers, jwf, jws, pwf, pws = model
    vocab = vocab_of(layers)
    prompt = tokens(rng, (1, 5), vocab)
    ref = np.asarray(jax_generate(jwf, jws, prompt, 4))
    eng = _port_engine(pwf, pws)
    try:
        for bad in ([1, 2, vocab, 3], [-1, 2], [2 ** 33]):
            with pytest.raises(ValueError, match=r"\[0, %d\)" % vocab):
                eng.submit(np.asarray(bad), 4)
        st = eng.stats()
        assert st["queue_depth"] == st["admitted"] == st["rejected"] == 0
        np.testing.assert_array_equal(eng.generate(prompt, 4, timeout=120),
                                      ref)
    finally:
        eng.stop()
