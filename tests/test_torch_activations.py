"""The port's ReLU against the JAX package's at the tie: the forward is
``torch.clamp_min`` bit for bit, and the gradient at exactly 0 is 0.5,
as ``jax.grad`` of ``jnp.maximum(x, 0)`` gives it (1 above, 0 below),
exactly, in float32 and bfloat16; it reaches ``conv_relu``,
``all2all_relu`` and ``ffn``."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from veles_tpu.ops.activations import relu as jax_relu  # noqa: E402
from veles_tpu_torch.ops.activations import relu  # noqa: E402


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu_gradient_at_the_tie_matches_jax_exactly(dtype):
    x = np.asarray([-1.0, 0.0, 1.0], np.float32)
    want = jax.grad(lambda v: jnp.sum(jax_relu(v)))(
        jnp.asarray(x, dtype))
    xt = torch.tensor(x, dtype=getattr(torch, dtype), requires_grad=True)
    y = relu(xt)
    (g,) = torch.autograd.grad(y.sum(), xt)
    assert g.dtype == xt.dtype
    assert g.float().tolist() == np.asarray(want, np.float32).tolist() \
        == [0.0, 0.5, 1.0]
    assert torch.equal(y.detach(), torch.clamp_min(xt.detach(), 0))


def test_relu_forward_bitwise_and_cotangent_scaled():
    """Forward bitwise ``clamp_min`` over finite values including zeros
    of both signs and the extremes; the backward multiplies the incoming
    cotangent by the JAX factor, here against ``jax.vjp``."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(np.float32)
    x[::7] = 0.0
    x[1::11] = -0.0
    x[:4] = [np.finfo(np.float32).max, -np.finfo(np.float32).max,
             np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny]
    ct = rng.standard_normal(4096).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = relu(xt)
    assert y.detach().numpy().tobytes() == torch.clamp_min(
        torch.from_numpy(x), 0).numpy().tobytes()
    (g,) = torch.autograd.grad(y, xt, torch.from_numpy(ct))
    _, vjp = jax.vjp(jax_relu, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(ct))
    assert g.numpy().tobytes() == np.asarray(want).tobytes()
