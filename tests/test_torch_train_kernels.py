"""The training path's kernel modules on the CPU against the JAX package:
the flash-attention backward (the plain dQ and dK/dV versions, and the
``autograd.Function`` that joins them to the forward) against the
gradients of ``pk.flash_attention`` run in interpret mode, and the row
gather against ``pk.gather_rows(..., interpret=True)``, on the same numpy
inputs.

Tolerances: flash gradients rtol 2e-3 / atol 2e-4 in float32 (the
bound of tests/test_pallas.py's gradient tests; the two sides sum in
different orders); the gather bitwise.  On a CPU tensor every wrapper
takes its plain version and counts no launch; the CUDA kernels are held
against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from veles_tpu.ops import pallas_kernels as pk  # noqa: E402
from veles_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from veles_tpu_torch.ops.kernels import flash_bwd_dkv as dkv  # noqa: E402
from veles_tpu_torch.ops.kernels import flash_bwd_dq as dq  # noqa: E402
from veles_tpu_torch.ops.kernels import gather_rows as gr  # noqa: E402

torch.set_num_threads(2)

GRAD_TOL = dict(rtol=2e-3, atol=2e-4)

# (B, Tq, Tk, H, Hk, D, causal, window): tests/test_pallas.py:54-91
# (causal 48, padded 37, cross 24/40), :191-203 (window) and :213-245
# (GQA G=2 and 4)
BWD_CASES = {
    "causal": (2, 48, 48, 2, 2, 16, True, None),
    "padded37": (1, 37, 37, 2, 2, 8, True, None),
    "cross24_40": (1, 24, 40, 2, 2, 8, False, None),
    "window": (1, 96, 96, 2, 2, 16, True, 32),
    "gqa2": (1, 64, 64, 4, 2, 16, True, None),
    "gqa4": (1, 64, 64, 8, 2, 16, True, None),
}


def _inputs(rng, B, Tq, Tk, H, Hk, D):
    return (rng.standard_normal((B, Tq, H, D)).astype(np.float32),
            rng.standard_normal((B, Tk, Hk, D)).astype(np.float32),
            rng.standard_normal((B, Tk, Hk, D)).astype(np.float32))


def _jax_grads(q, k, v, causal, window):
    """d/d(q, k, v) of sum(out^2) through the Pallas kernels (interpret
    mode: forward, dQ and dK/dV pallas_calls)."""
    def loss(a, b, c):
        return jnp.sum(jnp.square(pk.flash_attention(
            a, b, c, causal, None, 16, 16, True, window)))
    g = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in g]


@pytest.mark.parametrize("case", list(BWD_CASES), ids=list(BWD_CASES))
def test_autograd_function_matches_jax_kernel_grads(rng, case):
    B, Tq, Tk, H, Hk, D, causal, window = BWD_CASES[case]
    q, k, v = _inputs(rng, B, Tq, Tk, H, Hk, D)
    ref = _jax_grads(q, k, v, causal, window)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    before = (fa.launches.count, dq.launches.count, dkv.launches.count)
    out, lse = fa.flash_attention(tq, tk, tv, causal, None, window,
                                  block_k=16)
    assert not lse.requires_grad
    got = torch.autograd.grad(out.square().sum(), (tq, tk, tv))
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), r, **GRAD_TOL)
    # the CPU route: plain versions only, no kernel launch counted
    assert (fa.launches.count, dq.launches.count,
            dkv.launches.count) == before


@pytest.mark.parametrize("case", ["causal", "padded37", "cross24_40",
                                  "window", "gqa2"])
def test_plain_backward_matches_jax_kernel_grads(rng, case):
    """The plain dQ and dK/dV versions called directly, from the plain
    forward's out and lse, with dO = 2 * out (the gradient of sum(out^2))
    and delta = rowsum(dO * out)."""
    B, Tq, Tk, H, Hk, D, causal, window = BWD_CASES[case]
    q, k, v = _inputs(rng, B, Tq, Tk, H, Hk, D)
    ref = _jax_grads(q, k, v, causal, window)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                        window=window, block_k=16)
    do = 2 * out
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    kw = dict(causal=causal, scale=D ** -0.5, window=window, block_k=16)
    g_q = dq.flash_bwd_dq_plain(tq, tk, tv, do, lse, delta, **kw)
    g_k, g_v = dkv.flash_bwd_dkv_plain(tq, tk, tv, do, lse, delta, **kw)
    for g, r in zip((g_q, g_k, g_v), ref):
        np.testing.assert_allclose(g.numpy(), r, **GRAD_TOL)


def test_plain_backward_masks_rows_without_keys():
    """P is forced to 0 by the mask, never left to exp underflow: with a
    window of 1 each query sees only its own key, and a zero lse row
    (as a bogus padded row would carry) changes nothing masked."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((1, 8, 2, 16), generator=gen)
                   for _ in range(4))
    out, lse = fa.flash_attention_plain(q, k, v, causal=True, window=1)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    kw = dict(causal=True, scale=0.25, window=1)
    g_k, g_v = dkv.flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    # out == v (one live key, p = 1), so dv == do and dk == 0
    torch.testing.assert_close(g_v, do, rtol=0, atol=1e-6)
    torch.testing.assert_close(g_k, torch.zeros_like(k), rtol=0,
                               atol=1e-6)
    assert torch.all(dq.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                           **kw).abs() < 1e-6)


def test_bwd_wrappers_refuse_bad_shapes():
    x = torch.zeros(1, 8, 2, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="lse and delta"):
        dq.flash_bwd_dq(x, x, x, x, lse[:, :1], lse, causal=True,
                        scale=0.25)
    with pytest.raises(ValueError, match="multiple"):
        dkv.flash_bwd_dkv(x, x[:, :, :0], x[:, :, :0], x, lse, lse,
                          causal=True, scale=0.25)


# -- the fullbatch row gather ------------------------------------------------

GATHER_CASES = {
    # tests/test_pallas.py:134 (f32 samples of 3 x 7)
    "f32_3x7": (np.float32, (40, 3, 7), 13),
    # the LM loader's token rows (int32, T=64)
    "int32_tokens": (np.int32, (50, 64), 16),
    # per-position float32 masks of the per_position loader
    "f32_masks": (np.float32, (30, 32), 7),
}


@pytest.mark.parametrize("case", list(GATHER_CASES),
                         ids=list(GATHER_CASES))
def test_gather_plain_matches_jax_kernel_bitwise(rng, case):
    dtype, shape, m = GATHER_CASES[case]
    if np.issubdtype(dtype, np.integer):
        data = rng.integers(0, 1 << 20, shape).astype(dtype)
    else:
        data = rng.standard_normal(shape).astype(dtype)
    idx = rng.integers(0, shape[0], m).astype(np.int32)
    ref = np.asarray(pk.gather_rows(jnp.asarray(data), jnp.asarray(idx),
                                    interpret=True))
    before = gr.launches.count
    out = gr.gather_rows(torch.from_numpy(data), idx)
    assert gr.launches.count == before
    assert out.is_contiguous() and out.dtype == torch.from_numpy(data).dtype
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out.numpy().tobytes() == ref.tobytes()


def test_gather_refuses_out_of_range_indices():
    data = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    for bad in ([0, 4], [-1], [7, 1]):
        with pytest.raises(IndexError, match="out of range"):
            gr.gather_rows(data, np.asarray(bad))
    with pytest.raises(IndexError):          # the plain version alike
        gr.gather_rows_plain(data, torch.tensor([4]))
    assert gr.gather_rows(data, np.zeros(0, np.int64)).shape == (0, 3)


@pytest.mark.parametrize("row_bytes,ptrs,unit", [
    (8192, (0, 256), 16), (84, (0, 4), 4), (21, (0, 0), 1), (24, (8, 0), 8),
    (48, (16, 2), 2)])
def test_gather_copy_unit(row_bytes, ptrs, unit):
    """The kernel's copy width: the widest of 16/8/4/2/1 bytes that
    divides the row size and both base addresses."""
    assert gr.copy_unit(row_bytes, *ptrs) == unit
