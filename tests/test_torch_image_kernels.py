"""The image slice's kernels, plain PyTorch versions on the CPU, against
the JAX package's Pallas kernels in interpret mode (as
tests/test_pallas.py runs them).

* ``fused_dropout``: bitwise equal, forward and gradient, at rates 0.1,
  0.5 and 0.9, on a 1-D input, with a column count that is not a
  multiple of 128, with more than 8192 columns (the JAX kernel's
  column-block branch) and in bfloat16.
* ``mean_disp_normalize``: bitwise equal to the Pallas kernel and to the
  XLA form (``veles_tpu/ops/normalize.py``), uint8 and float32 input,
  including a feature count that is not a multiple of 128.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from veles_tpu.ops import normalize as jnorm  # noqa: E402
from veles_tpu.ops import pallas_kernels as pk  # noqa: E402
from veles_tpu_torch.ops import normalize as pnorm  # noqa: E402
from veles_tpu_torch.ops.kernels import fused_dropout as fd  # noqa: E402
from veles_tpu_torch.ops.kernels import mean_disp as md  # noqa: E402

torch.set_num_threads(2)


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _to_torch(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _from_torch(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits(t.detach().numpy())


def _from_jax(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16)
    return _bits(a)


DROPOUT_CASES = {
    # AlexNet's drop6/drop7 row layout, narrow
    "r0.5_8x256": ((8, 256), 0.5, "float32", 12345),
    "r0.1_8x256": ((8, 256), 0.1, "float32", 7),
    "r0.9_8x256": ((8, 256), 0.9, "float32", 2 ** 32 - 1),
    "1d_1000": ((1000,), 0.5, "float32", 3),
    "cols_300": ((5, 7, 300), 0.4, "float32", 99),
    "cols_8320": ((3, 8320), 0.5, "float32", 0xC0FFEE),
    "bf16_16x200": ((16, 200), 0.3, "bfloat16", 11),
    # NHWC conv activations
    "nhwc_2x5x5x8": ((2, 5, 5, 8), 0.5, "float32", 5),
}


@pytest.mark.parametrize("case", list(DROPOUT_CASES))
def test_fused_dropout_plain_matches_pallas_bitwise(case):
    shape, rate, dt, seed = DROPOUT_CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    seed_j = jnp.uint32(seed)
    jout, vjp = jax.vjp(lambda a: pk.fused_dropout(a, seed_j, rate, 256,
                                                   True), jx)
    (jgrad,) = vjp(jg)

    tx = _to_torch(x, tdt).requires_grad_(True)
    tout = fd.fused_dropout(tx, seed, rate)
    (tgrad,) = torch.autograd.grad(tout, tx, _to_torch(g, tdt))
    assert tout.dtype == tdt and tout.shape == tuple(shape)
    np.testing.assert_array_equal(_from_torch(tout), _from_jax(jout))
    np.testing.assert_array_equal(_from_torch(tgrad), _from_jax(jgrad))
    # the plain version alone gives the same bits
    np.testing.assert_array_equal(
        _from_torch(fd.fused_dropout_plain(_to_torch(x, tdt), seed, rate)),
        _from_jax(jout))
    kept = np.asarray(jout, np.float32) != 0
    assert 0.0 < kept.mean() < 1.0


def test_fused_dropout_host_helpers_match_the_kernel_math():
    """splitmix32 on the host equals the JAX kernel's; rate and scale are
    the float32 values the JAX kernel divides and compares by."""
    for z in (0, 1, 0x9E3779B9, 2 ** 32 - 1, 123456789):
        ref = int(pk._splitmix32(jnp.uint32(z)))
        assert fd.splitmix32(z) == ref
    for rate in (0.1, 0.3, 0.5, 0.9):
        r32, scale = fd.rate_and_scale(rate)
        assert r32 == np.float32(rate)
        ref = jnp.float32(1.0) / (1.0 - rate)
        assert np.asarray(scale).view(np.uint32) == np.asarray(
            ref, np.float32).view(np.uint32)
    for bad in (-0.1, 1.0, 1.5):
        with pytest.raises(ValueError, match="rate"):
            fd.rate_and_scale(bad)


def test_fused_dropout_wrapper_takes_the_plain_route_on_the_cpu():
    x = torch.ones(4, 8)
    before = fd.launches.count
    y = fd.fused_dropout(x, 1, 0.5)
    assert fd.launches.count == before
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}


MEAN_DISP_CASES = {
    "uint8_4x13x13x3": ((4, 13, 13, 3), "uint8"),
    "f32_4x13x13x3": ((4, 13, 13, 3), "float32"),
    "uint8_3x19x19x3": ((3, 19, 19, 3), "uint8"),
    "uint8_2x4100": ((2, 4100), "uint8"),
    "f32_5x7": ((5, 7), "float32"),
}


@pytest.mark.parametrize("case", list(MEAN_DISP_CASES))
def test_mean_disp_plain_matches_pallas_and_xla_bitwise(case):
    shape, dt = MEAN_DISP_CASES[case]
    rng = np.random.default_rng(len(case))
    if dt == "uint8":
        x = rng.integers(0, 256, shape).astype(np.uint8)
    else:
        x = (rng.standard_normal(shape) * 50 + 100).astype(np.float32)
    feat = shape[1:]
    mean = rng.uniform(100, 150, feat).astype(np.float32)
    rdisp = rng.uniform(0.01, 0.02, feat).astype(np.float32)
    jpal = pk.mean_disp_normalize(jnp.asarray(x), jnp.asarray(mean),
                                  jnp.asarray(rdisp), interpret=True)
    jxla = jnorm.mean_disp_normalize(jnp.asarray(x), jnp.asarray(mean),
                                     jnp.asarray(rdisp))
    args = (torch.from_numpy(x), torch.from_numpy(mean),
            torch.from_numpy(rdisp))
    for got in (md.mean_disp_normalize_plain(*args),
                md.mean_disp_normalize(*args),
                pnorm.mean_disp_normalize(*args)):
        assert got.dtype == torch.float32 and got.shape == shape
        np.testing.assert_array_equal(_from_torch(got), _from_jax(jpal))
        np.testing.assert_array_equal(_from_torch(got), _from_jax(jxla))


def test_mean_disp_refuses_mismatched_statistics():
    x = torch.zeros(2, 4, 4, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="mean"):
        md.mean_disp_normalize(x, torch.zeros(4, 4), torch.ones(4, 4, 3))
    with pytest.raises(NotImplementedError, match="float32"):
        pnorm.mean_disp_normalize(x, torch.zeros(4, 4, 3),
                                  torch.ones(4, 4, 3), dtype=torch.bfloat16)
