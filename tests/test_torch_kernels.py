"""The port's kernel modules on the CPU: the plain PyTorch versions of the
flash-attention forward and the paged-attention decode against the JAX
package's Pallas kernels run in interpret mode, on the same numpy inputs
(float32).  Tolerances are tests/test_pallas.py's: flash 2e-4/2e-5
(2e-5/2e-6 with a window or GQA), paged decode 1e-5/1e-6 — the two sides
sum in different orders, so they agree to rounding, not bitwise.

On a CPU tensor each wrapper must take its plain version and count no
kernel launch; the CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from veles_tpu.ops import pallas_kernels as pk  # noqa: E402
from veles_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from veles_tpu_torch.ops.kernels import paged_attention as pa  # noqa: E402

torch.set_num_threads(2)

FLASH_TOL = dict(rtol=2e-4, atol=2e-5)
FLASH_TIGHT = dict(rtol=2e-5, atol=2e-6)     # window / GQA (test_pallas)
PAGED_TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_flash(q, k, v, causal, window=None):
    out, lse = pk._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=None, block_q=16, block_k=16, interpret=True, window=window,
        return_lse=True)
    B, Tq, H, _ = q.shape
    lse = np.asarray(lse)[:, :Tq, 0].reshape(B, H, Tq)
    return np.asarray(out), lse


def _qkv(rng, B, Tq, Tk, H, Hk, D):
    q = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, Hk, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, Hk, D)).astype(np.float32)
    return q, k, v


FLASH_CASES = [
    # (B, Tq, Tk, H, Hk, D, causal, window, tol)
    (2, 48, 48, 2, 2, 16, True, None, FLASH_TOL),
    (2, 48, 48, 2, 2, 16, False, None, FLASH_TOL),
    (1, 37, 37, 1, 1, 8, True, None, FLASH_TOL),       # ragged T
    (1, 24, 40, 2, 2, 8, False, None, FLASH_TOL),      # Tq != Tk
    (1, 96, 96, 2, 2, 16, True, 32, FLASH_TIGHT),      # window
    (1, 100, 100, 2, 2, 16, True, 16, FLASH_TIGHT),    # window, ragged
    (1, 64, 64, 4, 2, 16, True, None, FLASH_TIGHT),    # GQA G=2
    (1, 64, 64, 8, 2, 16, True, None, FLASH_TIGHT),    # GQA G=4
    (1, 96, 96, 4, 2, 16, True, 32, FLASH_TIGHT),      # GQA + window
]


@pytest.mark.parametrize(
    "B,Tq,Tk,H,Hk,D,causal,window,tol", FLASH_CASES,
    ids=["causal", "full", "ragged", "cross", "window", "window_ragged",
         "gqa2", "gqa4", "gqa_window"])
def test_flash_plain_matches_jax_kernel(rng, B, Tq, Tk, H, Hk, D, causal,
                                        window, tol):
    q, k, v = _qkv(rng, B, Tq, Tk, H, Hk, D)
    ref_out, ref_lse = _jax_flash(q, k, v, causal, window)
    out, lse = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, block_k=16)
    np.testing.assert_allclose(out.numpy(), ref_out, **tol)
    np.testing.assert_allclose(lse.numpy(), ref_lse, **tol)


def test_flash_wrapper_takes_plain_version_on_cpu(rng):
    q, k, v = _qkv(rng, 1, 40, 40, 4, 2, 16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = fa.launches.count
    out, lse = fa.flash_attention(tq, tk, tv, True, None, 8)
    ref, ref_lse = fa.flash_attention_plain(tq, tk, tv, causal=True,
                                            window=8)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert fa.launches.count == before


def test_flash_window_one_and_empty_rows():
    """window=1 leaves each query only its own key (out == v), and with
    no key at all the -1e30 masking gives 0 with a finite lse, never NaN
    — the TPU kernel's finalize contract."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 4, 1, 8), generator=gen) for _ in range(3))
    out, _ = fa.flash_attention_plain(q, k, v, causal=True, window=1)
    torch.testing.assert_close(out, v, rtol=0, atol=1e-6)
    out, lse = fa.flash_attention_plain(q, k[:, :0], v[:, :0],
                                        causal=False)
    assert torch.all(out == 0) and torch.all(torch.isfinite(lse))


def test_flash_validation():
    q = torch.ones(1, 32, 4, 8)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, q, q, False, None, 8)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, q[:, :, :3], q[:, :, :3], True)


# -- paged-attention decode -------------------------------------------------

def _paged_case(rng, B=3, Hk=2, G=2, Dh=8, psz=4, n_ptab=5):
    """tests/test_pallas.py:282 shapes: per-slot page tables over a pool
    with one scratch row, mixed per-row positions, GQA grouping."""
    H = Hk * G
    rows = B * n_ptab + 1
    pool_k = rng.standard_normal((rows, psz, Hk, Dh)).astype(np.float32)
    pool_v = rng.standard_normal((rows, psz, Hk, Dh)).astype(np.float32)
    ptab = rng.permutation(rows - 1)[:B * n_ptab].reshape(
        B, n_ptab).astype(np.int32)
    pos = rng.integers(0, n_ptab * psz, B).astype(np.int32)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    return q, pool_k, pool_v, ptab, pos


def _both(q, pool_k, pool_v, ptab, pos, window=None, Hk=2, psz=4):
    ref = pk.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(ptab), jnp.asarray(pos), page_size=psz, n_kv_heads=Hk,
        window=window, interpret=True)
    out = pa.paged_attention_decode(
        torch.from_numpy(q), torch.from_numpy(pool_k),
        torch.from_numpy(pool_v), torch.from_numpy(ptab),
        torch.from_numpy(pos), page_size=psz, n_kv_heads=Hk, window=window)
    return out.numpy(), np.asarray(ref)


def test_paged_plain_matches_jax_kernel_mixed_positions(rng):
    before = pa.launches.count
    out, ref = _both(*_paged_case(rng))
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **PAGED_TOL)
    assert pa.launches.count == before       # CPU: plain version only


@pytest.mark.parametrize("window", [None, 6], ids=["full", "window"])
def test_paged_plain_matches_jax_kernel_window_and_edges(rng, window):
    q, pool_k, pool_v, ptab, _ = _paged_case(rng)
    L = ptab.shape[1] * 4
    pos = np.asarray([0, L - 1, 7], np.int32)
    out, ref = _both(q, pool_k, pool_v, ptab, pos, window=window)
    np.testing.assert_allclose(out, ref, **PAGED_TOL)


def test_paged_plain_matches_jax_kernel_scratch_rows(rng):
    q, pool_k, pool_v, ptab, _ = _paged_case(rng, B=2, n_ptab=4)
    ptab[:, 2:] = pool_k.shape[0] - 1          # span = 2 pages per row
    pos = np.asarray([3, 6], np.int32)
    out, ref = _both(q, pool_k, pool_v, ptab, pos)
    np.testing.assert_allclose(out, ref, **PAGED_TOL)


@pytest.mark.parametrize("window", [None, 3], ids=["full", "window"])
def test_paged_plain_nan_row_for_corrupt_live_entry(rng, window):
    """A page-table entry outside the pool makes its row NaN when the
    entry is live (the CUDA kernel's contract); entries past the span, or
    before a window, are never read and change nothing."""
    q, pool_k, pool_v, ptab, _ = _paged_case(rng, B=3, n_ptab=5)
    rows = pool_k.shape[0]
    pos = torch.tensor([6, 17, 2], dtype=torch.int32)
    args = [torch.from_numpy(a) for a in (q, pool_k, pool_v)]
    kw = dict(page_size=4, n_kv_heads=2, window=window)
    good = pa.paged_attention_decode_plain(*args, torch.from_numpy(ptab),
                                           pos, **kw)
    bad = ptab.copy()
    bad[0, 1] = rows + 2          # row 0 (pos 6): page 1 is live
    bad[2, 4] = -1                # row 2 (pos 2): past its span
    if window is not None:
        bad[1, 0] = -7            # row 1 (pos 17): before its window
    out = pa.paged_attention_decode_plain(*args, torch.from_numpy(bad), pos,
                                          **kw)
    assert torch.isnan(out[0]).all()
    assert torch.equal(out[1:], good[1:])


def test_paged_plain_matches_jax_kernel_gqa4(rng):
    out, ref = _both(*_paged_case(rng, B=4, Hk=1, G=4, Dh=16), Hk=1)
    np.testing.assert_allclose(out, ref, **PAGED_TOL)


def test_paged_validation(rng):
    q, pool_k, pool_v, ptab, pos = map(torch.from_numpy, _paged_case(rng))
    with pytest.raises(ValueError, match="page size"):
        pa.paged_attention_decode(q, pool_k, pool_v, ptab, pos,
                                  page_size=8, n_kv_heads=2)
    with pytest.raises(ValueError, match="kv heads"):
        pa.paged_attention_decode(q, pool_k, pool_v, ptab, pos,
                                  page_size=4, n_kv_heads=4)
