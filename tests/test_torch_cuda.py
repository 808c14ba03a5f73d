"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a Hopper card (capability 9.0) and skips without
one.  The file imports neither JAX nor the JAX package, so it runs on a
machine without JAX; ``--noconftest`` keeps pytest from loading
tests/conftest.py, which imports JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

TF32 is off, so float32 products run in full float32.  Tolerances are
chip_smoke.py's: max |kernel - plain| 1e-4 in float32, 2e-2 in bfloat16
(one bf16 ulp near 1), lse 1e-3; paged decode 1e-4.
"""

import pytest

torch = pytest.importorskip("torch")

from veles_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from veles_tpu_torch.ops.kernels import paged_attention as pa  # noqa: E402

pytestmark = pytest.mark.cuda

FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-3
PAGED_TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper CUDA card (capability 9.0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "B,Tq,Tk,H,Hk,D,dtype,causal,window",
    [(2, 200, 200, 4, 4, 16, torch.float32, True, None),
     (2, 200, 200, 4, 4, 16, torch.bfloat16, True, None),
     (2, 300, 300, 8, 2, 64, torch.float32, True, 100),
     (2, 257, 513, 8, 8, 64, torch.bfloat16, False, None)],
    ids=["D16_f32", "D16_bf16", "D64_f32_gqa_window", "D64_bf16_cross"])
def test_flash_kernel_matches_plain(card, B, Tq, Tk, H, Hk, D, dtype, causal,
                                    window):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((B, Tq, H, D), generator=gen).to(card, dtype)
    k = torch.randn((B, Tk, Hk, D), generator=gen).to(card, dtype)
    v = torch.randn((B, Tk, Hk, D), generator=gen).to(card, dtype)
    before = fa.launches.count
    out, lse = fa.flash_attention(q, k, v, causal, None, window)
    assert fa.launches.count == before + 1
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
    assert out.dtype == dtype and out.shape == q.shape
    assert float((out.float() - ref.float()).abs().max()) <= FLASH_TOL[dtype]
    assert float((lse - ref_lse).abs().max()) <= LSE_TOL


def _paged(card, H, Hk, Dh, q_dtype, pos, S=4, psz=16, n_ptab=16):
    gen = torch.Generator().manual_seed(1)
    rows = S * n_ptab + 1
    pk = torch.randn((rows, psz, Hk, Dh), generator=gen)
    pv = torch.randn((rows, psz, Hk, Dh), generator=gen)
    ptab = torch.randperm(rows - 1, generator=gen)[:S * n_ptab].reshape(
        S, n_ptab).to(torch.int32)
    for b, p in enumerate(pos):          # entries past each span: scratch
        ptab[b, p // psz + 1:] = rows - 1
    q = torch.randn((S, H, Dh), generator=gen).to(q_dtype)
    return tuple(t.to(card) for t in (q, pk, pv, ptab,
                                      torch.tensor(pos, dtype=torch.int32)))


@pytest.mark.parametrize(
    "H,Hk,Dh,q_dtype,window",
    [(4, 4, 16, torch.float32, None), (4, 4, 16, torch.bfloat16, 20),
     (8, 8, 64, torch.bfloat16, None), (8, 2, 64, torch.float32, 40)],
    ids=["D16_f32", "D16_bf16_window", "D64_bf16", "D64_f32_gqa_window"])
def test_paged_kernel_matches_plain(card, H, Hk, Dh, q_dtype, window):
    args = _paged(card, H, Hk, Dh, q_dtype, [0, 255, 17, 100])
    before = pa.launches.count
    out = pa.paged_attention_decode(*args, page_size=16, n_kv_heads=Hk,
                                    window=window)
    assert pa.launches.count == before + 1
    ref = pa.paged_attention_decode_plain(*args, page_size=16,
                                          n_kv_heads=Hk, window=window)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert float((out - ref).abs().max()) <= PAGED_TOL


def test_paged_kernel_corrupt_live_entry_gives_nan_row(card):
    q, pk, pv, ptab, pos = _paged(card, 8, 8, 64, torch.float32,
                                  [0, 255, 17, 100])
    ptab[2, 1] = pk.shape[0] + 3         # row 2 (pos 17): a live page
    ptab[3, -1] = -1                     # row 3 (pos 100): past its span
    out = pa.paged_attention_decode(q, pk, pv, ptab, pos, page_size=16,
                                    n_kv_heads=8)
    ref = pa.paged_attention_decode_plain(q, pk, pv, ptab, pos,
                                          page_size=16, n_kv_heads=8)
    assert bool(torch.isnan(out[2]).all()) and bool(torch.isnan(ref[2]).all())
    keep = [0, 1, 3]
    assert bool(torch.isfinite(out[keep]).all())
    assert float((out[keep] - ref[keep]).abs().max()) <= PAGED_TOL


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(card):
    q, pk, pv, ptab, pos = _paged(card, 8, 8, 64, torch.float32, [5, 6, 7, 8])
    with pytest.raises(TypeError, match="float32 pools"):
        pa.paged_attention_decode(q, pk.bfloat16(), pv.bfloat16(), ptab, pos,
                                  page_size=16, n_kv_heads=8)
    x = torch.zeros((1, 8, 2, 32), device=card)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(x, x, x, True)
