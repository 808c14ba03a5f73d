"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a Hopper card (capability 9.0) and skips without
one.  The file imports neither JAX nor the JAX package, so it runs on a
machine without JAX; ``--noconftest`` keeps pytest from loading
tests/conftest.py, which imports JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

TF32 is off, so float32 products run in full float32.  Tolerances are
chip_smoke.py's: max |kernel - plain| 1e-4 in float32, 2e-2 in bfloat16
(one bf16 ulp near 1), lse 1e-3; paged decode 1e-4; the flash backward
kernels element by element, |kernel - plain| <= BWD_UNITS units u of the
dtype (bf16 2^-8, f32 2^-24) times (|plain| + its row's largest |plain|,
or the gradient's median |plain| where that is larger), and a gradient
whose exact value is 0 to BWD_UNITS units of the terms that cancel; in
float32 also within BWD_UNITS of a float64 evaluation, which stands in
for the plain version where that is the further of the two from it; the
row gather
bitwise; an attention unit's weight gradients
kernel vs plain path rtol 1e-4 of each gradient's largest entry in
float32; fused dropout (forward and gradient) and mean/disp normalize
bitwise; the one-launch batch gather bitwise; a captured train step
(``runtime/step_cache.py``) bitwise equal to the eager one over 8 steps;
the serving engine's captured decode, prefill, megastep and verify steps
bitwise equal to its eager ones (tokens, token rows and KV pool), their
replays' paged launches, and the sampler's noise bits equal to the CPU's;
the paged kernel on a bf16 pool within 1e-4 of its plain version, an
engine with a bf16 KV cache captured bitwise equal to eager, and a hot
swap into the captured graphs bitwise a fresh engine on the new weights;
a two-replica fleet of captured engines bitwise one of eager engines,
and a replica rebuilt (captured) while two others decode side by side,
every answer the reference tokens; a process whose memory poller samples
the card without pause exits cleanly; each export-path kernel's
``torch.library`` custom op bitwise its direct launch on the card and its
plain version on the CPU; a bf16 artifact exported on the card serving
the live engine's greedy tokens from its captured programs (paged
launches exact a replay, nothing built after load), refused on the CPU.
"""

import contextlib

import pytest

torch = pytest.importorskip("torch")

from unittest import mock  # noqa: E402

import numpy as np  # noqa: E402

from veles_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from veles_tpu_torch.ops.kernels import flash_bwd_dkv as dkv  # noqa: E402
from veles_tpu_torch.ops.kernels import flash_bwd_dq as dq  # noqa: E402
from veles_tpu_torch.ops.kernels import fused_dropout as fd  # noqa: E402
from veles_tpu_torch.ops.kernels import gather_rows as gr  # noqa: E402
from veles_tpu_torch.ops.kernels import mean_disp as md  # noqa: E402
from veles_tpu_torch.ops.kernels import paged_attention as pa  # noqa: E402

pytestmark = pytest.mark.cuda

FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-3
PAGED_TOL = 1e-4
BWD_UNIT = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8}
BWD_UNITS = {torch.float32: 1024.0, torch.bfloat16: 2.0}


@pytest.fixture
def card():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper CUDA card (capability 9.0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


bf16 = torch.bfloat16

f32 = torch.float32

# (B, Tq, Tk, H, Hk, D, dtype, causal, window).  bf16 runs on the
# tensor-core kernels, whose tiles are 128 query rows by 64 keys (forward)
# and 64 keys by 64 query rows (dK/dV): the edge cases cut them.  float32
# runs in 3xTF32, its forward in tiles of 16-64 query rows by 32 keys: the
# f32 edge cases cut those.
FLASH_CASES = {
    "D16_f32": (2, 200, 200, 4, 4, 16, torch.float32, True, None),
    "D16_bf16": (2, 200, 200, 4, 4, 16, bf16, True, None),
    "D64_f32_gqa_window": (2, 300, 300, 8, 2, 64, torch.float32, True, 100),
    "D64_bf16_cross": (2, 257, 513, 8, 8, 64, bf16, False, None),
    "bf16_T1": (2, 1, 1, 8, 8, 64, bf16, True, None),
    "bf16_T63": (2, 63, 63, 8, 8, 64, bf16, True, None),
    "bf16_T65": (2, 65, 65, 8, 8, 64, bf16, True, None),
    "bf16_T129": (2, 129, 129, 8, 8, 64, bf16, True, None),
    "bf16_cross_Tk_below_tile": (2, 200, 40, 8, 8, 64, bf16, False, None),
    "bf16_gqa2": (2, 300, 300, 8, 4, 64, bf16, True, None),
    "bf16_gqa4": (2, 300, 300, 8, 2, 64, bf16, True, None),
    "bf16_window_below_tile": (2, 400, 400, 8, 8, 64, bf16, True, 50),
    "bf16_rows_without_keys": (2, 300, 100, 8, 8, 64, bf16, True, 64),
    "bf16_D16_T2048": (2, 2048, 2048, 4, 4, 16, bf16, True, None),
    # configs/induction_lm64.json's attention as the curriculum trains it
    "D16_f32_curriculum": (100, 64, 64, 4, 4, 16, torch.float32, True,
                           None),
    "f32_T1": (2, 1, 1, 8, 8, 64, f32, True, None),
    "f32_T63": (2, 63, 63, 8, 8, 64, f32, True, None),
    "f32_T65": (2, 65, 65, 8, 8, 64, f32, True, None),
    "f32_T129": (2, 129, 129, 8, 8, 64, f32, True, None),
    "f32_cross_Tk_below_tile": (2, 200, 20, 8, 8, 64, f32, False, None),
    "f32_gqa2": (2, 300, 300, 8, 4, 64, f32, True, None),
    "f32_gqa4": (2, 300, 300, 8, 2, 64, f32, True, None),
    "f32_window_below_tile": (2, 400, 400, 8, 8, 64, f32, True, 20),
    # rows 164.. see no key (causal, window 64, Tq > Tk)
    "f32_rows_without_keys": (2, 300, 100, 8, 8, 64, f32, True, 64),
    "f32_D16_cross": (2, 150, 90, 4, 4, 16, f32, False, None),
    "f32_D16_gqa2_window_below_tile": (2, 300, 300, 4, 2, 16, f32, True,
                                       20),
}


def _variant(dtype):
    """A flash kernel's variant: tensor cores in bf16, and in float32 the
    3xTF32 forward and backward."""
    return "tc" if dtype == bf16 else "tf32x3"


@pytest.mark.parametrize("B,Tq,Tk,H,Hk,D,dtype,causal,window",
                         list(FLASH_CASES.values()), ids=list(FLASH_CASES))
def test_flash_kernel_matches_plain(card, B, Tq, Tk, H, Hk, D, dtype, causal,
                                    window):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((B, Tq, H, D), generator=gen).to(card, dtype)
    k = torch.randn((B, Tk, Hk, D), generator=gen).to(card, dtype)
    v = torch.randn((B, Tk, Hk, D), generator=gen).to(card, dtype)
    before = fa.launches.count
    variants = fa.launches.by_variant()
    out, lse = fa.flash_attention(q, k, v, causal, None, window)
    assert fa.launches.count == before + 1
    after = fa.launches.by_variant()
    vname = _variant(dtype)
    assert after.get(vname, 0) == variants.get(vname, 0) + 1
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
    assert out.dtype == dtype and out.shape == q.shape
    assert bool(torch.isfinite(out.float()).all())
    assert float((out.float() - ref.float()).abs().max()) <= FLASH_TOL[dtype]
    assert float((lse - ref_lse).abs().max()) <= LSE_TOL


@pytest.mark.parametrize("B,T,H,D", [(100, 64, 4, 16), (2, 2048, 8, 64)],
                         ids=["D16", "D64"])
def test_f32_flash_fwd_is_deterministic(card, B, T, H, D):
    """No float atomics: two float32 forward runs give the same bits."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((B, T, H, D), generator=gen).to(card)
               for _ in range(3))
    fa.launches.reset()
    first = fa.flash_attention(q, k, v, True)
    second = fa.flash_attention(q, k, v, True)
    assert fa.launches.by_variant() == {"tf32x3": 2}
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_f32_flash_fwd_takes_a_misaligned_view(card):
    """float32 views at an odd element offset (off the 16-byte boundary)
    go to the 3xTF32 forward, which then copies its K/V tiles word by
    word, and agree with the plain version as aligned inputs do."""
    gen = torch.Generator().manual_seed(4)
    shapes = ((2, 100, 4, 64), (2, 100, 2, 64), (2, 100, 2, 64))
    args = [torch.randn(s, generator=gen).to(card) for s in shapes]
    views = []
    for t in args:
        base = torch.empty(t.numel() + 1, device=card)
        view = base[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        views.append(view)
    fa.launches.reset()
    out, lse = fa.flash_attention(*views, True, None, 40)
    assert fa.launches.by_variant() == {"tf32x3": 1}
    ref, ref_lse = fa.flash_attention_plain(*args, causal=True, window=40)
    assert float((out - ref).abs().max()) <= FLASH_TOL[f32]
    assert float((lse - ref_lse).abs().max()) <= LSE_TOL


def _paged(card, H, Hk, Dh, q_dtype, pos, S=4, psz=16, n_ptab=16,
           pool_dtype=torch.float32):
    gen = torch.Generator().manual_seed(1)
    rows = S * n_ptab + 1
    pk = torch.randn((rows, psz, Hk, Dh), generator=gen).to(pool_dtype)
    pv = torch.randn((rows, psz, Hk, Dh), generator=gen).to(pool_dtype)
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


# (H, Hk, Dh, q dtype, positions, window, pages a row) at page 16: the
# kernel splits each row's live pages across a cluster of 4 blocks (16
# pages a block at pos 1023 of 64 pages), so these cut the splits'
# edges; a block stages 72 keys at once with an f32 pool at Dh 64 (144
# with a 16-bit pool, 288 and 576 at Dh 16), so its split goes in
# chunks
PAGED_SPLIT_CASES = {
    "pos_on_page_edges": (8, 8, 64, torch.float32,
                          [15, 16, 127, 128, 255, 256, 511, 512], None, 64),
    "pos_L_minus_1": (8, 8, 64, torch.bfloat16, [1023, 1022, 1009, 0],
                      None, 64),
    "window_across_splits": (8, 8, 64, torch.float32, [1023, 700, 130, 300],
                             200, 64),
    "window_1_pos_0": (8, 8, 64, torch.float32, [0, 1023, 16, 17], 1, 64),
    "gqa4": (8, 2, 64, torch.float32, [1023, 544, 17, 300], None, 64),
    "D16": (4, 4, 16, torch.bfloat16, [1023, 544, 0, 129], 64, 64),
    "chunked_splits": (8, 4, 64, torch.float32, [4095, 2100, 1100, 129],
                       None, 256),
    "chunked_splits_D16_window": (4, 4, 16, torch.bfloat16,
                                  [4095, 3000, 2047, 5], 3000, 256),
    # the merge's instance for G > 1 at Dh 16, eight query heads a kv
    # head, rows with fewer live pages than blocks (blocks with no key),
    # a window whose first key is inside a page
    "gqa4_D16": (4, 1, 16, torch.float32, [1023, 544, 17, 300], None, 64),
    "gqa8": (8, 1, 64, torch.bfloat16, [1023, 544, 17, 300], None, 64),
    "fewer_pages_than_splits": (8, 8, 64, torch.float32, [0, 15, 16, 100],
                                None, 64),
    "window_starts_inside_a_page": (8, 8, 64, torch.float32,
                                    [1023, 700, 130, 300], 37, 64),
}


@pytest.mark.parametrize("H,Hk,Dh,q_dtype,pos,window,n_ptab",
                         list(PAGED_SPLIT_CASES.values()),
                         ids=list(PAGED_SPLIT_CASES))
def test_paged_kernel_split_edges_match_plain(card, H, Hk, Dh, q_dtype, pos,
                                              window, n_ptab):
    args = _paged(card, H, Hk, Dh, q_dtype, pos, S=len(pos), n_ptab=n_ptab)
    out = pa.paged_attention_decode(*args, page_size=16, n_kv_heads=Hk,
                                    window=window)
    ref = pa.paged_attention_decode_plain(*args, page_size=16,
                                          n_kv_heads=Hk, window=window)
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= PAGED_TOL


def test_paged_kernel_corrupt_entry_in_a_later_split_gives_nan_row(card):
    """The bad-entry flag of one block of the cluster reaches the merge:
    the whole row is NaN, not a softmax over the other splits."""
    q, pk, pv, ptab, pos = _paged(card, 8, 8, 64, torch.float32,
                                  [1023, 1023, 544, 100], S=4, n_ptab=64)
    ptab[0, 60] = pk.shape[0] + 3        # row 0: page 60, the last split
    ptab[2, 30] = -2                     # row 2 (35 live pages): split 7
    out = pa.paged_attention_decode(q, pk, pv, ptab, pos, page_size=16,
                                    n_kv_heads=8)
    ref = pa.paged_attention_decode_plain(q, pk, pv, ptab, pos,
                                          page_size=16, n_kv_heads=8)
    for b in (0, 2):
        assert bool(torch.isnan(out[b]).all())
        assert bool(torch.isnan(ref[b]).all())
    keep = [1, 3]
    assert bool(torch.isfinite(out[keep]).all())
    assert float((out[keep] - ref[keep]).abs().max()) <= PAGED_TOL


def test_paged_kernel_is_deterministic(card):
    """Fixed splits merged in rank order: two runs give the same bits."""
    args = _paged(card, 8, 8, 64, torch.bfloat16,
                  [1023, 544, 530, 17, 0, 700, 600, 129], S=8, n_ptab=64)
    first = pa.paged_attention_decode(*args, page_size=16, n_kv_heads=8)
    second = pa.paged_attention_decode(*args, page_size=16, n_kv_heads=8)
    assert torch.equal(first, second)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(card):
    q, pk, pv, ptab, pos = _paged(card, 8, 8, 64, torch.float32, [5, 6, 7, 8])
    with pytest.raises(TypeError, match="float32/bfloat16/float16 pools"):
        pa.paged_attention_decode(q, pk.double(), pv.double(), ptab, pos,
                                  page_size=16, n_kv_heads=8)
    x = torch.zeros((1, 8, 2, 32), device=card)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(x, x, x, True)


# the bf16 KV pool (an engine with cache_dtype=torch.bfloat16): K and V
# widened to f32 in registers, 8 elements a 16-byte piece
PAGED_BF16_POOL_CASES = {
    "D64_bf16q": (8, 8, 64, torch.bfloat16, [0, 255, 17, 100], None, 16),
    "D64_f32q_gqa_window": (8, 2, 64, torch.float32, [0, 255, 17, 100], 40,
                            16),
    "D16_f32q": (4, 4, 16, torch.float32, [0, 255, 17, 100], None, 16),
    "D16_bf16q_window": (4, 4, 16, torch.bfloat16, [0, 255, 17, 100], 20,
                         16),
    "split_edges": (8, 8, 64, torch.bfloat16,
                    [15, 16, 127, 128, 255, 256, 511, 1023], None, 64),
    "window_across_splits": (8, 8, 64, torch.float32,
                             [1023, 700, 130, 300], 200, 64),
    "chunked_splits_gqa": (8, 4, 64, torch.bfloat16,
                           [4095, 2100, 1100, 129], None, 256),
    # the edges of the redesign: G = 8 and G = 4 at both head widths,
    # rows with fewer live pages than blocks (blocks with no key), a
    # window whose first key is inside a page, and at Dh 16 (576 keys a
    # block's chunk) a split of 2048 keys
    "gqa8_D64": (8, 1, 64, torch.bfloat16, [1023, 544, 17, 300], None, 64),
    "gqa8_D16_window": (8, 1, 16, torch.float32, [1023, 544, 17, 300], 20,
                        64),
    "gqa4_D16": (4, 1, 16, torch.bfloat16, [0, 15, 16, 100], None, 64),
    "fewer_pages_than_splits": (8, 8, 64, torch.bfloat16, [0, 15, 16, 100],
                                None, 64),
    "fewer_pages_than_splits_D16": (4, 4, 16, torch.float32,
                                    [0, 15, 16, 100], None, 64),
    "window_starts_inside_a_page": (8, 8, 64, torch.float32,
                                    [1023, 700, 130, 300], 37, 64),
    "chunked_splits_D16": (4, 4, 16, torch.bfloat16,
                           [8191, 5000, 2100, 129], None, 512),
}


@pytest.mark.parametrize("H,Hk,Dh,q_dtype,pos,window,n_ptab",
                         list(PAGED_BF16_POOL_CASES.values()),
                         ids=list(PAGED_BF16_POOL_CASES))
def test_paged_kernel_bf16_pool_matches_plain(card, H, Hk, Dh, q_dtype, pos,
                                              window, n_ptab):
    args = _paged(card, H, Hk, Dh, q_dtype, pos, S=len(pos), n_ptab=n_ptab,
                  pool_dtype=torch.bfloat16)
    before = pa.launches.by_variant().get("bf16_pool", 0)
    out = pa.paged_attention_decode(*args, page_size=16, n_kv_heads=Hk,
                                    window=window)
    assert pa.launches.by_variant()["bf16_pool"] == before + 1
    ref = pa.paged_attention_decode_plain(*args, page_size=16,
                                          n_kv_heads=Hk, window=window)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= PAGED_TOL


@pytest.mark.parametrize("H,Hk,Dh,q_dtype,pos,window,n_ptab",
                         list(PAGED_BF16_POOL_CASES.values()),
                         ids=list(PAGED_BF16_POOL_CASES))
def test_paged_kernel_f16_pool_matches_plain(card, H, Hk, Dh, q_dtype, pos,
                                             window, n_ptab):
    """The float16 pool (``cache_dtype=torch.float16``): K and V widened
    to f32 in registers, 8 halves a 16-byte piece, its own
    ``paged_decode_f16pool_kernel``; the bf16 pool's shapes."""
    args = _paged(card, H, Hk, Dh, q_dtype, pos, S=len(pos), n_ptab=n_ptab,
                  pool_dtype=torch.float16)
    before = pa.launches.by_variant().get("f16_pool", 0)
    out = pa.paged_attention_decode(*args, page_size=16, n_kv_heads=Hk,
                                    window=window)
    assert pa.launches.by_variant()["f16_pool"] == before + 1
    ref = pa.paged_attention_decode_plain(*args, page_size=16,
                                          n_kv_heads=Hk, window=window)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= PAGED_TOL


@pytest.mark.parametrize("pool_dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_paged_kernel_bf16_pool_corrupt_entry_and_repeat(card, pool_dtype):
    """A corrupt live entry NaNs its row with a 16-bit pool too (bf16 and
    f16), and two runs give the same bits."""
    q, pk, pv, ptab, pos = _paged(card, 8, 8, 64, torch.bfloat16,
                                  [1023, 1023, 544, 100], n_ptab=64,
                                  pool_dtype=pool_dtype)
    ptab[0, 60] = pk.shape[0] + 3
    first = pa.paged_attention_decode(q, pk, pv, ptab, pos, page_size=16,
                                      n_kv_heads=8)
    second = pa.paged_attention_decode(q, pk, pv, ptab, pos, page_size=16,
                                       n_kv_heads=8)
    assert torch.equal(first.nan_to_num(7.0), second.nan_to_num(7.0))
    assert bool(torch.isnan(first[0]).all())
    assert bool(torch.isfinite(first[1:]).all())


def test_paged_kernel_refuses_a_misaligned_bf16_pool_view(card):
    """The kernel reads pool rows in 16-byte pieces: a bf16 pool view
    one element off 16-byte alignment is refused, not misread."""
    q, pk, pv, ptab, pos = _paged(card, 8, 8, 64, torch.float32, [5, 6, 7, 8],
                                  pool_dtype=torch.bfloat16)
    flat_k = torch.empty(pk.numel() + 1, dtype=torch.bfloat16, device=card)
    flat_v = torch.empty_like(flat_k)
    bad_k = flat_k[1:].view(pk.shape)
    bad_v = flat_v[1:].view(pv.shape)
    bad_k.copy_(pk)
    bad_v.copy_(pv)
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_attention_decode(q, bad_k, bad_v, ptab, pos, page_size=16,
                                  n_kv_heads=8)


def test_flash_kernels_refuse_a_misaligned_bf16_view(card):
    """A bf16 view at an odd element offset cannot feed the tensor-core
    kernels' 16-byte copies: the wrappers raise naming the kernel, and
    nothing launches (no float32 kernel, no plain version)."""
    base = torch.zeros(2 * 64 * 8 * 64 + 1, device=card, dtype=bf16)
    x = base[1:].view(2, 64, 8, 64)
    assert x.data_ptr() % 16 != 0
    ok = torch.zeros_like(x)
    lse = torch.zeros((2, 8, 64), device=card)
    before = (fa.launches.count, dq.launches.count, dkv.launches.count)
    with pytest.raises(ValueError, match="flash_attention.*aligned"):
        fa.flash_attention(x, ok, ok, True)
    with pytest.raises(ValueError, match="flash_bwd_dq.*aligned"):
        dq.flash_bwd_dq(ok, x, ok, ok, lse, lse, causal=True, scale=0.125)
    with pytest.raises(ValueError, match="flash_bwd_dkv.*aligned"):
        dkv.flash_bwd_dkv(ok, ok, ok, x, lse, lse, causal=True, scale=0.125)
    assert (fa.launches.count, dq.launches.count,
            dkv.launches.count) == before


def test_f32_flash_bwd_takes_a_misaligned_view(card):
    """float32 views at an odd element offset (off the 16-byte boundary)
    go to the 3xTF32 backward kernels, which then copy their tiles word by
    word, and agree with the plain versions as aligned inputs do."""
    args, kw = _bwd_inputs(card, 2, 100, 100, 4, 2, 64, torch.float32,
                           True, 40)
    views = []
    for t in args[:4]:
        base = torch.empty(t.numel() + 1, device=card)
        view = base[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        views.append(view)
    moved = tuple(views) + args[4:]
    for m in (dq, dkv):
        m.launches.reset()
    got = (dq.flash_bwd_dq(*moved, **kw),) + dkv.flash_bwd_dkv(*moved, **kw)
    assert dq.launches.by_variant() == {"tf32x3": 1}
    assert dkv.launches.by_variant() == {"tf32x3": 1}
    ref = (dq.flash_bwd_dq_plain(*args, **kw),) + dkv.flash_bwd_dkv_plain(
        *args, **kw)
    for g, r in zip(got, ref):
        assert _bwd_units(g, r) <= BWD_UNITS[torch.float32]


def _bwd_inputs(card, B, Tq, Tk, H, Hk, D, dtype, causal, window, seed=2):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen).to(card, dtype)
                   for shape in ((B, Tq, H, D), (B, Tk, Hk, D),
                                 (B, Tk, Hk, D), (B, Tq, H, D)))
    out, lse = fa.flash_attention(q, k, v, causal, None, window)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return (q, k, v, do, lse, delta), dict(causal=causal, scale=D ** -0.5,
                                           window=window)


BWD_CASES = {
    "D16_f32": (2, 200, 200, 4, 4, 16, torch.float32, True, None),
    "D64_bf16": (2, 256, 256, 8, 8, 64, bf16, True, None),
    "D64_f32_gqa_window": (2, 300, 300, 8, 2, 64, torch.float32, True, 100),
    "D64_bf16_cross": (2, 257, 513, 8, 8, 64, bf16, False, None),
    "bf16_Tq1_Tk65": (2, 1, 65, 8, 8, 64, bf16, False, None),
    **{name: FLASH_CASES[name] for name in (
        "bf16_T1", "bf16_T63", "bf16_T65", "bf16_T129",
        "bf16_cross_Tk_below_tile", "bf16_gqa2", "bf16_gqa4",
        "bf16_window_below_tile", "bf16_rows_without_keys",
        "bf16_D16_T2048", "D16_f32_curriculum")},
    # configs/induction_lm.json's attention (f32, 4 heads of 16, T=32)
    "D16_f32_induction_lm": (100, 32, 32, 4, 4, 16, torch.float32, True,
                             None),
    # the training path's full width in float32
    "D64_f32_full_width": (16, 2048, 2048, 8, 8, 64, torch.float32, True,
                           None),
}


@pytest.mark.parametrize("B,Tq,Tk,H,Hk,D,dtype,causal,window",
                         list(BWD_CASES.values()), ids=list(BWD_CASES))
def test_flash_bwd_kernels_match_plain(card, B, Tq, Tk, H, Hk, D, dtype,
                                       causal, window):
    args, kw = _bwd_inputs(card, B, Tq, Tk, H, Hk, D, dtype, causal, window)
    before = (dq.launches.count, dkv.launches.count)
    variants = dkv.launches.by_variant()
    dq_variants = dq.launches.by_variant()
    got = (dq.flash_bwd_dq(*args, **kw),) + dkv.flash_bwd_dkv(*args, **kw)
    assert (dq.launches.count, dkv.launches.count) == (before[0] + 1,
                                                       before[1] + 1)
    vname = _variant(dtype)
    assert dkv.launches.by_variant().get(vname, 0) \
        == variants.get(vname, 0) + 1
    vname = _variant(dtype)
    assert dq.launches.by_variant().get(vname, 0) \
        == dq_variants.get(vname, 0) + 1
    ref = (dq.flash_bwd_dq_plain(*args, **kw),) + dkv.flash_bwd_dkv_plain(
        *args, **kw)
    q, k, v, do = args[:4]
    if dtype == torch.float32:
        exact = dict(zip(("dq", "dk", "dv"), _bwd_float64(*args, **kw)))
    # causal Tq = Tk = 1: P = 1 and dP = delta, so the exact dQ and dK
    # are 0 and each side holds only its own rounding of dP - delta; those
    # two are held in units of the terms that cancel (|dO| |V| scale
    # times |K| or |Q|), dV as every other gradient
    zero = (causal and Tq == Tk == 1)
    terms = _amax(do) * _amax(v) * kw["scale"]
    for name, g, r, other in zip(("dq", "dk", "dv"), got, ref, (k, q, None)):
        assert g.dtype == dtype and g.shape == r.shape
        if zero and other is not None:
            err = float((g.float() - r.float()).abs().max())
            assert err <= BWD_UNITS[dtype] * BWD_UNIT[dtype] * terms \
                * _amax(other), name
        elif dtype == torch.float32:
            assert _f32_bwd_within(g, r, exact[name]), name
        else:
            assert _bwd_units(g, r) <= BWD_UNITS[dtype], name


def _bwd_float64(q, k, v, do, lse, delta, *, causal, scale, window):
    """dQ, dK and dV evaluated in float64 from the same inputs, lse and
    delta (causal keys at or before the query, within the window), in the
    inputs' dtype: the answer both the kernel and the plain version
    round (chip_smoke.py's ``bwd_float64``)."""
    B, Tq, H, D = q.shape
    Tk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    qh, doh = (x.transpose(1, 2).double() for x in (q, do))
    kh, vh = (x.transpose(1, 2).double().repeat_interleave(G, dim=1)
              for x in (k, v))
    q_pos = torch.arange(Tq, device=q.device)[:, None]
    k_pos = torch.arange(Tk, device=q.device)[None, :]
    keep = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        keep = k_pos <= q_pos
        if window is not None:
            keep = keep & (k_pos > q_pos - window)
    dq_, dk_, dv_ = (torch.empty_like(x) for x in (qh, kh, vh))
    for b in range(B):
        p = torch.where(keep, torch.exp(qh[b] @ kh[b].transpose(-1, -2)
                                        * scale
                                        - lse[b].double()[..., None]), 0.0)
        ds = p * (doh[b] @ vh[b].transpose(-1, -2)
                  - delta[b].double()[..., None]) * scale
        dq_[b] = ds @ kh[b]
        dk_[b] = ds.transpose(-1, -2) @ qh[b]
        dv_[b] = p.transpose(-1, -2) @ doh[b]
    dk_, dv_ = (x.reshape(B, Hk, G, Tk, D).sum(2) for x in (dk_, dv_))
    return tuple(x.transpose(1, 2).to(t.dtype).contiguous()
                 for x, t in ((dq_, q), (dk_, k), (dv_, v)))


def _f32_bwd_within(got, plain, exact):
    """chip_smoke.py's float32 backward rule: within BWD_UNITS of the
    float64 evaluation, and within BWD_UNITS of the plain version unless
    the plain version is itself at least as far from float64 (its own
    rounding takes most of the units at T=2048)."""
    tol = BWD_UNITS[torch.float32]
    to_f64 = _bwd_units(got, exact)
    return to_f64 <= tol and (_bwd_units(got, plain) <= tol
                              or _bwd_units(plain, exact) >= to_f64)


def _amax(t):
    return float(t.float().abs().max())


def _bwd_units(got, ref):
    """The worst entry's |got - ref| in units u * (|ref| + its row's
    largest |ref|, or the median |ref| where that is larger: a row whose
    exact gradient cancels to 0 is rounding noise on both sides)."""
    err = (got.float() - ref.float()).abs()
    mag = ref.float().abs()
    row = torch.maximum(mag.amax(-1, keepdim=True), mag.flatten().median())
    scale = BWD_UNIT[ref.dtype] * (mag + row)
    units = torch.where(scale > 0, err / scale.clamp_min(1e-38),
                        torch.where(err > 0, float("inf"), 0.0))
    return float(units.max())


@pytest.mark.parametrize("B,T,H,Hk,D,dtype", [
    (2, 384, 8, 2, 64, bf16), (16, 2048, 8, 8, 64, bf16),
    (100, 64, 4, 4, 16, torch.float32), (16, 2048, 8, 8, 64, torch.float32)],
    ids=["gqa_384", "full_width_2048", "f32_D16_curriculum",
         "f32_D64_full_width"])
def test_flash_bwd_kernels_are_deterministic(card, B, T, H, Hk, D, dtype):
    """No float atomics: two backward runs give the same bits (the
    tensor-core dK/dV and dQ kernels, bf16 and the 3xTF32 float32 ones,
    up to the training path's full width)."""
    args, kw = _bwd_inputs(card, B, T, T, H, Hk, D, dtype, True, None)
    first = (dq.flash_bwd_dq(*args, **kw),) + dkv.flash_bwd_dkv(*args, **kw)
    second = (dq.flash_bwd_dq(*args, **kw),) + dkv.flash_bwd_dkv(*args,
                                                                  **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bf16_attention_launches_only_the_tensor_core_variants(card):
    """A bf16 forward and backward through the autograd.Function counts
    its flash forward, dQ and dK/dV launches on the bf16 tensor-core
    variant and none on float32's."""
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((2, 256, 8, 64), generator=gen).to(card, bf16)
               .requires_grad_(True) for _ in range(3))
    for m in (fa, dq, dkv):
        m.launches.reset()
    out, _ = fa.flash_attention(q, k, v, True)
    torch.autograd.grad(out.float().square().sum(), (q, k, v))
    assert fa.launches.by_variant() == {"tc": 1}
    assert dq.launches.by_variant() == {"tc": 1}
    assert dkv.launches.by_variant() == {"tc": 1}


@pytest.mark.parametrize("D", [16, 64])
def test_f32_attention_launches_the_tf32x3_backward(card, D):
    """A float32 forward and backward through the autograd.Function
    launches the 3xTF32 forward, dQ and dK/dV kernels, and no other
    variant."""
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((2, 256, 4, D), generator=gen).to(card)
               .requires_grad_(True) for _ in range(3))
    for m in (fa, dq, dkv):
        m.launches.reset()
    out, _ = fa.flash_attention(q, k, v, True)
    torch.autograd.grad(out.square().sum(), (q, k, v))
    assert fa.launches.by_variant() == {"tf32x3": 1}
    assert dq.launches.by_variant() == {"tf32x3": 1}
    assert dkv.launches.by_variant() == {"tf32x3": 1}


def _attention_grads(card, x, unit, params):
    from veles_tpu_torch.units.base import Context
    live = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    y, _ = unit.apply(live, {}, [x], Context(train=True))
    names = sorted(live)
    grads = torch.autograd.grad(y.square().mean(), [live[n] for n in names])
    return dict(zip(names, grads))


def test_attention_unit_weight_grads_match_plain_path(card):
    """The flash kernel's output carries the gradient: wq, wk and wv
    receive through the three kernels what the plain path gives them."""
    from veles_tpu_torch.units.base import Spec
    from veles_tpu_torch.units.parallel_nn import MultiHeadAttention
    unit = MultiHeadAttention(4, name="attn", rope=True, residual=True,
                              n_kv_heads=2)
    spec = Spec((2, 100, 64), torch.float32)
    params, _ = unit.init(torch.Generator().manual_seed(0), [spec], card)
    x = torch.randn((2, 100, 64), generator=torch.Generator().manual_seed(1)
                    ).to(card)
    flash = (fa, dq, dkv)
    before = [m.launches.count for m in flash]
    got = _attention_grads(card, x, unit, params)
    assert [m.launches.count for m in flash] == [n + 1 for n in before]
    with contextlib.ExitStack() as stack:
        for m in flash:        # each wrapper's own route, to the plain one
            stack.enter_context(mock.patch.object(
                m, "kernel_route", lambda t, name: False))
        ref = _attention_grads(card, x, unit, params)
    assert [m.launches.count for m in flash] == [n + 1 for n in before]
    assert sorted(got) == ["wk", "wo", "wq", "wv"]
    for name in got:
        scale = float(ref[name].abs().max())
        assert scale > 0, name
        assert float((got[name] - ref[name]).abs().max()) <= 1e-4 * scale, \
            name


@pytest.mark.parametrize("dtype,shape,m", [
    (torch.int32, (512, 2048), 16), (torch.uint8, (101, 3, 7), 37),
    (torch.float32, (40, 3, 7), 13)], ids=["int32_tokens", "uint8_21_bytes",
                                           "f32_3x7"])
def test_gather_kernel_matches_plain_bitwise(card, dtype, shape, m):
    gen = torch.Generator().manual_seed(3)
    data = (torch.randint(0, 200, shape, generator=gen).to(dtype)
            if dtype != torch.float32 else torch.randn(shape, generator=gen)
            ).to(card)
    idx = np.random.default_rng(3).integers(0, shape[0], m)
    before = gr.launches.count
    out = gr.gather_rows(data, idx)
    assert gr.launches.count == before + 1
    ref = gr.gather_rows_plain(data, torch.from_numpy(idx).to(card))
    assert out.is_contiguous() and torch.equal(out, ref)


def test_gather_kernel_refuses_an_index_out_of_range(card):
    data = torch.zeros((8, 5), dtype=torch.int32, device=card)
    before = gr.launches.count
    for bad in ([0, 8], [-1]):
        with pytest.raises(IndexError, match="out of range"):
            gr.gather_rows(data, np.asarray(bad))
    assert gr.launches.count == before


@pytest.mark.parametrize("shape,dtype,rate,seed", [
    ((512, 4096), torch.float32, 0.5, 2769742244),
    ((1000,), torch.float32, 0.1, 3), ((5, 7, 300), torch.float32, 0.9, 99),
    ((3, 8320), torch.float32, 0.5, 0xC0FFEE),
    ((16, 203), torch.bfloat16, 0.3, 11),
    ((4, 13, 13, 8), torch.float16, 0.5, 5)],
    ids=["alexnet_fc", "1d", "cols_300_r0.9", "cols_8320", "bf16_odd",
         "f16_nhwc"])
def test_fused_dropout_kernel_matches_plain_bitwise(card, shape, dtype, rate,
                                                    seed):
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(shape, generator=gen).to(card, dtype).requires_grad_(True)
    g = torch.randn(shape, generator=gen).to(card, dtype)
    before = fd.launches.count
    y = fd.fused_dropout(x, seed, rate)
    (gx,) = torch.autograd.grad(y, x, g)
    assert fd.launches.count == before + 2        # forward and backward
    ref = fd.fused_dropout_plain(x.detach(), seed, rate)
    ref_g = fd.fused_dropout_plain(g, seed, rate)
    assert y.dtype == dtype and torch.equal(y, ref)
    assert torch.equal(gx, ref_g)
    assert torch.equal(y == 0, gx == 0)          # one mask for both passes


def test_fused_dropout_reads_its_seed_from_the_card(card):
    """The seed lives in a one-element int32 tensor on the card: two
    seeds written into one slot give two masks, each bitwise the plain
    version's (and the host-int entry's) at that seed; the slot's bits
    are the uint32's (a seed above 2^31 included)."""
    gen = torch.Generator().manual_seed(9)
    x = torch.randn((100, 256), generator=gen).to(card)
    slot = torch.zeros(1, dtype=torch.int32, device=card)
    outs = []
    for seed in (0xDEADBEEF, 12345):
        slot.fill_(fd.seed_bits(seed))
        before = fd.launches.count
        y = fd.fused_dropout(x, slot, 0.5)
        assert fd.launches.count == before + 1
        assert torch.equal(y, fd.fused_dropout_plain(x, slot, 0.5))
        assert torch.equal(y, fd.fused_dropout(x, seed, 0.5))
        outs.append(y)
    assert not torch.equal(outs[0] == 0, outs[1] == 0)
    with pytest.raises(ValueError, match="one int32 element"):
        fd.fused_dropout(x, slot.cpu(), 0.5)


def test_fused_dropout_kernel_reads_a_misaligned_view(card):
    base = torch.randn(4 * 1025 + 1, device=card)
    x = base[1:].view(4, 1025)                  # 4-byte offset: no vectors
    assert x.data_ptr() % 16 != 0
    y = fd.fused_dropout(x, 77, 0.5)
    assert torch.equal(y, fd.fused_dropout_plain(x, 77, 0.5))
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        fd.fused_dropout(torch.zeros(4, device=card, dtype=torch.float64),
                         1, 0.5)


@pytest.mark.parametrize("shape,dtype", [
    ((64, 227, 227, 3), torch.uint8), ((8, 227, 227, 3), torch.float32),
    ((4, 13, 13, 3), torch.uint8), ((3, 5), torch.float32)],
    ids=["alexnet_uint8", "alexnet_f32", "odd_uint8", "tiny_f32"])
def test_mean_disp_kernel_matches_plain_bitwise(card, shape, dtype):
    gen = torch.Generator().manual_seed(5)
    x = (torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
         if dtype == torch.uint8
         else torch.randn(shape, generator=gen) * 50 + 100).to(card)
    feat = shape[1:]
    mean = (torch.rand(feat, generator=gen) * 50 + 100).to(card)
    rdisp = (torch.rand(feat, generator=gen) * 0.01 + 0.01).to(card)
    before = md.launches.count
    out = md.mean_disp_normalize(x, mean, rdisp)
    assert md.launches.count == before + 1
    ref = md.mean_disp_normalize_plain(x, mean, rdisp)
    assert out.dtype == torch.float32 and torch.equal(out, ref)


# (array specs, rows, m, count, offset): one, two and three arrays, every
# copy unit, a padded tail, the last batch of an epoch
BATCH_CASES = {
    "lm_train_3_arrays": ([((2048,), torch.int32), ((2048,), torch.int32),
                           ((2048,), torch.float32)], 512, 16, 16, 496),
    "two_padded_tail": ([((2048,), torch.int32), ((2048,), torch.int32)],
                        70, 16, 6, 64),
    "odd_rows_every_unit": ([((3, 7), torch.uint8), ((5,), torch.int16),
                             ((3,), torch.float32), ((2,), torch.float64)],
                            101, 37, 30, 64),
    "one_uint8_image": ([((256, 256, 3), torch.uint8)], 40, 8, 8, 0),
}


@pytest.mark.parametrize("case", list(BATCH_CASES), ids=list(BATCH_CASES))
def test_gather_batch_kernel_matches_plain_bitwise(card, case):
    specs, n, m, count, offset = BATCH_CASES[case]
    gen = torch.Generator().manual_seed(6)
    arrays = [torch.randint(0, 1 << 14, (n,) + s, generator=gen).to(dt)
              .to(card) for s, dt in specs]
    order = np.random.default_rng(6).permutation(n)[:offset + count]
    perm = gr.index_tensor(order, n, offset + m, card)
    outs = [torch.empty((m,) + a.shape[1:], dtype=a.dtype, device=card)
            for a in arrays]
    refs = [torch.empty_like(o) for o in outs]
    mask, ref_mask = torch.empty(m, device=card), torch.empty(m, device=card)
    before = gr.launches.by_variant().get("batch", 0)
    gr.gather_batch(arrays, outs, perm, offset, count, mask)
    assert gr.launches.by_variant()["batch"] == before + 1
    gr.gather_batch_plain(arrays, refs, perm, offset, count, ref_mask)
    torch.cuda.synchronize()
    for o, r in zip(outs, refs):
        assert torch.equal(o, r)
    assert torch.equal(mask, ref_mask)
    assert mask.sum().item() == count


def _lm_trainer(card, capture, dtype, snapshotter=None, epochs=1,
                n_train=64, force_host=False):
    """The bench LM's layer types at a narrow width (2 blocks, dim 64, 4
    heads of 16, vocab 64) over a card-resident per-position
    InductionLoader (8 x 128 tokens a batch), Adam; capture on or off."""
    from veles_tpu_torch.models.lm import InductionLoader
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.runtime.decision import Decision
    from veles_tpu_torch.runtime.step_cache import StepCache
    layers = [{"type": "embedding", "vocab": 64, "dim": 64, "name": "emb"}]
    for i in range(2):
        layers += [{"type": "attention", "n_heads": 4, "rope": True,
                    "residual": True, "name": f"attn{i}"},
                   {"type": "layer_norm", "name": f"ln{i}a"},
                   {"type": "ffn", "d_hidden": 128, "name": f"ffn{i}"},
                   {"type": "layer_norm", "name": f"ln{i}b"}]
    layers.append({"type": "all2all", "output_size": 64,
                   "per_position": True, "name": "head"})
    sw = StandardWorkflow({"name": "lm", "layers": layers,
                           "compute_dtype": dtype, "optimizer": "adam",
                           "optimizer_args": {"lr": 1e-3}})
    loader = InductionLoader(minibatch_size=8, n_train=n_train, n_valid=16,
                             seq_len=128, vocab=64, per_position=True,
                             device=card, force_host=force_host)
    tr = sw.make_trainer(loader, Decision(max_epochs=epochs), snapshotter,
                         device=card, step_cache=StepCache(capture=capture))
    tr.initialize(seed=0)
    return tr


def _state_equal(a, b):
    from veles_tpu_torch.ops.optimizers import tree_leaves
    la = tree_leaves({k: a[k] for k in ("params", "opt_state", "state")})
    lb = tree_leaves({k: b[k] for k in ("params", "opt_state", "state")})
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("dtype,force_host", [
    ("bfloat16", False), (None, False), ("bfloat16", True)],
    ids=["bf16", "f32", "bf16_host_batches"])
def test_captured_train_step_equals_eager_bitwise(card, dtype, force_host):
    """8 steps and an eval from one init: the captured steps leave the
    eager steps' parameters, optimizer state and epoch sums, bit for
    bit, whether the batches are gathered on the card or come from the
    host (pinned, copied into the static inputs)."""
    eager = _lm_trainer(card, False, dtype, force_host=force_host)
    captured = _lm_trainer(card, True, dtype, force_host=force_host)
    assert captured.step_cache.stats()["train"] == {"captured": True,
                                                    "reason": None}
    assert eager.step_cache.stats()["train"]["reason"] == "capture=False"
    eager.run()
    captured.run()
    assert captured.step_cache.stats()["eval"]["captured"]
    assert captured.wstate["step"] == eager.wstate["step"] == 8
    assert (captured.wstate["key"] == eager.wstate["key"]).all()
    assert _state_equal(captured.wstate, eager.wstate)
    assert captured.decision.history == eager.decision.history


@pytest.mark.parametrize("dtype", ["bfloat16", None], ids=["bf16", "f32"])
def test_train_step_flops_the_same_on_the_card_as_on_the_cpu(card, dtype):
    """The counted cost of one LM train step (``StepCache.entry_cost``:
    products by their formulas, the kernels by their ``cost()``) is the
    same whether the step runs the kernels on the card (counted in the
    capture's first warm-up) or their plain versions on the CPU (counted
    at the eager step's first execution)."""
    runs = (_lm_trainer(card, True, dtype),
            _lm_trainer(torch.device("cpu"), True, dtype))
    for tr in runs:
        tr.run()
    a, b = [tr.step_cache.entry_cost("train", tr._train_key) for tr in runs]
    assert a["flops"] > 0 and a["flops"] == b["flops"]
    assert a["bytes_accessed"] == b["bytes_accessed"]
    assert a["kernels"] == b["kernels"]
    assert set(a["kernels"]) == {fa.NAME, dq.NAME, dkv.NAME}


def test_replays_count_their_launches(card):
    """A replay adds the launches its capture recorded (by variant): a
    captured epoch counts the eager epoch's launches plus the warm-up
    steps', and one batch gather a step."""
    from veles_tpu_torch.ops.kernels import KERNELS
    from veles_tpu_torch.runtime.step_cache import WARMUP_STEPS
    counts = {}
    for capture in (False, True):
        for k in KERNELS:
            k.launches.reset()
        _lm_trainer(card, capture, "bfloat16").run()
        counts[capture] = {k.NAME: k.launches.state() for k in KERNELS}
    # per step: 2 layers' forward (train and eval), dQ and dK/dV (train)
    warm = {fa.NAME: 2 * WARMUP_STEPS * 2, dq.NAME: 2 * WARMUP_STEPS,
            dkv.NAME: 2 * WARMUP_STEPS}
    for name, (n, variants) in counts[False].items():
        got_n, got_v = counts[True][name]
        assert got_n == n + warm.get(name, 0), name
        if name in warm:
            assert got_v == {"tc": got_n}, name
    assert counts[True][gr.NAME] == counts[False][gr.NAME] \
        == (8 + 2, {"batch": 10})          # 8 train + 2 valid batches


def test_zero_recaptures_across_restore(card, tmp_path):
    """``Trainer.restore`` writes into the captured state's tensors: no
    recapture, and the next epoch equals an eager trainer's from the same
    snapshot, bitwise."""
    from veles_tpu_torch.runtime.snapshotter import Snapshotter
    snap = Snapshotter("cap", str(tmp_path))
    _lm_trainer(card, True, "bfloat16", snap).run()
    runs = {}
    for capture in (True, False):
        tr = _lm_trainer(card, capture, "bfloat16", epochs=2)
        compiles = tr.step_cache.compiles
        tr.restore(snap.last_path)
        assert tr.step_cache.compiles == compiles
        tr.run()
        assert tr.step_cache.recompiles == 0
        assert tr.step_cache.compiles == compiles + 1     # eval, lazily
        runs[capture] = tr
    assert _state_equal(runs[True].wstate, runs[False].wstate)
    assert runs[True].decision.history == runs[False].decision.history


def test_a_failed_capture_raises(card):
    """A step that cannot be captured (here: it reads a value back to
    the host) raises; the cache never falls back to the eager step."""
    from veles_tpu_torch.runtime.step_cache import StepCache

    class HostRead:
        kind = "eval"

        def begin(self, wstate):
            return None

        def run(self, wstate, batch, sub):
            return {"n": torch.tensor(float(batch["x"].sum().item()),
                                      device=card)}

    cache = StepCache()
    with pytest.raises(RuntimeError):
        cache.get_step("eval", ("host_read",), HostRead,
                       ({"params": {}}, {"x": torch.ones(4, device=card)}))
    assert cache.compiles == 0
    torch.cuda.synchronize()
    assert torch.ones(2, device=card).sum().item() == 2.0


# -- the serving engine's captured decode and prefill steps -------------------

def _serve_lm(device, dtype):
    """The bench LM's layer types at a narrow width (2 blocks, dim 64, 4
    heads of 16, vocab 64), random weights from seed 0."""
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.units.base import Spec
    layers = [{"type": "embedding", "vocab": 64, "dim": 64, "name": "emb"}]
    for i in range(2):
        layers += [{"type": "attention", "n_heads": 4, "rope": True,
                    "residual": True, "name": f"attn{i}"},
                   {"type": "layer_norm", "name": f"ln{i}a"},
                   {"type": "ffn", "d_hidden": 128, "name": f"ffn{i}"},
                   {"type": "layer_norm", "name": f"ln{i}b"}]
    layers.append({"type": "all2all", "output_size": 64,
                   "per_position": True, "name": "head"})
    wf = StandardWorkflow({"name": "lm", "layers": layers,
                           "compute_dtype": dtype}).workflow
    wf.build({"@input": Spec((2, 16), torch.int32),
              "@labels": Spec((2, 16), torch.int32),
              "@mask": Spec((2,), torch.float32)})
    return wf, wf.init_state(0, device=device)


def _drive(eng, script, iters, advance=None):
    """Run the scheduler's iteration (admit, one chunk slice, one advance
    of the decoding slots: ``advance(eng, i)``, by default one decode
    step) on this thread, ``iters`` times, submitting ``script[i]``'s
    requests before iteration i: the same calls in the same order on
    every engine, so page allocation and every input repeat exactly."""
    import threading
    eng._thread = threading.current_thread()     # submit() wants a runner
    reqs = []
    try:
        for i in range(iters):
            for prompt, n, kw in script.get(i, ()):
                reqs.append(eng.submit(prompt, n, **kw))
            eng._admit()
            eng._advance_prefills()
            if eng._active.any():
                if advance is None:
                    eng._step_once()
                else:
                    advance(eng, i)
    finally:
        eng._thread = None
    torch.cuda.synchronize()
    return reqs


def _fixed_policy(eng, i):
    """A timing-free scheduler policy for comparing engines: even
    iterations fuse a megastep where every slot is busy, else verify a
    draft where one exists, else one decode step; odd iterations try the
    draft first."""
    draft = eng._spec_drafts()
    if i % 2 == 0 and eng._mega_ready():
        eng._megastep_once()
    elif draft is not None:
        eng._verify_once(draft)
    elif eng._mega_ready():
        eng._megastep_once()
    else:
        eng._step_once()


def _serve_script(seed=3):
    """Admissions at iterations 0, 3, 9 and 17 (one sampled, one sharing
    a prefix, one chunked), retirements at different lengths."""
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, 64, 32).astype(np.int32)
    return {0: [(rng.integers(0, 64, 20), 12, {}),
                (np.concatenate([sysp, rng.integers(0, 64, 5)]), 30, {})],
            3: [(rng.integers(0, 64, 9), 6,
                 dict(temperature=0.9, top_k=8, seed=5))],
            9: [(np.concatenate([sysp, rng.integers(0, 64, 3)]), 10, {})],
            17: [(rng.integers(0, 64, 70), 8, {})]}


@pytest.mark.parametrize("dtype", ["bfloat16", None], ids=["bf16", "f32"])
def test_captured_decode_equals_eager_bitwise(card, dtype):
    """32 scheduler iterations with admissions (a prefix hit, a chunked
    prompt, a sampled row) and retirements mid-flight, through the
    captured decode and prefill graphs and through the eager steps: the
    same tokens for every request and the same KV pool, bit for bit."""
    from veles_tpu_torch.runtime.engine import DecodeEngine
    wf, ws = _serve_lm(card, dtype)
    engines = {}
    for capture in (True, False):
        eng = DecodeEngine(wf, ws, slots=4, l_max=128, page_size=16,
                           paged_kernel=True, prefill_chunk=32,
                           window_ms=0.0, capture=capture, device=card)
        engines[capture] = (eng, _drive(eng, _serve_script(), 32))
    (cap, creqs), (eag, ereqs) = engines[True], engines[False]
    assert cap.stats()["capture"]["decode"] == {"captured": True,
                                                "reason": None}
    assert eag.stats()["capture"]["decode"]["reason"] == "capture=False"
    assert [r.done.is_set() for r in creqs] == \
        [r.done.is_set() for r in ereqs]
    assert sum(r.done.is_set() for r in creqs) >= 3     # retired mid-run
    for a, b in zip(creqs, ereqs):
        if a.done.is_set():
            np.testing.assert_array_equal(a.result, b.result)
    assert cap.stats()["pages"]["prefix_hit_pages"] >= 2
    assert cap.stats()["prefill_calls"] > cap.stats()["admitted"]
    np.testing.assert_array_equal(cap._toks, eag._toks)
    for name in cap._caches:
        for k in ("k", "v"):
            assert torch.equal(cap._caches[name][k], eag._caches[name][k])


def test_captured_prefill_equals_eager_bitwise(card):
    """One 80-token prompt prefilled in slices of 32 through the
    prefill graph and through the eager step: the same last-position
    logits and the same pages, bit for bit."""
    from veles_tpu_torch.runtime.engine import DecodeEngine, _Request
    wf, ws = _serve_lm(card, "bfloat16")
    prompt = np.random.default_rng(1).integers(0, 64, 80).astype(np.int32)
    out = {}
    for capture in (True, False):
        eng = DecodeEngine(wf, ws, slots=2, l_max=128, page_size=16,
                           window_ms=0.0, capture=capture, device=card)
        req = _Request(prompt, 4, 0.0, None, None, None, 0, 1e18)
        assert eng._reserve_pages(req)
        logits = [eng._prefill_logits(0, req, prompt, s, min(32, 80 - s))
                  .clone() for s in (0, 32, 64)]
        torch.cuda.synchronize()
        out[capture] = (logits, {n: c["k"].clone()
                                 for n, c in eng._caches.items()})
    for a, b in zip(out[True][0], out[False][0]):
        assert torch.equal(a, b)
    for n in out[True][1]:
        assert torch.equal(out[True][1][n], out[False][1][n])


def test_serving_captures_stay_flat_and_count_replays(card):
    """Decode (sampling and greedy-only) and prefill are captured once
    each when the engine is built; a prefix hit, a chunked prefill, a preemption and a shed
    capture nothing more, and the paged-decode launches are one a layer
    per decode step, every one a replay."""
    from veles_tpu_torch.ops.kernels import paged_attention as pa
    from veles_tpu_torch.runtime.engine import (DecodeEngine,
                                                EngineOverloaded)
    wf, ws = _serve_lm(card, "bfloat16")
    eng = DecodeEngine(wf, ws, slots=2, l_max=128, page_size=16,
                       paged_kernel=True, prefill_chunk=32, pages=12,
                       queue_depth=2, priorities=2, window_ms=0.0,
                       device=card)
    pa.launches.reset()
    eng.start()
    rng = np.random.default_rng(4)
    sysp = rng.integers(0, 64, 32)
    try:
        eng.generate(np.concatenate([sysp, rng.integers(0, 64, 4)])[None],
                     4, timeout=300)
        eng.generate(np.concatenate([sysp, rng.integers(0, 64, 70)])[None],
                     4, timeout=300)                 # hit + chunks
        # hold the scheduler at its next decode step: the victim runs,
        # the class-0 arrival needs its pages, two class-1 arrivals fill
        # the queue and two more are shed
        import threading
        import time
        gate = threading.Event()
        step = eng._step_once
        eng._step_once = lambda: (gate.wait(300), step())
        victim = eng.submit(rng.integers(0, 64, 8), 100, priority=1)
        while not eng._active.any():
            time.sleep(0.001)
        high = eng.submit(rng.integers(0, 64, 8), 100, priority=0)
        shed = 0
        for _ in range(4):
            try:
                eng.submit(rng.integers(0, 64, 8), 4, priority=1)
            except EngineOverloaded:
                shed += 1
        gate.set()
        assert victim.done.wait(300) and high.done.wait(300)
        assert victim.error is None and high.error is None
    finally:
        eng.stop()
    st = eng.stats()
    assert st["compile"]["compiles"] == st["compile"]["captures"] == 3
    assert st["compile"]["recompiles"] == 0
    assert st["pages"]["prefix_hit_pages"] >= 2
    assert st["prefill_calls"] > st["admitted"]
    assert st["admission"]["preemptions"] >= 1 and shed >= 1
    assert pa.launches.count == 2 * st["decode_steps"]


# -- megastep, speculative verify, KV-page import -----------------------------

def _mega_spec_script(seed=6):
    """Four requests at iteration 0 (one sampled, one a repeated phrase
    the drafter predicts), a prefix hit at 8, a chunked prompt at 14."""
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, 64, 32).astype(np.int32)
    phrase = np.resize(rng.integers(0, 64, 6), 30).astype(np.int32)
    return {0: [(np.concatenate([sysp, rng.integers(0, 64, 5)]), 40, {}),
                (phrase, 36, {}),
                (rng.integers(0, 64, 12), 20,
                 dict(temperature=0.9, top_k=8, seed=5)),
                (rng.integers(0, 64, 9), 14, {})],
            8: [(np.concatenate([sysp, rng.integers(0, 64, 3)]), 10, {})],
            14: [(rng.integers(0, 64, 70), 8, {})]}


@pytest.mark.parametrize("dtype", ["bfloat16", None], ids=["bf16", "f32"])
def test_captured_megastep_and_verify_equal_eager_bitwise(card, dtype):
    """40 scheduler iterations under a fixed policy that runs megasteps
    (N=4) and verify steps (K=3) beside decode steps, through the
    captured graphs and through the eager steps: the same tokens for
    every request, token rows and KV pool, bit for bit."""
    from veles_tpu_torch.runtime.engine import DecodeEngine
    wf, ws = _serve_lm(card, dtype)
    runs = {}
    for capture in (True, False):
        eng = DecodeEngine(wf, ws, slots=4, l_max=128, page_size=16,
                           paged_kernel=True, prefill_chunk=32,
                           window_ms=0.0, megastep=4, spec=True, spec_k=3,
                           capture=capture, device=card)
        runs[capture] = (eng, _drive(eng, _mega_spec_script(), 40,
                                     _fixed_policy))
    (cap, creqs), (eag, ereqs) = runs[True], runs[False]
    for kind in ("decode", "prefill", "megastep", "verify",
                 "decode_greedy", "megastep_greedy", "verify_greedy"):
        assert cap.stats()["capture"][kind] == {"captured": True,
                                                "reason": None}
    for eng in (cap, eag):
        st = eng.stats()
        assert st["megastep"]["mega_dispatches"] > 0, st
        assert st["spec"]["verify_steps"] > 0, st
        assert st["spec"]["accepted"] > 0, st
    assert [r.done.is_set() for r in creqs] == \
        [r.done.is_set() for r in ereqs]
    assert sum(r.done.is_set() for r in creqs) >= 3
    for a, b in zip(creqs, ereqs):
        if a.done.is_set():
            np.testing.assert_array_equal(a.result, b.result)
    np.testing.assert_array_equal(cap._toks, eag._toks)
    for name in cap._caches:
        for k in ("k", "v"):
            assert torch.equal(cap._caches[name][k], eag._caches[name][k])


def test_megastep_and_verify_replays_count_their_paged_launches(card):
    """A megastep replay adds N paged launches a layer, a verify replay
    K + 1, a decode replay 1, each as its graph recorded at capture, in
    the sampling and the greedy-only program alike."""
    from veles_tpu_torch.runtime.engine import DecodeEngine
    wf, ws = _serve_lm(card, "bfloat16")
    eng = DecodeEngine(wf, ws, slots=2, l_max=128, page_size=16,
                       paged_kernel=True, window_ms=0.0, megastep=4,
                       spec=True, spec_k=3, device=card)
    layers = 2
    per = {"decode": layers, "megastep": 4 * layers,
           "verify": 4 * layers}
    for kind, n in per.items():
        for name in (kind, kind + "_greedy"):
            assert [m for c, (m, _) in eng._fns[name].launches
                    if c is pa.launches] == [n], name
    _drive(eng, {0: [(np.arange(20) % 7, 30, {}),
                     (np.arange(9) % 5, 30, {})]}, 1, lambda e, i: None)
    draft = np.full((2, 3), -1, np.int32)
    for kind, call in (("decode", eng._step_once),
                       ("megastep", eng._megastep_once),
                       ("verify", lambda: eng._verify_once(draft))):
        n0 = pa.launches.count
        call()
        torch.cuda.synchronize()
        assert pa.launches.count - n0 == per[kind], kind


def test_four_captures_stay_flat_across_hits_chunks_preemption_imports(card):
    """With megastep and spec on, the engine captures decode, megastep
    and verify (each sampling and greedy-only) and prefill when it is
    built; a prefix hit, a chunked
    prefill, a preemption and a KV-page import capture nothing more."""
    import threading
    import time
    from veles_tpu_torch.runtime.engine import (DecodeEngine,
                                                prefix_page_hashes)
    wf, ws = _serve_lm(card, "bfloat16")
    rng = np.random.default_rng(4)
    shared = rng.integers(0, 64, 48)
    src = DecodeEngine(wf, ws, slots=2, l_max=128, page_size=16,
                       window_ms=0.0, capture=False, device=card).start()
    try:
        src.generate(shared[None], 2, timeout=300)
        blob = src.export_pages(prefix_page_hashes(shared, 16))
    finally:
        src.stop()
    eng = DecodeEngine(wf, ws, slots=2, l_max=128, page_size=16,
                       paged_kernel=True, prefill_chunk=32, pages=12,
                       priorities=2, window_ms=0.0, megastep=4, spec=True,
                       spec_k=3, device=card)
    assert eng.stats()["compile"]["captures"] == 7
    eng.start()
    try:
        assert eng.import_pages(blob)["imported"] == 3
        eng.generate(np.concatenate([shared, rng.integers(0, 64, 4)])[None],
                     4, timeout=300)                  # remote hit
        eng.generate(np.concatenate([shared, rng.integers(0, 64, 40)])[None],
                     4, timeout=300)                  # hit + chunks
        gate = threading.Event()
        step = eng._advance_once
        eng._advance_once = lambda: (gate.wait(300), step())
        victim = eng.submit(rng.integers(0, 64, 8), 100, priority=1)
        while not eng._active.any():
            time.sleep(0.001)
        high = eng.submit(rng.integers(0, 64, 8), 100, priority=0)
        gate.set()
        assert victim.done.wait(300) and high.done.wait(300)
        assert victim.error is None and high.error is None
    finally:
        eng.stop()
    st = eng.stats()
    assert st["compile"]["compiles"] == st["compile"]["captures"] == 7
    assert st["compile"]["recompiles"] == 0 and st["compile"]["hits"] == 0
    assert st["kv_transfer"]["remote_hit_pages"] >= 2
    assert st["admission"]["preemptions"] >= 1


def test_sampler_noise_bits_match_the_cpu(card):
    """The integer hash of the Gumbel noise is the same on the card as
    on the CPU; the float32 logs within 1e-6."""
    from veles_tpu_torch.runtime.generate import (fold_keys, gumbel_noise,
                                                  noise_bits)
    keys = torch.cat([fold_keys([s], p, "cpu") for s, p in (
        (0, 0), (1, 5), (-7, 77), (2 ** 62 + 11, 1023), (12345, 511))])
    assert torch.equal(noise_bits(keys.to(card), 1024).cpu(),
                       noise_bits(keys, 1024))
    torch.testing.assert_close(gumbel_noise(keys.to(card), 1024).cpu(),
                               gumbel_noise(keys, 1024), rtol=1e-6,
                               atol=1e-6)


# -- a bf16 KV pool, and a hot swap into the captured graphs ----------------

@pytest.mark.parametrize("dtype", ["bfloat16", None], ids=["bf16", "f32"])
def test_bf16_cache_engine_captured_equals_eager_bitwise(card, dtype):
    """``cache_dtype=torch.bfloat16``: the engine builds and captures its
    paged steps (the paged kernel's bf16-pool variant), and 32 scheduler
    iterations give the eager engine's tokens and pool bit for bit."""
    from veles_tpu_torch.runtime.engine import DecodeEngine
    wf, ws = _serve_lm(card, dtype)
    engines = {}
    for capture in (True, False):
        eng = DecodeEngine(wf, ws, slots=4, l_max=128, page_size=16,
                           paged_kernel=True, prefill_chunk=32,
                           window_ms=0.0, capture=capture,
                           cache_dtype=torch.bfloat16, device=card)
        before = pa.launches.by_variant().get("bf16_pool", 0)
        engines[capture] = (eng, _drive(eng, _serve_script(), 32))
        assert pa.launches.by_variant()["bf16_pool"] > before
    (cap, creqs), (eag, ereqs) = engines[True], engines[False]
    assert cap.stats()["capture"]["decode"]["captured"]
    assert cap._caches["attn0"]["k"].dtype == torch.bfloat16
    assert sum(r.done.is_set() for r in creqs) >= 3
    for a, b in zip(creqs, ereqs):
        assert a.done.is_set() == b.done.is_set()
        if a.done.is_set():
            np.testing.assert_array_equal(a.result, b.result)
    for name in cap._caches:
        for k in ("k", "v"):
            assert torch.equal(cap._caches[name][k], eag._caches[name][k])


def test_swapped_captured_engine_equals_a_fresh_one(card):
    """A captured float32 engine swapped to a second weight set keeps
    every served tensor's storage and captures nothing new, and its
    greedy tokens equal a fresh engine's on those weights, bit for bit."""
    from veles_tpu_torch.runtime.engine import DecodeEngine
    wf, ws_a = _serve_lm(card, None)
    ws_b = wf.init_state(1, device=card)
    kw = dict(slots=4, l_max=128, page_size=16, paged_kernel=True,
              window_ms=0.0, device=card)
    prompts = np.random.default_rng(4).integers(0, 64, (4, 24)).astype(
        np.int32)
    fresh = DecodeEngine(wf, ws_b, **kw).start()
    try:
        ref = fresh.generate(prompts, 16, timeout=300)
    finally:
        fresh.stop()
    eng = DecodeEngine(wf, ws_a, **kw).start()
    try:
        old = eng.generate(prompts, 16, timeout=300)
        ptrs = [t.data_ptr() for p in eng.params.values()
                for t in p.values()]
        comp = eng.stats()["compile"]
        eng.swap_params(ws_b["params"])
        got = eng.generate(prompts, 16, timeout=300)
        st = eng.stats()
    finally:
        eng.stop()
    assert ptrs == [t.data_ptr() for p in eng.params.values()
                    for t in p.values()]
    assert st["swaps"] == 1
    assert st["compile"]["captures"] == comp["captures"]
    assert st["compile"]["recompiles"] == 0
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(old, got)


# -- a float16 KV pool ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", None], ids=["bf16", "f32"])
def test_f16_cache_engine_captured_equals_eager_bitwise(card, dtype):
    """``cache_dtype=torch.float16``: the engine builds and captures its
    paged steps (the kernel's f16-pool variant), and 32 scheduler
    iterations give the eager engine's tokens and pool bit for bit."""
    from veles_tpu_torch.runtime.engine import DecodeEngine
    wf, ws = _serve_lm(card, dtype)
    engines = {}
    for capture in (True, False):
        eng = DecodeEngine(wf, ws, slots=4, l_max=128, page_size=16,
                           paged_kernel=True, prefill_chunk=32,
                           window_ms=0.0, capture=capture,
                           cache_dtype=torch.float16, device=card)
        before = pa.launches.by_variant().get("f16_pool", 0)
        engines[capture] = (eng, _drive(eng, _serve_script(), 32))
        assert pa.launches.by_variant()["f16_pool"] > before
    (cap, creqs), (eag, ereqs) = engines[True], engines[False]
    assert cap.stats()["capture"]["decode"]["captured"]
    assert cap._caches["attn0"]["k"].dtype == torch.float16
    assert sum(r.done.is_set() for r in creqs) >= 3
    for a, b in zip(creqs, ereqs):
        assert a.done.is_set() == b.done.is_set()
        if a.done.is_set():
            np.testing.assert_array_equal(a.result, b.result)
    for name in cap._caches:
        for k in ("k", "v"):
            assert torch.equal(cap._caches[name][k], eag._caches[name][k])


def test_f16_cache_engine_greedy_equals_the_f32_pool_engine(card):
    """Float32 compute: a captured engine on a float16 pool gives the
    float32-pool engine's greedy tokens, as the bf16 pool's engine does."""
    from veles_tpu_torch.runtime.engine import DecodeEngine
    wf, ws = _serve_lm(card, None)
    prompts = np.random.default_rng(8).integers(0, 64, (4, 24)).astype(
        np.int32)
    toks = {}
    for cdt in (torch.float32, torch.float16, torch.bfloat16):
        eng = DecodeEngine(wf, ws, slots=4, l_max=128, page_size=16,
                           paged_kernel=True, window_ms=0.0,
                           cache_dtype=cdt, device=card).start()
        try:
            toks[cdt] = eng.generate(prompts, 16, timeout=300)
            assert eng.stats()["capture"]["decode"]["captured"]
        finally:
            eng.stop()
    np.testing.assert_array_equal(toks[torch.float16], toks[torch.float32])
    np.testing.assert_array_equal(toks[torch.bfloat16], toks[torch.float32])


# -- the dropout seed on the card: captured train steps with dropout ----------

@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN restricted to its deterministic algorithms (it may otherwise
    pick algorithms that reduce with atomics)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def _synthdigits_trainer(card, capture, tmp_path, n_train=400):
    """configs/synthdigits_conv.json at its published widths over a
    card-resident mnist loader of ``n_train`` SynthDigits (4 train
    batches of 100), capture on or off."""
    import json
    import os
    from veles_tpu_torch.models.mnist import MnistLoader
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.runtime.decision import Decision
    from veles_tpu_torch.runtime.step_cache import StepCache
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, os.pardir, "configs",
                           "synthdigits_conv.json")) as f:
        sw = StandardWorkflow(json.load(f)["workflow"])
    with mock.patch.dict(os.environ, {"VELES_TORCH_CACHE": str(tmp_path)}):
        loader = MnistLoader(minibatch_size=100, n_train=n_train,
                             n_valid=100, device=card)
    tr = sw.make_trainer(loader, Decision(max_epochs=1), device=card,
                         step_cache=StepCache(capture=capture))
    tr.initialize(seed=0)
    return tr


def _staged_seeds(trainer):
    """Run the trainer's epoch, recording each train step's staged
    dropout seed (read back after the step)."""
    step = trainer._train_step
    inner = getattr(step, "step", step)       # the TrainStep
    seeds = []

    def run(wstate, batch):
        out = step(wstate, batch)
        seeds.append(int(inner.seeds["drop3"].item()))
        return out

    run.captured = getattr(step, "captured", False)
    trainer._train_step = run
    try:
        trainer.run()
    finally:
        trainer._train_step = step
    return seeds


def test_synthdigits_conv_captured_step_equals_eager_bitwise(card, tmp_path):
    """The train step with dropout is captured (no reason given), and 4
    captured steps from one init leave the eager steps' state and epoch
    sums bit for bit, each step with its own dropout seed."""
    runs = {}
    with _deterministic_cudnn():
        for capture in (False, True):
            tr = _synthdigits_trainer(card, capture, tmp_path)
            runs[capture] = (tr, _staged_seeds(tr))
    (eager, e_seeds), (cap, c_seeds) = runs[False], runs[True]
    assert cap.step_cache.stats()["train"] == {"captured": True,
                                               "reason": None}
    assert cap.step_cache.stats()["eval"]["captured"]
    assert eager.wstate["step"] == cap.wstate["step"] == 4
    assert e_seeds == c_seeds and len(set(c_seeds)) == 4
    assert _state_equal(cap.wstate, eager.wstate)
    assert cap.decision.history == eager.decision.history


def test_alexnet_shaped_dropout_step_captured_equals_eager(card,
                                                          monkeypatch):
    """AlexNet's layers at their widths (drop6 / drop7 over 4096
    features) on 67-pixel crops of a card-resident store: the train step
    is captured, and 4 captured steps equal 4 eager ones bit for bit,
    the dropout launches of the captured epoch its replays' plus the
    warm-up steps'."""
    from veles_tpu_torch.models import alexnet
    from veles_tpu_torch.runtime.decision import Decision
    from veles_tpu_torch.runtime.step_cache import StepCache, WARMUP_STEPS
    monkeypatch.setattr(alexnet, "INPUT_HW", 67)
    monkeypatch.setattr(alexnet, "STORE_HW", 72)
    runs = {}
    with _deterministic_cudnn():
        for capture in (False, True):
            sw = alexnet.alexnet_e2e_device_workflow(
                minibatch_size=8, n_train=32, n_valid=8, device=card)
            tr = sw.make_trainer(sw.loader, Decision(max_epochs=1),
                                 device=card,
                                 step_cache=StepCache(capture=capture))
            fd.launches.reset()
            tr.initialize(seed=0)
            tr.run()
            runs[capture] = (tr, fd.launches.count)
    (eager, e_n), (cap, c_n) = runs[False], runs[True]
    assert cap.step_cache.stats()["train"] == {"captured": True,
                                               "reason": None}
    assert e_n == 4 * 4                   # 2 units x (fwd, bwd) a step
    assert c_n == e_n + 4 * WARMUP_STEPS
    assert _state_equal(cap.wstate, eager.wstate)
    assert cap.decision.history == eager.decision.history


# -- the recurrent family -----------------------------------------------------

def _rec_lm_trainer(card, capture):
    """The GRU+LSTM LM's layer types at a narrow width (dim 32, vocab 32)
    over a card-resident InductionLoader (8 x 16 tokens a batch, the last
    position supervised), Adam; capture on or off."""
    from veles_tpu_torch.models.lm import InductionLoader
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.runtime.decision import Decision
    from veles_tpu_torch.runtime.step_cache import StepCache
    layers = [{"type": "embedding", "vocab": 32, "dim": 32, "name": "emb"},
              {"type": "gru", "hidden": 32, "name": "gru1"},
              {"type": "lstm", "hidden": 32, "name": "lstm1"},
              {"type": "seq_last", "name": "last"},
              {"type": "softmax", "output_size": 32, "name": "out"}]
    sw = StandardWorkflow({"name": "rec_lm", "layers": layers,
                           "optimizer": "adam",
                           "optimizer_args": {"lr": 1e-3}})
    loader = InductionLoader(minibatch_size=8, n_train=64, n_valid=16,
                             seq_len=16, vocab=32, device=card)
    tr = sw.make_trainer(loader, Decision(max_epochs=1), device=card,
                         step_cache=StepCache(capture=capture))
    tr.initialize(seed=0)
    return tr


def test_recurrent_train_step_captured_equals_eager_bitwise(card):
    """8 GRU+LSTM steps and an eval from one init: the captured steps
    (the scan's Python loop recorded whole) leave the eager steps'
    parameters, Adam state and epoch sums, bit for bit."""
    eager = _rec_lm_trainer(card, False)
    captured = _rec_lm_trainer(card, True)
    assert captured.step_cache.stats()["train"] == {"captured": True,
                                                    "reason": None}
    eager.run()
    captured.run()
    assert captured.step_cache.stats()["eval"]["captured"]
    assert captured.wstate["step"] == eager.wstate["step"] == 8
    assert _state_equal(captured.wstate, eager.wstate)
    assert captured.decision.history == eager.decision.history


def _mixed_chain(device, dtype):
    """tests/test_generate.py:149-156's mixed chain at a narrow width:
    two attention blocks of the bench LM's types, then gru, seq_last and
    a softmax head (vocab 64, dim 64), random weights from seed 0."""
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.units.base import Spec
    layers = [{"type": "embedding", "vocab": 64, "dim": 64, "name": "emb"}]
    for i in range(2):
        layers += [{"type": "attention", "n_heads": 4, "rope": True,
                    "residual": True, "name": f"attn{i}"},
                   {"type": "layer_norm", "name": f"ln{i}a"},
                   {"type": "ffn", "d_hidden": 128, "name": f"ffn{i}"},
                   {"type": "layer_norm", "name": f"ln{i}b"}]
    layers += [{"type": "gru", "hidden": 64, "name": "gru"},
               {"type": "seq_last", "name": "last"},
               {"type": "softmax", "output_size": 64, "name": "out"}]
    wf = StandardWorkflow({"name": "mixed", "layers": layers,
                           "compute_dtype": dtype}).workflow
    wf.build({"@input": Spec((2, 16), torch.int32),
              "@labels": Spec((2,), torch.int32),
              "@mask": Spec((2,), torch.float32)})
    return wf, wf.init_state(0, device=device)


@pytest.mark.parametrize("dtype", ["bfloat16", None], ids=["bf16", "f32"])
def test_mixed_chain_engine_captured_equals_eager_bitwise(card, dtype):
    """40 scheduler iterations of the mixed attention + GRU chain under
    the fixed megastep (N=4) / verify (K=3) / decode policy, with a
    chunked prompt and a sampled row, through the captured graphs and
    the eager steps: tokens, token rows, KV pool and the GRU carries bit
    for bit, no prefix hit; each program's graph records one paged
    launch a layer a micro-step, and a replay adds exactly that."""
    from veles_tpu_torch.runtime.engine import DecodeEngine
    wf, ws = _mixed_chain(card, dtype)
    runs = {}
    for capture in (True, False):
        eng = DecodeEngine(wf, ws, slots=4, l_max=128, page_size=16,
                           paged_kernel=True, prefill_chunk=32,
                           window_ms=0.0, megastep=4, spec=True, spec_k=3,
                           capture=capture, device=card)
        runs[capture] = (eng, _drive(eng, _mega_spec_script(), 40,
                                     _fixed_policy))
    (cap, creqs), (eag, ereqs) = runs[True], runs[False]
    for kind in ("decode", "prefill", "megastep", "verify",
                 "decode_greedy", "megastep_greedy", "verify_greedy"):
        assert cap.stats()["capture"][kind] == {"captured": True,
                                                "reason": None}
    st = cap.stats()
    assert st["megastep"]["mega_dispatches"] > 0, st
    assert st["spec"]["verify_steps"] > 0, st
    assert st["pages"]["prefix_hit_pages"] == 0, st
    assert [r.done.is_set() for r in creqs] == \
        [r.done.is_set() for r in ereqs]
    assert sum(r.done.is_set() for r in creqs) >= 3
    for a, b in zip(creqs, ereqs):
        if a.done.is_set():
            np.testing.assert_array_equal(a.result, b.result)
    np.testing.assert_array_equal(cap._toks, eag._toks)
    for name in cap._caches:
        for part in cap._caches[name]:
            assert torch.equal(cap._caches[name][part],
                               eag._caches[name][part]), (name, part)
    layers = 2
    per = {"decode": layers, "megastep": 4 * layers, "verify": 4 * layers}
    for kind, n in per.items():
        for name in (kind, kind + "_greedy"):
            assert [m for c, (m, _) in cap._fns[name].launches
                    if c is pa.launches] == [n], name
    fresh = DecodeEngine(wf, ws, slots=2, l_max=128, page_size=16,
                         paged_kernel=True, window_ms=0.0, megastep=4,
                         spec=True, spec_k=3, device=card)
    _drive(fresh, {0: [(np.arange(20) % 7, 30, {}),
                       (np.arange(9) % 5, 30, {})]}, 1, lambda e, i: None)
    draft = np.full((2, 3), -1, np.int32)
    for kind, call in (("decode", fresh._step_once),
                       ("megastep", fresh._megastep_once),
                       ("verify", lambda: fresh._verify_once(draft))):
        n0 = pa.launches.count
        call()
        torch.cuda.synchronize()
        assert pa.launches.count - n0 == per[kind], kind


def _pp_moe_trainer(card, capture):
    """configs/induction_lm_pp_moe.json at its published width (dim 64,
    the pipeline stack run sequentially: no mesh) over a small
    card-resident InductionLoader (4 batches of 80 and one to
    evaluate); capture on or off."""
    import json
    import os
    from veles_tpu_torch.models.lm import InductionLoader
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.runtime.decision import Decision
    from veles_tpu_torch.runtime.step_cache import StepCache
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "configs", "induction_lm_pp_moe.json")
    with open(path) as f:
        cfg = json.load(f)
    ld = {k: v for k, v in cfg["loader"].items() if k != "name"}
    loader = InductionLoader(**ld, n_train=4 * ld["minibatch_size"],
                             n_valid=ld["minibatch_size"], device=card)
    tr = StandardWorkflow(cfg["workflow"]).make_trainer(
        loader, Decision(max_epochs=1), device=card,
        step_cache=StepCache(capture=capture))
    tr.initialize(seed=0)
    return tr


def test_pp_moe_train_step_captured_equals_eager_bitwise(card):
    """The pipeline stack with dropout and an MoE stage: 4 captured steps
    and an eval leave the eager steps' parameters, Adam state, MoE aux
    state and epoch sums, bit for bit; each step launches the dropout
    kernel forward and backward for both stage dropouts (their seed
    slots) and the f32 flash kernels."""
    eager = _pp_moe_trainer(card, False)
    captured = _pp_moe_trainer(card, True)
    assert captured.step_cache.stats()["train"] == {"captured": True,
                                                    "reason": None}
    assert captured._train_step.step.seeded == ["s0u1_dropout",
                                                "s1u1_dropout"]
    per = {k.NAME: m for c, (m, _) in captured._train_step.launches
           for k in (fa, dq, dkv, fd) if k.launches is c}
    # each stage dropout launches forward and backward
    assert per[fd.NAME] == 4 and per[fa.NAME] >= 3 and per[dq.NAME] == 3
    eager.run()
    captured.run()
    assert captured.wstate["step"] == eager.wstate["step"] == 4
    assert _state_equal(captured.wstate, eager.wstate)
    assert captured.decision.history == eager.decision.history


def _moe_chain(device):
    """induction_lm_pp_moe.json's chain (dim 64, vocab 16): the three
    attention stages without their dropouts, the MoE stage, seq_last and
    the softmax head; random weights from seed 0."""
    import json
    import os
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.units.base import Spec
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "configs", "induction_lm_pp_moe.json")
    with open(path) as f:
        wcfg = json.load(f)["workflow"]
    for layer in wcfg["layers"]:
        if layer["type"] == "pipeline_stack":
            layer["stages"] = [[s for s in st if s["type"] != "dropout"]
                               for st in layer["stages"]]
    wf = StandardWorkflow(wcfg).workflow
    wf.build({"@input": Spec((2, 16), torch.int32),
              "@labels": Spec((2,), torch.int32),
              "@mask": Spec((2,), torch.float32)})
    return wf, wf.init_state(0, device=device)


def test_moe_chain_engine_captured_equals_eager_bitwise(card):
    """40 scheduler iterations of the MoE chain (decoded dropless inside
    the graphs) under the fixed megastep / verify / decode policy,
    captured and eager: tokens, token rows and the KV pool bit for bit;
    a replay launches the paged kernel once an attention stage a
    micro-step."""
    from veles_tpu_torch.runtime.engine import DecodeEngine
    wf, ws = _moe_chain(card)
    runs = {}
    for capture in (True, False):
        eng = DecodeEngine(wf, ws, slots=4, l_max=128, page_size=16,
                           paged_kernel=True, prefill_chunk=32,
                           window_ms=0.0, megastep=4, spec=True, spec_k=3,
                           capture=capture, device=card)
        script = {i: [(np.asarray(p) % 16, n, kw) for p, n, kw in reqs]
                  for i, reqs in _mega_spec_script().items()}
        runs[capture] = (eng, _drive(eng, script, 40, _fixed_policy))
    (cap, creqs), (eag, ereqs) = runs[True], runs[False]
    for kind in ("decode", "prefill", "megastep", "verify"):
        assert cap.stats()["capture"][kind] == {"captured": True,
                                                "reason": None}
    assert sum(r.done.is_set() for r in creqs) >= 3
    for a, b in zip(creqs, ereqs):
        assert a.done.is_set() == b.done.is_set()
        if a.done.is_set():
            np.testing.assert_array_equal(a.result, b.result)
    np.testing.assert_array_equal(cap._toks, eag._toks)
    for name in cap._caches:
        for part in cap._caches[name]:
            assert torch.equal(cap._caches[name][part],
                               eag._caches[name][part]), (name, part)
    layers = 3
    for kind, n in {"decode": layers, "megastep": 4 * layers,
                    "verify": 4 * layers}.items():
        assert [m for c, (m, _) in cap._fns[kind].launches
                if c is pa.launches] == [n], kind


# -- the fleet: several captured engines in one process -----------------------

def _fleet_of(wf, ws, n, capture, card):
    """``n`` in-process replicas of the narrow LM behind a started
    router; every engine on its own copy of ``ws`` (a swap writes into
    the served tensors)."""
    from veles_tpu_torch.runtime.deploy import DeployController
    from veles_tpu_torch.runtime.engine import DecodeEngine
    from veles_tpu_torch.runtime.fleet import FleetRouter, InProcessReplica
    from veles_tpu_torch.runtime.restful import RestfulServer

    def factory():
        own = dict(ws, params={u: {k: t.clone() for k, t in p.items()}
                               for u, p in ws["params"].items()})
        eng = DecodeEngine(wf, own, slots=4, l_max=128, page_size=16,
                           paged_kernel=True, window_ms=0.0,
                           capture=capture, device=card).start()
        srv = RestfulServer(wf.make_predict_step(), eng.wstate, 2, (16,),
                            port=0, workflow=wf, engine=eng, device=card)
        DeployController(server=srv)
        return srv.start()

    replicas = [InProcessReplica(factory) for _ in range(n)]
    router = FleetRouter(scrape_interval_s=0.05)
    for rep in replicas:
        router.add_replica(url=rep.url, registry_key="in-process",
                           restart=rep.restart, kill=rep.kill)
    return router.start(), replicas


def _fleet_requests(seed=8):
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, 64, 32).tolist()
    out = [{"prompt": [rng.integers(0, 64, n).tolist()], "steps": s}
           for n, s in ((5, 12), (20, 30), (70, 8))]
    out += [{"prompt": [sysp + rng.integers(0, 64, 4).tolist()],
             "steps": 10} for _ in range(3)]
    out.append({"prompt": [rng.integers(0, 64, 9).tolist()], "steps": 16,
                "temperature": 0.9, "top_k": 8, "seed": 5})
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", None], ids=["bf16", "f32"])
def test_fleet_captured_equals_eager_bitwise(card, dtype):
    """The same requests (greedy, shared-prefix with affinity and page
    fetches, sampled) through a two-replica fleet of captured engines
    and one of eager engines: the same tokens bit for bit, and every
    captured replica's captures flat."""
    wf, ws = _serve_lm(card, dtype)
    toks = {}
    for capture in (True, False):
        router, replicas = _fleet_of(wf, ws, 2, capture, card)
        try:
            toks[capture] = []
            for body in _fleet_requests():
                st, doc, _h = router.handle_generate(dict(body))
                assert st == 200, doc
                toks[capture].append(doc["tokens"])
            if capture:
                for rep in replicas:
                    c = rep.srv.engine.stats()["compile"]
                    assert c["captures"] == 3 and c["recompiles"] == 0, c
        finally:
            router.stop()
            for rep in replicas:
                rep.stop()
    assert toks[True] == toks[False]


def test_replica_restart_while_two_others_decode(card):
    """A captured replica rebuilt (a new engine capturing its graphs)
    twice while two others decode greedy requests side by side without
    pause: no request fails, every answer is the reference tokens (each
    engine captured on a stream of its own, so no two share a cuBLAS
    workspace), the rebuilt engine's captures are flat, and its decode
    graph records exactly one paged launch a layer (the capture gate
    keeps the other engines' replays out of its count)."""
    import threading
    import time
    wf, ws = _serve_lm(card, "bfloat16")
    router, replicas = _fleet_of(wf, ws, 3, True, card)
    body = {"prompt": [list(range(3, 40))], "steps": 24}
    stop, bad, done = threading.Event(), [], []
    try:
        ref = replicas[0].srv.engine.generate(
            np.asarray(body["prompt"], np.int32), 24, timeout=300)

        def hammer(rep):
            from veles_tpu_torch.runtime.fleet_client import ReplicaClient
            cli = ReplicaClient(rep.url, timeout_s=300)
            while not stop.is_set():
                st, doc, _r = cli.generate(dict(body))
                if st != 200 or doc["tokens"] != ref.tolist():
                    bad.append((st, doc))
                done.append(1)

        threads = [threading.Thread(target=hammer, args=(r,))
                   for r in replicas[:2]]
        for t in threads:
            t.start()
        for _ in range(2):
            n0 = len(done)
            replicas[2].restart()
            eng = replicas[2].srv.engine
            assert [m for c, (m, _) in eng._fns["decode_greedy"].launches
                    if c is pa.launches] == [2]
            got = eng.generate(np.asarray(body["prompt"], np.int32), 24,
                               timeout=300)
            np.testing.assert_array_equal(got, ref)
            c = eng.stats()["compile"]
            assert c["captures"] == 3 and c["recompiles"] == 0, c
            assert len({r.srv.engine.step_cache._capture_stream.cuda_stream
                        for r in replicas}) == 3
            deadline = time.monotonic() + 120
            while len(done) < n0 + 20:
                assert time.monotonic() < deadline
                time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join(300)
        assert not bad, (len(bad), len(done), bad[:2])
        assert len(done) >= 40
    finally:
        stop.set()
        router.stop()
        for rep in replicas:
            rep.stop()


def test_process_with_the_memory_poller_exits_cleanly(card):
    """A process whose device poller samples the card without pause
    exits with 0 and no C++ abort: the monitor's exit hook stops and
    joins the poller before the interpreter ends daemon threads (one
    ended inside a CUDA call aborts the process with "terminate called
    without an active exception")."""
    import os
    import subprocess
    import sys
    child = (
        "import torch\n"
        "from veles_tpu_torch.runtime.memory import memory_monitor\n"
        "x = torch.randn(2048, 2048, device='cuda')\n"
        "assert memory_monitor().ensure_poller(interval_s=1e-5)\n"
        "for _ in range(20):\n"
        "    x = x @ x.T / 2048\n"
        "torch.cuda.synchronize()\n")
    root_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for _ in range(3):
        r = subprocess.run([sys.executable, "-c", child], cwd=root_dir,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "terminate called" not in r.stderr


def test_process_exiting_while_its_engine_decodes_exits_cleanly(card):
    """A process that returns while its started engine decodes on the
    card exits with 0 and no C++ abort: the engine's exit hook stops and
    joins the ``decode-engine`` thread before the interpreter ends daemon
    threads."""
    import os
    import subprocess
    import sys
    child = (
        "import threading, torch\n"
        "from veles_tpu_torch.models.standard import StandardWorkflow\n"
        "from veles_tpu_torch.runtime.engine import DecodeEngine\n"
        "from veles_tpu_torch.units.base import Spec\n"
        "layers = [{'type': 'embedding', 'vocab': 64, 'dim': 64,\n"
        "           'name': 'emb'},\n"
        "          {'type': 'attention', 'n_heads': 4, 'rope': True,\n"
        "           'residual': True, 'name': 'attn'},\n"
        "          {'type': 'all2all', 'output_size': 64,\n"
        "           'per_position': True, 'name': 'head'}]\n"
        "wf = StandardWorkflow({'name': 'lm', 'layers': layers}).workflow\n"
        "wf.build({'@input': Spec((2, 16), torch.int32),\n"
        "          '@labels': Spec((2, 16), torch.int32),\n"
        "          '@mask': Spec((2,), torch.float32)})\n"
        "ws = wf.init_state(0, device='cuda')\n"
        "eng = DecodeEngine(wf, ws, slots=2, l_max=2048, page_size=16,\n"
        "                   paged_kernel=True, window_ms=0.0,\n"
        "                   device='cuda').start()\n"
        "req = eng.submit([1, 2, 3], 2000)\n"
        "while req.first_token_at is None:\n"
        "    threading.Event().wait(0.001)\n"
        "assert eng.started and not req.done.is_set()\n")
    root_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for _ in range(3):
        r = subprocess.run([sys.executable, "-c", child], cwd=root_dir,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "terminate called" not in r.stderr


# -- the export path's custom ops and sealed artifacts -----------------------

def _direct_and_op(card, mod):
    """One call of ``mod``'s kernel through its custom op (CUDA and CPU
    tensors) and through the direct launch, at a serving-sized shape:
    (op on the card, direct launch, op on the CPU, plain on the CPU)."""
    g = torch.Generator().manual_seed(3)
    if mod is pa:
        B, H, Hk, Dh, psz, n_ptab = 4, 8, 2, 64, 16, 8
        rows = B * n_ptab + 1
        q = torch.randn(B, H, Dh, generator=g)
        kp = torch.randn(rows, psz, Hk, Dh, generator=g)
        vp = torch.randn(rows, psz, Hk, Dh, generator=g)
        ptab = torch.randperm(rows - 1, generator=g)[:B * n_ptab].view(
            B, n_ptab).int()
        pos = torch.tensor([0, 17, 63, 127], dtype=torch.int32)
        kw = dict(page_size=psz, n_kv_heads=Hk, scale=Dh ** -0.5)
        args = (q, kp, vp, ptab, pos)
        dev = [t.to(card) for t in args]
        return (pa.paged_attention_decode(*dev, **kw),
                pa._launch(*dev, H // Hk, psz, Dh ** -0.5, None),
                pa.paged_attention_decode(*args, **kw),
                pa.paged_attention_decode_plain(*args, **kw))
    if mod is fa:
        q, k, v = (torch.randn(2, 256, 8, 64, generator=g).to(bf16)
                   for _ in range(3))
        dev = [t.to(card) for t in (q, k, v)]
        return (fa.flash_attention(*dev, True),
                fa._launch(*dev, True, 64 ** -0.5, None),
                fa.flash_attention(q, k, v, True),
                fa.flash_attention_plain(q, k, v, causal=True))
    x = torch.randint(0, 256, (8, 227, 227, 3), generator=g,
                      dtype=torch.uint8)
    mean = torch.rand(227, 227, 3, generator=g) * 255
    rdisp = torch.rand(227, 227, 3, generator=g)
    dev = [t.to(card) for t in (x, mean, rdisp)]
    return (md.mean_disp_normalize(*dev), md._launch(*dev),
            md.mean_disp_normalize(x, mean, rdisp),
            md.mean_disp_normalize_plain(x, mean, rdisp))


@pytest.mark.parametrize("mod", [pa, fa, md],
                         ids=["paged_attention", "flash_attention",
                              "mean_disp"])
def test_custom_op_is_the_kernel_on_the_card_and_plain_on_the_cpu(card,
                                                                   mod):
    """Each kernel of the export path through its ``torch.library``
    custom op: on a CUDA tensor bitwise the direct kernel launch (one
    counted launch a call), on a CPU tensor bitwise the plain version."""
    n0 = mod.launches.count
    op, direct, cpu_op, plain = _direct_and_op(card, mod)
    torch.cuda.synchronize()
    assert mod.launches.count - n0 == 2
    for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (op, direct))):
        assert torch.equal(a, b)
    for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (cpu_op, plain))):
        assert torch.equal(a, b)


def test_bf16_artifact_decode_equals_the_live_engine(card, tmp_path):
    """A bf16 artifact exported on the card (paged kernel, megastep 4,
    spec k 3) served by an ArtifactRunner: its captured programs give
    the live engine's greedy tokens over a driven script, bitwise; each
    replay adds its paged launches (2 layers: 2, 8, 8); no recapture
    after load.  Its programs are refused on the CPU."""
    from veles_tpu_torch.export.compiled import export_compiled
    from veles_tpu_torch.runtime.artifact import ArtifactError, ArtifactRunner
    from veles_tpu_torch.runtime.engine import DecodeEngine
    wf, ws = _serve_lm(card, "bfloat16")
    kw = dict(slots=4, l_max=128, page_size=16, paged_kernel=True)
    art = str(tmp_path / "art")
    export_compiled(wf, ws, art, megastep=4, spec=True, spec_k=3, **kw)
    runner = ArtifactRunner(art, window_ms=0.0, prefill_chunk=32,
                            device=card)
    live = DecodeEngine(wf, ws, window_ms=0.0, prefill_chunk=32,
                        device=card, **kw)
    comp0 = dict(runner.stats()["compile"])
    assert comp0["captures"] == comp0["compiles"] == 7
    per = {"decode": 2, "megastep": 8, "verify": 8}
    for kind, n in per.items():
        for name in (kind, kind + "_greedy"):
            assert [m for c, (m, _) in runner._fns[name].launches
                    if c is pa.launches] == [n], name
    script = {0: [(np.arange(20) % 7, 12, {}), (np.arange(40) % 9, 20, {})],
              3: [(np.arange(9) % 5, 9, {})]}
    got = _drive(runner, script, 40)
    want = _drive(live, script, 40)
    assert all(r.done.is_set() for r in got)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.result, b.result)
    comp = runner.stats()["compile"]
    assert comp["compiles"] == comp0["compiles"] and comp["recompiles"] == 0
    with pytest.raises(ArtifactError, match="re-export on the serving"):
        ArtifactRunner(art, device="cpu")


def test_a_collection_during_a_capture_frees_no_graph(card):
    """Dead captured engines are reference cycles that hold CUDA graphs
    until the cycle collector runs; a collection on the capturing thread
    inside a capture would destroy their graphs there, a call the capture
    forbids ("operation not permitted when stream is capturing"), and
    invalidate it.  Allocation counts trigger a collection, so whether
    one falls inside a given capture depends on the whole heap; the test
    holds the condition that rules it out: ``StepCache`` captures with
    the collector off, and turns it back on after the capture, which
    then replays cleanly."""
    import gc
    from veles_tpu_torch.runtime.step_cache import StepCache
    seen = []

    class Step:
        kind = "eval"

        def begin(self, state):
            return None

        def run(self, state, inputs, host):
            if torch.cuda.is_current_stream_capturing():
                seen.append(gc.isenabled())
            state["x"].add_(1.0)
            return {"y": state["x"] * 2.0}

    state = {"x": torch.zeros(8, device=card)}
    assert gc.isenabled()
    fn = StepCache().get_step("eval", ("gc",), Step, (state, {}))
    assert fn.captured
    assert seen and not any(seen)       # captured with the collector off
    assert gc.isenabled()
    out = fn(state, None)               # the warm-ups ran on a copy
    torch.cuda.synchronize()
    assert torch.equal(out["y"], torch.full((8,), 2.0, device=card))
