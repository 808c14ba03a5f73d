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
or the gradient's median |plain| where that is larger); the row gather
bitwise; an attention unit's weight gradients
kernel vs plain path rtol 1e-4 of each gradient's largest entry in
float32; fused dropout (forward and gradient) and mean/disp normalize
bitwise.
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


def _bwd_inputs(card, B, Tq, Tk, H, Hk, D, dtype, causal, window, seed=2):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen).to(card, dtype)
                   for shape in ((B, Tq, H, D), (B, Tk, Hk, D),
                                 (B, Tk, Hk, D), (B, Tq, H, D)))
    out, lse = fa.flash_attention(q, k, v, causal, None, window)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return (q, k, v, do, lse, delta), dict(causal=causal, scale=D ** -0.5,
                                           window=window)


BWD_CASES = [(2, 200, 200, 4, 4, 16, torch.float32, True, None),
             (2, 256, 256, 8, 8, 64, torch.bfloat16, True, None),
             (2, 300, 300, 8, 2, 64, torch.float32, True, 100),
             (2, 257, 513, 8, 8, 64, torch.bfloat16, False, None)]
BWD_IDS = ["D16_f32", "D64_bf16", "D64_f32_gqa_window", "D64_bf16_cross"]


@pytest.mark.parametrize("B,Tq,Tk,H,Hk,D,dtype,causal,window", BWD_CASES,
                         ids=BWD_IDS)
def test_flash_bwd_kernels_match_plain(card, B, Tq, Tk, H, Hk, D, dtype,
                                       causal, window):
    args, kw = _bwd_inputs(card, B, Tq, Tk, H, Hk, D, dtype, causal, window)
    before = (dq.launches.count, dkv.launches.count)
    got = (dq.flash_bwd_dq(*args, **kw),) + dkv.flash_bwd_dkv(*args, **kw)
    assert (dq.launches.count, dkv.launches.count) == (before[0] + 1,
                                                       before[1] + 1)
    ref = (dq.flash_bwd_dq_plain(*args, **kw),) + dkv.flash_bwd_dkv_plain(
        *args, **kw)
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        assert _bwd_units(g, r) <= BWD_UNITS[dtype]


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


def test_flash_bwd_kernels_are_deterministic(card):
    """No float atomics: two backward runs give the same bits."""
    args, kw = _bwd_inputs(card, 2, 384, 384, 8, 2, 64, torch.bfloat16,
                           True, None)
    first = (dq.flash_bwd_dq(*args, **kw),) + dkv.flash_bwd_dkv(*args, **kw)
    second = (dq.flash_bwd_dq(*args, **kw),) + dkv.flash_bwd_dkv(*args,
                                                                  **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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
