"""The arithmetic of the float32 flash forward kernel
(``veles_tpu_torch/csrc/flash_fwd_tf32x3.cu``) emulated on the CPU.

The kernel runs only on a Hopper card; what it computes is the function
of ``flash_attention_plain`` and of the JAX package's ``_flash_fwd``, but
summed its own way: each float32 operand split into a TF32 big part and a
TF32 small part by integer operations on its bits (``to_tf32`` in
``csrc/tf32x3.cuh``), every product of 8 terms taken three times
(small.big, big.small, then big.big) into one zeroed sum, the two small
cross terms first, that sum added in float32 (``mma3c``), and the online
softmax state rescaled once per key tile of the kernel's width (32
keys).  The emulation below does the
same sums in torch (each chunk's three products exact in float64, then
rounded to float32, as the tensor core's exact TF32 products summed into
a fresh fragment are to within a few float32 roundings) and is held,
within 1e-4 as the kernel is on the card,
against the plain version and against the Pallas kernel in interpret
mode on the same numpy inputs.  Nothing in the package imports it."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from veles_tpu.ops import pallas_kernels as pk  # noqa: E402
from veles_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-4          # out, against the plain version (chip_smoke FLASH_TOL)
LSE_TOL = 1e-3
NEG = -1e30


def to_tf32(x):
    """x rounded to TF32 (10 stored mantissa bits), to nearest, ties away
    from zero: ``(bits + 0x1000) & 0xffffe000`` on the float32 bits."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 1 << 31, r - (1 << 32), r)
    return r.to(torch.int32).view(torch.float32)


def split(x):
    """x = big + small, both TF32."""
    big = to_tf32(x)
    return big, to_tf32(x - big)


def mma3c(acc, a, b):
    """acc += a . b over the last axis of a (8 terms) in 3xTF32: the
    three products (cross terms first, the big product last) exact, into
    one zeroed sum rounded to float32, then added to acc in float32."""
    (ab, as_), (bb, bs) = (tuple(x.double() for x in split(y))
                           for y in (a, b))
    return acc + ((as_ @ bb + ab @ bs) + ab @ bb).float()


def flash_fwd_tf32x3(q, k, v, causal=False, window=None, scale=None):
    """The kernel's forward, (B, Tq, H, D) float32 q and (B, Tk, Hk, D)
    k/v: ``(out, lse)`` as the kernel sums them."""
    B, Tq, H, D = q.shape
    Tk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    bk = 32
    scale = D ** -0.5 if scale is None else scale
    qh = q.transpose(1, 2)                                 # (B, H, Tq, D)
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)     # (B, H, Tk, D)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    m = torch.full((B, H, Tq), NEG)
    l = torch.zeros((B, H, Tq))
    acc = torch.zeros((B, H, Tq, D))
    rows = torch.arange(Tq)[:, None]
    for kb in range(0, Tk, bk):
        keys = torch.arange(kb, kb + bk)[None, :]
        live = (keys < Tk).expand(Tq, bk)
        if causal:
            live = live & (keys <= rows)
            if window is not None:
                live = live & (keys > rows - window)
        # copies past Tk are zero-filled
        kt = torch.zeros((B, H, bk, D))
        vt = torch.zeros((B, H, bk, D))
        kt[:, :, :min(bk, Tk - kb)] = kh[:, :, kb:kb + bk]
        vt[:, :, :min(bk, Tk - kb)] = vh[:, :, kb:kb + bk]
        # S = Q . K^T, each 8-dim chunk into a zeroed sum
        s = torch.zeros((B, H, Tq, bk))
        for c in range(0, D, 8):
            s = mma3c(s, qh[..., c:c + 8],
                      kt[..., c:c + 8].transpose(-1, -2))
        s = torch.where(live, s * scale, torch.tensor(NEG))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(live, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        m = m_new
        acc = acc * alpha[..., None]
        # O += P . V, each 8-key chunk into a zeroed sum
        for c in range(0, bk, 8):
            acc = mma3c(acc, p[..., c:c + 8], vt[..., c:c + 8, :])
    denom = l.clamp_min(1e-30)
    out = (acc / denom[..., None]).transpose(1, 2).contiguous()
    return out, m + torch.log(denom)


def _jax_flash(q, k, v, causal, window=None):
    out, lse = pk._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=None, block_q=16, block_k=16, interpret=True, window=window,
        return_lse=True)
    B, Tq, H, _ = q.shape
    lse = np.asarray(lse)[:, :Tq, 0].reshape(B, H, Tq)
    return np.asarray(out), lse


CASES = {
    # (B, Tq, Tk, H, Hk, D, causal, window)
    "causal_D16": (2, 48, 48, 2, 2, 16, True, None),
    "causal_D64": (1, 80, 80, 2, 2, 64, True, None),
    "noncausal_cross_D16": (1, 40, 72, 2, 2, 16, False, None),
    "noncausal_cross_D64": (1, 24, 40, 2, 2, 64, False, None),
    "window_D16": (1, 96, 96, 2, 2, 16, True, 20),
    "window_D64": (1, 70, 70, 2, 2, 64, True, 24),
    "gqa2_D16": (1, 64, 64, 4, 2, 16, True, None),
    "gqa4_D64": (1, 40, 40, 4, 1, 64, True, None),
    "ragged_T37_D64": (1, 37, 37, 2, 2, 64, True, None),
    "ragged_T1_D16": (2, 1, 1, 2, 2, 16, True, None),
    "pp_T32_D16": (2, 32, 32, 4, 4, 16, True, None),
    # rows 29.. see no key (causal, window 8, Tq > Tk)
    "rows_without_keys_D16": (1, 40, 22, 2, 2, 16, True, 8),
}


def _inputs(seed, B, Tq, Tk, H, Hk, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Tq, H, D)).astype(np.float32),
            rng.standard_normal((B, Tk, Hk, D)).astype(np.float32),
            rng.standard_normal((B, Tk, Hk, D)).astype(np.float32))


@pytest.mark.parametrize("B,Tq,Tk,H,Hk,D,causal,window",
                         list(CASES.values()), ids=list(CASES))
def test_emulated_kernel_matches_plain_and_jax(B, Tq, Tk, H, Hk, D, causal,
                                               window):
    q, k, v = _inputs(17, B, Tq, Tk, H, Hk, D)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_fwd_tf32x3(tq, tk, tv, causal, window)
    ref, ref_lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                            window=window)
    assert float((out - ref).abs().max()) <= TOL
    assert float((lse - ref_lse).abs().max()) <= LSE_TOL
    jout, jlse = _jax_flash(q, k, v, causal, window)
    assert float(np.abs(out.numpy() - jout).max()) <= TOL
    assert float(np.abs(lse.numpy() - jlse).max()) <= LSE_TOL


def test_rows_without_keys_write_zero_and_the_floor_lse():
    q, k, v = _inputs(5, 1, 40, 22, 2, 2, 16)
    out, lse = flash_fwd_tf32x3(*map(torch.from_numpy, (q, k, v)), True, 8)
    dead = slice(29, None)         # row i sees keys (i - 8, i] and k < 22
    assert torch.equal(out[:, dead], torch.zeros_like(out[:, dead]))
    floor = torch.tensor(NEG) + torch.log(torch.tensor(1e-30))
    assert torch.equal(lse[..., dead], floor.expand_as(lse[..., dead]))


def test_split_is_exact_and_small():
    """x - big is exact in float32 and |small| <= 2^-11 |x|; big has at
    most 10 stored mantissa bits and rounds halfway cases away from 0."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096)
                         .astype(np.float32) * 1e3)
    big, small = split(x)
    assert torch.equal((x.double() - big.double()).float().double(),
                       x.double() - big.double())
    assert bool((small.abs() <= x.abs() * 2.0 ** -11).all())
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((small.view(torch.int32) & 0x1FFF) == 0).all())
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert to_tf32(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


@pytest.mark.parametrize("D", [16, 64])
def test_three_products_are_what_makes_it_float32(D):
    """The split is what holds the kernel to float32: against a float64
    evaluation, the 3xTF32 sums are within a few float32 roundings where
    one TF32 product (big parts alone) is over 1000x further and off the
    1e-4 bound: that bound rejects a kernel that lost the split."""
    q, k, v = map(torch.from_numpy, _inputs(9, 1, 64, 64, 2, 2, D))
    qh, kh, vh = (x.transpose(1, 2).double() for x in (q, k, v))
    s = qh @ kh.transpose(-1, -2) * D ** -0.5
    s = s.masked_fill(torch.ones(64, 64, dtype=torch.bool).triu(1),
                      float("-inf"))
    exact = (torch.softmax(s, -1) @ vh).transpose(1, 2)
    out, _ = flash_fwd_tf32x3(q, k, v, True)
    err3 = float((out.double() - exact).abs().max())
    one, _ = fa.flash_attention_plain(to_tf32(q), to_tf32(k), to_tf32(v),
                                      causal=True)
    err1 = float((one.double() - exact).abs().max())
    assert err3 <= 2e-6
    assert err1 >= 1000 * err3
    assert err1 > TOL
