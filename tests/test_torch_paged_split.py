"""The arithmetic of the paged decode kernel
(``veles_tpu_torch/csrc/paged_attention.cu``) emulated on the CPU.

The kernel runs only on a Hopper card; what it computes is the function of
``paged_attention_decode_plain`` and of the JAX package's
``paged_attention_decode``, but in its own order: each (row, kv head)
group's live pages split across a cluster of SPLITS blocks (a fixed run of
pages a block), a block's keys staged CHUNK at a time, key ``slot + k
SLOTS`` of a chunk owned by one key slot of the block (LPK lanes of one
16-byte piece each), each slot its own online softmax over its keys in
groups (an f32 pool's 3 keys, a 16-bit pool's 9: one rescale a group,
scores in base 2 from a q pre-scaled by scale log2 e), the slots of a
warp merged pairwise by lane distance, then every block's four warp
states merged per output across the cluster (the warps of a rank first,
then the ranks pairwise by distance 1, 2), and a corrupt live entry
anywhere in the group NaNs the whole row.  The emulation below follows
that order at the slot's granularity (a slot's score a float32 dot
product) and is held, within 1e-4 as the kernel is on the card, against
the plain version and against the Pallas kernel in interpret mode on the
same numpy inputs.  Nothing in the package imports it."""

import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from veles_tpu.ops import pallas_kernels as pk  # noqa: E402
from veles_tpu_torch.ops.kernels import paged_attention as pa  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-4          # max |kernel - plain| (chip_smoke PAGED_TOL)
NEG = -1e30
LOG2E = 1.4426950408889634
SPLITS, NWARPS, KPT = 4, 4, 9    # the kernel's constants


def _merge(a, b):
    """Two softmax states (m, l, acc) as the kernel's warp merge takes
    them: m the larger, each side rescaled by exp2(its m - m)."""
    (ma, la, aa), (mb, lb, ab) = a, b
    mx = torch.maximum(ma, mb)
    fa, fb = torch.exp2(ma - mx), torch.exp2(mb - mx)
    return mx, la * fa + lb * fb, aa * fa[:, None] + ab * fb[:, None]


def _pairwise(vals, combine):
    """The butterfly over len(vals) lanes (distance 1, 2, 4, ...), as the
    kernel's shuffles: lane 0's result."""
    o = 1
    while o < len(vals):
        vals = [combine(vals[i], vals[i ^ o]) for i in range(len(vals))]
        o <<= 1
    return vals[0]


def _slot_state(qs, keys, kf, vf, kg):
    """One key slot's online softmax over its keys (lists of K and V rows)
    in groups of kg: the scores of a group, one rescale, then P.V."""
    G, Dh = qs.shape
    m = torch.full((G,), NEG)
    l = torch.zeros(G)
    acc = torch.zeros(G, Dh)
    for k0 in range(0, len(keys), kg):
        grp = keys[k0:k0 + kg]
        s = torch.stack([qs @ kf[i] for i in grp], -1)       # (G, |grp|)
        mx = torch.maximum(m, s.max(-1).values)
        alpha = torch.exp2(m - mx)
        m, l, acc = mx, l * alpha, acc * alpha[:, None]
        for u, i in enumerate(grp):
            pe = torch.exp2(s[:, u] - m)
            l = l + pe
            acc = acc + pe[:, None] * vf[i][None, :]
    return m, l, acc


def emulate(q, k_pool, v_pool, ptab, pos, *, page_size, n_kv_heads,
            window=None):
    B, H, Dh = q.shape
    Hk, psz = n_kv_heads, page_size
    G = H // Hk
    rows, n_ptab = k_pool.shape[0], ptab.shape[1]
    vec = 16 // k_pool.element_size()
    lpk = Dh // vec
    slots = 32 * NWARPS // lpk
    chunk = KPT * slots
    kg = 3 if k_pool.element_size() == 4 else KPT
    kf, vf = k_pool.float(), v_pool.float()
    out = torch.empty(B, H, Dh)
    for b in range(B):
        p = int(pos[b])
        lo = max(0, p - window + 1) if window else 0
        j_lo = lo // psz
        n_pages = max(0, min(p // psz, n_ptab - 1) - j_lo + 1)
        for kh in range(Hk):
            qs = q[b, kh * G:(kh + 1) * G].float() * (Dh ** -0.5 * LOG2E)
            ranks, bad = [], False
            for rank in range(SPLITS):
                pa_ = j_lo + rank * n_pages // SPLITS
                pb_ = j_lo + (rank + 1) * n_pages // SPLITS
                t_begin = max(pa_ * psz, lo)
                n_keys = (min(pb_ * psz - 1, p) - t_begin + 1 if pb_ > pa_
                          else 0)
                keys = {s: ([], []) for s in range(slots)}
                for c0 in range(0, n_keys, chunk):
                    n = min(chunk, n_keys - c0)
                    for idx in range(n):
                        t = t_begin + c0 + idx
                        e = int(ptab[b, t // psz])
                        ok = 0 <= e < rows
                        bad |= not ok
                        ks, vs = keys[idx % slots]
                        ks.append(kf[e, t % psz, kh] if ok
                                  else torch.zeros(Dh))
                        vs.append(vf[e, t % psz, kh] if ok
                                  else torch.zeros(Dh))
                states = [_slot_state(qs, list(range(len(keys[s][0]))),
                                      *keys[s], kg) for s in range(slots)]
                per_warp = slots // NWARPS
                ranks.append([_pairwise(states[w * per_warp:
                                               (w + 1) * per_warp], _merge)
                              for w in range(NWARPS)])
            # each rank's warps, then the ranks pairwise, per output
            local = []
            for warps in ranks:
                mx = torch.stack([w[0] for w in warps]).max(0).values
                ls, acs = torch.zeros(G), torch.zeros(G, Dh)
                for m_w, l_w, a_w in warps:
                    f = torch.exp2(m_w - mx)
                    ls = ls + l_w * f
                    acs = acs + a_w * f[:, None]
                local.append((mx, ls, acs))
            gm = _pairwise([s[0] for s in local], torch.maximum)
            scaled = [(ls * torch.exp2(mx - gm),
                       acs * torch.exp2(mx - gm)[:, None])
                      for mx, ls, acs in local]
            ls = _pairwise([s[0] for s in scaled], torch.add)
            acs = _pairwise([s[1] for s in scaled], torch.add)
            res = acs / torch.clamp(ls, min=1e-30)[:, None]
            out[b, kh * G:(kh + 1) * G] = (torch.full_like(res, math.nan)
                                           if bad else res)
    return out


def _case(seed, B, Hk, G, Dh, n_ptab, pos, pool_dtype, psz=16):
    rng = np.random.default_rng(seed)
    H = Hk * G
    rows = B * n_ptab + 1
    pools = [torch.from_numpy(rng.standard_normal(
        (rows, psz, Hk, Dh)).astype(np.float32)).to(pool_dtype)
        for _ in range(2)]
    ptab = rng.permutation(rows - 1)[:B * n_ptab].reshape(
        B, n_ptab).astype(np.int32)
    for b, p in enumerate(pos):             # entries past each span: scratch
        ptab[b, p // psz + 1:] = rows - 1
    q = torch.from_numpy(rng.standard_normal((B, H, Dh)).astype(np.float32))
    return (q, *pools, torch.from_numpy(ptab),
            torch.tensor(pos, dtype=torch.int32))


def _jax(q, k_pool, v_pool, ptab, pos, *, page_size, n_kv_heads, window):
    return np.asarray(pk.paged_attention_decode(
        *(jnp.asarray(t.float().numpy() if t.is_floating_point()
                      else t.numpy()) for t in (q, k_pool, v_pool, ptab,
                                                pos)),
        page_size=page_size, n_kv_heads=n_kv_heads, window=window,
        interpret=True))


# (Hk, G, Dh, pages a row, positions, window, pool dtype): the serving
# head width at G = 1 and GQA, Dh 16, rows with fewer live pages than
# blocks (positions 0-16: blocks with no key), a window whose first key
# is inside a page, and splits longer than a chunk (144 keys at 16-bit
# Dh 64, 72 at f32 Dh 64, 576 at 16-bit Dh 16)
CASES = {
    "bf16_D64_G1": (2, 1, 64, 64, [1023, 544, 17, 0], None, torch.bfloat16),
    "f16_D64_G4_window": (1, 4, 64, 64, [1023, 700, 130, 15], 37,
                          torch.float16),
    "f32_D64_G1_fewer_pages_than_splits": (2, 1, 64, 64, [0, 15, 16, 100],
                                           None, torch.float32),
    "bf16_D16_G8_window": (1, 8, 16, 64, [1023, 544, 17, 300], 20,
                           torch.bfloat16),
    "f32_D16_G2": (2, 2, 16, 64, [700, 129, 16, 1], None, torch.float32),
    "bf16_D64_chunked": (1, 2, 64, 256, [4095, 2100], None, torch.bfloat16),
    "f32_D64_chunked_window": (1, 1, 64, 256, [4095, 1500], 1200,
                               torch.float32),
    "f16_D16_chunked": (1, 1, 16, 512, [8191, 129], None, torch.float16),
}


@pytest.mark.parametrize("Hk,G,Dh,n_ptab,pos,window,pool_dtype",
                         list(CASES.values()), ids=list(CASES))
def test_emulated_kernel_matches_plain_and_jax(Hk, G, Dh, n_ptab, pos,
                                               window, pool_dtype):
    args = _case(0, len(pos), Hk, G, Dh, n_ptab, pos, pool_dtype)
    kw = dict(page_size=16, n_kv_heads=Hk, window=window)
    out = emulate(*args, **kw)
    plain = pa.paged_attention_decode_plain(*args, **kw)
    assert bool(torch.isfinite(out).all())
    assert float((out - plain).abs().max()) <= TOL
    assert float(np.abs(out.numpy() - _jax(*args, **kw)).max()) <= TOL


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_kernel_nans_the_row_of_a_corrupt_live_entry(pool_dtype):
    """Whichever block of a row's split reads the bad entry, the whole row
    is NaN; an entry past a row's span is never read."""
    args = _case(1, 4, 2, 1, 64, 64, [1023, 1023, 544, 100], pool_dtype)
    q, kp, vp, ptab, pos = args
    ptab[0, 60] = kp.shape[0] + 3       # row 0: the last block's pages
    ptab[2, 3] = -2                     # row 2: the first block's pages
    ptab[3, -1] = -1                    # row 3: past its span
    kw = dict(page_size=16, n_kv_heads=2)
    out = emulate(*args, **kw)
    plain = pa.paged_attention_decode_plain(*args, **kw)
    for b in (0, 2):
        assert bool(torch.isnan(out[b]).all())
        assert bool(torch.isnan(plain[b]).all())
    keep = [1, 3]
    assert bool(torch.isfinite(out[keep]).all())
    assert float((out[keep] - plain[keep]).abs().max()) <= TOL
