"""The port's capturable sampler (runtime/generate.py ``sample_slots``)
on the CPU: greedy rows are the float32 argmax bit for bit; the top-k /
top-p filter keeps the candidates the JAX package's ``_sample_slots``
keeps on the same logits (veles_tpu/runtime/engine.py:1024-1066); the
array ``fold_seed`` the engine fills its key table with equals the host
one bit for bit; the Gumbel noise is a pure function of (seed, position,
vocabulary index) and finite for every hash, so a filtered entry never
comes back."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from veles_tpu.runtime import engine as jax_engine  # noqa: E402
from veles_tpu_torch.runtime.generate import (  # noqa: E402
    filter_logits, fold_keys, fold_seed, fold_seed_array, gumbel_from_bits,
    gumbel_noise, sample_slots, sampling_tensors)

V = 16

#: per-row (temperature, top_k, top_p): keep-all sentinels, top-k alone,
#: top-p alone, both, a top_k past V, a tiny top_p (one candidate)
ROWS = [(1.0, V, 1.0), (0.7, 3, 1.0), (1.3, V, 0.8), (0.9, 5, 0.6),
        (2.0, 40, 0.95), (1.1, V, 1e-6)]


def _logits(rng, S, ties=False):
    lg = rng.normal(0.0, 2.0, (S, V)).astype(np.float32)
    if ties:
        # equal values straddling the k-th threshold and the top-p cut
        lg[:, :6] = np.round(lg[:, :6])
        lg[:, 6:10] = lg[:, :4]
    return lg


def _jax_candidates(logits, temp, topk, topp):
    """The JAX sampler's finite candidates per row, read through its
    categorical draw: each row's draw answers the bitmask of its finite
    filtered logits (V <= 30 fits an int32)."""
    bit = (1 << np.arange(V)).astype(np.int32)

    def mask(key, row):
        return jnp.sum(jnp.where(jnp.isfinite(row[0]), bit, 0),
                       dtype=jnp.int32)[None]

    keys = jax.vmap(jax.random.key)(jnp.arange(len(temp)))
    real = jax.random.categorical
    jax.random.categorical = mask
    try:
        got = jax_engine._sample_slots(
            jnp.asarray(logits), keys, jnp.asarray(temp, jnp.float32),
            jnp.asarray(topk, jnp.int32), jnp.asarray(topp, jnp.float32))
    finally:
        jax.random.categorical = real
    return [{v for v in range(V) if int(m) >> v & 1} for m in np.asarray(got)]


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_filter_keeps_the_jax_samplers_candidates(rng, ties):
    lg = _logits(rng, len(ROWS), ties)
    temp, topk, topp = (np.array(c) for c in zip(*ROWS))
    want = _jax_candidates(lg, temp, topk, topp)
    t, k, p = sampling_tensors(temp, topk, topp, "cpu")
    x3 = filter_logits(torch.from_numpy(lg), t, k, p)
    got = [set(np.flatnonzero(np.isfinite(r)).tolist()) for r in x3.numpy()]
    assert got == want
    assert len(got[-1]) == 1 and len(got[0]) == V


def test_greedy_rows_are_the_argmax_bitwise(rng):
    """Greedy rows among sampled ones take ``logits.float().argmax``;
    bf16 logits are widened first, as the decode step's are."""
    for dtype in (torch.float32, torch.bfloat16):
        lg = torch.from_numpy(_logits(rng, 6, ties=True)).to(dtype)
        temp = [0.0, 1.0, 0.0, -1.0, 0.8, 0.0]
        samp = sampling_tensors(temp, [V] * 6, [1.0] * 6, "cpu")
        out = sample_slots(lg, *samp,
                           gumbel_noise(fold_keys(range(6), 3, "cpu"), V))
        greedy = lg.float().argmax(-1)
        for r, t in enumerate(temp):
            if t <= 0:
                assert out[r] == greedy[r]


def test_fold_seed_array_equals_the_host_fold():
    gen = random.Random(3)
    seeds = [0, 1, -1, 2 ** 63 - 1, -2 ** 63, 2 ** 64 + 5, 2 ** 70 + 3] + [
        gen.getrandbits(64) - 2 ** 63 for _ in range(60)]
    values = np.array([0, 1, 2 ** 31 - 1]
                      + [gen.randrange(2 ** 31) for _ in range(9)])
    for s in seeds:
        got = fold_seed_array(s, values)
        assert got.dtype == np.int64
        assert got.tolist() == [fold_seed(s, int(v)) for v in values]


def _noise(seeds, pos):
    return torch.cat([gumbel_noise(fold_keys([s], p, "cpu"), 1024)
                      for s, p in zip(seeds, pos)])


def test_noise_is_a_function_of_seed_and_position_only():
    seeds, pos = (7, 7, 7, 8, -5), (3, 3, 4, 3, 3)
    a = _noise(seeds, pos)
    assert torch.equal(a, _noise(seeds, pos))
    assert torch.equal(a[0], a[1])                  # same (seed, pos)
    assert not torch.equal(a[0], a[2])              # another position
    assert not torch.equal(a[0], a[3])              # another seed
    # a batch of rows is the rows alone
    keys = torch.cat([fold_keys([s], p, "cpu") for s, p in zip(seeds, pos)])
    assert torch.equal(gumbel_noise(keys, 1024), a)
    assert torch.isfinite(a).all()


def test_sampled_rows_follow_their_seed_and_position(rng):
    """One sampled row's token is the same alone and in a batch of other
    rows, and the draw spreads over the candidates across seeds."""
    lg = torch.from_numpy(_logits(rng, 1)).expand(4, V).contiguous()
    samp = sampling_tensors([1.5] * 4, [V] * 4, [1.0] * 4, "cpu")
    noise = gumbel_noise(fold_keys([11, 12, 13, 14], 9, "cpu"), V)
    batch = sample_slots(lg, *samp, noise)
    for r in range(4):
        alone = sample_slots(lg[r:r + 1], *(t[r:r + 1] for t in samp),
                             noise[r:r + 1])
        assert alone[0] == batch[r]
    one = sampling_tensors([1.5], [V], [1.0], "cpu")
    draws = {int(sample_slots(lg[:1], *one, gumbel_noise(
        fold_keys([s], 9, "cpu"), V))[0]) for s in range(64)}
    assert len(draws) > 3


def test_noise_is_finite_for_every_hash():
    """Every 32-bit hash gives finite noise: the extremes, and each of
    the 2^23 bins of ``u`` (the bits below the bin do not reach it)."""
    ends = gumbel_from_bits(torch.tensor([0, 2 ** 32 - 1], dtype=torch.int64))
    assert torch.isfinite(ends).all() and ends[0] < ends[1]
    bins = torch.arange(2 ** 23, dtype=torch.int64) << 9
    for low in (0, 2 ** 9 - 1):
        assert torch.isfinite(gumbel_from_bits(bins | low)).all()


def test_a_single_candidate_wins_against_the_largest_noise(rng):
    """top_k = 1 and a tiny top_p keep one candidate, the row's argmax;
    the sampler returns it even when every other entry draws the largest
    noise a hash can give and the argmax the smallest."""
    S = 64
    lg = torch.from_numpy(rng.normal(0.0, 3.0, (S, V)).astype(np.float32))
    best = lg.argmax(-1)
    bits = torch.full((S, V), 2 ** 32 - 1, dtype=torch.int64)
    bits[torch.arange(S), best] = 0
    noise = gumbel_from_bits(bits)
    for topk, topp in ((1, 1.0), (V, 1e-6), (1, 1e-6)):
        samp = sampling_tensors(rng.uniform(0.1, 3.0, S), [topk] * S,
                                [topp] * S, "cpu")
        assert torch.equal(sample_slots(lg, *samp, noise), best)
        # and with each row's own noise, at 64 positions
        for pos in range(0, 640, 10):
            assert torch.equal(sample_slots(lg, *samp, gumbel_noise(
                fold_keys(range(S), pos, "cpu"), V)), best)
