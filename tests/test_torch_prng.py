"""The port's JAX key chain (``veles_tpu_torch/prng.py``) against
``jax.random``, and the train step's key against the JAX package's.

``threefry2x32``, ``split``, ``fold_in`` and ``bits32`` must equal
``jax.random``'s bit for bit (partitionable threefry, the JAX default);
the unit-name fold of ``Context.unit_key`` must equal the JAX package's;
after 1 and 3 train steps from the same key the port's ``wstate["key"]``
must equal the JAX state's raw key data."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_helpers import build_pair, induction_layers, tokens  # noqa: E402
from veles_tpu.ops import optimizers as jopt  # noqa: E402
from veles_tpu.units.base import Context as JaxContext  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.ops import optimizers as popt  # noqa: E402
from veles_tpu_torch.units.base import Context  # noqa: E402
from veles_tpu_torch.units.workflow import (seed_key,  # noqa: E402
                                            split_state_key)

KEYS = [0, 1, 3, 42, 2 ** 31 - 1]
NAMES = ["drop6", "drop7", "l3_dropout", "", "a_long_unit_name_0123456789"]


def _raw(key):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)))


def test_jax_key_chain_is_threefry_partitionable():
    """The equivalences below assume JAX's default partitionable
    threefry; this pins the assumption."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", KEYS)
def test_split_fold_in_bits_match_jax_random(seed):
    jkey = jax.random.key(seed)
    pkey = tuple(int(v) for v in seed_key(seed))
    assert pkey == _raw(jkey)
    ja, jb = jax.random.split(jkey)
    pa, pb = prng.split(pkey)
    assert (pa, pb) == (_raw(ja), _raw(jb))
    for data in (0, 1, 12345, 2 ** 31 - 2):
        jf = jax.random.fold_in(jb, data)
        pf = prng.fold_in(pb, data)
        assert pf == _raw(jf)
        assert prng.bits32(pf) == int(jax.random.bits(jf, dtype=jnp.uint32))


def test_threefry_counts_match_jax_prng():
    from jax._src import prng as jprng
    rng = np.random.default_rng(0)
    for _ in range(8):
        key = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
        cnt = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
        ref = jprng.threefry_2x32(jnp.asarray(key), jnp.asarray(cnt))
        assert prng.threefry2x32(key, cnt) == tuple(int(v) for v in ref)


@pytest.mark.parametrize("name", NAMES)
def test_unit_key_matches_jax_context(name):
    jkey = jax.random.fold_in(jax.random.key(7), 3)
    jctx = JaxContext(train=True, key=jkey)
    pctx = Context(train=True, key=_raw(jkey))
    assert pctx.unit_key(name) == _raw(jctx.unit_key(name))
    seed = prng.bits32(pctx.unit_key(name))
    assert seed == int(jax.random.bits(jctx.unit_key(name),
                                       dtype=jnp.uint32))
    assert Context(train=True).unit_key(name) is None


def test_split_state_key_keeps_the_state_layout():
    key, sub = split_state_key(seed_key(5))
    assert key.dtype == np.uint32 and key.shape == (2,)
    ja, jb = jax.random.split(jax.random.key(5))
    assert tuple(int(v) for v in key) == _raw(ja) and sub == _raw(jb)
    assert split_state_key(None) == (None, None)


def test_train_step_advances_the_key_as_jax():
    """1 and 3 steps from the same key: the port's state key equals the
    JAX state's raw key data after each step."""
    rng = np.random.default_rng(0)
    jo, po = jopt.SGD(0.1), popt.SGD(0.1)
    jwf, jws, pwf, pws = build_pair(induction_layers(), B=4, T=12, seed=2,
                                    optimizers=(jo, po))
    jws = {**jws, "key": jax.random.key(11)}
    pws["key"] = seed_key(11)
    jstep = jwf.make_train_step(jo, donate=False)
    pstep = pwf.make_train_step(po)
    for i in range(3):
        b = {"@input": tokens(rng, (4, 12), 16),
             "@labels": tokens(rng, (4,), 16),
             "@mask": np.ones(4, np.float32)}
        jws, _ = jstep(jws, b)
        pws, _ = pstep(pws, {k: torch.from_numpy(v) for k, v in b.items()})
        assert isinstance(pws["key"], np.ndarray)
        assert pws["key"].dtype == np.uint32
        assert tuple(int(v) for v in pws["key"]) == _raw(jws["key"]), i


def test_step_generator_comes_from_the_sub_key():
    """The Context's torch generator is seeded from the step's sub key:
    the same key gives the same draws, another key others."""
    from veles_tpu_torch.units.workflow import _step_generator
    params = {"u": {"w": torch.zeros(2)}}
    _, sub = split_state_key(seed_key(1))
    _, other = split_state_key(seed_key(2))
    a = torch.rand(4, generator=_step_generator(sub, params))
    b = torch.rand(4, generator=_step_generator(sub, params))
    c = torch.rand(4, generator=_step_generator(other, params))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert _step_generator(None, params) is None
