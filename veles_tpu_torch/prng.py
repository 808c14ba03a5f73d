"""Seeded, named PRNG streams (counterpart of veles_tpu/prng.py).

The numpy half is the JAX package's, bit for bit: each stream's host-side
``numpy.random.Generator`` (PCG64 from the stream's seed) and the
per-name seed derivation from ``root.common.random_seed``, so loader
shuffles and every other host draw equal the JAX package's.  The JAX key
chain becomes ``torch.Generator`` objects: ``next_generator()`` advances
the stream's count and returns a generator seeded from (seed, count).
The two frameworks give different numbers from the same key, so nothing
compares the device draws across packages; the count advances exactly as
the JAX chain's, and ``state()`` keeps the JAX dict layout, so a
payload's ``"prng"`` entry restores in either package.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch

from .config import root

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key, count) -> Tuple[int, int]:
    """Threefry-2x32 (20 rounds, JAX's default PRNG) of the uint32 pair
    ``count`` under the uint32 pair ``key``."""
    k0, k1 = (int(v) & _M32 for v in key)
    x0, x1 = (int(v) & _M32 for v in count)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def split(key) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``jax.random.split(key)`` (two keys) of a raw uint32 pair."""
    return threefry2x32(key, (0, 0)), threefry2x32(key, (0, 1))


def fold_in(key, data: int) -> Tuple[int, int]:
    """``jax.random.fold_in(key, data)`` of a raw uint32 pair."""
    return threefry2x32(key, (0, int(data) & _M32))


def bits32(key) -> int:
    """``jax.random.bits(key, dtype=uint32)``: one 32-bit draw."""
    a, b = threefry2x32(key, (0, 0))
    return a ^ b


def name_hash(name: str) -> int:
    """The unit-name hash ``Context.unit_key`` folds into the step key
    (veles_tpu/units/base.py:90-97)."""
    h = 0
    for c in name:
        h = (h * 131 + ord(c)) % (2 ** 31 - 1)
    return h



class RandomStream:
    """One named stream: a counted torch-generator chain plus a numpy
    Generator (``numpy``, used by loaders for epoch permutations)."""

    def __init__(self, name: str, seed: int):
        self.name = name
        self.seed = int(seed)
        self._count = 0
        self.numpy = np.random.Generator(np.random.PCG64(self.seed))
        self._lock = threading.Lock()

    def _seed_at(self, count: int) -> int:
        return int(np.random.SeedSequence(
            [self.seed, count]).generate_state(1, np.uint64)[0])

    def next_seed(self) -> int:
        """Advance the chain and return the 64-bit seed of its new link
        (the counterpart of ``next_key()``)."""
        with self._lock:
            self._count += 1
            return self._seed_at(self._count)

    def next_generator(self, device="cpu") -> torch.Generator:
        """Advance and return a fresh generator on ``device``."""
        return torch.Generator(device=device).manual_seed(self.next_seed())

    def randint(self, low, high=None, size=None):
        return self.numpy.integers(low, high, size)

    def permutation(self, n: int) -> np.ndarray:
        return self.numpy.permutation(n)

    def state(self) -> dict:
        return {
            "seed": self.seed,
            "count": self._count,
            "numpy": self.numpy.bit_generator.state,
        }

    def set_state(self, st: dict) -> None:
        self.seed = int(st["seed"])
        self._count = int(st["count"])
        self.numpy = np.random.Generator(np.random.PCG64(0))
        self.numpy.bit_generator.state = st["numpy"]


class _Registry:
    def __init__(self):
        self._streams: Dict[str, RandomStream] = {}
        self._lock = threading.Lock()

    def get(self, name: str = "default") -> RandomStream:
        """Fetch-or-create the named stream; its seed derives from
        ``root.common.random_seed`` and the name as in the JAX package."""
        with self._lock:
            if name not in self._streams:
                master = int(root.common.value("random_seed", 42))
                sub = np.random.SeedSequence(
                    [master, *[ord(c) for c in name]]).generate_state(1)[0]
                self._streams[name] = RandomStream(name, int(sub))
            return self._streams[name]

    def seed(self, name: str, seed: int) -> RandomStream:
        """Explicitly (re)seed a stream."""
        with self._lock:
            self._streams[name] = RandomStream(name, seed)
            return self._streams[name]

    def state(self) -> dict:
        with self._lock:
            return {k: v.state() for k, v in self._streams.items()}

    def set_state(self, st: dict) -> None:
        with self._lock:
            for k, s in st.items():
                stream = self._streams.get(k)
                if stream is None:
                    stream = self._streams[k] = RandomStream(k, s["seed"])
                stream.set_state(s)

    def reset(self) -> None:
        with self._lock:
            self._streams.clear()


streams = _Registry()
get = streams.get
seed = streams.seed
