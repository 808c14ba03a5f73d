"""Unit core (counterpart of veles_tpu/units/base.py).

A unit is a small descriptor plus plain functions over tensors, as in the
JAX package: ``init(generator, in_specs, device)`` builds its
``(params, state)`` dictionaries and ``apply(params, state, xs, ctx)`` is
its forward.  The Workflow keeps every tensor in one state dictionary
keyed by unit name — the layout snapshots flatten — so weights move
between the two packages by key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from .. import prng
from ..logger import Logger


@dataclasses.dataclass(frozen=True)
class Spec:
    """Shape + dtype of a tensor flowing between units (the JAX package's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))


@dataclasses.dataclass
class Context:
    """Per-call context threaded through apply(): the train/eval flag, the
    device mesh (None: single device — the only layout the port runs yet)
    and, in a train step, the step's PRNG key: the raw uint32 pair the
    JAX step passes as ``sub`` (veles_tpu/units/base.py:47-97).  Units
    draw from ``unit_key(name)``, the JAX package's per-name fold, so a
    dropout mask equals the JAX package's.  ``generator`` is a
    ``torch.Generator`` made by ``make_generator`` on first use, for
    draws that have no JAX counterpart to match; a step that draws
    nothing makes none."""
    train: bool = False
    mesh: Optional[Any] = None
    make_generator: Optional[Callable[[], torch.Generator]] = None
    key: Optional[Tuple[int, int]] = None
    _generator: Optional[torch.Generator] = dataclasses.field(
        default=None, init=False, repr=False)

    @property
    def generator(self) -> Optional[torch.Generator]:
        if self._generator is None and self.make_generator is not None:
            self._generator = self.make_generator()
        return self._generator

    def unit_key(self, name: str) -> Optional[Tuple[int, int]]:
        """``fold_in(key, hash(name))`` as ``Context.unit_key`` of the
        JAX package computes it; None without a key."""
        if self.key is None:
            return None
        return prng.fold_in(self.key, prng.name_hash(name))


def dtype_of(name) -> Optional[torch.dtype]:
    """Config dtype names ("bfloat16", "float32") -> torch dtypes; None
    or "" stays None (no compute-dtype policy)."""
    if name in (None, ""):
        return None
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class Unit(Logger):
    """Base of every dataflow node: ``inputs`` names the upstream units
    (or ``@batch`` keys) whose outputs it consumes."""

    #: why a train step holding this unit cannot be captured as a CUDA
    #: graph (``runtime/step_cache.py``), or None: a unit whose train-mode
    #: forward takes a per-step host value names it here
    capture_blocker: Optional[str] = None

    def __init__(self, name: Optional[str] = None,
                 inputs: Sequence[str] = ("@input",)):
        self.name = name or type(self).__name__
        self.inputs: Tuple[str, ...] = tuple(inputs)

    def output_spec(self, in_specs: Sequence[Spec]) -> Spec:
        return in_specs[0]

    def init(self, generator: torch.Generator, in_specs: Sequence[Spec],
             device) -> Tuple[dict, dict]:
        """Return (params, state) dictionaries of tensors on ``device``."""
        return {}, {}

    def apply(self, params, state, xs, ctx: Context):
        """Forward: returns (output, new_state)."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r} <- {list(self.inputs)})"


class Forward(Unit):
    """Marker base for trainable forward layers."""
