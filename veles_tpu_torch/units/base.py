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
    and, in a train step, the ``torch.Generator`` stochastic units draw
    from (where the JAX step splits its key).  The generator is made by
    ``make_generator`` on first use, so a step that draws nothing makes
    none."""
    train: bool = False
    mesh: Optional[Any] = None
    make_generator: Optional[Callable[[], torch.Generator]] = None
    _generator: Optional[torch.Generator] = dataclasses.field(
        default=None, init=False, repr=False)

    @property
    def generator(self) -> Optional[torch.Generator]:
        if self._generator is None and self.make_generator is not None:
            self._generator = self.make_generator()
        return self._generator


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
