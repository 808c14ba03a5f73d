"""Unit core (counterpart of veles_tpu/units/base.py), with the utility
units of veles_tpu/units/base.py:100-233: ``UnitRegistry``,
``TrivialUnit``, ``LambdaUnit``, ``InputJoiner`` and ``Avatar``.

A unit is a small descriptor plus plain functions over tensors, as in the
JAX package: ``init(generator, in_specs, device)`` builds its
``(params, state)`` dictionaries and ``apply(params, state, xs, ctx)`` is
its forward.  The Workflow keeps every tensor in one state dictionary
keyed by unit name — the layout snapshots flatten — so weights move
between the two packages by key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

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
    mesh (``parallel.mesh.Mesh``: the process groups of its axes; None:
    one process) and, in a train step, the step's PRNG key: the raw uint32 pair the
    JAX step passes as ``sub`` (veles_tpu/units/base.py:47-97).  Units
    draw from ``unit_key(name)``, the JAX package's per-name fold, so a
    dropout mask equals the JAX package's.  ``seeds`` maps a unit that
    draws a seed (``Unit.draws_seed``) to its seed slot on the device: a
    one-element int32 tensor the train step's host part fills with
    ``bits32(unit_key(name))`` before each step, so the device part
    (eager or captured) reads the seed there and takes no host value.
    ``generator`` is a ``torch.Generator`` made by ``make_generator`` on
    first use, for draws that have no JAX counterpart to match; a step
    that draws nothing makes none.

    ``manual_axes`` says how a unit finds its data laid out over the
    mesh (veles_tpu/units/base.py:47-88).  ``None`` (the default): every
    tensor the unit sees is the whole (logical) value on every rank of
    the axes a unit parallelizes over, so the unit lays its work out
    itself (ring attention slices its sequence chunk and gathers the
    output).  A tuple: the caller (a pipeline schedule) has already
    sharded the unit's data over the named axes, and the unit runs its
    per-rank body with collectives over those axes only.

    ``tp`` maps a unit name to the ``model`` splits of its params it
    computes over the model group itself (``Unit.tp_local``; its params
    are then this rank's blocks there): the megatron operators of
    ``parallel/tensor_parallel.py``.  None or a missing name: whole
    params."""
    train: bool = False
    mesh: Optional[Any] = None
    make_generator: Optional[Callable[[], torch.Generator]] = None
    key: Optional[Tuple[int, int]] = None
    seeds: Optional[Dict[str, torch.Tensor]] = None
    manual_axes: Optional[Tuple[str, ...]] = None
    tp: Optional[Dict[str, dict]] = None
    _generator: Optional[torch.Generator] = dataclasses.field(
        default=None, init=False, repr=False)

    @property
    def generator(self) -> Optional[torch.Generator]:
        if self._generator is None and self.make_generator is not None:
            self._generator = self.make_generator()
        return self._generator

    def axis_size(self, name: str) -> int:
        """Size of mesh axis ``name`` (1 without a mesh or axis)."""
        if self.mesh is None:
            return 1
        return int(self.mesh.shape.get(name, 1))

    def collective_mode(self, name: str) -> str:
        """How a unit parallelizes over mesh axis ``name``: ``"none"``
        (the axis is absent or of size 1, or a schedule did not lay the
        unit's data out over it: the local formulation), ``"wrapper"``
        (whole tensors: the unit lays out its own work over the axis) or
        ``"manual"`` (the data is already sharded over the axis: the
        per-rank body)."""
        if self.axis_size(name) <= 1:
            return "none"
        if self.manual_axes is None:
            return "wrapper"
        return "manual" if name in self.manual_axes else "none"

    def tp_split(self, name: str) -> Optional[dict]:
        """The model splits unit ``name`` computes over (None: whole
        params)."""
        return None if self.tp is None else self.tp.get(name)

    def unit_key(self, name: str) -> Optional[Tuple[int, int]]:
        """``fold_in(key, hash(name))`` as ``Context.unit_key`` of the
        JAX package computes it; None without a key."""
        if self.key is None:
            return None
        return prng.fold_in(self.key, prng.name_hash(name))

    def unit_seed(self, name: str):
        """The seed unit ``name`` draws: its slot in ``seeds`` (a device
        tensor), else ``bits32(unit_key(name))`` as a host int, else None
        (no key)."""
        if self.seeds is not None and name in self.seeds:
            return self.seeds[name]
        key = self.unit_key(name)
        return None if key is None else prng.bits32(key)


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


class UnitRegistry:
    """Name -> class registry of every unit class (the JAX package's
    ``UnitRegistry``: veles/unit_registry.py's metaclass in the
    reference)."""

    _units: Dict[str, type] = {}

    @classmethod
    def register(cls, klass):
        cls._units[klass.__name__] = klass
        return klass

    @classmethod
    def get(cls, name: str) -> type:
        return cls._units[name]

    @classmethod
    def names(cls):
        return sorted(cls._units)


class UnitMeta(type):
    def __init__(cls, name, bases, ns):
        super().__init__(name, bases, ns)
        if name != "Unit":
            UnitRegistry.register(cls)


def _meta_specs(fn, in_specs) -> Spec:
    """The output spec of ``fn`` over tensors of ``in_specs``, run on
    the meta device (the port's ``jax.eval_shape``)."""
    y = fn(*[torch.empty(s.shape, dtype=s.dtype, device="meta")
             for s in in_specs])
    return Spec(tuple(y.shape), y.dtype)


class Unit(Logger, metaclass=UnitMeta):
    """Base of every dataflow node: ``inputs`` names the upstream units
    (or ``@batch`` keys) whose outputs it consumes."""

    #: True for a unit whose train forward draws a 32-bit seed from the
    #: step key: the train step gives it a device seed slot
    #: (``Context.seeds``) and fills it every step
    draws_seed: bool = False

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

    def tp_local(self, parts: Dict[str, tuple], n_model: int) -> set:
        """The params whose ``model`` split (``parts``: param -> its
        partition under the rule) this unit computes over the model group
        itself; the others are gathered on use.  None by default."""
        return set()

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r} <- {list(self.inputs)})"


class TrivialUnit(Unit):
    """Identity passthrough (reference: veles/units.py:916)."""

    def apply(self, params, state, xs, ctx):
        return xs[0], state


class Forward(Unit):
    """Marker base for trainable forward layers."""


class LambdaUnit(Unit):
    """Wrap a pure tensor function as a unit; its output spec comes from
    ``out_spec(in_specs)`` or from running ``fn`` on meta tensors."""

    def __init__(self, fn: Callable, name=None, inputs=("@input",),
                 out_spec: Optional[Callable] = None):
        super().__init__(name or getattr(fn, "__name__", "LambdaUnit"),
                         inputs)
        self._fn = fn
        self._out_spec = out_spec

    def output_spec(self, in_specs):
        if self._out_spec is not None:
            return self._out_spec(in_specs)
        return _meta_specs(self._fn, in_specs)

    def apply(self, params, state, xs, ctx):
        return self._fn(*xs), state


class InputJoiner(Unit):
    """Concatenate the inputs along ``axis`` (reference:
    veles/input_joiner.py:49)."""

    def __init__(self, name=None, inputs=(), axis: int = -1):
        super().__init__(name, inputs)
        self.axis = axis

    def output_spec(self, in_specs):
        return _meta_specs(lambda *xs: torch.cat(xs, dim=self.axis),
                           in_specs)

    def apply(self, params, state, xs, ctx):
        return torch.cat(list(xs), dim=self.axis), state


class Avatar(TrivialUnit):
    """An identity kept for graph readability: in a dataflow graph an
    output may be consumed twice (reference: veles/avatar.py:22)."""
