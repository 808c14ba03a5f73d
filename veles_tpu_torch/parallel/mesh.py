"""The mesh of the port: ranks over named axes, one ``torch.distributed``
process group per axis (counterpart of veles_tpu/parallel/mesh.py,
``MeshSpec`` :35-62, ``make_mesh`` :64, the placement rules
``data_parallel_rules``, ``fsdp_rules``, ``tensor_parallel_rules`` and
``compose_rules`` :104-165, ``state_shardings`` :176-211 and
``batch_shardings`` :213-231).

One process is one rank is one device.  The world's ranks are laid out
over the axes ``(data, fsdp, model, seq, pipe, expert)`` in the order the
JAX package reshapes its device list, so rank ``r`` of a ``data=2,pipe=2``
mesh sits where the JAX mesh puts device ``r``.  A rule maps a state
leaf's ``(path, shape)`` to its partition tuple; ``state_shardings``
applies it over a state tree with the JAX package's divisibility guard,
and ``parallel/fsdp.py`` stores each rank's block of every leaf it
splits (gathered on use, gradients reduce-scattered back).  ``fsdp``
ranks are data-parallel: the batch rows split over ``data`` x ``fsdp``.
``model`` ranks compute the same rows; a unit whose weights the rule
splits the megatron way computes its part over the model group
(``parallel/tensor_parallel.py``).  A ``seq`` axis runs ring attention
over its group (``parallel/ring_attention.py``), an ``expert`` axis the
expert all-to-all (``parallel/moe.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: axis order of the JAX package's ``make_mesh`` (devices reshaped so)
AXES = ("data", "fsdp", "model", "seq", "pipe", "expert")
#: the axes the port runs: all of them
PORTED_AXES = AXES
#: the axes whose group exists even at size 1 (the data-parallel and
#: pipeline steps read it)
ALWAYS_GROUPED = ("data", "pipe")
#: the axes over which ranks hold the same block of every leaf a rule
#: splits over ``fsdp`` or ``model``: a gradient sums over them first
REPLICA_AXES = ("data", "seq", "pipe", "expert")


def check_axes(sizes: Dict[str, int]) -> None:
    """Raise ``ValueError`` for an axis the mesh does not know or a size
    below 1 (-1 absorbs the remaining ranks)."""
    for a, n in sizes.items():
        if a not in AXES:
            raise ValueError(f"unknown mesh axis {a!r} (axes: "
                             f"{', '.join(AXES)})")
        if int(n) < 1 and int(n) != -1:
            raise ValueError(f"mesh axis {a!r} has size {n}")


@dataclasses.dataclass
class MeshSpec:
    """Declarative mesh description; -1 absorbs the remaining ranks
    (veles_tpu/parallel/mesh.py:35-62)."""
    data: int = -1
    fsdp: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1

    def axis_sizes(self, n_devices: int) -> Dict[str, int]:
        sizes = {"data": self.data, "fsdp": self.fsdp,
                 "model": self.model, "seq": self.seq,
                 "pipe": self.pipe, "expert": self.expert}
        fixed = math.prod(v for v in sizes.values() if v > 0)
        wild = [k for k, v in sizes.items() if v == -1]
        if wild:
            rem = n_devices // fixed
            for k in wild[:-1]:
                sizes[k] = 1
            sizes[wild[-1]] = rem
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"mesh {sizes} does not tile {n_devices} devices")
        return sizes

    @classmethod
    def parse(cls, text: str) -> "MeshSpec":
        """``"data=2,pipe=2"`` -> MeshSpec (the CLI's ``--mesh``)."""
        kw = {}
        for part in text.split(","):
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in AXES:
                raise ValueError(f"unknown mesh axis {k!r} (axes: "
                                 f"{', '.join(AXES)})")
            kw[k] = int(v)
        return cls(**kw)


def rank_coords(rank: int, sizes: Dict[str, int]) -> Dict[str, int]:
    """Rank -> its index on every axis (row-major over ``AXES``)."""
    coords = {}
    for a in reversed(AXES):
        coords[a] = rank % sizes[a]
        rank //= sizes[a]
    return coords


def rank_of(coords: Dict[str, int], sizes: Dict[str, int]) -> int:
    r = 0
    for a in AXES:
        r = r * sizes[a] + coords.get(a, 0)
    return r


def axis_groups(axis, sizes: Dict[str, int]) -> List[List[int]]:
    """Every group of ranks along ``axis`` (an axis name, or a tuple of
    them: ranks that differ only there), in a fixed order every rank
    enumerates alike; a group's ranks in row-major order over the
    axes."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    n = math.prod(sizes.values())
    seen, groups = set(), []
    for r in range(n):
        if r in seen:
            continue
        c = rank_coords(r, sizes)
        g = []
        for i in range(math.prod(sizes[a] for a in axes)):
            sub = {}
            for a in reversed(axes):
                sub[a] = i % sizes[a]
                i //= sizes[a]
            g.append(rank_of({**c, **sub}, sizes))
        seen.update(g)
        groups.append(g)
    return groups


class Mesh:
    """This rank's view of the mesh: ``shape`` (axis -> size), its
    ``coords``, and per axis the global ranks of its group and the
    ``torch.distributed`` group over them (None without a process group,
    a one-process mesh, and for an axis of size 1 other than ``data``
    and ``pipe``, which have a group even then).  ``replica_group``:
    the group over ``REPLICA_AXES`` (the world where ``fsdp`` and
    ``model`` are 1)."""

    def __init__(self, sizes: Dict[str, int], rank: int = 0,
                 groups: Optional[Dict[str, object]] = None):
        self.shape = dict(sizes)
        self.rank = int(rank)
        self.size = math.prod(sizes.values())
        self.coords = rank_coords(self.rank, sizes)
        self.groups = dict(groups or {})
        self.world_group = self.groups.pop("__world__", None)
        self._ranks = {a: next(g for g in axis_groups(a, sizes)
                               if self.rank in g) for a in AXES}

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def axis_ranks(self, axis: str) -> List[int]:
        """Global ranks of this rank's group along ``axis``, in axis
        order."""
        return self._ranks[axis]

    def group(self, axis: str):
        return self.groups.get(axis)

    @property
    def replica_group(self):
        if self.shape["fsdp"] * self.shape["model"] == 1:
            return self.world_group
        return self.groups.get(REPLICA_AXES)

    @property
    def replica_size(self) -> int:
        return math.prod(self.shape[a] for a in REPLICA_AXES)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(spec: Optional[MeshSpec] = None, *,
              timeout_s: Optional[float] = None) -> Mesh:
    """The mesh over the initialized process group's ranks (one rank
    without one; ``parallel.distributed.initialize_distributed`` first).
    Every rank builds every axis's groups in the same order (group
    creation is collective), each with ``timeout_s`` (default
    ``distributed.default_timeout_s()``), and keeps its own."""
    import torch.distributed as dist
    from .distributed import default_timeout_s, host_count, host_index
    spec = spec or MeshSpec()
    n = host_count()
    sizes = spec.axis_sizes(n)
    check_axes(sizes)
    rank = host_index()
    groups = {}
    if dist.is_available() and dist.is_initialized():
        import datetime
        td = datetime.timedelta(
            seconds=timeout_s if timeout_s is not None
            else default_timeout_s())
        for a in AXES:
            if sizes[a] == 1 and a not in ALWAYS_GROUPED:
                continue
            for g in axis_groups(a, sizes):
                pg = dist.new_group(g, timeout=td)
                if rank in g:
                    groups[a] = pg
        if (sizes["fsdp"] * sizes["model"] > 1
                and math.prod(sizes[a] for a in REPLICA_AXES) > 1):
            for g in axis_groups(REPLICA_AXES, sizes):
                pg = dist.new_group(g, timeout=td)
                if rank in g:
                    groups[REPLICA_AXES] = pg
        groups["__world__"] = dist.new_group(list(range(n)), timeout=td)
    return Mesh(sizes, rank, groups)


# -- placement rules -----------------------------------------------------------

#: a rule maps (path, shape) to a partition tuple; () is replicated
Rule = Callable[[Tuple[str, ...], Tuple[int, ...]], tuple]


def data_parallel_rules(path, shape) -> tuple:
    """Replicate everything: gradients are summed over the data group
    (veles_tpu/parallel/mesh.py:104-107)."""
    return ()


def fsdp_rules(min_size: int = 2 ** 16, axis: str = "fsdp",
               axis_size: Optional[int] = None) -> Rule:
    """Split a leaf of at least ``min_size`` elements over ``axis`` on
    its largest dim (ties: the first), the ZeRO-3 layout: gathered on
    use, gradients reduce-scattered (veles_tpu/parallel/mesh.py:110-136).
    With ``axis_size`` (the mesh's extent) a dim it does not tile is
    skipped; without it the largest dim is chosen and
    ``state_shardings``' guard may drop the split."""

    def rule(path, shape) -> tuple:
        shape = tuple(shape)
        if math.prod(shape) < min_size:
            return ()
        for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
            if axis_size is not None and shape[d] % axis_size:
                continue
            parts = [None] * len(shape)
            parts[d] = axis
            return tuple(parts)
        return ()

    return rule


def tensor_parallel_rules(table: Dict[str, tuple],
                          default: Optional[Rule] = None) -> Rule:
    """Explicit per-leaf partitions by ``unit/param`` key, e.g. the
    megatron pair ``{"fc1/w": (None, "model"), "fc2/w": ("model",
    None)}``; a key matches a path that equals it or ends with
    ``/key`` (veles_tpu/parallel/mesh.py:139-151)."""
    default = default or data_parallel_rules

    def rule(path, shape) -> tuple:
        key = "/".join(path)
        for pat, part in table.items():
            if key == pat or key.endswith("/" + pat):
                return tuple(part)
        return default(path, shape)

    return rule


def compose_rules(*rules: Rule) -> Rule:
    """The first rule giving a leaf a non-replicated partition wins
    (veles_tpu/parallel/mesh.py:154-163)."""

    def rule(path, shape) -> tuple:
        for r in rules:
            p = tuple(r(path, shape))
            if any(a is not None for a in p):
                return p
        return ()

    return rule


def _axes_size(ax, sizes: Dict[str, int]) -> int:
    return sizes[ax] if isinstance(ax, str) else math.prod(
        sizes[a] for a in ax)


def guard_partition(part, shape, sizes: Dict[str, int]) -> tuple:
    """The divisibility guard (veles_tpu/parallel/mesh.py:176-196): an
    axis that does not tile its dim is dropped (the leaf stays
    replicated there), trailing ``None`` trimmed; a scalar is
    replicated."""
    shape = tuple(shape)
    if not shape:
        return ()
    parts = []
    for d, ax in enumerate(tuple(part) + (None,) * len(shape)):
        if d >= len(shape):
            break
        parts.append(ax if ax is not None and shape[d] % _axes_size(
            ax, sizes) == 0 else None)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def state_shardings(tree, sizes: Dict[str, int],
                    rule: Optional[Rule] = None, prefix=()):
    """The partition tuple ``rule`` gives every leaf of a state tree
    (dicts, tuples and lists walked by key and index, a leaf's path the
    keys down to it), each through the divisibility guard over the mesh
    ``sizes`` (veles_tpu/parallel/mesh.py:176-211).  A leaf is anything
    with a ``shape`` (a tensor, an array, a ``torch.Size`` tuple of a
    shape tree); a plain number is replicated."""
    rule = rule or data_parallel_rules
    if isinstance(tree, dict):
        return {k: state_shardings(v, sizes, rule, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_shape(tree):
        return type(tree)(state_shardings(v, sizes, rule,
                                          prefix + (str(i),))
                          for i, v in enumerate(tree))
    shape = tuple(tree) if _is_shape(tree) else tuple(
        getattr(tree, "shape", ()))
    return guard_partition(rule(prefix, shape) if shape else (), shape,
                           sizes)


def _is_shape(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(d, int) for d in x)


def batch_shardings(batch_spec: Dict[str, object], mesh: Mesh, *,
                    seq_axis: Optional[int] = None
                    ) -> Dict[str, tuple]:
    """Per batch key, the partition of its dims (a tuple, one entry a
    dim up to the last split one; ``()`` is replicated): the leading
    (batch) dim over the data and fsdp axes above 1 (fsdp ranks are
    data-parallel too) where their product divides it, and with
    ``seq_axis`` that dim over ``"seq"`` where the seq axis is above 1
    and divides it (veles_tpu/parallel/mesh.py:213-231)."""
    out = {}
    dp = tuple(a for a in ("data", "fsdp") if mesh.shape.get(a, 1) > 1)
    n = math.prod(mesh.shape[a] for a in dp)
    n_seq = mesh.shape.get("seq", 1)
    for k, s in batch_spec.items():
        shape = tuple(getattr(s, "shape", ()))
        parts = [None] * len(shape)
        if dp and shape and shape[0] % n == 0:
            parts[0] = dp if len(dp) > 1 else dp[0]
        if (seq_axis is not None and len(shape) > seq_axis and n_seq > 1
                and shape[seq_axis] % n_seq == 0):
            parts[seq_axis] = "seq"
        while parts and parts[-1] is None:
            parts.pop()
        out[k] = tuple(parts)
    return out


def shard_rows(t, axes: Sequence[str], mesh: Mesh, dim: int = 0):
    """This rank's chunk of ``t`` along ``dim`` under the partition
    ``axes`` (the first axis outermost)."""
    if not axes:
        return t
    n = math.prod(mesh.shape[a] for a in axes)
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + mesh.axis_index(a)
    rows = t.shape[dim] // n
    return t.narrow(dim, i * rows, rows)
