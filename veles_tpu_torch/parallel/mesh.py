"""The mesh of the port: ranks over named axes, one ``torch.distributed``
process group per axis (counterpart of veles_tpu/parallel/mesh.py,
``MeshSpec`` :35-62, ``make_mesh`` :64, ``data_parallel_rules`` :104 and
``batch_shardings`` :213, for the ``data``, ``seq``, ``pipe`` and
``expert`` axes).

One process is one rank is one device.  The world's ranks are laid out
over the axes ``(data, fsdp, model, seq, pipe, expert)`` in the order the
JAX package reshapes its device list, so rank ``r`` of a ``data=2,pipe=2``
mesh sits where the JAX mesh puts device ``r``.  Every rank holds the
whole workflow state (parameters replicated; a stage's rank computes
that stage's gradients and the step sums them over the world), so the
placement rules here describe the JAX package's layout and place
nothing.  A ``seq`` axis runs ring attention over its group
(``parallel/ring_attention.py``), an ``expert`` axis the expert
all-to-all (``parallel/moe.py``).  The ``fsdp`` and ``model`` axes need
real parameter sharding (gather on use, reduce-scatter of gradients):
they come with ROADMAP.md item 6c, and a size above 1 raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: axis order of the JAX package's ``make_mesh`` (devices reshaped so)
AXES = ("data", "fsdp", "model", "seq", "pipe", "expert")
#: the axes the port runs; the others come with ROADMAP.md item 6c
PORTED_AXES = ("data", "seq", "pipe", "expert")
#: the axes whose group exists even at size 1 (the data-parallel and
#: pipeline steps read it)
ALWAYS_GROUPED = ("data", "pipe")


def check_axes(sizes: Dict[str, int]) -> None:
    """Raise ``NotImplementedError`` for an axis of item 6c above 1."""
    late = [a for a in AXES if a not in PORTED_AXES and sizes.get(a, 1) > 1]
    if late:
        raise NotImplementedError(
            f"mesh axes {late} (FSDP and tensor parallelism: parameter "
            "sharding) come with ROADMAP.md item 6c; the port runs "
            f"{list(PORTED_AXES)}")


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


def axis_groups(axis: str, sizes: Dict[str, int]) -> List[List[int]]:
    """Every group of ranks along ``axis`` (ranks that differ only
    there), in a fixed order every rank enumerates alike."""
    n = math.prod(sizes.values())
    seen, groups = set(), []
    for r in range(n):
        if r in seen:
            continue
        c = rank_coords(r, sizes)
        g = [rank_of({**c, axis: i}, sizes) for i in range(sizes[axis])]
        seen.update(g)
        groups.append(g)
    return groups


class Mesh:
    """This rank's view of the mesh: ``shape`` (axis -> size), its
    ``coords``, and per axis the global ranks of its group and the
    ``torch.distributed`` group over them (None without a process group,
    a one-process mesh, and for an axis of size 1 other than ``data``
    and ``pipe``, which have a group even then)."""

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
        groups["__world__"] = dist.new_group(list(range(n)), timeout=td)
    return Mesh(sizes, rank, groups)


# -- placement rules -----------------------------------------------------------

#: a rule maps (path, shape) to a partition tuple; () is replicated
Rule = Callable[[Tuple[str, ...], Tuple[int, ...]], tuple]


def data_parallel_rules(path, shape) -> tuple:
    """Replicate everything: gradients are summed over the data group
    (veles_tpu/parallel/mesh.py:104-107)."""
    return ()


def state_placement(tree, rule: Optional[Rule] = None, prefix=()):
    """The partition tuple ``rule`` gives every leaf of a state tree
    (the JAX ``state_shardings`` walk, without placing anything)."""
    rule = rule or data_parallel_rules
    if isinstance(tree, dict):
        return {k: state_placement(v, rule, prefix + (str(k),))
                for k, v in tree.items()}
    return rule(prefix, tuple(getattr(tree, "shape", ())))


def batch_shardings(batch_spec: Dict[str, object], mesh: Mesh, *,
                    seq_axis: Optional[int] = None
                    ) -> Dict[str, tuple]:
    """Per batch key, the partition of its dims (a tuple, one entry a
    dim up to the last split one; ``()`` is replicated): the leading
    (batch) dim over ``"data"`` where the data axis is above 1 and
    divides it, and with ``seq_axis`` that dim over ``"seq"`` where the
    seq axis is above 1 and divides it (veles_tpu/parallel/mesh.py:
    213-231)."""
    out = {}
    n = mesh.shape.get("data", 1)
    n_seq = mesh.shape.get("seq", 1)
    for k, s in batch_spec.items():
        shape = tuple(getattr(s, "shape", ()))
        parts = [None] * len(shape)
        if n > 1 and shape and shape[0] % n == 0:
            parts[0] = "data"
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
