"""Tensor parallelism over the ``model`` group: the megatron operators as
autograd Functions, and the rank loop that runs every model rank's part
of a block in one process.

The JAX package splits a unit's weights by a rule
(``tensor_parallel_rules``, veles_tpu/parallel/mesh.py:139-151) and GSPMD
inserts the collectives.  Here a unit whose weights the rule splits the
megatron way computes its own part (``Unit.tp_local`` says which splits
it keeps; ``Context.tp`` hands them to it): a column split of a dense
weight computes its output columns, a row split its partial product,
all-reduced.  Model ranks see the same rows, so every tensor outside a
unit's split part is whole and the same on each of them:

* ``copy_to_model``: identity forward; the backward all-reduces the
  gradient of a whole input, each rank having computed its part;
* ``reduce_from_model``: the forward all-reduces the partial products;
  the backward is the identity;
* ``scatter_to_model``: this rank's block of a whole tensor along a dim;
  the backward all-gathers the blocks' gradients, so a whole tensor (a
  replicated bias sliced for a column split) gets its whole gradient;
* ``gather_from_model``: the forward all-gathers the ranks' blocks
  along a dim; the backward keeps this rank's block of the gradient.

A unit that all-reduces splits its forward in two (``tp_parts``): the
partial product, in float32 (a bf16 unit's operands rounded, the
product accumulated in float32, as a bf16 GEMM does), and ``finish``,
what follows the all-reduce (the rounding to the compute dtype, the
whole bias and residual), so the split block rounds where the unsplit
one does.  ``RankLoop`` stands in for the mesh when every model rank
runs in one process (the card has one device): the operators are then
plain (copy, slice), and ``model_ranks`` sums the ranks' partials, which
is what the all-reduce does, before one ``finish``, so autograd gives
each rank the gradient the group would.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

AXIS = "model"


class RankLoop:
    """Model rank ``index`` of ``size`` in a one-process loop: the mesh
    interface the units read (``shape``, ``axis_index``, ``group``), no
    process group."""

    in_process = True

    def __init__(self, index: int, size: int):
        self.index = int(index)
        self.shape = {"data": 1, "fsdp": 1, AXIS: int(size), "seq": 1,
                      "pipe": 1, "expert": 1}

    def axis_index(self, axis: str) -> int:
        return self.index if axis == AXIS else 0

    def group(self, axis: str):
        return None


def _looped(mesh) -> bool:
    return getattr(mesh, "in_process", False)


def _group(mesh):
    g = mesh.group(AXIS)
    if g is None:
        raise RuntimeError(
            f"the {AXIS!r} axis of {mesh} has no process group: tensor "
            "parallelism runs over one (initialize_distributed and "
            "make_mesh), or in one process through RankLoop")
    return g


def _block(t, dim, mesh):
    n = mesh.shape[AXIS]
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.axis_index(AXIS) * size, size)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.group = dim, _group(mesh)
        return _block(x, dim, mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        from .fsdp import all_gather_dim
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        from .fsdp import all_gather_dim
        ctx.dim, ctx.mesh = dim, mesh
        return all_gather_dim(x, dim, _group(mesh))

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.mesh).contiguous(), None, None


def copy_to_model(x, mesh):
    if _looped(mesh):
        return x
    return _CopyToModel.apply(x, _group(mesh))


def reduce_from_model(x, mesh):
    if _looped(mesh):
        return x
    return _ReduceFromModel.apply(x, _group(mesh))


def scatter_to_model(x, dim: int, mesh):
    if _looped(mesh):
        return _block(x, dim, mesh)
    return _ScatterToModel.apply(x, dim % x.dim(), mesh)


def gather_from_model(x, dim: int, mesh):
    if _looped(mesh):
        raise ValueError("a column-split output is gathered over a "
                         "process group; the rank loop sums row-split "
                         "partial products only")
    return _GatherFromModel.apply(x, dim % x.dim(), mesh)


def local_param(params: dict, name: str, split, dim: int, mesh):
    """``params[name]`` as this rank uses it: the block it stores where
    ``split`` keeps the model split, else its block of the whole
    tensor (``scatter_to_model``)."""
    if split is not None and name in split:
        return params[name]
    return scatter_to_model(params[name], dim, mesh)


def model_ranks(unit, rank_params: Sequence[dict], x: torch.Tensor,
                split: dict, **ctx_kw) -> torch.Tensor:
    """Every model rank's part of ``unit`` on the whole input ``x`` in
    one process: rank ``r`` computes its partial product with its blocks
    ``rank_params[r]`` (the splits ``split`` keeps) through a
    ``RankLoop`` (``unit.tp_parts``); the partials are summed, which is
    what the all-reduce does, and the unit's ``finish`` (the terms each
    rank holds whole: bias, rounding, residual) runs once on the sum."""
    from ..units.base import Context
    n = len(rank_params)
    total, finish = None, None
    for r, p in enumerate(rank_params):
        ctx = Context(mesh=RankLoop(r, n), tp={unit.name: split}, **ctx_kw)
        part, fin = unit.tp_parts(p, x, ctx)
        total = part if total is None else total + part
        finish = finish or fin
    return finish(total)


def split_weights(params: dict, split: dict, n: int) -> list:
    """Rank ``r``'s blocks of a unit's params under ``split`` (the
    others whole), for ``r`` in ``range(n)``."""
    from .fsdp import slice_block
    out = []
    for r in range(n):
        loop = RankLoop(r, n)
        out.append({k: (slice_block(v, split[k], loop) if k in split
                        else v) for k, v in params.items()})
    return out

