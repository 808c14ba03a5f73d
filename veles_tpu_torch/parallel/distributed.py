"""The process group (counterpart of veles_tpu/parallel/distributed.py
:22-120): ``torch.distributed`` over a TCP rendezvous, gloo on the CPU
and NCCL on the card.

The rendezvous reads the JAX package's environment names
(``VELES_COORDINATOR`` host:port, ``VELES_NUM_PROCESSES``,
``VELES_PROCESS_ID``), which ``parallel/launcher.py`` sets for each rank.
Every group is created with an explicit timeout (``VELES_DIST_TIMEOUT_S``,
default 120 s), so a rank that hangs in a collective fails within it
instead of waiting forever.  On the card one process drives one GPU: a
world larger than the host's GPU count is refused.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..logger import setup_logging

#: default seconds a collective may wait before the group fails it
DEFAULT_TIMEOUT_S = 120.0


def default_timeout_s() -> float:
    return float(os.environ.get("VELES_DIST_TIMEOUT_S", DEFAULT_TIMEOUT_S))


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device=None,
                           timeout_s: Optional[float] = None) -> bool:
    """Join the process group (no-op standalone: returns False).

    Arguments default to ``VELES_COORDINATOR`` / ``VELES_NUM_PROCESSES`` /
    ``VELES_PROCESS_ID``; without a coordinator the process runs alone.
    ``device``: where this rank computes — the backend is NCCL for a
    CUDA device and gloo otherwise; on the card rank ``r`` takes GPU
    ``r``, and a world larger than the GPU count raises."""
    coordinator = coordinator or os.environ.get("VELES_COORDINATOR")
    if coordinator is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("VELES_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("VELES_PROCESS_ID", "0"))
    from ..ops import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        n_gpu = torch.cuda.device_count()
        if num_processes > n_gpu:
            raise RuntimeError(
                f"a mesh of {num_processes} ranks needs {num_processes} "
                f"GPUs on this host, which has {n_gpu}: one rank drives "
                "one GPU (run the ranks on the CPU as gloo processes with "
                "--device cpu)")
        torch.cuda.set_device(process_id)
        backend = "nccl"
    else:
        backend = "gloo"
    if dist.is_initialized():
        return True
    td = datetime.timedelta(seconds=timeout_s if timeout_s is not None
                            else default_timeout_s())
    kw = {}
    import inspect
    if backend == "nccl" and "device_id" in inspect.signature(
            dist.init_process_group).parameters:
        kw["device_id"] = torch.device("cuda", process_id)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=td, **kw)
    setup_logging()
    return True


def shutdown_distributed() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_multihost() -> bool:
    return host_count() > 1


def host_count() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def host_index() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def place_batch(batch, mesh, shardings):
    """This rank's part of a global batch under ``shardings``
    (``parallel.mesh.batch_shardings``: per key a partition tuple, one
    entry a dim, each an axis name, a tuple of them or None): the chunk
    of every split dim, the others whole.  Every rank's loader yields the
    same global batch (the same seed), so no rank ships rows to
    another."""
    from .mesh import shard_rows

    def place(t, part):
        for d, ax in enumerate(part):
            if ax is not None:
                t = shard_rows(t, (ax,) if isinstance(ax, str)
                               else tuple(ax), mesh, dim=d)
        return t
    return {k: place(v, shardings.get(k, ())) for k, v in batch.items()}


def gather_to_host(tree):
    """Host numpy copy of a state tree of whole tensors (a placed
    state's blocks are gathered by ``parallel.fsdp.ShardedState.
    gather_state``, veles_tpu/parallel/distributed.py:103-120)."""
    if isinstance(tree, dict):
        return {k: gather_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_to_host(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy().copy()
    return np.asarray(tree)
