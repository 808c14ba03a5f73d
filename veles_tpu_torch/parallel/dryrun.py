"""One sharded train step over data x fsdp x model gloo ranks: the port's
counterpart of ``dryrun_multichip``'s first half (__graft_entry__.py:
51-104).  The same tiny stack (a conv trunk, fc6/fc7 split megatron
style over ``model``: fc6 by columns, fc7 by rows, ``fsdp_rules(min_size=
1024)`` for the rest) and the same factorization of the rank count.

``python -m veles_tpu_torch.parallel.dryrun N`` starts N ranks here as
gloo processes on the CPU (``parallel/launcher.py``) and each runs
:func:`dryrun_step`; every rank prints its loss.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

#: ranks -> (data, fsdp, model), the largest axes first (:64-65)
FACTORS = {8: (2, 2, 2), 4: (2, 2, 1), 2: (2, 1, 1), 1: (1, 1, 1)}
BATCH = 16


def dryrun_layers():
    """The conv trunk and the wide FCs (:69-77)."""
    return [
        {"type": "conv_relu", "n_kernels": 16, "kx": 3, "name": "conv1"},
        {"type": "max_pooling", "window": 2, "name": "pool1"},
        {"type": "all2all_relu", "output_size": 64, "name": "fc6"},
        {"type": "all2all_relu", "output_size": 64, "name": "fc7"},
        {"type": "softmax", "output_size": 10, "name": "fc8"},
    ]


def dryrun_rule(min_size: int = 1024):
    """fc6 column-parallel, fc7 row-parallel, then fsdp (:84-87)."""
    from .mesh import compose_rules, fsdp_rules, tensor_parallel_rules
    return compose_rules(
        tensor_parallel_rules({"fc6/w": (None, "model"),
                               "fc7/w": ("model", None)}),
        fsdp_rules(min_size=min_size))


def dryrun_workflow(device="cpu"):
    """(workflow, whole state, optimizer): SGD(0.01, momentum 0.9) from
    seed 0."""
    from ..models.standard import build_workflow
    from ..ops.optimizers import SGD
    from ..units.base import Spec
    wf = build_workflow("dryrun", dryrun_layers())
    wf.build({"@input": Spec((BATCH, 16, 16, 3), torch.float32),
              "@labels": Spec((BATCH,), torch.int32),
              "@mask": Spec((BATCH,), torch.float32)})
    opt = SGD(0.01, momentum=0.9)
    return wf, wf.init_state(0, opt, device), opt


def dryrun_step(mesh, rule=None):
    """One sharded train step of the stack on ``mesh`` under ``rule``
    (default :func:`dryrun_rule`) on the reference's constant batch;
    returns the metrics (floats)."""
    wf, ws, opt = dryrun_workflow()
    step = wf.make_sharded_train_step(opt, mesh, rule=rule or dryrun_rule())
    ws = step.place(ws)
    batch = {"@input": torch.ones((BATCH, 16, 16, 3)),
             "@labels": torch.zeros((BATCH,), dtype=torch.int32),
             "@mask": torch.ones((BATCH,))}
    ws, mets = step(ws, batch)
    mets = {k: float(v) for k, v in mets.items()}
    if not np.isfinite(mets["loss"]):
        raise RuntimeError(f"dryrun loss is not finite: {mets}")
    return mets


def main(argv=None) -> int:
    from .distributed import (host_count, initialize_distributed,
                              shutdown_distributed)
    from .mesh import MeshSpec, make_mesh
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 8
    if "VELES_PROCESS_ID" not in os.environ:
        from .launcher import HostLauncher
        import socket
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        launcher = HostLauncher(["localhost"] * n, coordinator_port=port)
        launcher.launch([sys.executable, "-m",
                         "veles_tpu_torch.parallel.dryrun", str(n)])
        return launcher.wait()
    torch.set_num_threads(1)
    initialize_distributed(device="cpu")
    dp, fs, tp = FACTORS.get(host_count(), (host_count(), 1, 1))
    mesh = make_mesh(MeshSpec(data=dp, fsdp=fs, model=tp))
    mets = dryrun_step(mesh)
    print(f"rank {mesh.rank} of data={dp} x fsdp={fs} x model={tp}: "
          f"loss {mets['loss']:.6f}", flush=True)
    shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
