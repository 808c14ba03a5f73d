"""Command line of the port: serve a config's workflow from a snapshot.

    python -m veles_tpu_torch CONFIG --snapshot SNAP --serve PORT \\
        [--device cpu] [root.common.serve.slots=4 ...]

``CONFIG`` is a ``configs/*.json`` file (its ``workflow`` section builds
the model, its ``loader`` section gives the /predict batch shape);
``SNAP`` is a snapshot manifest written by either package.  The server
answers ``POST /predict`` and ``POST /generate`` (through the
continuous-batching engine) until SIGINT or SIGTERM.  It runs on the
CUDA card unless ``--device cpu`` is given.  Training and the rest of
the JAX package's CLI come with later slices.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading

import numpy as np
import torch

from .config import apply_overrides, root
from .logger import Logger, setup_logging
from .models.standard import StandardWorkflow
from .ops import resolve_device
from .runtime.engine import DecodeEngine
from .runtime.restful import RestfulServer
from .runtime.snapshotter import wstate_from_snapshot
from .units.base import Spec
from .units.workflow import WorkflowError


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch",
        description="Serve a veles config's workflow from a snapshot on "
                    "the CUDA card (PyTorch port).")
    p.add_argument("config", help="configs/*.json workflow config")
    p.add_argument("overrides", nargs="*",
                   help="root.path=value config overrides")
    p.add_argument("--snapshot", required=True,
                   help="snapshot manifest (.json) to load weights from")
    p.add_argument("--serve", type=int, required=True, metavar="PORT",
                   help="HTTP port (0 = any free port)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging()
    log = Logger()
    with open(args.config) as f:
        root.update(json.load(f))
    apply_overrides(root, [o[len("root."):] if o.startswith("root.") else o
                           for o in args.overrides])
    device = resolve_device(args.device)
    sw = StandardWorkflow(root.workflow.to_dict())
    wf = sw.workflow
    B = int(root.loader.get("minibatch_size", 1))
    T = int(root.loader.get("seq_len", 1))
    wf.build({"@input": Spec((B, T), torch.int32),
              "@labels": Spec((B,), torch.int32),
              "@mask": Spec((B,), torch.float32)})
    wstate = wstate_from_snapshot(args.snapshot, wf, device=device)
    engine = None
    try:
        engine = DecodeEngine(wf, wstate, device=device).start()
    except WorkflowError as e:
        log.warning("serving /predict only (no decode engine: %s)", e)
    head = wf.default_output()
    srv = RestfulServer(wf.make_predict_step(head), wstate, B, (T,),
                        port=args.serve, workflow=wf, engine=engine,
                        input_dtype=np.int32, device=device).start()
    print(json.dumps({"serving": srv.port, "predict_head": head,
                      "engine": engine is not None,
                      "device": str(device)}), flush=True)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        srv.stop()
        if engine is not None:
            engine.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
