"""Command line of the port: train a config's workflow, or serve it from a
snapshot (counterpart of veles_tpu/__main__.py's training path :262-303
and ``--serve``).

    python -m veles_tpu_torch CONFIG [root.path=value ...] \\
        [--random-seed S] [--max-epochs N] [--snapshot-dir D] \\
        [--snapshot PATH] [--device cpu]
    python -m veles_tpu_torch CONFIG --snapshot SNAP --serve PORT \\
        [--model-dir DIR [--watch]] [--status-port P] [--trace-out F] \\
        [--device cpu] [root.common.serve.slots=4 ...]

``CONFIG`` is a ``configs/*.json`` file: its ``workflow`` section builds
the model and optimizer, its ``loader`` section names the loader and its
arguments.  Without ``--serve`` the run trains (``--snapshot`` resumes
from a snapshot of either package) and prints the results dict as one
JSON line.  With ``--serve`` it answers ``POST /predict`` and ``POST
/generate`` (through the continuous-batching engine) from the snapshot's
weights, with the deploy control plane attached (``runtime/deploy.py``:
``GET /models``, ``POST /admin/reload`` hot-swaps a snapshot,
``/admin/stage`` / ``/admin/commit`` / ``/admin/abort``, ``POST
/admin/drain``), until a drain (SIGTERM or ``/admin/drain``) or SIGINT.
``--model-dir`` names the snapshot directory the registry and the
watcher read, ``--watch`` swaps in each newer snapshot there.
``--status-port`` serves the live status page (training or serving),
``--trace-out`` writes the span ring's timelines as a Chrome trace on
exit.  Everything runs on the CUDA card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from . import prng
from .config import apply_overrides, root
from .logger import Logger, setup_logging
from .models.standard import StandardWorkflow
from .ops import resolve_device
from .runtime.decision import Decision
from .runtime.deploy import DeployController
from .runtime.engine import DecodeEngine
from .runtime.metrics import write_chrome_trace
from .runtime.restful import RestfulServer
from .runtime.snapshotter import Snapshotter, wstate_from_snapshot
from .runtime.status import StatusReporter, StatusServer
from .units.base import Spec
from .units.workflow import WorkflowError

#: the loader names of the JAX CLI (veles_tpu/__main__.py:38-45)
LOADERS = {"mnist": ("veles_tpu_torch.models.mnist", "MnistLoader"),
           "cifar": ("veles_tpu_torch.models.cifar", "CifarLoader"),
           "stl": ("veles_tpu_torch.models.stl", "StlLoader"),
           "induction": ("veles_tpu_torch.models.lm", "InductionLoader"),
           "imagenet_synthetic": ("veles_tpu_torch.models.alexnet",
                                  "ImagenetSyntheticLoader")}
#: loader names of the JAX CLI not ported yet -> the ROADMAP.md slice
#: that brings them (none left)
PENDING_LOADERS: dict = {}


def make_loader(name: str, **args):
    if name not in LOADERS:
        if name in PENDING_LOADERS:
            raise NotImplementedError(
                f"loader {name!r} is not ported yet; it comes with "
                f"ROADMAP.md {PENDING_LOADERS[name]}")
        raise KeyError(f"unknown loader {name!r}")
    import importlib
    mod, attr = LOADERS[name]
    return getattr(importlib.import_module(mod), attr)(**args)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch",
        description="Train a veles config's workflow, or serve it from a "
                    "snapshot, on the CUDA card (PyTorch port).")
    p.add_argument("config", help="configs/*.json workflow config")
    p.add_argument("overrides", nargs="*",
                   help="root.path=value config overrides")
    p.add_argument("--snapshot",
                   help="snapshot manifest (.json): weights to serve with "
                        "--serve, else the training run to resume")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve over HTTP instead of training (0 = any "
                        "free port); needs --snapshot")
    p.add_argument("--random-seed", type=int, default=None,
                   help="root.common.random_seed (loader shuffles and "
                        "initial weights)")
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--snapshot-dir", default=None,
                   help="write a snapshot after each epoch here")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--model-dir", default=None,
                   help="with --serve: the snapshot directory of the model "
                        "lifecycle control plane (POST /admin/reload "
                        "hot-swaps a snapshot, GET /models lists the "
                        "versioned registry)")
    p.add_argument("--watch", action="store_true",
                   help="with --serve --model-dir: poll the directory for "
                        "newer snapshots and hot-swap them (exponential "
                        "back-off on failures)")
    p.add_argument("--drain-timeout", type=float, default=None,
                   metavar="SECONDS",
                   help="graceful-drain deadline for SIGTERM / POST "
                        "/admin/drain (default "
                        "root.common.serve.drain_timeout_s)")
    p.add_argument("--status-port", type=int, default=None,
                   help="serve a live status page (JSON + HTML, "
                        "/metrics, /memory.json, /trace.json, POST "
                        "/debug/profile) on this port; 0 picks a free "
                        "port")
    p.add_argument("--trace-out", metavar="FILE", default=None,
                   help="on exit, write the host-side span timeline "
                        "(each request's queue-wait, prefill and decode "
                        "spans; status events) as Chrome-trace JSON")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging()
    with open(args.config) as f:
        root.update(json.load(f))
    apply_overrides(root, [o[len("root."):] if o.startswith("root.") else o
                           for o in args.overrides])
    if args.random_seed is not None:
        root.common.random_seed = args.random_seed
        prng.streams.reset()
    if args.watch and not (args.model_dir
                           or root.common.serve.get("model_dir")):
        raise SystemExit("--watch needs --model-dir (the snapshot "
                         "directory to poll)")
    if args.serve is None and (args.model_dir or args.watch):
        raise SystemExit("--model-dir and --watch drive the serving "
                         "control plane; they need --serve")
    device = resolve_device(args.device)
    status = status_server = None
    if args.status_port is not None:
        os.makedirs(str(root.common.cache_dir), exist_ok=True)
        status = StatusReporter(
            os.path.join(str(root.common.cache_dir), "status.json"),
            name=root.workflow.get("name", "workflow"))
        status_server = StatusServer(status, port=args.status_port).start()
    try:
        if args.serve is not None:
            if not args.snapshot:
                raise SystemExit("--serve needs --snapshot (the weights)")
            return _serve(args, device, status, status_server)
        return _train(args, device, status)
    finally:
        if status_server is not None:
            status_server.stop()
        if args.trace_out:
            write_chrome_trace(args.trace_out)


def _train(args, device, status=None) -> int:
    wf_cfg = root.workflow.to_dict()
    sw = StandardWorkflow(wf_cfg)
    loader_cfg = root.loader.to_dict() if "loader" in root else {}
    loader = make_loader(loader_cfg.pop("name", "mnist"), device=device,
                         **loader_cfg)
    decision = Decision(
        max_epochs=args.max_epochs or wf_cfg.get("max_epochs"),
        fail_iterations=wf_cfg.get("fail_iterations", 50))
    snap = None
    if args.snapshot_dir:
        snap = Snapshotter(wf_cfg.get("name", "workflow"), args.snapshot_dir)
    trainer = sw.make_trainer(loader, decision, snap, device=device,
                              status=status)
    trainer.initialize()
    if args.snapshot:
        trainer.restore(args.snapshot)
    results = trainer.run()
    print(json.dumps(results), flush=True)
    return 0


def _serve(args, device, status=None, status_server=None) -> int:
    log = Logger()
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
        engine = DecodeEngine(wf, wstate, status=status,
                              device=device).start()
    except WorkflowError as e:
        log.warning("serving /predict only (no decode engine: %s)", e)
    head = wf.default_output()
    # /predict serves the engine's tensors: one device copy of the weights
    srv = RestfulServer(wf.make_predict_step(head),
                        engine.wstate if engine is not None else wstate,
                        B, (T,),
                        port=args.serve, workflow=wf, engine=engine,
                        input_dtype=np.int32, device=device)
    deploy = DeployController(server=srv, model_dir=args.model_dir,
                              drain_timeout_s=args.drain_timeout,
                              status=status, boot_source=args.snapshot)
    deploy.install_signal_handlers()     # SIGTERM drains
    srv.start()
    if args.watch:
        deploy.start_watcher()
    print(json.dumps({"serving": srv.port, "predict_head": head,
                      "engine": engine is not None,
                      "device": str(device), "model_dir": deploy.model_dir,
                      "watching": deploy.watching,
                      "status_port": (status_server.port
                                      if status_server is not None
                                      else None),
                      "observe": ["/metrics", "/trace.json", "/slo.json",
                                  "/memory.json", "/models",
                                  "/debug/profile"]}), flush=True)
    try:
        deploy.wait()       # released by SIGTERM or POST /admin/drain
    except KeyboardInterrupt:
        deploy.drain(timeout=0)     # interactive: no grace hold
    finally:
        srv.stop()
        if engine is not None:
            engine.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
