"""Command line of the port: train a config's workflow, decode with it,
serve it from a snapshot, or run a snapshot-phased curriculum
(counterpart of veles_tpu/__main__.py's training path :262-303,
``--generate`` :1232-1303, ``--serve`` and ``--curriculum`` :943-970).

    python -m veles_tpu_torch CONFIG [root.path=value ...] \\
        [--random-seed S] [--max-epochs N] [--snapshot-dir D] \\
        [--snapshot SRC] [--result-file F] [--device cpu] \\
        [--mesh data=2,pipe=2] [--hosts localhost,localhost]
    python -m veles_tpu_torch CONFIG --snapshot SRC --generate N \\
        --prompt "1,2,3;4,5,6" [--temperature T [--top-k K] [--top-p P]] \\
        [--beams W [--length-penalty A]] [--eos-id E] [--result-file F]
    python -m veles_tpu_torch CONFIG --curriculum SPEC.json \\
        [--curriculum-out DIR] [--snapshot SRC] [--random-seed S] \\
        [--result-file F] [--device cpu]
    python -m veles_tpu_torch CONFIG --snapshot SRC --serve PORT \\
        [--model-dir DIR [--watch]] [--status-port P] [--trace-out F] \\
        [--fleet N | --join ROUTER_URL] [--device cpu] \\
        [root.common.serve.slots=4 ...]
    python -m veles_tpu_torch CONFIG [--snapshot SRC] --export DIR[.zip] \\
        [--compiled [--eos-id E]] [--device cpu]
    python -m veles_tpu_torch --serve PORT --artifact DIR \\
        [--fleet N | --join ROUTER_URL] [--device cpu]

``CONFIG`` is a ``configs/*.json`` file: its ``workflow`` section builds
the model and optimizer, its ``loader`` section names the loader and its
arguments.  A snapshot source ``SRC`` is a manifest file of either
package, ``sqlite://DB[#id|#best|#current]`` or an ``http(s)://``
manifest URL.  Without a mode flag the run trains (``--snapshot``
resumes) and prints the results dict as one JSON line (and writes it to
``--result-file``).  ``--generate N`` decodes N tokens after each prompt
row with the (restored) model instead: greedy, sampled from
``root.common.random_seed``, or a beam search, printing
``{"prompt_len", "tokens"[, "scores"]}``.  ``--curriculum`` runs the
config as chained training phases, each a subprocess of this CLI that
restores the best snapshot so far (``runtime/curriculum.py``), and
prints the summary.  With ``--serve`` it answers ``POST /predict`` and
``POST /generate`` (through the continuous-batching engine) from the
snapshot's weights, with the deploy control plane attached
(``runtime/deploy.py``: ``GET /models``, ``POST /admin/reload``
hot-swaps a snapshot, ``/admin/stage`` / ``/admin/commit`` /
``/admin/abort``, ``POST /admin/drain``), until a drain (SIGTERM or
``/admin/drain``) or SIGINT.  ``--model-dir`` names the snapshot
directory the registry and the watcher read, ``--watch`` swaps in each
newer snapshot there.  ``--fleet N`` serves N replicas of that stack in
this process (each its own engine and its own copy of the weights) behind
the fleet router (``runtime/fleet.py``) on PORT: ``POST /generate``,
``GET /fleet.json``, the merged ``/slo.json``, ``POST /admin/reload``
(the coordinated swap), ``/admin/rolling-drain``, ``/admin/join``,
``/admin/drain`` and, with ``root.common.serve.jobs.dir``, ``/jobs``.
``--join ROUTER_URL`` registers this single replica with a running
router after it boots.  ``--export DIR`` writes the (restored) model as
an export package (contents.json + npy, a directory or a ``.zip``: what
``serving/veles_serve`` loads) and exits; with ``--compiled`` it writes a
sealed compiled artifact instead (``export/compiled.py``: the serving
programs through ``torch.export``, a manifest and the weights) and
prints its summary.  ``--serve PORT --artifact DIR`` serves such an
artifact with no config: ``/generate`` through an ``ArtifactRunner``,
``/predict`` through its sealed forward, the deploy control plane
attached (``--fleet N``: N artifact replicas behind the router).
``--status-port`` serves the live status page (training or serving),
``--trace-out`` writes the span ring's timelines as a Chrome trace on
exit.  Everything runs on the CUDA card unless ``--device cpu`` is
given.

``--mesh data=D,fsdp=F,model=M,seq=Q,pipe=P,expert=X`` trains over a
mesh of D*F*M*Q*P*X ranks, one process each (``parallel/mesh.py``): the
batch splits over ``data`` x ``fsdp`` (and over ``expert`` for a model
with MoE layers, which exchange their tokens there), attention runs as
ring attention over ``seq``, and a ``pipe`` axis above 1 trains the
config's pipeline stack on the fused 1F1B schedule (interleaved with the
config's ``pipeline_interleave``), the seq and expert axes inside its
stages.  The state is placed as the JAX package's CLI places it
(veles_tpu/__main__.py:281-297): expert banks over ``expert``, stage
arrays over ``pipe``, and with ``fsdp`` above 1 every leaf of 64 Ki
elements or more over ``fsdp`` (``fsdp_rules``): each rank stores its
block, gathered on use.  ``model`` ranks compute the same rows: the
CLI, like the reference's, has no tensor-parallel table, so a megatron
split is reached through the API (``tensor_parallel_rules``).
Without ``--hosts`` the ranks start here as gloo processes on the CPU
(``--device cpu``); a run on the card has one rank (one GPU), so a
larger mesh there stops with an error.  ``--hosts h0,h1,...`` starts
one rank per entry (``parallel/launcher.py``: a subprocess for
localhost, ssh otherwise).  Rank 0 alone prints the results and writes
snapshots and ``--result-file``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from . import prng
from .config import apply_overrides, root
from .logger import Logger, setup_logging
from .ops import resolve_device
from .runtime.decision import Decision
from .runtime.deploy import DeployController
from .runtime.engine import DecodeEngine
from .runtime.metrics import write_chrome_trace
from .runtime.restful import RestfulServer
from .runtime.snapshotter import Snapshotter, wstate_from_snapshot
from .runtime.status import StatusReporter, StatusServer
from .units.base import Spec

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
    p.add_argument("config", nargs="?", default=None,
                   help="configs/*.json workflow config (none with "
                        "--artifact)")
    p.add_argument("overrides", nargs="*",
                   help="root.path=value config overrides")
    p.add_argument("--snapshot",
                   help="snapshot source (a manifest .json file, "
                        "sqlite://db#id, or an http(s):// manifest URL): "
                        "weights to serve with --serve or to decode with "
                        "--generate, else the training run to resume")
    p.add_argument("--result-file", help="write the results JSON here")
    p.add_argument("--curriculum", metavar="SPEC.json",
                   help="snapshot-phased curriculum: run the config as "
                        "chained training phases per the spec (each "
                        "phase restores the best snapshot so far; see "
                        "runtime/curriculum.py)")
    p.add_argument("--curriculum-out", default="curriculum_out",
                   help="directory for per-phase snapshots/results")
    p.add_argument("--export", metavar="DIR[.zip]", default=None,
                   help="write a native-serving package of the "
                        "(restored) model and exit: contents.json + npy "
                        "for serving/veles_serve (reference: "
                        "Workflow.package_export, veles/workflow.py:868)")
    p.add_argument("--compiled", action="store_true",
                   help="with --export DIR: write a sealed compiled "
                        "artifact instead (torch.export programs of the "
                        "batched forward and the decode engine's program "
                        "set, a manifest, the weights blob) and print the "
                        "manifest summary; serve it with --serve "
                        "--artifact DIR")
    p.add_argument("--artifact", metavar="DIR", default=None,
                   help="with --serve: boot from a compiled artifact "
                        "directory (export_compiled): its loaded programs, "
                        "no model Python, no config file")
    p.add_argument("--generate", type=int, metavar="N", default=None,
                   help="decode N tokens after --prompt with the "
                        "(restored) sequence model instead of training; "
                        "prints the token rows as JSON")
    p.add_argument("--prompt", default=None,
                   help="comma-separated token ids for --generate "
                        "(';' separates batch rows), or @file.npy")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sampling temperature for --generate "
                        "(0 = greedy)")
    p.add_argument("--top-k", type=int, default=None,
                   help="restrict --generate sampling to the k highest "
                        "logits (needs --temperature > 0)")
    p.add_argument("--top-p", type=float, default=None,
                   help="nucleus sampling for --generate: smallest "
                        "token set with cumulative probability >= p "
                        "(needs --temperature > 0)")
    p.add_argument("--beams", type=int, default=1,
                   help="beam-search width for --generate (>1 returns "
                        "the highest-total-log-prob continuation; "
                        "exclusive with sampling flags)")
    p.add_argument("--eos-id", type=int, default=None,
                   help="end-of-sequence token: greedy/sampling decode "
                        "stops a row that emits it (padding the rest); "
                        "with --beams, finished beams freeze and pad")
    p.add_argument("--length-penalty", type=float, default=0.0,
                   help="beam score normalization exponent over the "
                        "generated length (GNMT convention; 0 = raw "
                        "log-prob sum)")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve over HTTP instead of training (0 = any "
                        "free port); needs --snapshot")
    p.add_argument("--fleet", type=int, metavar="N", default=None,
                   help="with --serve: boot N replica serving stacks in "
                        "this process behind the fleet router (load and "
                        "prefix-affinity dispatch, coordinated hot swap, "
                        "rolling drain); PORT serves the router, the "
                        "replicas take ephemeral ports (default "
                        "root.common.serve.fleet.replicas)")
    p.add_argument("--join", metavar="ROUTER_URL", default=None,
                   help="with --serve: register this replica with a "
                        "running fleet router after boot (POST "
                        "/admin/join) so it receives dispatched traffic")
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
    p.add_argument("--mesh", default=None,
                   help="mesh spec over the axes data, fsdp, model, seq, "
                        "pipe and expert, e.g. data=2,fsdp=2 or "
                        "data=2,seq=2,pipe=2 (one rank process each; "
                        "fsdp shards the large parameters and their "
                        "optimizer state, model ranks compute the same "
                        "rows)")
    p.add_argument("--hosts", default=None,
                   help="comma-separated hosts: respawn this command on "
                        "each (localhost entries spawn locally) as one "
                        "gang of ranks")
    p.add_argument("--trace-out", metavar="FILE", default=None,
                   help="on exit, write the host-side span timeline "
                        "(each request's queue-wait, prefill and decode "
                        "spans; status events) as Chrome-trace JSON")
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    setup_logging()
    launched = _launch_ranks(args, argv)
    if launched is not None:
        return launched
    if args.curriculum and (args.generate is not None
                            or args.serve is not None):
        raise SystemExit("--curriculum is a training meta-mode; "
                         "--generate/--serve apply to single runs (run "
                         "them on the final best snapshot)")
    _check_export_args(args)
    if args.curriculum:
        # dispatched before the config is read: each phase subprocess
        # loads it itself
        return _curriculum(args)
    if args.artifact is None:
        if not args.config:
            build_parser().print_help()
            return 2
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
    _check_fleet_args(args)
    device = resolve_device(args.device)
    from .parallel.distributed import (initialize_distributed,
                                       shutdown_distributed)
    initialize_distributed(device=device)
    if (args.mesh or args.hosts) and (args.serve is not None
                                      or args.generate is not None):
        raise SystemExit("--mesh/--hosts train over a gang of ranks; "
                         "--serve and --generate run on one")
    status = status_server = None
    if args.status_port is not None:
        os.makedirs(str(root.common.cache_dir), exist_ok=True)
        status = StatusReporter(
            os.path.join(str(root.common.cache_dir), "status.json"),
            name=root.workflow.get("name", "workflow"))
        status_server = StatusServer(status, port=args.status_port).start()
    try:
        if args.artifact is not None:
            return _serve_artifact(args, device, status, status_server)
        if args.serve is not None:
            if not args.snapshot:
                raise SystemExit("--serve needs --snapshot (the weights)")
            return _serve(args, device, status, status_server)
        if args.generate is not None:
            _check_generate_args(args)
        return _train(args, device, status)
    finally:
        if status_server is not None:
            status_server.stop()
        if args.trace_out:
            write_chrome_trace(args.trace_out)
        shutdown_distributed()


def _check_export_args(args) -> None:
    """The JAX CLI's export and artifact guards (veles_tpu/__main__.py:
    863-918), before anything loads."""
    if args.artifact is not None and args.config and "=" in args.config \
            and not args.config.endswith(".json"):
        # with no config, the first override lands in the config slot
        args.overrides.insert(0, args.config)
        args.config = None
    if args.compiled and not args.export:
        raise SystemExit("--compiled modifies --export DIR (it writes "
                         "the compiled artifact there)")
    if args.artifact is None:
        if args.export and (args.serve is not None or args.curriculum
                            or args.generate is not None):
            raise SystemExit(
                "--export writes the (restored) model and exits; it does "
                "not combine with --serve, --generate or --curriculum "
                "(export first, then serve)")
        return
    if args.serve is None:
        raise SystemExit("--artifact serves a compiled artifact and needs "
                         "--serve PORT")
    if args.config:
        raise SystemExit("--artifact serves sealed programs; a workflow "
                         f"config cannot apply (drop {args.config!r}, or "
                         "serve the config via --serve without --artifact)")
    if args.export:
        raise SystemExit("--export needs the model config to package; it "
                         "cannot combine with --artifact serving (export "
                         "first, then serve the artifact)")
    if args.snapshot:
        raise SystemExit("--artifact serves the artifact's sealed weights; "
                         "--snapshot cannot apply (swap weights at runtime "
                         "via POST /admin/reload)")
    if args.generate is not None:
        raise SystemExit("--generate is a one-shot decode of a "
                         "config/snapshot model; with an artifact, serve it "
                         "and POST /generate")


def _export(args, trainer) -> int:
    """``--export DIR[.zip]`` (``--compiled``: a sealed artifact) of the
    (restored) model, at the loader's batch shape
    (veles_tpu/__main__.py:1153-1175)."""
    wf = trainer.workflow
    spec = wf.specs["@input"]
    input_spec = {"shape": [int(d) for d in spec.shape],
                  "dtype": str(spec.dtype).replace("torch.", "")}
    if args.compiled:
        if args.export.endswith(".zip"):
            raise SystemExit("--compiled exports a DIRECTORY artifact "
                             "(programs + manifest + weights), not a .zip")
        from .export.compiled import export_compiled, manifest_summary
        man = export_compiled(wf, trainer.wstate, args.export,
                              input_spec=input_spec, eos_id=args.eos_id)
        out = {"exported": args.export, "compiled": True,
               "manifest": manifest_summary(man)}
    else:
        from .export.package import export_package
        export_package(wf, trainer.wstate, args.export,
                       input_spec=input_spec)
        out = {"exported": args.export, "units": len(wf.units)}
    print(json.dumps(out), flush=True)
    _write_result(args, out)
    return 0


def _train(args, device, status=None) -> int:
    from .models.standard import StandardWorkflow
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
        # stored, not deflated: float weights barely deflate, and a run
        # that snapshots every epoch pays the deflate each time (both
        # packages read either)
        snap = Snapshotter(wf_cfg.get("name", "workflow"), args.snapshot_dir,
                           compression=False)
    mesh = _make_mesh(args, sw)
    trainer = sw.make_trainer(loader, decision, snap, device=device,
                              status=status, mesh=mesh,
                              rule=_mesh_rule(mesh, sw))
    trainer.initialize()
    if args.snapshot:
        trainer.restore(args.snapshot)
    if args.export:
        return _export(args, trainer)
    if args.generate is not None:
        return _generate(args, trainer)
    results = trainer.run()
    if trainer.writes:
        print(json.dumps(results), flush=True)
        _write_result(args, results)
    return 0


def _mesh_ranks(spec) -> int:
    """Ranks a ``--mesh`` spec asks for (a -1 axis counts 1)."""
    from .parallel.mesh import AXES
    return int(np.prod([max(getattr(spec, a), 1) for a in AXES]))


def _launch_ranks(args, argv):
    """The launcher role (veles_tpu/__main__.py:842-848): with
    ``--hosts``, or a ``--mesh`` of more ranks than this process on the
    CPU, start the gang and wait for it; a rank itself (its
    ``VELES_PROCESS_ID`` set) returns None and runs.  On the card a
    mesh of more than one rank is refused: one GPU, one rank."""
    if "VELES_PROCESS_ID" in os.environ:
        return None
    from .parallel.launcher import launch_hosts
    from .parallel.mesh import MeshSpec, check_axes
    if args.hosts:
        return launch_hosts(args.hosts.split(","), argv,
                            coordinator_port=_free_port())
    if not args.mesh:
        return None
    spec = MeshSpec.parse(args.mesh)
    check_axes(dataclasses.asdict(spec))
    n = _mesh_ranks(spec)
    if n <= 1:
        return None
    if resolve_device(args.device).type == "cuda":
        raise SystemExit(
            f"--mesh {args.mesh} asks for {n} ranks; a run on the card has "
            "one rank (one GPU on this host): run the ranks on the CPU "
            "with --device cpu, or one rank per GPU host with --hosts")
    # the ranks share this host's cores
    os.environ.setdefault("OMP_NUM_THREADS",
                          str(max(1, (os.cpu_count() or 1) // n)))
    return launch_hosts(["localhost"] * n, argv,
                        coordinator_port=_free_port())


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _make_mesh(args, sw):
    """The run's mesh: ``--mesh`` (or pure data parallelism over a
    ``--hosts`` gang), None for a lone process
    (veles_tpu/__main__.py:280-314); ``_mesh_rule`` places its state."""
    from .parallel.distributed import host_count
    from .parallel.mesh import MeshSpec, make_mesh
    if host_count() == 1:
        # one process and no group: the plain (captured) steps are the
        # mesh's steps
        if args.mesh:
            MeshSpec.parse(args.mesh).axis_sizes(1)     # must tile one
        return None
    return make_mesh(MeshSpec.parse(args.mesh) if args.mesh
                     else MeshSpec())


def _mesh_rule(mesh, sw):
    """The placement rule the JAX package's CLI composes for a mesh
    (veles_tpu/__main__.py:281-297): expert banks over ``expert`` and
    stage arrays over ``pipe`` where the graph has such units, then the
    large leaves over ``fsdp``; None where nothing applies."""
    if mesh is None:
        return None
    from .parallel.mesh import compose_rules, fsdp_rules
    from .units.parallel_nn import (MoEFFN, PipelineStack, expert_rules,
                                    pipeline_rules)
    rules = []
    kinds = {type(u) for u in sw.workflow.units}
    if MoEFFN in kinds and mesh.shape.get("expert", 1) > 1:
        rules.append(expert_rules())
    if PipelineStack in kinds and mesh.shape.get("pipe", 1) > 1:
        rules.append(pipeline_rules())
    if mesh.shape.get("fsdp", 1) > 1:
        rules.append(fsdp_rules(axis_size=mesh.shape["fsdp"]))
    return compose_rules(*rules) if rules else None


def _write_result(args, out) -> None:
    if args.result_file:
        with open(args.result_file, "w") as f:
            json.dump(out, f, indent=1)


def _curriculum(args) -> int:
    """``--curriculum``: the phases as subprocesses of this CLI, the
    device and the seed forwarded (veles_tpu/__main__.py:943-970)."""
    from .runtime.curriculum import CurriculumRunner
    with open(args.curriculum) as f:
        spec = json.load(f)
    extra = list(args.overrides)
    if args.device:
        extra += ["--device", args.device]
    summary = CurriculumRunner(args.config, spec, args.curriculum_out,
                               extra_argv=extra,
                               initial_snapshot=args.snapshot,
                               default_seed=args.random_seed).run()
    print(json.dumps({k: v for k, v in summary.items() if k != "phases"}),
          flush=True)
    _write_result(args, summary)
    return 0


def _check_fleet_args(args) -> None:
    """The JAX CLI's fleet guards (veles_tpu/__main__.py:866-890), at
    parse time: a pure argv conflict must not wait for a model load."""
    if args.fleet is not None and args.serve is None:
        raise SystemExit("--fleet fronts HTTP serving with the fleet "
                         "router and needs --serve PORT")
    if args.fleet is not None and args.watch:
        raise SystemExit(
            "--watch is per-replica and conflicts with --fleet: "
            "fleet-wide version changes go through the router's "
            "coordinated swap (POST /admin/reload on the router)")
    if args.fleet is not None and args.join:
        raise SystemExit("--fleet runs the router; --join makes this "
                         "process a replica of ANOTHER router — "
                         "pick one")
    if args.join and args.serve is None:
        raise SystemExit("--join registers a serving replica with a "
                         "fleet router and needs --serve PORT")
    if args.join and args.watch:
        raise SystemExit("--watch is a per-replica auto-swap and would "
                         "silently break the fleet's all-or-nothing "
                         "version invariant on a --join'ed replica; "
                         "fleet-wide version changes go through the "
                         "router's coordinated swap (POST /admin/reload "
                         "on the router)")


def _check_generate_args(args) -> None:
    """The JAX CLI's checks and messages (veles_tpu/__main__.py:
    1238-1276)."""
    if not args.prompt:
        raise SystemExit("--generate needs --prompt "
                         "(token ids, or @file.npy)")
    if (args.top_k is not None or args.top_p is not None) \
            and args.temperature <= 0:
        raise SystemExit(
            "--top-k/--top-p filter SAMPLING and need "
            "--temperature > 0 (temperature 0 is greedy decoding, "
            "which would silently ignore them)")
    if args.top_k is not None and args.top_k < 1:
        raise SystemExit(f"--top-k must be >= 1, got {args.top_k}")
    if args.top_p is not None and not 0.0 < args.top_p <= 1.0:
        raise SystemExit(f"--top-p must be in (0, 1], got "
                         f"{args.top_p}")
    if args.beams < 1:
        raise SystemExit(f"--beams must be >= 1, got {args.beams} "
                         "(a value < 1 would silently fall back to "
                         "greedy/sampling decode)")
    if args.beams <= 1 and args.length_penalty:
        raise SystemExit(
            "--length-penalty shapes BEAM scores and needs "
            "--beams > 1 (greedy/sampling decode would silently "
            "ignore it)")
    if args.beams > 1 and args.temperature > 0:
        raise SystemExit(
            "--beams is deterministic search; drop "
            "--temperature/--top-k/--top-p or use beams=1")


def _parse_prompt(text: str) -> np.ndarray:
    if text.startswith("@"):
        return np.atleast_2d(np.load(text[1:])).astype(np.int32)
    rows = [[int(t) for t in row.split(",") if t.strip()]
            for row in text.split(";") if row.strip()]
    if not rows or len({len(r) for r in rows}) != 1:
        raise SystemExit(
            "--prompt rows must be non-empty and equal length "
            f"(got lengths {[len(r) for r in rows]})")
    return np.asarray(rows, np.int32)


def _generate(args, trainer) -> int:
    """``--generate``: decode with the trainer's (restored) weights; the
    output JSON of veles_tpu/__main__.py:1278-1303.  Sampling seeds from
    ``root.common.random_seed``."""
    from .runtime.generate import generate, generate_beam
    prompt = _parse_prompt(args.prompt)
    if args.beams > 1:
        toks, scores = generate_beam(
            trainer.workflow, trainer.wstate, prompt, args.generate,
            beams=args.beams, eos_id=args.eos_id,
            length_penalty=args.length_penalty)
        out = {"prompt_len": int(prompt.shape[1]),
               "tokens": np.asarray(toks.cpu()).tolist(),
               "scores": np.asarray(scores.cpu()).tolist()}
    else:
        toks = generate(trainer.workflow, trainer.wstate, prompt,
                        args.generate, temperature=args.temperature,
                        seed=int(root.common.get("random_seed", 0)),
                        top_k=args.top_k, top_p=args.top_p,
                        eos_id=args.eos_id)
        out = {"prompt_len": int(prompt.shape[1]),
               "tokens": np.asarray(toks.cpu()).tolist()}
    print(json.dumps(out), flush=True)
    _write_result(args, out)
    return 0


def _fleet_n(args) -> int:
    """Replica count for ``--serve --fleet``: the flag, else
    ``root.common.serve.fleet.replicas`` (0 = one replica, no router),
    veles_tpu/__main__.py:489-496."""
    if args.fleet is not None:
        return max(0, int(args.fleet))
    return max(0, int(root.common.serve.fleet.get("replicas", 0) or 0))


def _serve_fleet(args, factory, banner: dict) -> int:
    """``--serve PORT --fleet N``: N in-process replica stacks (each
    built by ``factory``, a zero-arg callable returning a started
    ``RestfulServer`` whose engine runs, deploy control plane attached)
    behind the fleet router on PORT; blocks until the fleet drains
    (SIGTERM or ``POST /admin/drain`` on the router),
    veles_tpu/__main__.py:498-545."""
    from .runtime.fleet import FleetRouter, FleetServer, InProcessReplica
    if args.watch:
        raise SystemExit(
            "--watch is per-replica and conflicts with --fleet: "
            "fleet-wide version changes go through the router's "
            "coordinated swap (POST /admin/reload on the router)")
    if args.join:
        raise SystemExit("--fleet runs the router; --join makes this "
                         "process a replica of ANOTHER router — "
                         "pick one")
    n = _fleet_n(args)
    replicas = [InProcessReplica(factory) for _ in range(n)]
    router = FleetRouter()
    for rep in replicas:
        # one process, one metrics registry: the SLO merge counts the
        # shared histograms once
        router.add_replica(url=rep.url, registry_key="in-process",
                           restart=rep.restart, kill=rep.kill)
    fsrv = FleetServer(router, port=args.serve)
    fsrv.install_signal_handlers()
    fsrv.start()
    print(json.dumps(dict(
        banner, fleet=n, serving=fsrv.port,
        replicas=[r.url for r in replicas],
        observe=["/metrics", "/fleet.json", "/slo.json"])), flush=True)
    try:
        router.wait()       # released by SIGTERM or POST /admin/drain
    except KeyboardInterrupt:
        router.begin_drain()
    fsrv.stop()
    for rep in replicas:
        rep.stop()
    return 0


def _join(args, srv) -> None:
    """``--join ROUTER_URL``: register this replica with the router
    (retried on transport errors: the router may still be booting),
    veles_tpu/__main__.py:557-579."""
    from .runtime.deploy import http_retry
    from .runtime.fleet_client import ReplicaClient, ReplicaUnavailable

    def post():
        try:
            return ReplicaClient(args.join).request(
                "POST", "/admin/join",
                {"url": f"http://127.0.0.1:{srv.port}"})
        except ReplicaUnavailable as e:
            raise ConnectionError(str(e)) from e

    code, _h, doc = http_retry(post, what="fleet join")
    if code != 200:
        raise SystemExit(f"--join {args.join}: router refused the replica "
                         f"(HTTP {code}: {doc})")


def _serve(args, device, status=None, status_server=None) -> int:
    from .models.standard import StandardWorkflow
    from .units.workflow import WorkflowError
    log = Logger()
    sw = StandardWorkflow(root.workflow.to_dict())
    wf = sw.workflow
    B = int(root.loader.get("minibatch_size", 1))
    T = int(root.loader.get("seq_len", 1))
    wf.build({"@input": Spec((B, T), torch.int32),
              "@labels": Spec((B,), torch.int32),
              "@mask": Spec((B,), torch.float32)})
    head = wf.default_output()

    def stack(port):
        """One serving stack: its own copy of the snapshot's weights
        (a hot swap writes into the served tensors), an engine where the
        chain decodes, the REST server and the deploy control plane."""
        wstate = wstate_from_snapshot(args.snapshot, wf, device=device)
        engine = None
        try:
            engine = DecodeEngine(wf, wstate, status=status,
                                  device=device).start()
        except WorkflowError as e:
            log.warning("serving /predict only (no decode engine: %s)", e)
        # /predict serves the engine's tensors: one device copy
        srv = RestfulServer(wf.make_predict_step(head),
                            engine.wstate if engine is not None else wstate,
                            B, (T,), port=port, workflow=wf, engine=engine,
                            input_dtype=np.int32, device=device)
        deploy = DeployController(server=srv, model_dir=args.model_dir,
                                  drain_timeout_s=args.drain_timeout,
                                  status=status, boot_source=args.snapshot)
        return srv, deploy

    return _run_stacks(args, stack, {"predict_head": head,
                                     "device": str(device)},
                       status_server)


def _serve_artifact(args, device, status=None, status_server=None) -> int:
    """``--serve PORT --artifact DIR``: serve a sealed compiled artifact
    with no config and no model code (veles_tpu/__main__.py:607-680): a
    decodable artifact's ``/generate`` through an ``ArtifactRunner``, its
    sealed forward behind ``/predict``, the deploy control plane around
    it (``/admin/reload`` swaps weights from snapshots, packages, other
    artifacts or a forge store: the programs stay sealed)."""
    from .runtime.artifact import ArtifactRunner, load_forward, read_manifest
    man = read_manifest(args.artifact)
    ispec = man.get("input_spec") or {}
    shape = [int(d) for d in (ispec.get("shape") or (1, 1))]

    def stack(port):
        runner = None
        if "decode" in man["programs"]:
            runner = ArtifactRunner(args.artifact, status=status,
                                    device=device).start()
            wstate = runner.wstate
            predict_fn = runner.predict if runner.has_forward else None
        else:
            predict_fn, wstate, _ = load_forward(args.artifact,
                                                 device=device)
        if predict_fn is None:
            def predict_fn(wstate, batch):
                raise ValueError("this artifact was exported without a "
                                 "forward program; only /generate is "
                                 "served")
        srv = RestfulServer(
            predict_fn, wstate, shape[0], tuple(shape[1:]), port=port,
            engine=runner, device=device,
            input_dtype=np.dtype(ispec.get("dtype", "float32")),
            default_eos_id=man.get("eos_id"),
            vocab_size=man.get("input_vocab"))
        deploy = DeployController(server=srv, model_dir=args.model_dir,
                                  drain_timeout_s=args.drain_timeout,
                                  status=status,
                                  boot_source=str(args.artifact))
        return srv, deploy

    return _run_stacks(args, stack, {
        "artifact": args.artifact, "workflow": man.get("workflow"),
        "programs": sorted(man["programs"]), "device": str(device)},
        status_server)


def _run_stacks(args, stack, banner: dict, status_server=None) -> int:
    """Serve ``stack(port) -> (server, deploy)``: N replicas behind the
    fleet router with ``--fleet``, else one, until a drain (SIGTERM or
    ``POST /admin/drain``) or SIGINT."""
    if _fleet_n(args):
        def factory():
            return stack(0)[0].start()

        return _serve_fleet(args, factory, banner)
    srv, deploy = stack(args.serve)
    engine = srv.engine
    deploy.install_signal_handlers()     # SIGTERM drains
    srv.start()
    try:
        if args.join:
            _join(args, srv)
        if args.watch:
            deploy.start_watcher()
        print(json.dumps(dict(
            banner, serving=srv.port, engine=engine is not None,
            model_dir=deploy.model_dir, watching=deploy.watching,
            status_port=(status_server.port if status_server is not None
                         else None),
            observe=["/metrics", "/trace.json", "/slo.json",
                     "/memory.json", "/models", "/debug/profile"])),
              flush=True)
        try:
            deploy.wait()   # released by SIGTERM or POST /admin/drain
        except KeyboardInterrupt:
            deploy.drain(timeout=0)     # interactive: no grace hold
    finally:
        srv.stop()
        if engine is not None:
            engine.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
