"""Compiled-artifact runner: serve a sealed ``torch.export`` artifact with
no model code (counterpart of veles_tpu/runtime/artifact.py).

``export_compiled`` (``export/compiled.py``) seals the decode engine's
program set and the batched forward into a directory of ``.pt2``
programs, a manifest and a weights blob.  :class:`ArtifactRunner` is the
other half: a :class:`~.engine.DecodeEngine` (the same scheduler, prefix
cache, preemption, megastep, speculation, streaming, swap and drain)
whose model hooks read the artifact: the served weights from
``tensors.npz`` cast to the manifest's dtypes, the caches from the
manifest's rows, the head width from ``vocab``, and the steps from
``torch.export.load(...).module()``, handed to the engine's StepCache,
so on the card they are captured as CUDA graphs at load.  Nothing is
captured after load: per request or per swap the counters stay flat.
The runner needs neither the config nor the workflow; the kernel
modules it imports register the custom ops the programs call.

Integrity and failure semantics mirror snapshots and are checked at
load, never mid-request: every blob's sha256 is verified first
(:class:`~.snapshotter.SnapshotCorruptError` for a damaged manifest, a
checksum mismatch or a blob that does not load); a newer
``format_version``, the JAX package's artifact, or a program that this
torch cannot load raise :class:`ArtifactVersionError` naming both
versions; a program exported for another device type or capability
raises :class:`ArtifactError` asking for a re-export on the serving
device (the counterpart of ``_check_platform``, artifact.py:184-199).
"""

from __future__ import annotations

import json
import os
import types
from typing import Dict, Optional

import numpy as np
import torch

from ..export.compiled import (FORMAT, FORMAT_VERSION, JAX_FORMAT, MANIFEST,
                               device_record, tree_get, tree_nest)
from ..ops import resolve_device
from .engine import DecodeEngine, _ServeStep
from .snapshotter import SnapshotCorruptError, _unflatten, sha256_files
from .step_cache import tree_signature, without_gc


class ArtifactError(RuntimeError):
    """The artifact is structurally unusable here (no manifest, no such
    program, another device): distinct from corruption
    (:class:`~.snapshotter.SnapshotCorruptError`: fetch the bytes again)
    and from version skew (:class:`ArtifactVersionError`: re-export)."""


class ArtifactVersionError(ArtifactError):
    """The artifact was written by a newer format, by the JAX package, or
    by a torch whose programs this one cannot load: re-export it."""


def is_artifact_dir(path: str) -> bool:
    """The directory holds an artifact manifest (the control plane's
    dispatch test, made before the package's contents.json test)."""
    return os.path.isfile(os.path.join(str(path), MANIFEST))


def read_manifest(art_dir: str) -> dict:
    """Parse and check ``artifact.json`` (no blob verification: that is
    :func:`verify_artifact`'s)."""
    path = os.path.join(str(art_dir), MANIFEST)
    try:
        with open(path) as f:
            man = json.load(f)
    except FileNotFoundError:
        raise ArtifactError(
            f"{art_dir!r} is not a compiled artifact (no {MANIFEST}; "
            "produce one with export_compiled / python -m veles_tpu_torch "
            "CONFIG --export DIR --compiled)") from None
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise SnapshotCorruptError(
            f"{path}: unparseable artifact manifest ({e})") from e
    if isinstance(man, dict) and man.get("format") == JAX_FORMAT:
        raise ArtifactVersionError(
            f"{path}: a compiled artifact of the JAX package (StableHLO "
            "programs); this port serves torch.export artifacts: re-export "
            "it with veles_tpu_torch.export.export_compiled")
    if not isinstance(man, dict) or man.get("format") != FORMAT:
        raise ArtifactError(f"{path}: not a compiled-artifact manifest")
    try:
        ver = int(man.get("format_version", 1))
    except (TypeError, ValueError) as e:
        raise SnapshotCorruptError(
            f"{path}: artifact manifest is damaged (format_version "
            f"{man.get('format_version')!r}); re-export") from e
    if ver > FORMAT_VERSION:
        raise ArtifactVersionError(
            f"{path}: artifact format version {ver} is newer than this "
            f"veles_tpu_torch reads ({FORMAT_VERSION}); upgrade, or "
            "re-export with a matching version")
    progs = man.get("programs")
    ok = (isinstance(man.get("tensors"), str) and isinstance(progs, dict)
          and all(isinstance(p, dict) and isinstance(p.get("file"), str)
                  and isinstance(p.get("state"), list)
                  and isinstance(p.get("inputs"), list)
                  for p in progs.values())
          and isinstance(man.get("served"), list)
          and isinstance(man.get("device"), dict))
    if ok and "decode" in progs:
        ok = all(isinstance(man.get(k), int)
                 for k in ("slots", "l_max", "page_size", "pages", "vocab"))
    if ok and "forward" in progs:
        ispec = man.get("input_spec")
        ok = isinstance(ispec, dict) and isinstance(
            ispec.get("shape"), list) and "dtype" in ispec
    if not ok:
        raise SnapshotCorruptError(
            f"{path}: artifact manifest is damaged (tensors, program, "
            "geometry, device or input_spec entries missing or "
            "malformed); re-export")
    return man


def _verify_blob(path: str, want: Optional[str]) -> None:
    if not want:
        return
    try:
        got = sha256_files([path])
    except OSError as e:
        raise SnapshotCorruptError(
            f"{path}: artifact blob unreadable ({e})") from e
    if got != want:
        raise SnapshotCorruptError(
            f"{path}: artifact checksum mismatch (manifest {want[:12]}..., "
            f"blob {got[:12]}...)")


def verify_artifact(art_dir: str, man: dict) -> None:
    """Every blob the manifest names against its sha256, before anything
    loads: torn or flipped bytes raise SnapshotCorruptError."""
    blobs = [(man["tensors"], man.get("tensors_sha256"))]
    blobs += [(p["file"], p.get("sha256"))
              for p in man.get("programs", {}).values()]
    for rel, want in blobs:
        _verify_blob(os.path.join(str(art_dir), rel), want)


def load_artifact_weights(art_dir: str, man: Optional[dict] = None, *,
                          verify: bool = True) -> Dict[str, dict]:
    """The weights blob as host numpy trees ``{"params", "state"}`` in the
    workflow's own layout: what the deploy control plane swaps onto a
    live engine from an ``artifact://`` source."""
    man = man if man is not None else read_manifest(art_dir)
    npz_path = os.path.join(str(art_dir), man["tensors"])
    if verify:
        _verify_blob(npz_path, man.get("tensors_sha256"))
    try:
        with np.load(npz_path, allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
    except (OSError, ValueError, EOFError) as e:
        raise SnapshotCorruptError(
            f"{npz_path}: artifact tensors unreadable ({e})") from e
    tree = _unflatten(flat)
    return {"params": tree.get("params") or {},
            "state": tree.get("state") or {}}


def check_device(man: dict, device: torch.device) -> None:
    """The serving device must be the kind the programs were exported
    on (their constants are baked there): refused at load."""
    want = man.get("device") or {}
    have = device_record(device)
    if want.get("type") != have["type"] or (
            have["type"] == "cuda"
            and list(want.get("capability") or []) != have["capability"]):
        raise ArtifactError(
            f"the artifact's programs were exported on "
            f"{want.get('type')} ({want.get('name')}, capability "
            f"{want.get('capability')}); this process serves on "
            f"{have['type']} ({have['name']}, capability "
            f"{have['capability']}): re-export on the serving device")


def load_program(art_dir: str, man: dict, name: str):
    """``torch.export.load`` of one program, as a callable module."""
    info = man["programs"].get(name)
    if info is None:
        raise ArtifactError(f"artifact {art_dir!r} holds no {name!r} "
                            f"program (has {sorted(man['programs'])})")
    path = os.path.join(str(art_dir), info["file"])
    try:
        with without_gc():
            return torch.export.load(path).module()
    except Exception as e:  # noqa: BLE001 — format or version skew
        # the checksum passed: the bytes are the exporter's, so a load
        # failure is producer/consumer skew, not corruption in transit
        raise ArtifactVersionError(
            f"artifact program {name!r} did not load ({type(e).__name__}: "
            f"{e}); it was exported by torch {man.get('torch_version')}, "
            f"this process runs torch {torch.__version__}: re-export with "
            "a torch this process can load") from e


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def served_params(man: dict, params: dict, device) -> dict:
    """The workflow-layout ``params`` (numpy) as the programs' parameter
    inputs: each leaf at the manifest's served dtype on ``device``."""
    rows = man["served"]
    return tree_nest([r["path"] for r in rows], [
        torch.from_numpy(np.array(tree_get(params, r["path"]), copy=True))
        .to(device=device, dtype=_dtype(r["dtype"])) for r in rows])


def _state_tensors(state: dict, device) -> dict:
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, copy=True)).to(device)
    return conv(state)


def _flat_args(man: dict, info: dict, params, state, inputs) -> list:
    return ([tree_get(params, r["path"]) for r in man["served"]]
            + [tree_get(state, r["path"]) for r in info["state"]]
            + [tree_get(inputs, r["path"]) for r in info["inputs"]])


def load_forward(art_dir: str, device=None):
    """Only the batched forward of an artifact: ``(predict_fn, wstate,
    manifest)``, ``predict_fn(wstate, batch)`` in the
    ``make_predict_step`` contract (what ``--serve --artifact`` boots
    for a forward-only artifact)."""
    art_dir = str(art_dir)
    device = resolve_device(device)
    man = read_manifest(art_dir)
    verify_artifact(art_dir, man)
    if "forward" not in man["programs"]:
        raise ArtifactError(f"artifact {art_dir!r} holds no forward "
                            "program (exported without an input spec?)")
    check_device(man, device)
    module = load_program(art_dir, man, "forward")
    parts = load_artifact_weights(art_dir, man, verify=False)
    wstate = {"params": served_params(man, parts["params"], device),
              "state": _state_tensors(parts["state"], device)}
    return _forward_fn(man, module), wstate, man


def _forward_fn(man: dict, module):
    info = man["programs"]["forward"]

    def predict(wstate, batch):
        with torch.no_grad():
            return module(*_flat_args(man, info, wstate["params"],
                                      wstate.get("state") or {},
                                      {"x": batch["@input"]}))

    return predict


class _SealedPlan:
    """What the engine reads of a decode plan, from the manifest: the
    attention units (name, heads, window: goodput pricing, KV transfer,
    the memory ledger) and the recurrent units' names."""

    wf = None

    def __init__(self, man: dict):
        self._attn_units = [types.SimpleNamespace(**u)
                            for u in man.get("attn_units", [])]
        self._rec_units = list(man.get("rec_units", []))

    def attn_keys(self):
        return {u.name for u in self._attn_units}


class _SealedStep(_ServeStep):
    """A sealed program in the engine's step shape: ``run(state, inputs,
    host)`` calls the loaded module on the served parameters, the state's
    tensors and the inputs in the manifest's order; its static inputs
    are zeros of the manifest's rows."""

    def __init__(self, engine, name: str, module):
        info = engine.manifest["programs"][name]
        super().__init__(engine, tree_nest(
            [r["path"] for r in info["inputs"]],
            [torch.zeros(tuple(r["shape"]), dtype=_dtype(r["dtype"]),
                         device=engine.device) for r in info["inputs"]]))
        self.name, self.kind, self.n = name, info["kind"], int(info["n"])
        self.module, self._info, self._man = module, info, engine.manifest

    def run(self, state, inputs, host):
        with torch.no_grad():
            return self.module(*_flat_args(self._man, self._info,
                                           self.params, state, inputs))


class ArtifactRunner(DecodeEngine):
    """A :class:`~.engine.DecodeEngine` whose model comes from a sealed
    artifact: the same ``submit`` / ``generate`` / ``swap_params`` /
    ``drain`` / ``stats`` and REST and deploy integrations, with the
    three model hooks reading the artifact.  ``spec`` / ``megastep``
    default to what it seals; asking for an unsealed program raises.
    ``device`` defaults to the card and must be the kind the artifact was
    exported on.  The other keywords are the engine's scheduler knobs."""

    def __init__(self, art_dir: str, *, spec: Optional[bool] = None,
                 megastep: Optional[int] = None, device=None, **kw):
        self.art_dir = str(art_dir)
        device = resolve_device(device)
        man = read_manifest(self.art_dir)
        verify_artifact(self.art_dir, man)
        progs = man["programs"]
        if "decode" not in progs:
            why = man.get("decode_unsupported", "a forward-only export")
            raise ArtifactError(
                f"artifact {art_dir!r} holds no decode program ({why}); "
                "a forward-only artifact loads through load_forward()")
        check_device(man, device)
        spec_meta = man.get("spec_decode") or None
        if spec_meta is not None and (
                not isinstance(spec_meta.get("k"), int)
                or "verify" not in progs):
            raise SnapshotCorruptError(
                f"{art_dir}: artifact manifest spec_decode entry is damaged "
                "(no static k, or no sealed verify program); re-export")
        want_spec = bool(spec_meta) if spec is None else bool(spec)
        if want_spec and spec_meta is None:
            raise ArtifactError(
                f"artifact {art_dir!r} seals no speculative verify program; "
                "re-export with export_compiled(..., spec=True): the runner "
                "has no model code to trace one from")
        mega_meta = man.get("megastep") or None
        if mega_meta is not None and (
                not isinstance(mega_meta.get("n"), int)
                or mega_meta["n"] < 2 or "megastep" not in progs):
            raise SnapshotCorruptError(
                f"{art_dir}: artifact manifest megastep entry is damaged "
                "(no static n >= 2, or no sealed megastep program); "
                "re-export")
        sealed_n = int(mega_meta["n"]) if mega_meta else 1
        want_mega = sealed_n if megastep is None else int(megastep)
        if want_mega > 1 and want_mega != sealed_n:
            raise ArtifactError(
                f"artifact {art_dir!r} seals "
                + (f"megastep N={sealed_n}" if sealed_n > 1
                   else "no megastep program")
                + f", megastep={want_mega} was asked for; re-export with "
                "export_compiled(..., megastep=N)")
        self.manifest = man
        self.workflow = None               # the point: no model code
        self.workflow_checksum = man.get("workflow_checksum")
        names = ["decode", "decode_greedy", "prefill"]
        if want_mega > 1:
            names += ["megastep", "megastep_greedy"]
        if want_spec:
            names += ["verify", "verify_greedy"]
        self._modules = {n: load_program(self.art_dir, man, n)
                         for n in names}
        forward = (load_program(self.art_dir, man, "forward")
                   if "forward" in progs else None)
        self._forward = None
        super().__init__(
            None, None, slots=man["slots"], l_max=man["l_max"], paged=True,
            page_size=man["page_size"], pages=man["pages"],
            paged_kernel=bool(man.get("paged_kernel", False)),
            megastep=want_mega, spec=want_spec,
            spec_k=int(spec_meta["k"]) if want_spec else None,
            cache_dtype=_dtype(man.get("cache_dtype", "float32")),
            device=device, **kw)
        self._forward = (_forward_fn(man, forward) if forward is not None
                         else None)
        self.info("artifact %s: %d programs%s, vocab=%s, %d captured or "
                  "built at load", self.art_dir, len(self._modules)
                  + (forward is not None),
                  " (with forward)" if forward is not None else "",
                  man.get("vocab"), self.step_cache.compiles)

    # -- the model hooks ------------------------------------------------------
    def _load_model(self, workflow, wstate, output_unit):
        man = self.manifest
        parts = load_artifact_weights(self.art_dir, man, verify=False)
        self.params = served_params(man, parts["params"], self.device)
        self.wstate = {"params": self.params,
                       "state": _state_tensors(parts["state"],
                                               self.device)}
        # the workflow-layout tree a swap may bring (as the manifest's
        # rows say), or the served one
        caller = tree_nest([r["path"] for r in man["params"]], [
            torch.empty(tuple(r["shape"]), dtype=_dtype(r["dtype"]),
                        device="meta") for r in man["params"]])
        self._swap_sigs = (tree_signature(caller),
                           tree_signature(self.params))
        self.plan = _SealedPlan(man)
        self._prefix_ok = bool(man.get("prefix_reuse", False))
        self._input_vocab = man.get("input_vocab")
        self._vocab = int(man["vocab"])

    def _make_caches(self, cache_dtype) -> dict:
        rows = self.manifest.get("caches", [])
        return tree_nest([r["path"] for r in rows], [
            torch.zeros(tuple(r["shape"]), dtype=_dtype(r["dtype"]),
                        device=self.device) for r in rows])

    def _make_steps(self, kinds) -> list:
        names = [kind + sfx for kind, _ in kinds for sfx in ("", "_greedy")]
        return [_SealedStep(self, n, self._modules[n])
                for n in names + ["prefill"]]

    # -- the forward leg ----------------------------------------------------
    @property
    def has_forward(self) -> bool:
        return self._forward is not None

    def predict(self, wstate, batch):
        """The ``make_predict_step`` contract over the sealed forward
        (RestfulServer's ``predict_fn``; the wstate argument is the
        server's live reference, which a swap replaces)."""
        if self._forward is None:
            raise ArtifactError(
                "the artifact was exported without a forward program")
        return self._forward(wstate, batch)

    def stats(self) -> dict:
        st = super().stats()
        st["artifact"] = {
            "dir": self.art_dir,
            "workflow": self.manifest.get("workflow"),
            "checksum": (self.workflow_checksum or "")[:12],
            "torch_version": self.manifest.get("torch_version"),
            "programs": len(self._modules) + self.has_forward,
        }
        return st
