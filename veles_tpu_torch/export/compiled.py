"""Compiled-artifact export: ``torch.export`` programs + manifest +
weights (counterpart of veles_tpu/export/compiled.py).

The package export (``export/package.py``) ships weights and structure;
this module ships the serving programs themselves.  The decode engine's
program set (``runtime/engine.py``: ``decode`` and ``decode_greedy``,
``megastep`` and ``megastep_greedy`` when N > 1, ``verify`` and
``verify_greedy`` when speculation is on, the one-position ``prefill``)
and the workflow's batched ``forward`` are each exported once with
``torch.export`` and saved as ``programs/<name>.pt2``, so
``runtime/artifact.py``'s :class:`~..runtime.artifact.ArtifactRunner`
serves them with no config and no model code.  The JAX package lowers to
StableHLO per prefill bucket; the port compiles nothing per shape, so
one prefill program serves every prompt length.

One source of step math: each program is the very step object the live
engine captures (``_TokenStep.run``, ``_PrefillStep.run``) or the
workflow's forward, wrapped in a module whose inputs are explicit — the
served parameters in the manifest's order, the step's state tensors and
its inputs — and exported under ``torch.no_grad()``.  The hand-written
kernels on that path (paged decode, the flash forward, mean/disp) are
``torch.library`` custom ops, so the sealed programs launch them on the
card exactly as the live engine does.  In-place writes (the KV pool, the
slot state, the token matrix) stay in place in the exported graph.

**Weights are inputs, never constants**: they live once, in
``tensors.npz`` (the snapshotter's flattened keys, the workflow's own
layout), and the runner casts them to the served dtypes the manifest
records, so a hot swap writes into the served tensors and recaptures
nothing.  Constants that a step holds (its row and offset indices) are
baked on the exporting device: an artifact serves on the device type
and capability it was exported on, which the manifest records and the
runner checks at load.

Layout (a directory, storable in a forge like any package)::

    <out_dir>/
      artifact.json         # manifest: geometry, program inputs, sha256s
      tensors.npz           # params (+ unit state)
      programs/<name>.pt2   # decode, decode_greedy, ..., prefill, forward

Integrity follows the snapshot discipline: every blob's sha256 (of the
in-memory bytes) is in the manifest, blobs are written ``.tmp`` +
fsync + rename, the manifest last, stray ``.tmp`` files of a dead export
cleared first; the runner verifies every checksum before it loads.
"""

from __future__ import annotations

import io
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..runtime.step_cache import without_gc

#: manifest file name inside an artifact directory (the deploy control
#: plane's test for ``artifact://`` sources)
MANIFEST = "artifact.json"
#: a name distinct from the JAX package's ("veles-tpu-compiled-
#: artifact"): each package refuses the other's artifacts by it
FORMAT = "veles-tpu-torch-compiled-artifact"
FORMAT_VERSION = 1
#: the JAX package's artifact format name, refused with its own message
JAX_FORMAT = "veles-tpu-compiled-artifact"


def tree_paths(tree, prefix: str = "") -> list:
    """Sorted ``"a/b/c"`` paths of a nested dict's leaves."""
    out = []
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(tree[k], dict):
            out.extend(tree_paths(tree[k], path))
        else:
            out.append(path)
    return out


def tree_get(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def tree_nest(paths, leaves) -> dict:
    """The nested dict of ``leaves`` at ``paths`` (:func:`tree_paths`'s
    inverse)."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        parts = path.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = leaf
    return out


def _rows(tree) -> list:
    """``[{path, shape, dtype}]`` of a nested dict of tensors/arrays."""
    return [{"path": p, "shape": [int(d) for d in tree_get(tree, p).shape],
             "dtype": str(tree_get(tree, p).dtype).replace("torch.", "")}
            for p in tree_paths(tree)]


def device_record(device) -> dict:
    """The exporting (or serving) device as the manifest records it."""
    device = torch.device(device)
    if device.type == "cuda":
        return {"type": "cuda", "name": torch.cuda.get_device_name(device),
                "capability": list(torch.cuda.get_device_capability(
                    device))}
    return {"type": device.type, "name": device.type, "capability": None}


class _Program(torch.nn.Module):
    """``fn(params, state, inputs)`` over flat tensor arguments: the
    served parameters, the state tensors and the inputs, each group in
    its path order (what the runner passes)."""

    def __init__(self, fn, groups):
        super().__init__()
        self._fn = fn
        self._groups = groups

    def forward(self, *flat):
        trees, i = [], 0
        for paths in self._groups:
            trees.append(tree_nest(paths, flat[i:i + len(paths)]))
            i += len(paths)
        return self._fn(*trees)


def _export(fn, params, state, inputs):
    """``torch.export`` of ``fn(params, state, inputs)`` over flat
    arguments; returns (the saved program's bytes, its input rows)."""
    groups = [tree_paths(params), tree_paths(state), tree_paths(inputs)]
    flat = tuple(tree_get(t, p) for t, paths in
                 zip((params, state, inputs), groups) for p in paths)
    buf = io.BytesIO()
    with without_gc(), torch.no_grad():
        ep = torch.export.export(_Program(fn, groups), flat, strict=False)
        # the example inputs hold the weights: a program blob holds none
        ep.example_inputs = None
        torch.export.save(ep, buf)
    return buf.getvalue(), {"state": _rows(state), "inputs": _rows(inputs)}


def _write_blob(path: str, data: bytes, staged: list) -> str:
    """Stage ``data`` at ``path + ".tmp"`` (fsynced), record the rename,
    return the sha256 of the in-memory bytes: a torn write fails the
    load-time verify instead of being sealed as the expected checksum."""
    import hashlib

    from ..runtime.snapshotter import _fsync_file
    tmp = path + ".tmp"
    staged.append((tmp, path))      # before the write: cleaned on a death
    with open(tmp, "wb") as f:
        f.write(data)
    _fsync_file(tmp)
    return hashlib.sha256(data).hexdigest()


def _param_device(params) -> torch.device:
    for p in tree_paths(params):
        return tree_get(params, p).device
    return torch.device("cpu")


def export_compiled(workflow, wstate, out_dir: str, *,
                    slots: Optional[int] = None,
                    l_max: Optional[int] = None,
                    paged: Optional[bool] = None,
                    page_size: Optional[int] = None,
                    pages: Optional[int] = None,
                    paged_kernel: Optional[bool] = None,
                    spec: Optional[bool] = None,
                    spec_k: Optional[int] = None,
                    megastep: Optional[int] = None,
                    cache_dtype=torch.float32,
                    output_unit: Optional[str] = None,
                    input_spec: Optional[dict] = None,
                    eos_id: Optional[int] = None) -> dict:
    """Export ``workflow``'s serving programs as a sealed artifact under
    ``out_dir`` and return the manifest.

    The batched **forward** (the workflow's predict at the build batch,
    or ``input_spec`` ``{"shape", "dtype"}``) is always exported.  A
    decodable chain also seals the engine's program set at the geometry
    ``slots`` / ``l_max`` / ``page_size`` / ``pages`` / ``paged_kernel``
    (defaults from ``root.common.serve``, the live engine's), with
    ``megastep`` (> 1) and ``spec`` / ``spec_k`` adding their programs.
    Programs run on the device the weights lie on.  A chain that
    ``DecodePlan`` refuses, the dense layout (its masked write has a
    data-dependent shape) or one ``torch.export`` cannot take ships
    forward-only, the reason under ``decode_unsupported``.  An eos id
    outside the vocabulary is refused before anything is exported."""
    from ..config import root
    from ..runtime.engine import DecodeEngine, resolve_serve_geometry
    from ..runtime.snapshotter import _flatten, _fsync_dir
    from ..units.base import Context
    from ..units.nn import input_vocab as _input_vocab
    from ..units.workflow import WorkflowError
    from .package import resolve_measured_units

    geo = resolve_serve_geometry(slots, l_max, paged=paged,
                                 page_size=page_size, pages=pages,
                                 paged_kernel=paged_kernel,
                                 megastep=megastep)
    spec_on = bool(root.common.serve.spec.get("enabled", False)
                   if spec is None else spec)
    spec_k = int(root.common.serve.spec.get("k", 4)
                 if spec_k is None else spec_k)
    if spec_on and spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    params = wstate["params"]
    state = wstate.get("state") or {}
    device = _param_device(params)
    # eos is sealed as the serving default: a bad one would refuse every
    # /generate of the artifact, so it is refused before any export
    in_vocab = _input_vocab(workflow, params)
    if eos_id is not None and (int(eos_id) < 0 or (
            in_vocab is not None and int(eos_id) >= in_vocab)):
        raise ValueError(
            f"eos_id {eos_id} is outside the exported model's vocabulary "
            f"[0, {in_vocab if in_vocab is not None else '?'})")
    resolve_measured_units(workflow, device)

    prog_dir = os.path.join(out_dir, "programs")
    os.makedirs(prog_dir, exist_ok=True)
    for stray in os.listdir(prog_dir):
        if stray.endswith(".tmp"):
            os.unlink(os.path.join(prog_dir, stray))
    for stray in ("tensors.npz.tmp", MANIFEST + ".tmp"):
        stray = os.path.join(out_dir, stray)
        if os.path.exists(stray):
            os.unlink(stray)
    staged: list = []
    programs: dict = {}
    try:
        tensors = _flatten({"params": params, "state": state})
        buf = io.BytesIO()
        # stored, not deflated: float weights barely deflate, and the
        # deflate of a full-width model costs seconds
        np.savez(buf, **tensors)
        tensors_sha = _write_blob(os.path.join(out_dir, "tensors.npz"),
                                  buf.getvalue(), staged)
        del buf

        # -- the decode program set (the live engine's steps) ------------
        engine, decode_reason, vocab = None, None, None
        if not geo.paged:
            decode_reason = ("the dense KV layout is not sealed (its "
                             "masked cache write has a data-dependent "
                             "shape); export the paged layout")
        else:
            try:
                # built, never started: its steps are the programs, its
                # served tensors their parameter inputs (capture=False:
                # the export traces the eager steps)
                engine = DecodeEngine(
                    workflow, wstate, slots=geo.slots, l_max=geo.l_max,
                    paged=True, page_size=geo.page_size, pages=geo.pages,
                    paged_kernel=geo.paged_kernel, megastep=geo.megastep,
                    spec=spec_on, spec_k=spec_k, output_unit=output_unit,
                    cache_dtype=cache_dtype, capture=False, device=device)
            except WorkflowError as e:      # DecodePlan refused the chain
                decode_reason = f"{type(e).__name__}: {e}"
        if engine is not None:
            vocab = engine._vocab
            if eos_id is not None and not 0 <= int(eos_id) < vocab:
                raise ValueError(f"eos_id {eos_id} is outside the "
                                 f"exported model's vocabulary [0, {vocab})")
        served = engine.params if engine is not None else params
        if engine is not None:
            n_staged = len(staged)
            try:
                for name, fn in engine._fns.items():
                    step = fn.step
                    st = engine._caches if step.kind == "prefill" \
                        else engine._dstate

                    def run(p, s, i, step=step):
                        step.params = p
                        if step.kind != "prefill":
                            # a cache-free chain's empty caches have no
                            # leaf to carry them through the flat inputs
                            s.setdefault("caches", {})
                        return step.run(s, i, None)

                    blob, info = _export(run, served, st, step.inputs)
                    fname = f"programs/{name}.pt2"
                    sha = _write_blob(os.path.join(out_dir, fname), blob,
                                      staged)
                    programs[name] = dict(
                        info, file=fname, sha256=sha, kind=step.kind,
                        n=int(getattr(step, "n", 1)))
            except Exception as e:  # noqa: BLE001 — export refused it
                decode_reason = (f"torch.export: {type(e).__name__}: "
                                 f"{str(e)[:2000]}")
                # the programs staged before the refusal ship with none
                for tmp, _ in staged[n_staged:]:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                del staged[n_staged:]
                programs.clear()
                engine = None

        # -- the batched forward ------------------------------------------
        head = output_unit or workflow.default_output()
        if input_spec is None:
            s_in = workflow.specs.get("@input")
            if s_in is not None:
                input_spec = {"shape": [int(d) for d in s_in.shape],
                              "dtype": str(s_in.dtype).replace("torch.",
                                                               "")}
        if input_spec is not None:
            needed = workflow.ancestors(head)

            def forward(p, s, i):
                outputs, _ = workflow.forward(p, s, {"@input": i["x"]},
                                              Context(train=False),
                                              only=needed)
                return outputs[head]

            x = torch.zeros(tuple(input_spec["shape"]),
                            dtype=getattr(torch, input_spec["dtype"]),
                            device=device)
            blob, info = _export(forward, served, state, {"x": x})
            fname = "programs/forward.pt2"
            sha = _write_blob(os.path.join(out_dir, fname), blob, staged)
            programs["forward"] = dict(info, file=fname, sha256=sha,
                                       kind="forward", n=1)

        decodes = engine is not None
        plan = engine.plan if decodes else None
        manifest = {
            "format": FORMAT,
            "format_version": FORMAT_VERSION,
            "workflow": workflow.name,
            "workflow_checksum": workflow.checksum(),
            "torch_version": torch.__version__,
            "device": device_record(device),
            "saved_at": time.time(),
            "tensors": "tensors.npz",
            "tensors_sha256": tensors_sha,
            "params": [dict(r, path=r["path"][len("params/"):])
                       for r in _rows_flat(tensors, "params/")],
            "state": [dict(r, path=r["path"][len("state/"):])
                      for r in _rows_flat(tensors, "state/")],
            # the programs' parameter inputs, in order: the served dtypes
            "served": _rows(served),
            "caches": _rows(engine._caches) if decodes else [],
            "slots": geo.slots if decodes else None,
            "l_max": geo.l_max if decodes else None,
            "paged": decodes,
            "page_size": geo.page_size if decodes else None,
            "pages": geo.pages if decodes else None,
            "paged_kernel": bool(decodes and geo.paged_kernel),
            "prefix_reuse": bool(decodes and not plan._rec_units),
            "spec_decode": {"k": spec_k} if decodes and spec_on else None,
            "megastep": ({"n": geo.megastep}
                         if decodes and geo.megastep > 1 else None),
            "cache_dtype": str(cache_dtype).replace("torch.", ""),
            "vocab": vocab,
            "input_vocab": in_vocab,
            "eos_id": eos_id,
            "input_spec": input_spec,
            # what the runner's goodput and KV transfer read of the plan
            "attn_units": ([{"name": u.name, "n_heads": int(u.n_heads),
                             "window": u.window}
                            for u in plan._attn_units] if decodes else []),
            "rec_units": ([u.name for u in plan._rec_units]
                          if decodes else []),
            "programs": programs,
        }
        if decode_reason is not None:
            manifest["decode_unsupported"] = decode_reason

        # -- commit: blobs renamed first, the manifest last --------------
        man_path = os.path.join(out_dir, MANIFEST)
        man_tmp = man_path + ".tmp"
        keep = {os.path.basename(final) for _, final in staged}
        staged.append((man_tmp, man_path))
        with open(man_tmp, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        for tmp, final in staged:
            os.replace(tmp, final)
        for leftover in os.listdir(prog_dir):
            # a re-export into the same directory: programs the new
            # manifest does not name go
            if leftover.endswith((".pt2", ".tmp")) and leftover not in keep:
                os.unlink(os.path.join(prog_dir, leftover))
        _fsync_dir(prog_dir)
        _fsync_dir(out_dir)
        return manifest
    except BaseException:
        for tmp, _ in staged:
            if os.path.exists(tmp):
                os.unlink(tmp)
        raise


def _rows_flat(flat: dict, prefix: str) -> list:
    """Manifest rows of one subtree of the flattened tensors blob (its
    structural markers skipped)."""
    return [{"path": k, "shape": [int(d) for d in v.shape],
             "dtype": str(v.dtype)}
            for k, v in sorted(flat.items()) if k.startswith(prefix)
            and not k.endswith(("__seq__", "__emptydict__"))]


def manifest_summary(manifest: dict) -> dict:
    """Compact view of a manifest (the CLI's ``--export --compiled``
    output)."""
    progs = manifest.get("programs", {})
    return {
        "workflow": manifest.get("workflow"),
        "checksum": (manifest.get("workflow_checksum") or "")[:12],
        "torch_version": manifest.get("torch_version"),
        "device": (manifest.get("device") or {}).get("name"),
        "slots": manifest.get("slots"), "l_max": manifest.get("l_max"),
        "paged": manifest.get("paged", False),
        "page_size": manifest.get("page_size"),
        "pages": manifest.get("pages"),
        "paged_kernel": manifest.get("paged_kernel", False),
        "spec_decode": manifest.get("spec_decode"),
        "megastep": manifest.get("megastep"),
        "vocab": manifest.get("vocab"),
        "programs": sorted(p["file"] for p in progs.values()),
        "decode_unsupported": manifest.get("decode_unsupported"),
        "tensors_sha256": (manifest.get("tensors_sha256") or "")[:12],
    }
