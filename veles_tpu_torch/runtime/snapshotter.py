"""Snapshots in the JAX package's format, and carrying weights across
(counterpart of veles_tpu/runtime/snapshotter.py).

A snapshot is a JSON manifest plus one ``npz`` of tensors whose keys are
the flattened workflow-state paths (``params/emb/table``,
``state/__emptydict__``, ...) — the same ``_flatten``/``_unflatten``
scheme (snapshotter.py:75-134) and the same ``tensors_sha256`` integrity
check (:186-213), so a snapshot written by either package loads in the
other with byte-identical tensors.

:func:`params_from_jax` carries weights across: a nested numpy tree, a
full workflow state, or a flat ``"emb/table"``-keyed dict in the JAX
layout becomes the port's parameter dictionary.  Weights keep the
``x @ W`` layout ``(in, out)``; nothing is transposed.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import zipfile
from typing import Any, Dict

import numpy as np
import torch

from ..logger import Logger
from ..ops import resolve_device


class SnapshotCorruptError(RuntimeError):
    """A snapshot failed integrity verification (checksum mismatch,
    unreadable tensors blob, unparseable manifest)."""


def _flatten(tree, prefix="", out=None):
    out = {} if out is None else out
    if isinstance(tree, dict):
        if not tree:
            out[f"{prefix}/__emptydict__"] = np.zeros(0)
            return out
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}/{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        out[f"{prefix}/__seq__"] = np.asarray(
            [len(tree), int(isinstance(tree, tuple))])
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = _to_numpy(tree)
    return out


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("bfloat16 tensors have no numpy dtype; keep "
                            "snapshot parameters in float32")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _unflatten(flat: Dict[str, np.ndarray]):
    root: dict = {}
    seqs = set()
    for key, value in flat.items():
        parts = key.split("/")
        if parts[-1] == "__seq__":
            seqs.add("/".join(parts[:-1]))
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            continue
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1] == "__emptydict__":
            continue
        node[parts[-1]] = value

    def fix(node, path=""):
        if not isinstance(node, dict):
            return node
        out = {k: fix(v, f"{path}/{k}" if path else k)
               for k, v in node.items()}
        if path in seqs:
            seq = [out[str(i)] for i in range(len(out))]
            return tuple(seq) if flat[f"{path}/__seq__"][1] else seq
        return out

    return fix(root)


def sha256_files(paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
    return h.hexdigest()


def _commit_bytes(target: str, data: bytes) -> None:
    """fsynced ``*.tmp`` sibling renamed into place."""
    tmp = target + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)


class Snapshotter(Logger):
    """Write and read snapshots in the JAX package's manifest + npz
    format (``<prefix>_<tag>.json`` + ``.npz``, ``_current`` symlink)."""

    def __init__(self, prefix: str, directory: str = "snapshots", *,
                 compression: bool = True):
        self.prefix = prefix
        self.directory = directory
        self.compression = compression

    def save(self, tag: str, payload: Dict[str, Any]) -> str:
        """``payload["wstate"]`` (tensors or numpy) goes to the npz, every
        other key to the manifest.  Returns the manifest path."""
        os.makedirs(self.directory, exist_ok=True)
        base = f"{self.prefix}_{tag}"
        npz_path = os.path.join(self.directory, base + ".npz")
        tensors = _flatten(payload.get("wstate", {}))
        saver = np.savez_compressed if self.compression else np.savez
        saver(npz_path, **tensors)
        manifest = {k: v for k, v in payload.items() if k != "wstate"}
        manifest["tensors"] = base + ".npz"
        manifest["tensors_sha256"] = sha256_files([npz_path])
        manifest["saved_at"] = time.time()
        man_path = os.path.join(self.directory, base + ".json")
        _commit_bytes(man_path, json.dumps(manifest, indent=1,
                                           default=repr).encode())
        link = os.path.join(self.directory, self.prefix + "_current.json")
        tmp = link + ".tmp"
        if os.path.lexists(tmp):
            os.remove(tmp)
        os.symlink(os.path.basename(man_path), tmp)
        os.replace(tmp, link)
        self.info("snapshot %s", man_path)
        return man_path

    @staticmethod
    def load(path: str, *, verify: bool = True) -> Dict[str, Any]:
        """Read a manifest (or its ``_current`` symlink); returns the
        payload with ``wstate`` as a numpy tree.  Integrity failures raise
        :class:`SnapshotCorruptError`."""
        try:
            with open(path) as f:
                manifest = json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise SnapshotCorruptError(
                f"{path}: unparseable manifest ({e})") from e
        if not isinstance(manifest, dict) or "tensors" not in manifest:
            raise SnapshotCorruptError(f"{path}: not a snapshot manifest")
        npz_path = os.path.join(os.path.dirname(path), manifest["tensors"])
        want = manifest.get("tensors_sha256")
        if verify and want:
            try:
                got = sha256_files([npz_path])
            except OSError as e:
                raise SnapshotCorruptError(
                    f"{path}: tensors blob unreadable ({e})") from e
            if got != want:
                raise SnapshotCorruptError(
                    f"{path}: tensors checksum mismatch (manifest "
                    f"{want[:12]}…, blob {got[:12]}…)")
        try:
            with np.load(npz_path, allow_pickle=False) as z:
                flat = {k: z[k] for k in z.files}
        except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
            raise SnapshotCorruptError(
                f"{path}: tensors blob unreadable ({e})") from e
        payload = dict(manifest)
        payload["wstate"] = _unflatten(flat)
        return payload


def params_from_jax(tree, workflow=None, *, device=None) -> dict:
    """The port's ``{unit: {param: tensor}}`` from weights in the JAX
    layout: a nested numpy tree, a whole workflow state (its ``params``
    is taken), or a flat dict keyed ``"emb/table"`` (an optional leading
    ``params/`` is stripped).  Values keep their dtype and bytes and the
    ``(in, out)`` layout.  With ``workflow`` (built) the names and
    shapes are checked against what it expects; any difference raises
    ``ValueError`` naming it.  Tensors go to ``device`` (default: the
    CUDA card)."""
    dev = resolve_device(device)
    if isinstance(tree, dict) and isinstance(tree.get("params"), dict):
        tree = tree["params"]
    if isinstance(tree, dict) and tree and all(
            isinstance(k, str) and "/" in k for k in tree):
        flat = {}
        for k, v in tree.items():
            flat[k[len("params/"):] if k.startswith("params/") else k] = v
        tree = _unflatten(flat)
    params = {}
    for unit, sub in tree.items():
        if not isinstance(sub, dict):
            raise ValueError(f"params/{unit}: expected a dict of tensors")
        params[unit] = {
            name: torch.from_numpy(np.array(_to_numpy(v), copy=True)).to(dev)
            for name, v in sub.items()}
    if workflow is not None:
        want = workflow.param_shapes()
        got = {u: {k: tuple(t.shape) for k, t in p.items()}
               for u, p in params.items()}
        if want != got:
            diffs = []
            for u in sorted(set(want) | set(got)):
                w, g = want.get(u, {}), got.get(u, {})
                for k in sorted(set(w) | set(g)):
                    if w.get(k) != g.get(k):
                        diffs.append(f"{u}/{k}: expected {w.get(k)}, "
                                     f"got {g.get(k)}")
            raise ValueError("weights do not fit the workflow: "
                             + "; ".join(diffs[:8]))
    return params


def params_to_numpy(params) -> dict:
    """``{unit: {param: ndarray}}`` (host copies) of the port's params."""
    return {u: {k: _to_numpy(t) for k, t in p.items()}
            for u, p in params.items()}


def wstate_from_snapshot(path: str, workflow, *, device=None) -> dict:
    """A serving workflow state from a snapshot of either package:
    parameters carried across (checked against ``workflow``), the rest
    of the state kept as host data."""
    from ..units.workflow import new_state
    ws = Snapshotter.load(path)["wstate"]
    return new_state(params_from_jax(ws, workflow, device=device),
                     {}, ws.get("opt_state", {}), ws.get("step", 0),
                     ws.get("key"))
