"""Snapshots in the JAX package's format, and carrying weights across
(counterpart of veles_tpu/runtime/snapshotter.py).

A snapshot is a JSON manifest plus one ``npz`` of tensors whose keys are
the flattened workflow-state paths (``params/emb/table``,
``state/__emptydict__``, ...) — the same ``_flatten``/``_unflatten``
scheme (snapshotter.py:75-134) and the same ``tensors_sha256`` integrity
check (:186-213), so a snapshot written by either package loads in the
other with byte-identical tensors.  The trainer's payload (wstate with
``opt_state``, loader, decision, prng, config, ``workflow_checksum``)
is the JAX ``Trainer``'s, so a training run resumes in either package.
The epoch throttle (``tick``), the ``_current``/``_best`` symlinks and
keep-last-K retention follow snapshotter.py:141-272, the walk-back past
corrupt snapshots (:func:`restore_with_walkback`), ``snapshot_checksum``
and ``compare_snapshots`` :568-672.  :meth:`Snapshotter.load` also reads
a ``sqlite://`` URI (:class:`SnapshotterToDB`, :426-515: the same table,
so either package reads the other's database) and an ``http(s)://``
manifest URL (:330-393: both downloads size-capped, transient failures
retried by ``deploy.http_retry``).

:func:`params_from_jax` carries weights across: a nested numpy tree, a
full workflow state, or a flat ``"emb/table"``-keyed dict in the JAX
layout becomes the port's parameter dictionary.  Weights keep the
``x @ W`` layout ``(in, out)``; nothing is transposed.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..logger import Logger
from ..ops import resolve_device
from ..ops.optimizers import tree_map


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


def _fsync_file(path: str) -> None:
    """Flush a finished file's bytes to stable storage
    (veles_tpu/runtime/snapshotter.py:41-46)."""
    with open(path, "rb") as f:
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    """Persist a directory's entries (the rename metadata); best effort
    where a directory cannot be opened (veles_tpu/runtime/snapshotter.py:
    49-58)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


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
    format (``<prefix>_<tag>.json`` + ``.npz``, ``_current``/``_best``
    symlinks), with interval and time throttling."""

    def __init__(self, prefix: str, directory: Optional[str] = None, *,
                 compression: bool = True, interval: int = 1,
                 time_interval: float = 0.0):
        if directory is None:
            from ..config import root
            directory = str(root.common.get("snapshot_dir", "snapshots")
                            or "snapshots")
        self.prefix = prefix
        self.directory = directory
        self.compression = compression
        self.interval = interval          # epochs between snapshots
        self.time_interval = time_interval  # min seconds between snapshots
        self._lock = threading.Lock()
        self._last_time = 0.0             # guarded-by: self._lock
        self._counter = 0                 # guarded-by: self._lock
        self.last_path: Optional[str] = None

    def tick(self, *, best: bool = False) -> bool:
        """Advance the throttle and report whether this epoch snapshots:
        every ``interval``-th call and at least ``time_interval`` seconds
        after the last snapshot, or always when ``best``."""
        with self._lock:
            self._counter += 1
            now = time.time()
            if not best:
                if self._counter % max(self.interval, 1) != 0:
                    return False
                if now - self._last_time < self.time_interval:
                    return False
            self._last_time = now
            return True

    def maybe_save(self, tag: str, payload: Dict[str, Any], *,
                   best: bool = False) -> Optional[str]:
        """Throttled save."""
        if not self.tick(best=best):
            return None
        return self.save(tag, payload, best=best)

    def save(self, tag: str, payload: Dict[str, Any], *,
             best: bool = False) -> str:
        """``payload["wstate"]`` (tensors or numpy) goes to the npz, every
        other key to the manifest; both are fsynced before the
        ``_current`` (and with ``best`` the ``_best``) symlink flips to
        the new manifest.  ``root.common.snapshot_keep`` > 0 removes all
        but the newest K snapshots afterwards (symlink targets are kept).
        Returns the manifest path."""
        from ..config import root
        os.makedirs(self.directory, exist_ok=True)
        base = f"{self.prefix}_{tag}"
        npz_path = os.path.join(self.directory, base + ".npz")
        tensors = _flatten(payload.get("wstate", {}))
        saver = np.savez_compressed if self.compression else np.savez
        saver(npz_path, **tensors)
        with open(npz_path, "rb") as f:
            os.fsync(f.fileno())
        manifest = {k: v for k, v in payload.items() if k != "wstate"}
        manifest["tensors"] = base + ".npz"
        manifest["tensors_sha256"] = sha256_files([npz_path])
        manifest["saved_at"] = time.time()
        man_path = os.path.join(self.directory, base + ".json")
        _commit_bytes(man_path, json.dumps(manifest, indent=1,
                                           default=repr).encode())
        for link, active in (("_current", True), ("_best", best)):
            if not active:
                continue
            lpath = os.path.join(self.directory, self.prefix + link + ".json")
            tmp = lpath + ".tmp"
            if os.path.lexists(tmp):
                os.remove(tmp)
            os.symlink(os.path.basename(man_path), tmp)
            os.replace(tmp, lpath)
        self.info("snapshot %s%s", man_path, " [best]" if best else "")
        self.last_path = man_path
        keep = int(root.common.get("snapshot_keep", 0) or 0)
        if keep > 0:
            self._gc(keep)
        # fault harness: a torn write discovered only at restore time
        from .faults import get_plan
        if get_plan().truncate_snapshot:
            size = max(os.path.getsize(npz_path) // 2, 1)
            with open(npz_path, "rb+") as f:
                f.truncate(size)
            self.warning("fault injection: truncated %s to %d bytes",
                         npz_path, size)
        return man_path

    def _gc(self, keep: int) -> None:
        """Keep-last-K retention over this prefix's snapshots; the
        ``_current``/``_best`` targets are never removed."""
        snaps = list_snapshots(self.directory, prefix=self.prefix + "_")
        protected = {os.path.realpath(os.path.join(
            self.directory, self.prefix + link + ".json"))
            for link in ("_current", "_best")}
        for ent in snaps[:-keep]:
            if os.path.realpath(ent["path"]) in protected:
                continue
            for p in (ent["path"],
                      os.path.join(self.directory, ent["tensors"])):
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass

    @staticmethod
    def load(path: str, *, verify: bool = True) -> Dict[str, Any]:
        """Read a manifest (or its ``_current`` symlink), a
        ``sqlite://db[#id|#best|#current]`` URI written by
        :class:`SnapshotterToDB`, or an ``http(s)://`` manifest URL;
        returns the payload with ``wstate`` as a numpy tree.  Integrity
        failures of a manifest file raise :class:`SnapshotCorruptError`."""
        if path.startswith("sqlite://"):
            return SnapshotterToDB.load_uri(path)
        if path.startswith(("http://", "https://")):
            return Snapshotter._load_http(path)
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

    #: manifest JSON cap (MiB): structure only, tensors live in the npz
    _HTTP_MANIFEST_MAX_MB = 64

    @staticmethod
    def _read_capped(resp, limit: int, what: str, knob: str) -> bytes:
        """Chunked read that refuses more than ``limit`` bytes (a remote
        snapshot URI may name a server the caller does not control): a
        declared Content-Length over the cap fails at once, a lying or
        chunked response on the running total.  ``knob`` names the
        setting to raise."""
        try:
            declared = int(resp.headers.get("Content-Length", ""))
        except ValueError:
            declared = None
        if declared is not None and declared > limit:
            raise ValueError(
                f"{what} declares {declared} bytes, over the "
                f"{limit}-byte cap ({knob})")
        chunks, total = [], 0
        while True:
            chunk = resp.read(1 << 20)
            if not chunk:
                return b"".join(chunks)
            total += len(chunk)
            if total > limit:
                raise ValueError(
                    f"{what} exceeded the {limit}-byte cap ({knob})")
            chunks.append(chunk)

    @staticmethod
    def _load_http(url: str) -> Dict[str, Any]:
        """The manifest and its tensors npz over HTTP, the npz resolved
        relative to the manifest URL; both downloads capped (the npz by
        ``root.common.snapshot_http_max_mb``), connection errors and 5xx
        retried with back-off, 4xx raised at once."""
        import urllib.parse
        import urllib.request
        from ..config import root
        from .deploy import http_retry   # deploy imports this module
        max_bytes = int(float(root.common.get(
            "snapshot_http_max_mb", 2048)) * 2**20)

        def fetch(u, limit, what, knob):
            def once():
                with urllib.request.urlopen(u, timeout=30.0) as r:
                    return Snapshotter._read_capped(r, limit, what, knob)
            return http_retry(once, what=what)

        manifest = json.loads(fetch(
            url, Snapshotter._HTTP_MANIFEST_MAX_MB << 20,
            f"snapshot manifest {url}",
            "Snapshotter._HTTP_MANIFEST_MAX_MB"))
        tensors_url = urllib.parse.urljoin(url, manifest["tensors"])
        blob = fetch(tensors_url, max_bytes,
                     f"snapshot tensors {tensors_url}",
                     "root.common.snapshot_http_max_mb")
        payload = dict(manifest)
        payload["wstate"] = _unflatten_npz(blob)
        return payload

    @staticmethod
    def restore_wstate(payload: Dict[str, Any], like: dict) -> dict:
        """The saved workflow state cast leaf by leaf to the dtype and
        device of ``like`` (the live state of the same workflow and
        optimizer): tensors become tensors on ``like``'s devices, numpy
        leaves (the key) numpy, and the integer step an int.  A
        structure or a tensor shape that differs raises ``ValueError``."""
        def cast(saved, template, path):
            if isinstance(template, dict):
                if not isinstance(saved, dict) or set(saved) != set(template):
                    raise ValueError(
                        f"snapshot state structure does not match this "
                        f"workflow's at {path or '/'}: "
                        f"{sorted(saved) if isinstance(saved, dict) else saved!r}"
                        f" vs {sorted(template)} (different optimizer or "
                        "architecture? the checksum only covers graph "
                        "topology)")
                return {k: cast(saved[k], v, f"{path}/{k}")
                        for k, v in template.items()}
            if isinstance(template, (tuple, list)):
                if not isinstance(saved, (tuple, list)) \
                        or len(saved) != len(template):
                    raise ValueError(f"snapshot state structure does not "
                                     f"match this workflow's at {path}")
                return type(template)(cast(a, b, f"{path}/{i}") for i, (a, b)
                                      in enumerate(zip(saved, template)))
            if isinstance(template, torch.Tensor):
                if np.shape(saved) != tuple(template.shape):
                    raise ValueError(
                        f"snapshot tensor {path} has shape "
                        f"{np.shape(saved)}, this workflow's "
                        f"{tuple(template.shape)} (another width? the "
                        "checksum only covers graph topology)")
                return torch.from_numpy(np.array(saved, copy=True)).to(
                    device=template.device, dtype=template.dtype)
            if isinstance(template, np.ndarray):
                return np.asarray(saved).astype(template.dtype)
            if isinstance(template, int):
                return int(np.asarray(saved))
            if template is None:    # a state without a key keeps none
                return None
            return saved

        return cast(payload["wstate"], like, "")


def _unflatten_npz(blob: bytes):
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        return _unflatten({k: z[k] for k in z.files})


class SnapshotterToDB(Snapshotter):
    """Snapshots into a sqlite database instead of the filesystem (the
    JAX package's table: a row carries the manifest JSON and the npz
    bytes, so either package reads the other's rows).  ``last_path`` is a
    ``sqlite://db#id`` URI :meth:`Snapshotter.load` (and therefore
    ``Trainer.restore`` and the deploy control plane) accepts."""

    _SCHEMA = ("CREATE TABLE IF NOT EXISTS snapshots ("
               "id INTEGER PRIMARY KEY AUTOINCREMENT, prefix TEXT, "
               "tag TEXT, saved_at REAL, best INTEGER, manifest TEXT, "
               "tensors BLOB)")

    def __init__(self, prefix: str, db_path: str = "snapshots.sqlite", *,
                 compression: bool = True, interval: int = 1,
                 time_interval: float = 0.0):
        super().__init__(prefix, os.path.dirname(db_path) or ".",
                         compression=compression, interval=interval,
                         time_interval=time_interval)
        self.db_path = db_path

    def _connect(self):
        import sqlite3
        conn = sqlite3.connect(self.db_path)
        conn.execute(self._SCHEMA)
        return conn

    def save(self, tag: str, payload: Dict[str, Any], *,
             best: bool = False) -> str:
        buf = io.BytesIO()
        tensors = _flatten(payload.get("wstate", {}))
        saver = np.savez_compressed if self.compression else np.savez
        saver(buf, **tensors)
        manifest = {k: v for k, v in payload.items() if k != "wstate"}
        manifest["saved_at"] = time.time()
        blob = buf.getvalue()
        conn = self._connect()
        try:
            with conn:
                cur = conn.execute(
                    "INSERT INTO snapshots (prefix, tag, saved_at, best, "
                    "manifest, tensors) VALUES (?, ?, ?, ?, ?, ?)",
                    (self.prefix, tag, manifest["saved_at"], int(best),
                     json.dumps(manifest, default=repr), blob))
                rowid = cur.lastrowid
        finally:
            conn.close()
        self.last_path = f"sqlite://{self.db_path}#{rowid}"
        self.info("snapshot %s (%.1f MiB)%s", self.last_path,
                  len(blob) / 2**20, " [best]" if best else "")
        return self.last_path

    @staticmethod
    def load_uri(uri: str) -> Dict[str, Any]:
        """``sqlite://db`` (the latest row), ``sqlite://db#<id>`` (that
        row), ``#best`` (the latest best row) or ``#current`` (the
        latest); the fragment splits at the LAST '#', so a db path may
        hold one.  A missing row raises ``FileNotFoundError``."""
        import sqlite3
        if not uri.startswith("sqlite://"):
            raise ValueError(f"not a sqlite:// snapshot URI: {uri!r}")
        rest = uri[len("sqlite://"):]
        head, sep, frag = rest.rpartition("#")
        db_path = head if sep else rest
        if not sep:
            frag = ""
        if not os.path.exists(db_path):
            # sqlite3.connect would create an empty database
            raise FileNotFoundError(uri)
        conn = sqlite3.connect(db_path)
        try:
            if frag == "best":
                row = conn.execute(
                    "SELECT manifest, tensors FROM snapshots WHERE best=1 "
                    "ORDER BY id DESC LIMIT 1").fetchone()
            elif frag and frag != "current":
                row = conn.execute(
                    "SELECT manifest, tensors FROM snapshots WHERE id=?",
                    (int(frag),)).fetchone()
            else:
                row = conn.execute(
                    "SELECT manifest, tensors FROM snapshots "
                    "ORDER BY id DESC LIMIT 1").fetchone()
        finally:
            conn.close()
        if row is None:
            raise FileNotFoundError(uri)
        manifest, blob = row
        payload = json.loads(manifest)
        payload["wstate"] = _unflatten_npz(blob)
        return payload


def list_snapshots(directory: str, prefix: Optional[str] = None) -> list:
    """Snapshot manifests in ``directory`` (symlinks skipped), oldest to
    newest by their ``saved_at``."""
    out = []
    if not os.path.isdir(directory):
        return out
    for fn in sorted(os.listdir(directory)):
        path = os.path.join(directory, fn)
        if not fn.endswith(".json") or os.path.islink(path):
            continue
        if prefix and not fn.startswith(prefix):
            continue
        try:
            with open(path) as f:
                man = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            continue
        if not isinstance(man, dict) or "tensors" not in man:
            continue
        out.append({"path": path, "saved_at": float(man.get("saved_at", 0)),
                    "tensors": man["tensors"]})
    out.sort(key=lambda e: (e["saved_at"], e["path"]))
    return out


def snapshot_checksum(path: str) -> str:
    """sha256 hex digest of the tensors blob a manifest references (two
    snapshots with identical weights hash identically); '' when the blob
    cannot be read — callers treat '' as "unknown", never as a match."""
    try:
        with open(path) as f:
            man = json.load(f)
        npz = os.path.join(os.path.dirname(path), man["tensors"])
        return sha256_files([npz])
    except (OSError, KeyError, TypeError, ValueError,
            json.JSONDecodeError):
        return ""


def restore_with_walkback(path: str) -> Tuple[Dict[str, Any], str,
                                              List[dict]]:
    """Load the snapshot at ``path``; on corruption, walk back through the
    snapshots in the same directory (newest to oldest by ``saved_at``) to
    the newest VALID one.  Returns ``(payload, used_path, skipped)``,
    ``skipped`` listing ``{"path", "reason"}`` of every snapshot rejected
    on the way.  Raises :class:`SnapshotCorruptError` when nothing in the
    directory loads; a missing ``path`` raises as it is (most likely a
    typo: restoring a sibling the caller never named would be worse).
    Remote URIs (``sqlite://``, ``http(s)://``) have no directory to walk
    and load directly."""
    if path.startswith(("sqlite://", "http://", "https://")):
        return Snapshotter.load(path), path, []
    skipped: List[dict] = []
    target = os.path.realpath(path)
    try:
        return Snapshotter.load(path), target, skipped
    except SnapshotCorruptError as e:
        skipped.append({"path": target,
                        "reason": f"{type(e).__name__}: {e}"})
    directory = os.path.dirname(path) or "."
    seen = {target}
    for ent in reversed(list_snapshots(directory)):
        real = os.path.realpath(ent["path"])
        if real in seen:
            continue
        seen.add(real)
        try:
            return Snapshotter.load(ent["path"]), real, skipped
        except (SnapshotCorruptError, OSError, KeyError, ValueError) as e:
            skipped.append(
                {"path": real, "reason": f"{type(e).__name__}: {e}"})
    raise SnapshotCorruptError(
        f"no valid snapshot found in {directory!r}; rejected "
        + "; ".join(f"{s['path']} ({s['reason']})" for s in skipped))


def compare_snapshots(path_a: str, path_b: str) -> Dict[str, Any]:
    """Per-tensor diff of two snapshots (manifests, their symlinks, or
    ``sqlite://`` / ``http(s)://`` URIs):
    ``{"rows", "only_a", "only_b", "meta"}``, each row with key, shape,
    dtype and max |d| / mean |d| / max relative d (0-denominators
    excluded), or ``mismatch`` where shape or dtype differ; ``meta`` maps
    the manifest fields that differ to their (a, b) values."""
    pa, pb = Snapshotter.load(path_a), Snapshotter.load(path_b)
    fa = _flatten(pa.get("wstate", {}))
    fb = _flatten(pb.get("wstate", {}))
    rows = []
    for k in sorted(set(fa) & set(fb)):
        a, b = np.asarray(fa[k]), np.asarray(fb[k])
        if a.shape != b.shape or a.dtype != b.dtype:
            rows.append({"key": k, "mismatch": True,
                         "shape_a": list(a.shape), "dtype_a": str(a.dtype),
                         "shape_b": list(b.shape), "dtype_b": str(b.dtype)})
            continue
        af = a.astype(np.float64, copy=False)
        bf = b.astype(np.float64, copy=False)
        d = np.abs(af - bf)
        denom = np.maximum(np.abs(af), np.abs(bf))
        nz = denom > 0
        rows.append({
            "key": k, "mismatch": False,
            "shape": list(a.shape), "dtype": str(a.dtype),
            "max_abs": float(d.max()) if d.size else 0.0,
            "mean_abs": float(d.mean()) if d.size else 0.0,
            "max_rel": float((d[nz] / denom[nz]).max()) if nz.any()
            else 0.0,
        })
    skip = {"tensors", "saved_at", "wstate"}
    meta = {}
    for k in sorted((set(pa) | set(pb)) - skip):
        va, vb = pa.get(k), pb.get(k)
        if va != vb:
            meta[k] = [va, vb]
    return {"rows": rows,
            "only_a": sorted(set(fa) - set(fb)),
            "only_b": sorted(set(fb) - set(fa)),
            "meta": meta}


def wstate_to_numpy(wstate: dict) -> dict:
    """Host copy of a workflow state in the JAX package's leaf types:
    tensors to numpy, the integer step to an int32 scalar."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v) for v in x)
        return _to_numpy(x)
    out = conv(wstate)
    out["step"] = np.asarray(wstate["step"], np.int32)
    return out


def _tensors(tree, slot: str, dev, want=None) -> dict:
    """``{unit: {name: tensor}}`` on ``dev`` from the nested numpy tree (a
    unit's entry may nest further: a pipeline stack's ``s<i>/<unit>/...``);
    values keep their dtype and bytes.  With ``want`` (unit -> name ->
    shape, nested alike) a name or shape that differs raises
    ``ValueError``."""
    def place(sub, path):
        if isinstance(sub, dict):
            return {k: place(v, f"{path}/{k}") for k, v in sub.items()}
        return torch.from_numpy(np.array(_to_numpy(sub), copy=True)).to(dev)

    out = {}
    for unit, sub in tree.items():
        if not isinstance(sub, dict):
            raise ValueError(f"{slot}/{unit}: expected a dict of tensors")
        out[unit] = place(sub, f"{slot}/{unit}")
    if want is not None:
        w = _shape_paths(want)
        g = _shape_paths(tree_map(lambda t: tuple(t.shape), out))
        if w != g:
            diffs = [f"{slot}/{k}: expected {w.get(k)}, got {g.get(k)}"
                     for k in sorted(set(w) | set(g))
                     if w.get(k) != g.get(k)]
            what = "weights" if slot == "params" else "unit state"
            raise ValueError(f"{what} do not fit the workflow: "
                             + "; ".join(diffs[:8]))
    return out


def _shape_paths(tree, prefix="", out=None) -> Dict[str, tuple]:
    """``"unit/param" -> shape`` of a nested dict whose leaves are
    shapes (tuples)."""
    out = {} if out is None else out
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            _shape_paths(v, path, out)
        else:
            out[path] = tuple(v)
    return out


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
        tree = _unflatten({k[len("params/"):] if k.startswith("params/")
                           else k: v for k, v in tree.items()})
    want = workflow.param_shapes() if workflow is not None else None
    return _tensors(tree, "params", dev, want)


def wstate_from_jax(tree, workflow=None, *, optimizer=None,
                    device=None) -> dict:
    """A port workflow state from a JAX workflow state (a nested numpy
    dict, as a snapshot's ``wstate`` gives it, the key as its raw uint32
    data): ``params`` as :func:`params_from_jax`, the
    unit ``state`` (normalizer statistics) byte for byte, the ``key`` and
    the ``step``.  With ``workflow`` both params and unit state are
    checked against it.  ``opt_state`` is ``optimizer.init(params)``
    (empty without one)."""
    from ..units.workflow import new_state
    dev = resolve_device(device)
    params = params_from_jax(tree, workflow, device=dev)
    want = workflow.state_shapes() if workflow is not None else None
    state = _tensors(tree.get("state", {}), "state", dev, want)
    key = tree.get("key")
    key = None if key is None else np.asarray(key, np.uint32).reshape(2)
    step = int(np.asarray(tree.get("step", 0)))
    opt_state = optimizer.init(params) if optimizer is not None else {}
    return new_state(params, state, opt_state, step, key)


def params_to_numpy(params) -> dict:
    """``{unit: {param: ndarray}}`` (host copies) of the port's params
    (nested alike where a unit's params nest)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _to_numpy(t)
    return conv(params)


def wstate_from_snapshot(path: str, workflow, *, device=None) -> dict:
    """A serving workflow state from a snapshot of either package:
    parameters and unit state carried across (checked against
    ``workflow``), the optimizer state kept as host data."""
    ws = Snapshotter.load(path)["wstate"]
    out = wstate_from_jax(ws, workflow, device=device)
    out["opt_state"] = ws.get("opt_state", {})
    return out
