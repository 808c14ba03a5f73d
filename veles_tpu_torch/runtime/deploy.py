"""Model lifecycle control plane: a versioned registry, hot weight swaps,
graceful drain and a snapshot watcher (the snapshot half of
veles_tpu/runtime/deploy.py).

* a **versioned model registry**: every weight set this process has
  served gets an entry (monotonic version id, source path, sha256 of the
  tensors blob, load time); ``GET /models`` renders it with the active
  version marked;
* **hot swaps**: new weights load from a snapshot of either package
  (``runtime/snapshotter.py``; a manifest file, the ``_current`` /
  ``_best`` symlinks, a directory whose newest manifest is taken, a
  ``sqlite://`` URI or an ``http(s)://`` manifest URL), an export
  package of either package (a ``contents.json`` directory or a
  ``.zip``), a compiled artifact (``artifact://DIR``, the prefix
  optional for a directory holding ``artifact.json``: its weights blob)
  or ``forge://<root>/<name>[@version]`` (a package or an artifact in a
  :class:`~..forge.store.ForgeStore`), each held to the served
  workflow's checksum,
  are checked against the served tree and cast to its dtypes, placed on
  the device through pinned memory while the old version keeps serving
  (:meth:`DecodeEngine.stage_params`), then copied into the served
  tensors at a dispatch boundary (:meth:`DecodeEngine.swap_params`).
  Same shapes and dtypes reuse the engine's captured steps: the
  StepCache counters stay flat.  A failure leaves the old version
  serving (the REST layer's 409).  ``stage`` / ``commit_staged`` /
  ``abort_staged`` split the two halves (``POST /admin/stage``,
  ``/admin/commit``, ``/admin/abort``);
* **graceful drain** (``POST /admin/drain`` and the SIGTERM handler):
  admissions stop, ``GET /ready`` answers 503, in-flight requests
  retire, the engine stops and :meth:`DeployController.wait` returns; a
  ``handoff`` URL first receives the engine's hottest prefix pages
  (``PUT /kv/pages``);
* an optional **snapshot watcher** polling a directory for newer
  snapshots (by ``saved_at``, deduplicated by the tensors checksum),
  retrying with exponential back-off, swapping on its own (``--model-dir
  --watch``).

:func:`http_retry` is the retry shape every HTTP fetch of a snapshot
shares.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import root
from ..logger import Logger
from ..ops.optimizers import tree_map
from . import faults
from .engine import EngineDraining, signature_mismatch
from .metrics import registry as metrics_registry
from .snapshotter import (Snapshotter, list_snapshots, sha256_files,
                          snapshot_checksum)
from .step_cache import tree_signature

#: Shared retry back-off (veles_tpu/runtime/deploy.py:55-66): the
#: watcher and the snapshot http loads grow their delay by
#: BACKOFF_FACTOR a consecutive failure and add up to BACKOFF_JITTER of
#: uniform spread; HTTP_RETRY_* bound a request-scale retry's delay.
BACKOFF_FACTOR = 2.0
BACKOFF_JITTER = 0.25
HTTP_RETRY_BASE_S = 0.25
HTTP_RETRY_MAX_S = 4.0


def http_retry(fn, *, what: str = "http request",
               retries: Optional[int] = None, log=None,
               base_s: float = HTTP_RETRY_BASE_S):
    """Call ``fn()``, retrying TRANSIENT failures (connection errors and
    HTTP 5xx) up to ``retries`` times (default
    ``root.common.net.http_retries``) with exponential back-off and
    jitter.  A 4xx re-raises at once: the client is wrong, not unlucky."""
    import random
    if retries is None:
        retries = int(root.common.net.get("http_retries", 3))
    attempt = 0
    while True:
        try:
            return fn()
        except urllib.error.HTTPError as e:
            if e.code < 500 or attempt >= retries:
                raise
            reason = f"HTTP {e.code}"
        except (urllib.error.URLError, ConnectionError, TimeoutError,
                OSError) as e:
            if attempt >= retries:
                raise
            reason = f"{type(e).__name__}: {e}"
        delay = min(base_s * BACKOFF_FACTOR ** attempt, HTTP_RETRY_MAX_S)
        delay *= 1.0 + random.random() * BACKOFF_JITTER
        if log is not None:
            log.warning("%s failed (%s); retry %d/%d in %.2fs", what,
                        reason, attempt + 1, retries, delay)
        time.sleep(delay)
        attempt += 1


def _shape_signature(tree) -> Tuple:
    """(path, shape) signature: a float32-trained snapshot casts to a
    bfloat16 template, but a shape mismatch is another architecture."""
    return tuple((p, s, "") for p, s, _ in tree_signature(tree))


def _host_like(saved, template) -> dict:
    """The numpy tree ``saved`` as host tensors of ``template``'s
    dtypes."""
    return tree_map(lambda t, x: torch.from_numpy(np.array(x, copy=True))
                    .to(t.dtype), template, saved)


def _place_like(saved, template):
    """The numpy tree ``saved`` as tensors of ``template``'s dtypes and
    devices, fully transferred (host data pinned, then copied on a side
    stream that is waited for): the staging of a server without an
    engine (an engine stages its own, into its served layout)."""
    side = None

    def place(x, t):
        nonlocal side
        if t.device.type != "cuda":
            return x.to(t.device)
        if side is None:
            side = torch.cuda.Stream(t.device)
        with torch.cuda.stream(side):
            return x.pin_memory().to(t.device, non_blocking=True)

    out = tree_map(place, _host_like(saved, template), template)
    if side is not None:
        side.synchronize()
    return out


def _manifest_saved_at(path) -> float:
    """``saved_at`` of a local snapshot manifest, 0.0 when unreadable:
    the watcher's newness anchor."""
    try:
        with open(str(path)) as f:
            return float(json.load(f).get("saved_at") or 0.0)
    except (OSError, TypeError, ValueError, json.JSONDecodeError):
        return 0.0


class ModelRegistry(Logger):
    """Versioned record of every weight set this process has served
    (metadata only: the weights live on the device, the active set at
    rest and a staged one during a swap).  Re-activating an older
    version reloads it from its source."""

    def __init__(self):
        self._entries: List[dict] = []  # guarded-by: self._lock
        self._lock = threading.Lock()
        self.active_version: Optional[int] = None  # guarded-by: self._lock

    def add(self, *, label: str, source: str, kind: str,
            checksum: str) -> dict:
        with self._lock:
            entry = {"version": len(self._entries) + 1,
                     "label": str(label), "source": str(source),
                     "kind": str(kind), "checksum": str(checksum),
                     "loaded_at": time.time()}
            self._entries.append(entry)
        return entry

    def get(self, version) -> dict:
        try:
            version = int(version)
        except (TypeError, ValueError):
            raise KeyError(f"version must be an integer, got {version!r}")
        with self._lock:
            for e in self._entries:
                if e["version"] == version:
                    return e
            have = [e["version"] for e in self._entries]
        raise KeyError(f"registry has no version {version} (has {have})")

    def activate(self, version: int) -> None:
        with self._lock:
            self.active_version = int(version)

    @property
    def active(self) -> Optional[dict]:
        with self._lock:
            version = self.active_version
        if version is None:
            return None
        return self.get(version)

    def to_doc(self) -> dict:
        """The ``GET /models`` document."""
        with self._lock:
            return {"active": self.active_version,
                    "versions": [dict(e, active=(e["version"]
                                                 == self.active_version))
                                 for e in self._entries]}


class DeployController(Logger):
    """The control plane around a live engine and/or REST server.

    ``DeployController(server=srv)`` sets ``srv.deploy``, so the server
    routes ``GET /models`` and ``POST /admin/*`` here; ``engine=``
    defaults to the server's engine.  A controller without a server
    drives a library-embedded engine; one without an engine swaps a
    plain predict server's ``wstate`` (a reference flip each request
    picks up).  ``boot_source``, when it is a snapshot manifest,
    registers version 1 as reloadable with its checksum."""

    def __init__(self, *, server=None, engine=None,
                 model_dir: Optional[str] = None, status=None,
                 drain_timeout_s: Optional[float] = None,
                 watch_interval_s: Optional[float] = None,
                 watch_backoff_max_s: Optional[float] = None,
                 boot_label: str = "boot", boot_source: str = "live"):
        if server is None and engine is None:
            raise ValueError(
                "DeployController needs a server and/or an engine")
        serve = root.common.serve
        self.server = server
        self.engine = engine if engine is not None \
            else getattr(server, "engine", None)
        self.status = status
        self.model_dir = model_dir or (serve.get("model_dir") or None)
        self.drain_timeout_s = float(
            drain_timeout_s if drain_timeout_s is not None
            else serve.get("drain_timeout_s", 30.0))
        self.drain_grace_s = float(serve.get("drain_grace_s", 2.0))
        self.watch_interval_s = float(
            watch_interval_s if watch_interval_s is not None
            else serve.get("watch_interval_s", 5.0))
        self.watch_backoff_max_s = float(
            watch_backoff_max_s if watch_backoff_max_s is not None
            else serve.get("watch_backoff_max_s", 300.0))

        self.registry = ModelRegistry()
        self._ck_lock = threading.Lock()
        self._ck_cache = None  # ((path, mtime), digest)  # guarded-by: self._ck_lock
        has_boot_src = boot_source not in (None, "", "live")
        boot_kind = "snapshot" if has_boot_src else "live"
        boot_checksum = ""
        # an artifact manifest's workflow checksum backs the foreign-
        # workflow guard where no engine or workflow can be asked (a
        # forward-only artifact server)
        self._boot_workflow_checksum: Optional[str] = None
        if has_boot_src:
            from .artifact import is_artifact_dir, read_manifest
            src = str(boot_source)
            art = src[len("artifact://"):] \
                if src.startswith("artifact://") else src
            if src.startswith("artifact://") and not is_artifact_dir(art):
                # an explicit artifact source never registers as an
                # empty-checksum snapshot
                raise ValueError(
                    f"{src}: not a compiled artifact (no manifest)")
            if is_artifact_dir(art):
                boot_kind = "artifact"
                bman = read_manifest(art)
                boot_checksum = bman.get("tensors_sha256", "")
                self._boot_workflow_checksum = bman.get(
                    "workflow_checksum")
            else:
                boot_checksum = self._snapshot_checksum(src)
        boot = self.registry.add(label=boot_label, source=boot_source,
                                 kind=boot_kind, checksum=boot_checksum)
        self.registry.activate(boot["version"])

        # re-entrant: _watch_once holds it across its check and reload()
        # takes it again; one reload-shaped operation at a time, held
        # across the load
        self._reload_lock = threading.RLock()
        # two-phase staging: (token, new wstate, staged params, meta)
        self._staged_swap = None
        self._stage_seq = 0
        self._draining = False
        self._stopped = threading.Event()
        self._drain_thread: Optional[threading.Thread] = None
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        # the watcher acts only on snapshots saved after the one it last
        # swapped in (or the boot snapshot)
        self._watch_floor = _manifest_saved_at(boot_source) \
            if has_boot_src else 0.0
        self.swaps = 0
        self.last_swap_ms: Optional[float] = None
        self.last_stage_ms: Optional[float] = None
        self.last_flip_ms: Optional[float] = None
        self.last_error: Optional[str] = None
        reg = metrics_registry()
        self._m_swaps = reg.counter(
            "vt_deploy_swaps_total",
            "hot weight swaps applied by the deploy control plane")
        self._m_reload_failures = reg.counter(
            "vt_deploy_reload_failures_total",
            "reloads rejected with the old version still serving (the "
            "HTTP 409 path)")
        self._g_last_swap_ms = reg.gauge(
            "vt_deploy_last_swap_ms", "latency of the last hot swap")
        self._g_active_version = reg.gauge(
            "vt_deploy_active_version", "registry version now serving")

        if server is not None:
            server.deploy = self
        self._report()

    # -- live state ---------------------------------------------------------
    def _live_wstate(self) -> dict:
        if self.engine is not None:
            return self.engine.wstate
        return self.server.wstate

    def _live_checksum(self) -> Optional[str]:
        """Topology checksum of the served workflow, when known (an
        artifact runner's, or the boot artifact's, from its manifest)."""
        wf = getattr(self.engine, "plan", None)
        wf = getattr(wf, "wf", None) or getattr(self.server, "workflow", None)
        if wf is not None:
            return wf.checksum()
        return (getattr(self.engine, "workflow_checksum", None)
                or self._boot_workflow_checksum)

    # -- source loading -----------------------------------------------------
    def _snapshot_checksum(self, path: str) -> str:
        """:func:`snapshot_checksum` memoized on (path, manifest mtime):
        the watcher checks a candidate's checksum and reload() hashes
        the same blob again."""
        try:
            key = (path, os.path.getmtime(path))
        except OSError:
            return snapshot_checksum(path)
        with self._ck_lock:
            if self._ck_cache is not None and self._ck_cache[0] == key:
                return self._ck_cache[1]
        digest = snapshot_checksum(path)
        with self._ck_lock:
            self._ck_cache = (key, digest)
        return digest

    def load_source(self, source: str) -> Tuple[dict, dict]:
        """A weight source as host trees and registry metadata:
        ``(parts, meta)``, ``parts`` holding numpy ``params`` (and
        ``state`` where saved), ``meta`` label, kind, checksum and
        source.  A snapshot manifest path (or its ``_current`` /
        ``_best`` symlink), a ``sqlite://`` or ``http(s)://`` snapshot URI
        (checksum unknown: ''), an export package directory or ``.zip``,
        a compiled artifact directory (``artifact://`` optional),
        ``forge://<root>/<name>[@version]``, or a snapshot directory
        whose newest manifest is taken (veles_tpu/runtime/deploy.py:
        381-455)."""
        if not source:
            raise ValueError(
                "reload needs a source (a snapshot manifest or directory, "
                "a package, an artifact or a forge:// URI) or a registry "
                "version")
        source = str(source)
        from .artifact import is_artifact_dir
        if source.startswith("artifact://"):
            return self._load_artifact(source[len("artifact://"):], source)
        if source.startswith("forge://"):
            path_part, _, ver = source[len("forge://"):].partition("@")
            store_root, _, name = path_part.rpartition("/")
            if not store_root or not name:
                raise ValueError(
                    f"bad forge source {source!r}; expected "
                    "forge://<store_root>/<name>[@version]")
            from ..forge.store import ForgeStore
            store = ForgeStore(store_root)
            # the registry pins the RESOLVED version: re-activating a
            # bare forge://root/name entry must reload the same weights
            resolved = store.resolve_version(name, ver or None)
            vdir = store.version_dir(name, resolved)
            uri = f"forge://{store_root}/{name}@{resolved}"
            if is_artifact_dir(vdir):
                return self._load_artifact(vdir, uri, kind="forge")
            return self._load_package(vdir, uri, kind="forge")
        if source.startswith(("sqlite://", "http://", "https://")):
            return self._from_snapshot(Snapshotter.load(source), source, "")
        if source.endswith(".zip"):
            return self._load_package(source, source)
        if os.path.isdir(source):
            if is_artifact_dir(source):
                return self._load_artifact(source, source)
            if os.path.isfile(os.path.join(source, "contents.json")):
                return self._load_package(source, source)
            snaps = list_snapshots(source)
            if not snaps:
                raise ValueError(
                    f"{source!r} holds no snapshot manifests and is not an "
                    "export package or a compiled artifact")
            source = snaps[-1]["path"]
        return self._from_snapshot(Snapshotter.load(source), source,
                                   self._snapshot_checksum(source))

    def _check_workflow(self, saved: Optional[str], source: str,
                        what: str) -> None:
        live = self._live_checksum()
        if saved and live and saved != live:
            verb = "taken" if what == "snapshot" else "exported"
            raise ValueError(
                f"{what} {source!r} was {verb} from a different workflow "
                f"(checksum {saved!r} != served {live!r}); refusing the "
                "swap, the old version keeps serving")

    def _load_artifact(self, path: str, source: str,
                       kind: str = "artifact") -> Tuple[dict, dict]:
        """A compiled artifact's weights blob as a weight source: a swap
        moves weights only (a live engine keeps its captured programs,
        an artifact runner its loaded ones).  Its integrity is the
        manifest's tensors sha256 (SnapshotCorruptError: the 409)."""
        from .artifact import load_artifact_weights, read_manifest
        man = read_manifest(path)
        self._check_workflow(man.get("workflow_checksum"), source,
                             "artifact")
        loaded = load_artifact_weights(path, man)
        parts = {"params": loaded["params"]}
        if loaded.get("state"):
            parts["state"] = loaded["state"]
        if not parts["params"]:
            raise ValueError(f"artifact {source!r} holds no params")
        label = man.get("workflow") \
            or os.path.basename(path.rstrip("/")) or path
        return parts, {"label": label, "kind": kind,
                       "checksum": man.get("tensors_sha256", ""),
                       "source": source}

    def _load_package(self, path: str, source: str,
                      kind: str = "package") -> Tuple[dict, dict]:
        """An export package (contents.json + npy, either package's) as a
        weight source, its tensors routed into params and state by the
        live tree (the export prefixed a name collision with
        ``state_``)."""
        from ..export.package import load_package
        contents = load_package(path)
        self._check_workflow(contents.get("checksum"), source, "package")
        template = self._live_wstate()
        tparams = template.get("params") or {}
        tstate = template.get("state") or {}
        params: Dict[str, dict] = {}
        state: Dict[str, dict] = {}
        for u in contents.get("units", ()):
            name = u["name"]
            for pname, arr in u.get("tensors", {}).items():
                if pname.startswith("state_") and \
                        pname[len("state_"):] in tstate.get(name, {}):
                    state.setdefault(name, {})[pname[len("state_"):]] = arr
                elif pname in tparams.get(name, {}):
                    params.setdefault(name, {})[pname] = arr
                elif pname in tstate.get(name, {}):
                    state.setdefault(name, {})[pname] = arr
                else:
                    # surfaces in the signature check with a clear path
                    params.setdefault(name, {})[pname] = arr
        if not params:
            raise ValueError(f"package {source!r} holds no unit weights")
        if path.endswith(".zip"):
            checksum = sha256_files([path])
        else:
            checksum = sha256_files(sorted(
                os.path.join(dp, fn)
                for dp, _, fns in os.walk(path) for fn in fns))
        parts = {"params": params}
        if state:
            parts["state"] = state
        label = (contents.get("workflow")
                 or os.path.basename(path.rstrip("/")) or path)
        return parts, {"label": label, "kind": kind,
                       "checksum": checksum, "source": source}

    def _from_snapshot(self, payload: dict, source: str,
                       checksum: str) -> Tuple[dict, dict]:
        self._check_workflow(payload.get("workflow_checksum"), source,
                             "snapshot")
        ws = payload.get("wstate") or {}
        parts = {k: ws[k] for k in ("params", "state") if ws.get(k)}
        if not parts.get("params"):
            raise ValueError(f"snapshot {source!r} holds no params")
        label = os.path.basename(source.rstrip("/")) or source
        return parts, {"label": label, "kind": "snapshot",
                       "checksum": checksum, "source": source}

    # -- staging + swap -----------------------------------------------------
    def _stage(self, parts: dict):
        """Check the loaded trees against the live ones and cast them to
        its dtypes: ``(new wstate, staged params or None)``.  With an
        engine the params go to :meth:`DecodeEngine.stage_params` as host
        tensors (its staged tree is the swap's one device copy); without
        one they are placed on the server's devices.  The old tree
        serves throughout.  ``params`` must match exactly; a ``state``
        tree that does not is kept live with a warning."""
        live = self._live_wstate()
        new = dict(live)
        for k in ("params", "state"):
            saved = parts.get(k)
            tmpl = live.get(k)
            if not saved or not tmpl:
                continue
            want, got = _shape_signature(tmpl), _shape_signature(saved)
            if want != got:
                diff = signature_mismatch(want, got)
                if k == "state":
                    self.warning("swap keeps the live 'state' tree (the "
                                 "loaded one does not match: %s)", diff)
                    continue
                raise ValueError(
                    "hot swap rejected: the loaded parameter tree does not "
                    "match the served model (same-architecture weights "
                    f"only): {diff}")
            new[k] = (_host_like(saved, tmpl)
                      if k == "params" and self.engine is not None
                      else _place_like(saved, tmpl))
        staged = (self.engine.stage_params(new["params"])
                  if self.engine is not None else None)
        return new, staged

    def _apply(self, new_wstate: dict, staged=None) -> None:
        """Flip the served tree: the engine's in place at a dispatch
        boundary (the server then serves the engine's tensors), or the
        server's reference for its next request."""
        if self.engine is not None:
            self.engine.swap_params(staged if staged is not None
                                    else new_wstate["params"])
            self.engine.wstate = new_wstate = dict(
                new_wstate, params=self.engine.params)
        if self.server is not None:
            self.server.wstate = new_wstate

    def _load_and_stage(self, source, version):
        """The load half of reload and stage: ``(new wstate, staged,
        meta)``; a failure is recorded and re-raised (KeyError from a
        malformed manifest as ValueError, the 409 path)."""
        if version is not None:
            entry = self.registry.get(version)
            if entry["kind"] == "live":
                raise ValueError(
                    f"version {entry['version']} is the boot state with no "
                    "reloadable source")
            source = entry["source"]
        try:
            parts, meta = self.load_source(source)
            new_wstate, staged = self._stage(parts)
        except KeyError as e:
            self._fail(f"KeyError: {e}")
            raise ValueError(
                f"malformed source {source!r}: missing key {e}") from e
        except Exception as e:
            self._fail(f"{type(e).__name__}: {e}")
            raise
        return new_wstate, staged, meta

    def _fail(self, msg: str):
        self.last_error = msg
        self._m_reload_failures.inc()
        self._report()

    def reload(self, source: Optional[str] = None, version=None) -> dict:
        """Load and hot-swap a snapshot (``POST /admin/reload``);
        ``version=`` re-activates a registry entry from its recorded
        source.  A load, staging or flip failure leaves the old version
        serving."""
        with self._reload_lock:
            if self.draining:
                raise EngineDraining("draining; not accepting reloads")
            t0 = time.monotonic()
            pre = self._compile_marker()
            new_wstate, staged, meta = self._load_and_stage(source, version)
            stage_s = time.monotonic() - t0
            if self.draining:
                # a drain that began while loading wins
                raise EngineDraining("draining; not accepting reloads")
            return self._flip_locked(new_wstate, staged, meta, t0, pre,
                                     stage_s)

    def _flip_locked(self, new_wstate, staged, meta, t0, pre,
                     stage_s) -> dict:
        """The flip half of a swap, shared by :meth:`reload` and
        :meth:`commit_staged` (callers hold ``_reload_lock``): apply,
        record the registry entry, publish the gauges.  The engine's
        flip is in place, so there is no previous tree to roll back to:
        a failure here is one before the flip (a scheduler that did not
        take it in time), and the old version keeps serving."""
        t_flip = time.monotonic()
        try:
            self._apply(new_wstate, staged)
        except Exception as e:
            self._fail(f"{type(e).__name__}: {e}")
            self.warning("swap not applied (%s); old version still "
                         "serving", self.last_error)
            raise
        now = time.monotonic()
        entry = self.registry.add(
            label=meta["label"], source=meta["source"],
            kind=meta["kind"], checksum=meta["checksum"])
        self.registry.activate(entry["version"])
        self.swaps += 1
        self._m_swaps.inc()
        self.last_swap_ms = round(1e3 * (now - t0), 3)
        self.last_stage_ms = round(1e3 * stage_s, 3)
        self.last_flip_ms = round(1e3 * (now - t_flip), 3)
        self._g_last_swap_ms.set(self.last_swap_ms)
        self.last_error = None
        post = self._compile_marker()
        recompiled = (post - pre) if None not in (pre, post) else 0
        if recompiled:
            self.warning("the compile counter moved across a swap (%d new "
                         "programs): shapes should have matched exactly",
                         recompiled)
        self.info("hot-swapped to version %d (%s) in %.1f ms (stage %.1f, "
                  "flip %.1f)", entry["version"], entry["label"],
                  self.last_swap_ms, self.last_stage_ms, self.last_flip_ms)
        if self.status is not None:
            try:
                self.status.record_event(
                    "swap", version=entry["version"],
                    label=entry["label"], swap_ms=self.last_swap_ms)
            except Exception:  # noqa: BLE001 — the swap landed; a status
                pass           # hiccup must not report failure
        self._report()
        return {"active": dict(entry, active=True),
                "in_flight_at_flip": (self.engine.last_swap_in_flight
                                      if self.engine is not None else None),
                "swap_ms": self.last_swap_ms,
                "stage_ms": self.last_stage_ms,
                "flip_ms": self.last_flip_ms,
                "compiles_during_swap": recompiled}

    # -- two-phase swap -----------------------------------------------------
    def stage(self, source: Optional[str] = None, version=None) -> dict:
        """Phase one (``POST /admin/stage``): load, check and place the
        new weights on the device without flipping; the old version
        keeps serving until :meth:`commit_staged`, or
        :meth:`abort_staged` withdraws them.  One staging at a time."""
        with self._reload_lock:
            if self.draining:
                raise EngineDraining("draining; not accepting swaps")
            if self._staged_swap is not None:
                raise ValueError(
                    f"swap {self._staged_swap[0]!r} is already staged; "
                    "commit or abort it before staging another")
            t0 = time.monotonic()
            new_wstate, staged, meta = self._load_and_stage(source, version)
            self._stage_seq += 1
            token = f"stage-{self._stage_seq}"
            self._staged_swap = (token, new_wstate, staged, meta,
                                 time.monotonic() - t0)
            return {"staged": token, "label": meta["label"],
                    "kind": meta["kind"], "checksum": meta["checksum"]}

    def commit_staged(self, token: str) -> dict:
        """Phase two (``POST /admin/commit``): flip the tree
        :meth:`stage` placed.  The token must match the pending staging;
        the staging is consumed either way."""
        with self._reload_lock:
            staged, self._staged_swap = self._staged_swap, None
            if staged is None or staged[0] != str(token):
                if staged is not None:
                    self._staged_swap = staged  # not ours: keep it
                raise ValueError(
                    f"no staged swap with token {token!r} (stage again "
                    "before committing)")
            if self.draining:
                raise EngineDraining("draining; not accepting swaps")
            _tok, new_wstate, tree, meta, stage_s = staged
            return self._flip_locked(new_wstate, tree, meta,
                                     time.monotonic(),
                                     self._compile_marker(), stage_s)

    def abort_staged(self, token: Optional[str] = None) -> dict:
        """Withdraw a pending staging (``POST /admin/abort``): the staged
        tree is dropped, the old version was never displaced.  Without a
        token, whatever is staged; aborting nothing is fine."""
        with self._reload_lock:
            staged = self._staged_swap
            if staged is not None and (token is None
                                       or staged[0] == str(token)):
                self._staged_swap = None
                return {"aborted": staged[0]}
            return {"aborted": None}

    @property
    def staged_token(self) -> Optional[str]:
        with self._reload_lock:
            return self._staged_swap[0] if self._staged_swap is not None \
                else None

    def _compile_marker(self) -> Optional[int]:
        if self.engine is not None:
            return int(self.engine.step_cache.compiles)
        return None

    # -- drain / shutdown ---------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._draining or (self.engine is not None
                                  and self.engine.draining)

    def begin_drain(self, handoff: Optional[str] = None) -> dict:
        """Asynchronous drain (``POST /admin/drain``): ``/ready`` turns
        503 at once, in-flight work retires on a background thread, then
        :meth:`wait` returns.  ``handoff`` names a successor's base URL
        that receives the engine's hottest prefix pages first."""
        self._draining = True
        if self._drain_thread is None or not self._drain_thread.is_alive():
            self._drain_thread = threading.Thread(
                target=self.drain, kwargs={"handoff": handoff},
                name="deploy-drain", daemon=True)
            self._drain_thread.start()
        return {"draining": True, "drain_timeout_s": self.drain_timeout_s,
                **({"handoff": handoff} if handoff else {})}

    def _handoff_pages(self, url: str) -> Optional[dict]:
        """Ship the engine's hottest prefix pages to ``url``'s ``PUT
        /kv/pages``.  Best effort: any failure (dense layout, an injected
        transfer fault, an unreachable or refusing successor) is logged
        and the drain goes on."""
        eng = self.engine
        if eng is None or not getattr(eng, "paged", False):
            return None
        kvt = root.common.serve.kv_transfer
        top = int(kvt.get("prewarm_pages", 64))
        if top <= 0:
            return None
        try:
            if faults.enabled():
                plan = faults.get_plan()
                if plan.kv_transfer_slow_ms:
                    time.sleep(plan.kv_transfer_slow_ms / 1e3)
                if plan.kv_transfer_drop \
                        and faults.fire_once("deploy_kv_handoff"):
                    raise OSError("fault: kv_transfer_drop")
            hashes = eng.hot_page_hashes(top)
            if not hashes:
                return None
            blob = eng.export_pages(hashes)
            req = urllib.request.Request(
                url.rstrip("/") + "/kv/pages", data=blob, method="PUT",
                headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(
                    req, timeout=float(kvt.get("timeout_s", 5.0))) as r:
                doc = json.loads(r.read())
            self.info("drain handoff: %d pages -> %s",
                      int(doc.get("imported", 0))
                      + int(doc.get("skipped", 0)), url)
            return doc
        except Exception as e:  # noqa: BLE001 — the drain proceeds
            self.warning("drain handoff to %s failed: %s", url, e)
        return None

    def drain(self, timeout: Optional[float] = None,
              handoff: Optional[str] = None) -> bool:
        """Graceful drain: stop admissions (503 on ``/ready``), stop the
        watcher, let in-flight work retire, stop the engine, release
        :meth:`wait`.  True when everything retired before the deadline.
        ``timeout=0`` skips the grace hold (Ctrl-C)."""
        self._draining = True
        if handoff:
            self._handoff_pages(handoff)
        self.stop_watcher()
        timeout = timeout if timeout is not None else self.drain_timeout_s
        t0 = time.monotonic()
        clean = True
        if self.engine is not None:
            clean = self.engine.drain(timeout)
        # hold /ready at 503 at least drain_grace_s, so load balancers
        # see the flip before the listener closes
        grace = min(float(timeout), self.drain_grace_s) \
            - (time.monotonic() - t0)
        if grace > 0:
            time.sleep(grace)
        try:
            if self.status is not None:
                self.status.record_event("drain", clean=clean)
            self._report()
        except Exception:  # noqa: BLE001 — wait() must never stay
            pass           # blocked with the engine down
        self.info("drained%s", "" if clean else " (dirty: a timeout or a "
                  "scheduler death; leftovers failed with EngineStopped)")
        self._stopped.set()
        return clean

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until drained (SIGTERM or ``/admin/drain``): the CLI's
        serve loop parks here."""
        return self._stopped.wait(timeout)

    def install_signal_handlers(self) -> bool:
        """SIGTERM -> graceful drain -> clean exit.  Only possible from
        the main thread; returns whether the handler was installed."""

        def _on_sigterm(signum, frame):  # noqa: ARG001
            self.info("SIGTERM: draining before exit")
            self.begin_drain()

        try:
            signal.signal(signal.SIGTERM, _on_sigterm)
            return True
        except ValueError:
            self.warning("not the main thread; SIGTERM handler not "
                         "installed")
            return False

    # -- snapshot watcher ---------------------------------------------------
    @property
    def watching(self) -> bool:
        return (self._watch_thread is not None
                and self._watch_thread.is_alive())

    def start_watcher(self):
        """Poll ``model_dir`` for a snapshot saved after the one the
        watcher last swapped in and swap automatically ("the newest
        snapshot in model_dir wins").  Failures (a snapshot mid-write, a
        rejected tree, an IO error) retry with exponential back-off up to
        ``watch_backoff_max_s``; a success resets the interval."""
        if self.model_dir is None:
            raise ValueError("the snapshot watcher needs a model_dir")
        if self.watching:
            return self
        self._watch_stop.clear()
        self._watch_thread = threading.Thread(
            target=self._watch_loop, name="snapshot-watcher", daemon=True)
        self._watch_thread.start()
        self.info("watching %s every %.1fs", self.model_dir,
                  self.watch_interval_s)
        return self

    def stop_watcher(self):
        self._watch_stop.set()
        t = self._watch_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10)
            if t.is_alive():
                # mid-reload: keep the reference so that a start_watcher
                # now spawns no second thread
                self.warning("watcher still mid-attempt; it exits after "
                             "the current reload")
                return
        self._watch_thread = None

    def _watch_loop(self):
        delay = self.watch_interval_s
        while not self._watch_stop.wait(delay):
            try:
                self._watch_once()
                delay = self.watch_interval_s
            except Exception as e:  # noqa: BLE001 — the watcher outlives
                # any one bad snapshot: back off, retry
                delay = min(max(delay, self.watch_interval_s)
                            * BACKOFF_FACTOR, self.watch_backoff_max_s)
                self.last_error = f"{type(e).__name__}: {e}"
                self.warning("snapshot watcher: %s (retrying in %.1fs)",
                             self.last_error, delay)
                self._report()

    def _watch_once(self):
        snaps = list_snapshots(self.model_dir)
        if not snaps:
            return
        newest = snaps[-1]
        if newest["saved_at"] <= self._watch_floor:
            return
        checksum = self._snapshot_checksum(newest["path"])
        # the dedup check and the swap as one step: a manual reload
        # between them must not make the watcher re-swap live weights
        with self._reload_lock:
            active = self.registry.active
            if active is not None and checksum \
                    and checksum == active.get("checksum"):
                self._watch_floor = newest["saved_at"]
                return
            self.info("watcher: newer snapshot %s", newest["path"])
            self.reload(newest["path"])  # raises -> back-off + retry
            self._watch_floor = newest["saved_at"]

    # -- observability ------------------------------------------------------
    def models_doc(self) -> dict:
        """The ``GET /models`` document: the registry and the control
        plane's state."""
        doc = self.registry.to_doc()
        doc.update(self._gauges())
        return doc

    def _gauges(self) -> dict:
        return {"swaps": self.swaps, "last_swap_ms": self.last_swap_ms,
                "last_stage_ms": self.last_stage_ms,
                "last_flip_ms": self.last_flip_ms,
                "draining": self.draining, "watching": self.watching,
                "model_dir": self.model_dir, "staged": self.staged_token,
                "last_error": self.last_error}

    def _report(self):
        active = self.registry.active or {}
        self._g_active_version.set(active.get("version") or 0)
        if self.status is None:
            return
        try:
            self.status.update(deploy={
                "active_version": active.get("version"),
                "active_label": active.get("label"),
                "versions": len(self.registry.to_doc()["versions"]),
                **self._gauges()})
        except Exception:  # noqa: BLE001 — status must never take the
            pass           # control plane down
