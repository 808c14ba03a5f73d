"""Versioned package store backing the Forge server (a copy of
veles_tpu/forge/store.py, which holds no JAX, rewired to the port).

Reference parity: the reference ForgeServer kept packages in per-name git
repositories with manifest.json metadata and tag-per-version semantics
(reference: veles/forge/forge_server.py:462+, version discovery in
FetchHandler._discover_version :259-283). The rebuild keeps the observable
contract — names, monotonically addable versions, "master" = latest,
manifest metadata, tar.gz package bodies — on a plain directory tree::

    <root>/<name>/<version>/manifest.json + package files
    <root>/<name>/versions.json            (ordered version list)

which is trivially inspectable and needs no git dependency.

Payload-agnostic: an ``export_package()`` directory, a compiled
artifact (``export_compiled()`` — artifact.json + ``torch.export``
programs + tensors.npz), or any other file set uploads via :meth:`ForgeStore.
pack_dir` and serves back byte-identical; the deploy control plane's
``forge://<root>/<name>[@version]`` sources dispatch on the payload
(runtime/deploy.py: contents.json -> package, artifact.json ->
compiled artifact).
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import tarfile
import threading
import time
from typing import Dict, List, Optional

from ..logger import Logger


def _safe_extract_tar(tar: tarfile.TarFile, dest_dir: str) -> None:
    """Extract with tarfile's "data" filter: rejects absolute paths,
    ``..`` escapes and link members pointing outside the destination
    (veles_tpu/downloader.py:75-83)."""
    try:
        tar.extractall(dest_dir, filter="data")
    except tarfile.FilterError as e:
        raise IOError(f"unsafe archive member: {e}") from e

#: Manifest keys the reference required at upload (forge_server.py upload
#: validation; manifest fields used by the client at forge_client.py:161-182).
REQUIRED_MANIFEST_KEYS = ("name", "workflow", "configuration")
LATEST = "master"  # the reference's "master" version alias

# First char must be alphanumeric/underscore: rejects ".", "..", and other
# dot-only names that would resolve to the store root or its parent.
_NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]*$")


class Manifest(dict):
    """manifest.json contents; a dict with validation."""

    @classmethod
    def validate(cls, data: dict) -> "Manifest":
        for key in REQUIRED_MANIFEST_KEYS:
            if key not in data:
                raise ValueError(f"manifest misses required key {key!r}")
        if not _NAME_RE.match(str(data["name"])):
            raise ValueError(f"invalid package name {data['name']!r}")
        return cls(data)


class ForgeStore(Logger):
    """Thread-safe versioned package store on a directory tree."""

    def __init__(self, root_dir: str):
        self.root_dir = root_dir
        os.makedirs(root_dir, exist_ok=True)
        self._lock = threading.Lock()

    # -- queries -----------------------------------------------------------
    def list(self) -> List[dict]:
        """[{name, author, short_description, version, updated}] for every
        package (reference: ServiceHandler.handle_list,
        forge_server.py:127-138)."""
        out = []
        for name in sorted(os.listdir(self.root_dir)):
            versions = self._versions(name)
            if not versions:
                continue
            man = self.manifest(name, versions[-1])
            out.append({
                "name": name,
                "author": man.get("author", ""),
                "short_description": man.get("short_description", ""),
                "version": versions[-1],
                "versions": versions,
                "updated": man.get("_uploaded", ""),
            })
        return out

    def details(self, name: str) -> dict:
        """Full manifest of the latest version + version history (reference:
        ServiceHandler.handle_details, forge_server.py:123-126)."""
        versions = self._versions(name)
        if not versions:
            raise KeyError(f"no such package {name!r}")
        man = dict(self.manifest(name, versions[-1]))
        man["versions"] = versions
        return man

    def manifest(self, name: str, version: str) -> Manifest:
        path = os.path.join(self._vdir(name, version), "manifest.json")
        with open(path) as f:
            return Manifest(json.load(f))

    def version_dir(self, name: str,
                    version: Optional[str] = None) -> str:
        """Filesystem directory of a stored version (``version=None`` /
        ``"master"`` resolves to the latest) — the deploy control
        plane's load-by-version hook: an ``export_package()`` directory
        uploaded to the store serves straight from here via
        ``forge://<store_root>/<name>[@version]`` sources
        (runtime/deploy.py)."""
        return self._vdir(name, self.resolve_version(name, version))

    def resolve_version(self, name: str, version: Optional[str]) -> str:
        versions = self._versions(name)
        if not versions:
            raise KeyError(f"no such package {name!r}")
        if version in (None, "", LATEST):
            return versions[-1]
        if version not in versions:
            raise KeyError(f"{name!r} has no version {version!r} "
                           f"(has {versions})")
        return version

    # -- mutation ----------------------------------------------------------
    def add(self, tar_bytes: bytes) -> Manifest:
        """Ingest an uploaded package: a tar.gz whose root contains
        manifest.json (+ workflow/config/package files). Returns the stored
        manifest. Version comes from the manifest ("version" key, default
        autoincrement 1,2,3... as strings)."""
        with io.BytesIO(tar_bytes) as bio, \
                tarfile.open(fileobj=bio, mode="r:*") as tar:
            names = tar.getnames()
            if "manifest.json" not in names:
                raise ValueError("package tar misses manifest.json")
            man = Manifest.validate(json.load(
                tar.extractfile("manifest.json")))
            name = man["name"]
            with self._lock:
                versions = self._versions(name)
                version = str(man.get("version") or len(versions) + 1)
                if version in versions:
                    raise ValueError(
                        f"{name!r} already has version {version!r}")
                vdir = self._vdir(name, version)
                # Extract into a temp dir and rename into place: a rejected
                # upload must not leave partial files that a later upload of
                # the same version would silently serve.
                tmpdir = vdir + ".ingest"
                if os.path.exists(tmpdir):
                    shutil.rmtree(tmpdir)
                os.makedirs(tmpdir)
                try:
                    for member in tar.getmembers():
                        if not member.isfile():
                            continue
                        # thumbnail.svg is SERVER-derived: never accept
                        # an uploaded one (it would be served verbatim
                        # as image/svg+xml — stored-XSS vector when
                        # regeneration fails)
                        if os.path.basename(member.name) == \
                                self.THUMBNAIL:
                            continue
                        # refuse path escapes in hostile archives
                        target = os.path.realpath(
                            os.path.join(tmpdir, member.name))
                        if not target.startswith(
                                os.path.realpath(tmpdir) + os.sep):
                            raise ValueError(
                                f"unsafe member path {member.name!r}")
                        os.makedirs(os.path.dirname(target), exist_ok=True)
                        with tar.extractfile(member) as src, \
                                open(target, "wb") as dst:
                            shutil.copyfileobj(src, dst)
                    man["version"] = version
                    man["_uploaded"] = time.strftime("%Y-%m-%d %H:%M:%S")
                    with open(os.path.join(tmpdir, "manifest.json"),
                              "w") as f:
                        json.dump(man, f, indent=1)
                    # catalog thumbnail (reference: forge_server.py
                    # upload() rendered the workflow graph to
                    # thumbnail.png via PIL/graphviz; here a
                    # dependency-free SVG of the unit chain). Failure
                    # must never reject the upload.
                    try:
                        self._render_thumbnail(tmpdir, man)
                    except Exception as e:  # noqa: BLE001
                        self.warning("thumbnail generation failed for "
                                     "%s: %s", name, e)
                    # An unregistered vdir can exist if a previous process
                    # died between rename and _write_versions; it is orphan
                    # garbage (never listed/served), safe to replace.
                    if os.path.exists(vdir):
                        shutil.rmtree(vdir)
                    os.rename(tmpdir, vdir)
                except Exception:
                    shutil.rmtree(tmpdir, ignore_errors=True)
                    raise
                self._write_versions(name, versions + [version])
        self.info("stored %s==%s", name, version)
        return man

    def delete(self, name: str) -> None:
        """Remove a package entirely (reference: handle_delete,
        forge_server.py:139-152)."""
        path = os.path.join(self.root_dir, name)
        if not os.path.isdir(path):
            raise KeyError(f"no such package {name!r}")
        with self._lock:
            shutil.rmtree(path)
        self.info("deleted %s", name)

    THUMBNAIL = "thumbnail.svg"

    def thumbnail_path(self, name: str,
                       version: Optional[str] = None) -> str:
        """Path of a stored version's catalog thumbnail (KeyError if the
        package/version is unknown; the file may still be absent when
        generation failed — callers 404 on that)."""
        version = self.resolve_version(name, version)
        return os.path.join(self._vdir(name, version), self.THUMBNAIL)

    @classmethod
    def _render_thumbnail(cls, vdir: str, man: Dict) -> None:
        """Write thumbnail.svg: a unit-chain rendering of the package.

        The reference shelled out to `veles --workflow-graph` and PIL to
        produce a 256px PNG per upload (forge_server.py:690-725); the
        rebuild renders a plain SVG with zero dependencies.  Structure
        source, in order of preference: an exported serving package's
        contents.json (unit classes), else the manifest's workflow/
        configuration entries as a two-box summary.
        """
        labels = []
        cj = None
        for base, _, files in os.walk(vdir):
            if "contents.json" in files:
                cj = os.path.join(base, "contents.json")
                break
        if cj is not None:
            with open(cj) as f:
                doc = json.load(f)
            labels = [u.get("name") or u.get("class", "unit")
                      for u in doc.get("units", [])]
        if not labels:
            labels = [str(man.get("workflow", "workflow")),
                      str(man.get("configuration", "config"))]
        more = len(labels) - 10
        if more > 0:
            labels = labels[:9] + [f"... +{more + 1} more"]
        W, bh, gap, pad = 256, 22, 10, 8
        H = pad * 2 + len(labels) * bh + (len(labels) - 1) * gap
        from html import escape as esc
        parts = [f'<svg xmlns="http://www.w3.org/2000/svg" '
                 f'width="{W}" height="{H}" font-family="monospace" '
                 f'font-size="11">',
                 f'<rect width="{W}" height="{H}" fill="#fafafa"/>']
        for i, lab in enumerate(labels):
            y = pad + i * (bh + gap)
            parts.append(
                f'<rect x="28" y="{y}" width="200" height="{bh}" '
                f'rx="4" fill="#e8eef7" stroke="#4a6da7"/>')
            parts.append(
                f'<text x="{W // 2}" y="{y + bh - 7}" '
                f'text-anchor="middle">{esc(str(lab)[:28])}</text>')
            if i + 1 < len(labels):
                ay = y + bh
                parts.append(
                    f'<line x1="{W // 2}" y1="{ay}" x2="{W // 2}" '
                    f'y2="{ay + gap}" stroke="#4a6da7" '
                    f'marker-end="none"/>')
        parts.append("</svg>")
        with open(os.path.join(vdir, cls.THUMBNAIL), "w") as f:
            f.write("".join(parts))

    # -- package IO --------------------------------------------------------
    def pack(self, name: str, version: Optional[str] = None) -> bytes:
        """tar.gz of a stored version (what /fetch streams; reference:
        FetchHandler.get, forge_server.py:284-307)."""
        version = self.resolve_version(name, version)
        vdir = self._vdir(name, version)
        bio = io.BytesIO()
        with tarfile.open(fileobj=bio, mode="w:gz") as tar:
            for fname in sorted(os.listdir(vdir)):
                if fname == self.THUMBNAIL:
                    continue  # server-side derived, not package content
                tar.add(os.path.join(vdir, fname), arcname=fname)
        return bio.getvalue()

    @staticmethod
    def pack_dir(path: str, manifest: Dict) -> bytes:
        """Client-side: build an uploadable tar.gz from a directory plus a
        manifest dict (the reference built the tar from workflow + config +
        extra files listed in the manifest, forge_client.py:147-192)."""
        man = Manifest.validate(manifest)
        bio = io.BytesIO()
        with tarfile.open(fileobj=bio, mode="w:gz") as tar:
            mbytes = json.dumps(man, indent=1).encode()
            info = tarfile.TarInfo("manifest.json")
            info.size = len(mbytes)
            tar.addfile(info, io.BytesIO(mbytes))
            for dirpath, _, files in os.walk(path):
                for fname in sorted(files):
                    if fname == "manifest.json":
                        continue
                    full = os.path.join(dirpath, fname)
                    tar.add(full, arcname=os.path.relpath(full, path))
        return bio.getvalue()

    @staticmethod
    def unpack(tar_bytes: bytes, dest: str) -> str:
        os.makedirs(dest, exist_ok=True)
        with io.BytesIO(tar_bytes) as bio, \
                tarfile.open(fileobj=bio, mode="r:*") as tar:
            # "data" filter also rejects symlink members escaping dest —
            # the bytes come from a remote forge server and are untrusted.
            _safe_extract_tar(tar, dest)
        return dest

    # -- internals ---------------------------------------------------------
    def _vdir(self, name: str, version: str) -> str:
        if not _NAME_RE.match(name) or not _NAME_RE.match(version):
            raise ValueError(f"invalid name/version {name!r}/{version!r}")
        return os.path.join(self.root_dir, name, version)

    def _versions(self, name: str) -> List[str]:
        path = os.path.join(self.root_dir, name, "versions.json")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return json.load(f)

    def _write_versions(self, name: str, versions: List[str]) -> None:
        with open(os.path.join(self.root_dir, name, "versions.json"),
                  "w") as f:
            json.dump(versions, f)
