"""HDFS text loading over the WebHDFS REST gateway.

Reference parity: ``HDFSTextLoader`` (reference:
veles/loader/hdfs_loader.py:48) streamed chunks of text lines off HDFS via
the snakebite native-RPC client. That client (and a namenode to talk to)
isn't available here, so this redesign speaks **WebHDFS** — the standard
HTTP gateway every Hadoop distribution ships — with nothing but stdlib
urllib. The protocol is two-step: the namenode answers metadata ops
directly and redirects OPEN reads to a datanode with a 307
(urllib follows it transparently).

Capabilities kept from the reference unit:
* ``stat`` on initialize (logged, validates the path exists);
* streamed line iteration — the file is read in byte ranges, never fully
  resident;
* chunked output: ``read_chunks()`` yields lists of ``chunk_lines`` lines
  with a ``finished`` flag, exactly the reference's output contract.

``CsvLoader`` accepts ``webhdfs://host:port/path`` sources through this
client (see ext.py), closing the round-1 "HDFS loader absent" gap.

(The port's copy of veles_tpu/loader/hdfs.py, which holds no
JAX: the same batches from the same files, rewired to the port's
package.)
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Iterator, List, Optional

from ..logger import Logger
from .base import LoaderError


def _urlopen_retrying(url: str, timeout: float):
    """urlopen with bounded transient retry (connection errors and 5xx —
    a datanode mid-restart — back off and retry; 4xx like a missing path
    fail fast).  The loader-level ``_fetch_batch`` retry can't see these
    because this client wraps them into LoaderError for its callers.
    Retry shape is the shared ``deploy.http_retry`` (backoff + jitter),
    bounded by the LOADER knobs rather than the serving ones."""
    from ..config import root
    from ..runtime.deploy import http_retry
    return http_retry(
        lambda: urllib.request.urlopen(url, timeout=timeout),
        what=f"WebHDFS {url.split('?', 1)[0]}",
        retries=int(root.common.loader.get("retries", 2)),
        base_s=float(root.common.loader.get("retry_backoff_s", 0.05)))


class WebHdfsClient:
    """Minimal WebHDFS v1 client (GETFILESTATUS / LISTSTATUS / OPEN)."""

    def __init__(self, url: str, user: Optional[str] = None,
                 timeout: float = 30.0):
        # url: "http://namenode:9870" (or "webhdfs://namenode:9870")
        if url.startswith("webhdfs://"):
            url = "http://" + url[len("webhdfs://"):]
        self.base = url.rstrip("/")
        self.user = user
        self.timeout = timeout

    def _url(self, path: str, op: str, **params) -> str:
        if not path.startswith("/"):
            path = "/" + path
        q = {"op": op, **params}
        if self.user:
            q["user.name"] = self.user
        return (f"{self.base}/webhdfs/v1"
                f"{urllib.parse.quote(path)}?{urllib.parse.urlencode(q)}")

    def _get_json(self, url: str) -> dict:
        try:
            with _urlopen_retrying(url, self.timeout) as r:
                return json.load(r)
        except urllib.error.HTTPError as e:
            raise LoaderError(
                f"WebHDFS {e.code} for {url}: "
                f"{e.read(200)!r}") from e

    def stat(self, path: str) -> dict:
        return self._get_json(self._url(path, "GETFILESTATUS"))[
            "FileStatus"]

    def list(self, path: str) -> List[dict]:
        return self._get_json(self._url(path, "LISTSTATUS"))[
            "FileStatuses"]["FileStatus"]

    def open(self, path: str, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        params: Dict[str, int] = {}
        if offset:
            params["offset"] = offset
        if length is not None:
            params["length"] = length
        url = self._url(path, "OPEN", **params)
        try:
            # The namenode 307-redirects to a datanode; urllib follows.
            with _urlopen_retrying(url, self.timeout) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            raise LoaderError(
                f"WebHDFS OPEN failed ({e.code}) for {path}") from e

    def text(self, path: str, encoding: str = "utf-8",
             block: int = 1 << 20) -> Iterator[str]:
        """Stream decoded lines without holding the whole file."""
        size = int(self.stat(path)["length"])
        buf = b""
        offset = 0
        while offset < size:
            chunk = self.open(path, offset=offset,
                              length=min(block, size - offset))
            if not chunk:
                break
            offset += len(chunk)
            buf += chunk
            *lines, buf = buf.split(b"\n")
            for ln in lines:
                yield ln.decode(encoding)
        if buf:
            yield buf.decode(encoding)


class HdfsTextLoader(Logger):
    """Chunked HDFS text reader (the reference unit's contract: fill
    ``output`` with ``chunk_lines`` lines per run until ``finished``)."""

    def __init__(self, url: str, file: str, chunk_lines: int = 1000,
                 user: Optional[str] = None):
        self.client = WebHdfsClient(url, user=user)
        self.file = file
        self.chunk_lines = int(chunk_lines)
        self.finished = False
        self._gen: Optional[Iterator[str]] = None

    def initialize(self) -> None:
        st = self.client.stat(self.file)
        self.debug("opened %s (%d bytes)", self.file, st["length"])
        self._gen = self.client.text(self.file)
        self.finished = False

    def read_chunk(self) -> List[str]:
        """Next chunk of up to ``chunk_lines`` lines; sets ``finished``
        when the file is exhausted."""
        if self._gen is None:
            self.initialize()
        out: List[str] = []
        for _ in range(self.chunk_lines):
            try:
                out.append(next(self._gen))
            except StopIteration:
                self.finished = True
                break
        return out

    def read_chunks(self) -> Iterator[List[str]]:
        while not self.finished:
            chunk = self.read_chunk()
            if chunk:
                yield chunk
