"""HTTP client for one fleet replica (a copy of
veles_tpu/runtime/fleet_client.py, which holds no JAX).

A replica is an ordinary serving stack — :class:`~.restful.RestfulServer`
over a :class:`~.engine.DecodeEngine`, with a
:class:`~.deploy.DeployController` attached — reached over plain HTTP.
The router never links against replica objects: everything it knows
about a replica flows through this client (scraped ``/engine`` stats,
``/metrics`` text, ``/ready``, dispatched ``/generate`` calls, the
two-phase ``/admin/stage`` -> ``/admin/commit`` swap protocol), which is
what makes in-process replicas and ``--join``ed remote processes
indistinguishable to the dispatch logic.

Connection-level failures raise :class:`ReplicaUnavailable`, the
router's ejection/failover signal.  HTTP error *statuses* are returned,
not raised: a 429 is backpressure to honor, a 503 a drain to route
around, and only the router knows which of those mean "try a survivor".
No retries happen here; the router owns failover.
"""

from __future__ import annotations

import http.client
import json
import urllib.error
import urllib.request
from typing import Optional, Tuple


class ReplicaUnavailable(RuntimeError):
    """The replica could not be reached at the transport level
    (connection refused/reset, DNS, timeout) — as opposed to an HTTP
    error status, which means the replica is alive and answering."""


class ReplicaClient:
    """Thin JSON-over-HTTP client bound to one replica base URL."""

    def __init__(self, base_url: str, *, timeout_s: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)

    def __repr__(self):
        return f"ReplicaClient({self.base_url})"

    # -- transport ----------------------------------------------------------
    def request(self, method: str, path: str, body: Optional[dict] = None,
                timeout: Optional[float] = None
                ) -> Tuple[int, dict, object]:
        """One HTTP exchange → ``(status, headers, parsed body)``.
        Bodies are parsed as JSON when they look like it, else returned
        as text (``/metrics``).  4xx/5xx come back as statuses with
        their parsed bodies; only transport failures raise."""
        data = None
        headers = {}
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(
            self.base_url + path, data=data, headers=headers,
            method=method)
        timeout = self.timeout_s if timeout is None else float(timeout)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, dict(r.headers), self._parse(r.read())
        except urllib.error.HTTPError as e:
            # the server ANSWERED: an error status is information, not
            # unavailability — read the body before the handle closes
            with e:
                return e.code, dict(e.headers), self._parse(e.read())
        except (urllib.error.URLError, ConnectionError, TimeoutError,
                OSError) as e:
            raise ReplicaUnavailable(
                f"{self.base_url}: {type(e).__name__}: {e}") from e

    @staticmethod
    def _parse(raw: bytes):
        text = raw.decode("utf-8", "replace")
        stripped = text.lstrip()
        if stripped.startswith(("{", "[")):
            try:
                return json.loads(text)
            except json.JSONDecodeError:
                pass
        return text

    # -- scrape surface ------------------------------------------------------
    def ready(self, timeout: Optional[float] = None) -> bool:
        """``GET /ready`` → True on 200 (draining / SLO-degraded
        replicas answer 503, which reads as ``False`` — deprioritized,
        not ejected)."""
        status, _h, _b = self.request("GET", "/ready", timeout=timeout)
        return status == 200

    def engine_stats(self, timeout: Optional[float] = None
                     ) -> Optional[dict]:
        """``GET /engine`` — the per-engine load/admission snapshot the
        dispatch score reads; None when the replica serves no engine."""
        status, _h, body = self.request("GET", "/engine",
                                        timeout=timeout)
        return body if status == 200 and isinstance(body, dict) else None

    def metrics_text(self, timeout: Optional[float] = None) -> str:
        """``GET /metrics`` Prometheus text — the raw material of the
        fleet-merged ``/slo.json`` histograms."""
        status, _h, body = self.request("GET", "/metrics",
                                        timeout=timeout)
        return body if status == 200 and isinstance(body, str) else ""

    def models_doc(self, timeout: Optional[float] = None
                   ) -> Optional[dict]:
        status, _h, body = self.request("GET", "/models",
                                        timeout=timeout)
        return body if status == 200 and isinstance(body, dict) else None

    def slo_doc(self, timeout: Optional[float] = None) -> Optional[dict]:
        status, _h, body = self.request("GET", "/slo.json",
                                        timeout=timeout)
        return body if status == 200 and isinstance(body, dict) else None

    # -- KV-page transfer (docs/serving.md "Disaggregated
    # prefill/decode"): the one raw-bytes path in the client — page
    # blobs are binary wire format, not JSON ---------------------------------
    def fetch_pages(self, hashes=None, top: Optional[int] = None,
                    timeout: Optional[float] = None
                    ) -> Tuple[int, bytes]:
        """``GET /kv/pages`` → ``(status, blob)``.  ``hashes`` is an
        iterable of page digests (raw bytes or hex — the query string
        carries hex); ``top=K`` instead fetches the replica's K hottest
        cached pages (the drain pre-warm set).  Non-200 answers return
        the status with an empty blob; transport failures raise
        :class:`ReplicaUnavailable` like every other call."""
        if top is not None:
            path = f"/kv/pages?top={int(top)}"
        else:
            hx = ",".join(h if isinstance(h, str) else bytes(h).hex()
                          for h in (hashes or []))
            path = f"/kv/pages?hashes={hx}"
        req = urllib.request.Request(self.base_url + path, method="GET")
        t = self.timeout_s if timeout is None else float(timeout)
        try:
            with urllib.request.urlopen(req, timeout=t) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            with e:
                e.read()
            return e.code, b""
        except (urllib.error.URLError, ConnectionError, TimeoutError,
                OSError) as e:
            raise ReplicaUnavailable(
                f"{self.base_url}: {type(e).__name__}: {e}") from e

    def put_pages(self, blob: bytes, timeout: Optional[float] = None
                  ) -> Tuple[int, object]:
        """``PUT /kv/pages`` → ``(status, doc)`` — ship a serialized
        page blob into the replica's prefix cache.  400 means the
        replica REJECTED the blob (geometry/weights-version/integrity);
        the caller falls back to local prefill, never errors the
        request."""
        req = urllib.request.Request(
            self.base_url + "/kv/pages", data=bytes(blob),
            headers={"Content-Type": "application/octet-stream"},
            method="PUT")
        t = self.timeout_s if timeout is None else float(timeout)
        try:
            with urllib.request.urlopen(req, timeout=t) as r:
                return r.status, self._parse(r.read())
        except urllib.error.HTTPError as e:
            with e:
                return e.code, self._parse(e.read())
        except (urllib.error.URLError, ConnectionError, TimeoutError,
                OSError) as e:
            raise ReplicaUnavailable(
                f"{self.base_url}: {type(e).__name__}: {e}") from e

    # -- dispatch ------------------------------------------------------------
    def generate(self, body: dict, timeout: Optional[float] = None
                 ) -> Tuple[int, object, float]:
        """Forward one ``POST /generate`` → ``(status, doc,
        retry_after_s)``.  ``retry_after_s`` is 0.0 unless the replica
        shed the request (429) — then it carries the replica's adaptive
        hint (the un-rounded body value when present, else the
        header)."""
        status, headers, doc = self.request("POST", "/generate", body,
                                            timeout=timeout)
        retry = 0.0
        if status == 429:
            if isinstance(doc, dict) and doc.get("retry_after_s"):
                retry = float(doc["retry_after_s"])
            else:
                try:
                    retry = float(headers.get("Retry-After", 1.0))
                except (TypeError, ValueError):
                    retry = 1.0
        return status, doc, retry

    def generate_stream(self, body: dict,
                        timeout: Optional[float] = None):
        """Forward one streaming ``POST /generate`` (``{"stream":
        true}`` body) → ``(status, frames_or_doc, retry_after_s)``.
        On 200, ``frames_or_doc`` is an ITERATOR of parsed NDJSON frame
        dicts — the connection stays open while the caller drains it,
        and a transport failure mid-stream raises
        :class:`ReplicaUnavailable` FROM THE ITERATOR (the router's
        resume-from-last-frame signal).  On any error status the
        connection is already drained and closed and ``frames_or_doc``
        is the parsed error body, matching :meth:`generate`'s shape."""
        data = json.dumps(body).encode()
        req = urllib.request.Request(
            self.base_url + "/generate", data=data,
            headers={"Content-Type": "application/json"},
            method="POST")
        t = self.timeout_s if timeout is None else float(timeout)
        try:
            resp = urllib.request.urlopen(req, timeout=t)
        except urllib.error.HTTPError as e:
            with e:
                doc = self._parse(e.read())
            retry = 0.0
            if e.code == 429:
                if isinstance(doc, dict) and doc.get("retry_after_s"):
                    retry = float(doc["retry_after_s"])
                else:
                    try:
                        retry = float(e.headers.get("Retry-After", 1.0))
                    except (TypeError, ValueError):
                        retry = 1.0
            return e.code, doc, retry

        except (urllib.error.URLError, ConnectionError, TimeoutError,
                OSError) as e:
            raise ReplicaUnavailable(
                f"{self.base_url}: {type(e).__name__}: {e}") from e

        def frames():
            try:
                with resp:
                    for raw in resp:
                        raw = raw.strip()
                        if not raw:
                            continue
                        try:
                            yield json.loads(raw)
                        except json.JSONDecodeError as e:
                            # a half-written line is a mid-stream cut,
                            # same failover signal as a dropped socket
                            raise ReplicaUnavailable(
                                f"{self.base_url}: truncated stream "
                                f"frame: {e}") from e
            except (ConnectionError, TimeoutError, OSError,
                    http.client.HTTPException) as e:
                raise ReplicaUnavailable(
                    f"{self.base_url}: {type(e).__name__}: {e}") from e

        return resp.status, frames(), 0.0

    # -- lifecycle ops (the coordinated-swap / drain fan-out) ---------------
    def stage(self, source: Optional[str] = None, version=None,
              timeout: Optional[float] = None) -> Tuple[int, object]:
        body = {}
        if source is not None:
            body["source"] = str(source)
        if version is not None:
            body["version"] = version
        status, _h, doc = self.request("POST", "/admin/stage", body,
                                       timeout=timeout)
        return status, doc

    def commit(self, token: str, timeout: Optional[float] = None
               ) -> Tuple[int, object]:
        status, _h, doc = self.request("POST", "/admin/commit",
                                       {"token": token}, timeout=timeout)
        return status, doc

    def abort(self, token: Optional[str] = None,
              timeout: Optional[float] = None) -> Tuple[int, object]:
        body = {} if token is None else {"token": token}
        status, _h, doc = self.request("POST", "/admin/abort", body,
                                       timeout=timeout)
        return status, doc

    def reload(self, source: Optional[str] = None, version=None,
               timeout: Optional[float] = None) -> Tuple[int, object]:
        body = {}
        if source is not None:
            body["source"] = str(source)
        if version is not None:
            body["version"] = version
        status, _h, doc = self.request("POST", "/admin/reload", body,
                                       timeout=timeout)
        return status, doc

    def drain(self, timeout: Optional[float] = None) -> Tuple[int, object]:
        status, _h, doc = self.request("POST", "/admin/drain", {},
                                       timeout=timeout)
        return status, doc
