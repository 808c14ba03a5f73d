"""Status reporting: a status file and a small HTTP endpoint with live
plots (counterpart of veles_tpu/runtime/status.py, which holds no JAX).

A :class:`StatusReporter` writes status.json atomically (any dashboard
can poll it), and an optional :class:`StatusServer` thread serves it
over stdlib HTTP with a minimal HTML view.  Nested gauge groups render
as dotted rows, so the decode engine's stats (``engine.pages.free``,
``engine.swaps``, ...) and the deploy control plane's
(``deploy.active_version``, ...) land on the page with no schema here.
With a ``plots_dir`` the page also embeds every PNG in it, with an mtime
cache-buster under the 2-second meta refresh.  The server also answers
``/metrics``, ``/slo.json``, ``/memory.json``, ``/trace.json`` and
``POST /debug/profile``."""

from __future__ import annotations

import collections
import html
import http.server
import json
import os
import threading
import time
import urllib.parse
from typing import Optional

from ..config import root
from ..logger import Logger
from .memory import memory_monitor
from .metrics import registry, span_ring
from .profiler import profiler, serve_profile_post
from .slo import slo_tracker


class StatusReporter(Logger):
    """Atomically maintained status.json (reference: the per-master status
    document).

    Event flushes COALESCE: ``record_event`` bursts (a retire storm at
    a deadline sweep, a watcher flapping) rewrite status.json at most
    once per ``flush_interval_s`` (default ``root.common.observe
    .status_flush_s``) instead of fsync-storming the disk — a deferred
    burst is always flushed by a trailing timer, so the final state
    lands within one interval.  Direct ``update()`` calls still write
    through immediately (their callers are already epoch/0.5s-cadence
    throttled)."""

    def __init__(self, path: str = "status.json", name: str = "workflow",
                 plots_dir: Optional[str] = None,
                 graph_svg: Optional[str] = None,
                 events_max: int = 20,
                 flush_interval_s: Optional[float] = None):
        self.path = path
        self.name = name
        self.plots_dir = plots_dir
        # a rendered workflow-graph SVG the status page embeds
        self.graph_svg = graph_svg
        self.started = time.time()
        self.flush_interval_s = float(
            root.common.observe.get("status_flush_s", 0.25)
            if flush_interval_s is None else flush_interval_s)
        # one reporter, many writers (engine scheduler, deploy control
        # plane, trainer): _lock serializes the read-modify-write on
        # _extra / _events and stays IO-free, so the scheduler tick never
        # stalls behind a slow disk; the file write serializes on
        # _io_lock, which guards no data and only orders the replaces
        self._extra = {}  # guarded-by: self._lock
        self._events = collections.deque(maxlen=max(1, int(events_max)))  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._last_flush = 0.0  # guarded-by: self._lock
        self._flush_timer: Optional[threading.Timer] = None  # guarded-by: self._lock
        self._doc_seq = 0  # guarded-by: self._lock
        self._io_lock = threading.Lock()
        self._written_seq = 0   # newest doc seq on disk (under _io_lock)
        reg = registry()
        self._m_flushes = reg.counter(
            "vt_status_flushes_total", "status.json writes")
        self._m_coalesced = reg.counter(
            "vt_status_flushes_coalesced_total",
            "event flushes deferred into the trailing coalescing timer "
            "(root.common.observe.status_flush_s)")

    def plot_files(self):
        """Sorted (name, mtime) of the PNGs currently in plots_dir."""
        if not self.plots_dir or not os.path.isdir(self.plots_dir):
            return []
        out = []
        for fn in sorted(os.listdir(self.plots_dir)):
            if fn.endswith(".png"):
                try:
                    mt = os.path.getmtime(os.path.join(self.plots_dir, fn))
                except OSError:
                    continue
                out.append((fn, mt))
        return out

    def record_event(self, kind: str, **info) -> None:
        """Append to the bounded event log shipped inside status.json
        (``events`` key, newest last): discrete lifecycle moments — a
        weight swap, a drain, a watcher failure — that a sampled gauge
        can't show (the deploy control plane's swap and version history,
        runtime/deploy.py).  Writes coalesce (class docstring); events
        also land as instants on the ``/trace.json`` timeline."""
        at = time.monotonic()
        with self._lock:
            # under the same lock update() iterates the deque with —
            # an un-locked append can blow up that iteration
            self._events.append(
                {"kind": str(kind), "time": round(time.time(), 3), **info})
            stamped = self._flush_locked(coalesce=True)
        self._write_doc(stamped)
        span_ring().add_instant(str(kind), at, cat="status", args=info)

    def update(self, **fields) -> None:
        with self._lock:
            self._extra.update(fields)
            stamped = self._flush_locked(coalesce=False)
        self._write_doc(stamped)

    def _flush_locked(self, *, coalesce: bool):  # requires-lock: self._lock
        """Decide defer-vs-flush and snapshot the document under the
        lock; the caller performs the file write AFTER releasing it.
        Returns ``(doc, seq)`` to write, or None when deferred."""
        now = time.monotonic()
        if coalesce and now - self._last_flush < self.flush_interval_s:
            self._m_coalesced.inc()
            if self._flush_timer is None:
                # trailing flush: the burst's FINAL state always lands
                # within one interval of its last event
                delay = self._last_flush + self.flush_interval_s - now
                t = threading.Timer(max(delay, 0.005), self._timer_flush)
                t.daemon = True
                self._flush_timer = t
                t.start()
            return None
        return self._doc_locked(now)

    def _timer_flush(self) -> None:
        with self._lock:
            self._flush_timer = None
            stamped = self._doc_locked(time.monotonic())
        self._write_doc(stamped)

    def _doc_locked(self, now: float):  # requires-lock: self._lock
        """Snapshot the status document + a monotonic sequence stamp
        (the write-ordering token _write_doc checks)."""
        self._last_flush = now
        if self._flush_timer is not None:
            # a direct write supersedes the pending trailing flush
            self._flush_timer.cancel()
            self._flush_timer = None
        doc = {
            "name": self.name,
            "time": time.time(),
            "uptime_s": round(time.time() - self.started, 1),
            **self._extra,
        }
        if self._events:
            doc["events"] = list(self._events)
        self._doc_seq += 1
        return doc, self._doc_seq

    def _write_doc(self, stamped) -> None:
        """Write a snapshot taken under ``_lock`` — OUTSIDE it, so no
        reader/writer of ``_extra``/``_events`` ever stalls behind the
        disk.  ``_io_lock`` orders concurrent writers; the sequence
        stamp drops a write that lost the race to a newer snapshot
        (the file must only ever move forward)."""
        if stamped is None:
            return
        doc, seq = stamped
        with self._io_lock:
            if seq <= self._written_seq:
                return          # a newer snapshot already landed
            self._written_seq = seq
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, default=repr)
            os.replace(tmp, self.path)
        self._m_flushes.inc()

    def read(self) -> dict:
        with open(self.path) as f:
            return json.load(f)


_HTML = """<!doctype html><meta http-equiv="refresh" content="2">
<title>veles_tpu_torch status</title>
<style>body{font-family:monospace;margin:2em}td{padding:2px 12px}</style>
<h2>veles_tpu_torch — %s</h2>
<p>%s</p>
<table>%s</table>"""

#: the observability endpoints linked from the status page header
_LINKS = ("/status.json", "/metrics", "/trace.json", "/slo.json",
          "/memory.json")


def _header_links() -> str:
    links = " · ".join(
        f'<a href="{p}">{p.lstrip("/")}</a>' for p in _LINKS)
    last = profiler().last_path
    if last:
        links += (" · last profile: "
                  f"<code>{html.escape(str(last))}</code>")
    return links


class _Handler(http.server.BaseHTTPRequestHandler):
    reporter: Optional[StatusReporter] = None

    def _reply(self, body: bytes, code: int = 200,
               ctype: str = "application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200, default=None):
        self._reply(json.dumps(obj, default=default).encode(), code)

    def do_GET(self):
        if self.path.split("?", 1)[0] == "/metrics":
            # Prometheus text exposition of the process registry
            self._reply(
                registry().render().encode(),
                ctype="text/plain; version=0.0.4; charset=utf-8")
            return
        if self.path.split("?", 1)[0] == "/slo.json":
            # rolling-window latency percentiles + SLO burn rates
            # (runtime/slo.py; the read also rotates the ring)
            self._json(slo_tracker().doc())
            return
        if self.path.split("?", 1)[0] == "/memory.json":
            # device truth + the shape-derived component ledger
            self._json(memory_monitor().doc())
            return
        if self.path.split("?", 1)[0] == "/trace.json":
            # Chrome-trace / Perfetto timeline of the span ring
            self._json(span_ring().chrome_trace(), default=repr)
            return
        if self.path.split("?", 1)[0] == "/graph.svg":
            svg = self.reporter.graph_svg if self.reporter else None
            if not svg or not os.path.isfile(svg):
                self.send_response(404)
                self.end_headers()
                return
            with open(svg, "rb") as f:
                body = f.read()
            self.send_response(200)
            self.send_header("Content-Type", "image/svg+xml")
            self.send_header("Cache-Control", "no-store")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path.startswith("/plots/"):
            # serve a PNG from plots_dir; unquote FIRST, then basename-
            # only lookup, so a crafted (or %2F-encoded) path can never
            # escape the directory
            fn = os.path.basename(
                urllib.parse.unquote(self.path.split("?", 1)[0]))
            root = self.reporter.plots_dir if self.reporter else None
            full = os.path.join(root, fn) if root else None
            if not fn.endswith(".png") or not full \
                    or not os.path.isfile(full):
                self.send_response(404)
                self.end_headers()
                return
            with open(full, "rb") as f:
                body = f.read()
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Cache-Control", "no-store")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        try:
            doc = self.reporter.read() if self.reporter else {}
        except (OSError, json.JSONDecodeError):
            doc = {}
        if self.path.startswith("/status"):
            body = json.dumps(doc).encode()
            ctype = "application/json"
        else:
            def flat(d, prefix=""):
                # nested gauge groups (e.g. the decode engine's) render
                # as dotted rows instead of one opaque repr cell
                for k, v in sorted(d.items()):
                    key = f"{prefix}{k}"
                    if isinstance(v, dict):
                        yield from flat(v, key + ".")
                    else:
                        yield key, v

            # html.escape EVERY interpolated key/value: a metric value
            # whose repr carries < or & (an error string, a path, a
            # label) must render as text, never as markup
            rows = "".join(
                f"<tr><td>{html.escape(str(k))}</td>"
                f"<td>{html.escape(str(v))}</td></tr>"
                for k, v in flat(doc))
            plots = self.reporter.plot_files() if self.reporter else []
            # mtime cache-buster: the 2s meta refresh re-requests each
            # image only as it actually changes.  Filenames are URL-
            # quoted for the path and HTML-escaped for the attribute —
            # a quote or angle bracket in a plot name must not break
            # out of the src attribute
            imgs = "".join(
                '<p><img src="/plots/'
                f'{html.escape(urllib.parse.quote(fn))}?t={int(mt)}" '
                'style="max-width:95%"></p>' for fn, mt in plots)
            graph = ""
            if self.reporter and self.reporter.graph_svg \
                    and os.path.isfile(self.reporter.graph_svg):
                graph = ('<h3>workflow graph</h3>'
                         '<p><img src="/graph.svg" '
                         'style="max-width:95%"></p>')
            body = (_HTML % (html.escape(str(doc.get("name", "?"))),
                             _header_links(), rows)
                    + graph + imgs).encode()
            ctype = "text/html"
        self._reply(body, ctype=ctype)

    def do_POST(self):
        if self.path.split("?", 1)[0] != "/debug/profile":
            self.send_error(404)
            return
        # shared handler (runtime/profiler.py): ingress cap, capture,
        # 409/400/500 mapping, one implementation for both servers
        code, obj = serve_profile_post(self.headers, self.rfile)
        self._json(obj, code=code)

    def log_message(self, *args):  # silence request logging
        pass


class StatusServer(Logger):
    """Background HTTP server for the status file."""

    def __init__(self, reporter: StatusReporter, port: int = 0,
                 host: str = "127.0.0.1"):
        handler = type("BoundHandler", (_Handler,), {"reporter": reporter})
        self.httpd = http.server.ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        self.info("status server on http://127.0.0.1:%d", self.port)
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
