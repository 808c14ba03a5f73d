"""Logging mixin + event tracing.

A copy of ``veles_tpu/logger.py`` kept inside the PyTorch port (the port
imports nothing of the JAX package).  The one change: :class:`TraceContext`
annotates ``torch.profiler`` traces where the JAX package annotated
``jax.profiler`` ones.

Original design notes (reference: veles/logger.py:59 — mixin with colored
console, file duplication, ``event()`` distributed-trace API :264-289):
  * MongoDB sink is dropped; the ``event()`` timeline is written as JSON-lines
    to a local file (set ``root.common.trace_file``) so it stays greppable.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from typing import Optional

from .config import root

_COLORS = {
    logging.DEBUG: "\033[37m",
    logging.INFO: "\033[92m",
    logging.WARNING: "\033[93m",
    logging.ERROR: "\033[91m",
    logging.CRITICAL: "\033[1;91m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelno, "")
            return f"{color}{msg}{_RESET}"
        return msg


_configured = False
_configure_lock = threading.Lock()


def setup_logging(level=logging.INFO, logfile: Optional[str] = None):
    """Configure the root logger once; colored console + optional file copy
    (reference: veles/logger.py:187 redirect_all_logging_to_file)."""
    global _configured
    with _configure_lock:
        rootlog = logging.getLogger()
        if not _configured:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(_ColorFormatter(
                "%(asctime)s %(levelname).1s %(name)s: %(message)s",
                datefmt="%H:%M:%S"))
            rootlog.addHandler(handler)
            _configured = True
        rootlog.setLevel(level)
        if logfile:
            fh = logging.FileHandler(logfile)
            fh.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname).1s %(name)s: %(message)s"))
            rootlog.addHandler(fh)


class EventTracer:
    """Append-only JSONL event timeline (reference: Logger.event(),
    veles/logger.py:264-289).  The sink is a file; the schema keeps
    name/kind/timestamp/attrs."""

    def __init__(self, path: str = ""):
        self._path = path
        self._lock = threading.Lock()
        self._fh = None

    def _ensure(self):
        path = self._path or root.common.value("trace_file", "")
        if not path:
            return None
        if self._fh is None or self._path != path:
            self._path = path
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        return self._fh

    def emit(self, name: str, kind: str = "single", **attrs):
        with self._lock:
            fh = self._ensure()
            if fh is None:
                return
            rec = {"ts": time.time(), "name": name, "kind": kind}
            rec.update(attrs)
            fh.write(json.dumps(rec, default=repr) + "\n")

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


_tracer = EventTracer()


class Logger:
    """Mixin granting ``self.logger`` + ``info/debug/warning/error`` and the
    ``event()`` trace API (reference: veles/logger.py:59,264)."""

    @property
    def logger(self) -> logging.Logger:
        lg = getattr(self, "_logger_", None)
        if lg is None:
            lg = logging.getLogger(type(self).__name__)
            self._logger_ = lg
        return lg

    def debug(self, msg, *args):
        self.logger.debug(msg, *args)

    def info(self, msg, *args):
        self.logger.info(msg, *args)

    def warning(self, msg, *args):
        self.logger.warning(msg, *args)

    def error(self, msg, *args):
        self.logger.error(msg, *args)

    def exception(self, msg, *args):
        self.logger.exception(msg, *args)

    def event(self, name: str, kind: str = "single", **attrs):
        """Emit a timeline event: kind in {"begin", "end", "single"}."""
        _tracer.emit(name, kind, unit=type(self).__name__, **attrs)


class TraceContext:
    """``with TraceContext("decode_step"):`` — emits begin/end events and,
    when ``step`` is given, a ``torch.profiler.record_function`` range so
    the step shows up by name in a profiler trace."""

    def __init__(self, name: str, step: Optional[int] = None, **attrs):
        self.name = name
        self.step = step
        self.attrs = attrs
        self._prof_ctx = None

    def __enter__(self):
        _tracer.emit(self.name, "begin", **self.attrs)
        if self.step is not None:
            import torch.profiler
            self._prof_ctx = torch.profiler.record_function(
                f"{self.name}#{self.step}")
            self._prof_ctx.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._prof_ctx is not None:
            self._prof_ctx.__exit__(*exc)
        _tracer.emit(self.name, "end", seconds=dt, **self.attrs)
        return False
