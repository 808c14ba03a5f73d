"""On-demand device profiler capture: ``POST /debug/profile``
(counterpart of veles_tpu/runtime/profiler.py, with ``torch.profiler``
in place of ``jax.profiler``).

An operator triggers a duration-bounded trace of the running process,
its warm caches and live load intact:

* one capture at a time: a second ``POST`` while one runs answers
  **409** with the active capture's path (the profiler is process-wide;
  two concurrent captures would corrupt both traces);
* the duration is capped at ``root.common.observe.profile_max_s``;
* each capture lands under ``root.common.observe.profile_dir`` (default
  ``<cache_dir>/profiles``) in its own timestamped directory, exported
  as a Chrome trace (``trace.json``, Perfetto-loadable) with a kernel
  summary (``kernels.json``: device time and calls by kernel name).

The capture thread only sleeps while the profiler records: it never
touches a captured step, and the engine's replays go on on the
scheduler's thread (CUPTI sees the kernels inside a CUDA-graph replay).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Optional, Tuple

from ..config import root
from ..logger import Logger
from .metrics import registry

_CAPTURE_IDS = itertools.count(1)


class ProfilerBusy(RuntimeError):
    """A capture is already running (the HTTP 409 path)."""

    def __init__(self, path: str):
        super().__init__(
            f"a profiler capture is already running (writing {path}); "
            "retry when it finishes")
        self.path = path


class ProfilerCapture(Logger):
    """Single-flight ``torch.profiler`` capture controller (one a process,
    behind :func:`profiler`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active_path: Optional[str] = None  # guarded-by: self._lock
        self._last_path: Optional[str] = None    # guarded-by: self._lock
        self._n = 0                              # guarded-by: self._lock
        self._m_captures = registry().counter(
            "vt_profile_captures_total",
            "completed on-demand profiler captures (POST /debug/profile)")

    @property
    def active(self) -> bool:
        with self._lock:
            return self._active_path is not None

    @property
    def last_path(self) -> Optional[str]:
        """Directory of the most recent finished capture (the status
        page links it)."""
        with self._lock:
            return self._last_path

    def _capture_dir(self) -> str:
        base = str(root.common.observe.get("profile_dir", "") or "")
        if not base:
            base = os.path.join(str(root.common.cache_dir), "profiles")
        stamp = time.strftime("%Y%m%d-%H%M%S")
        return os.path.join(
            base, f"{stamp}-{os.getpid()}-{next(_CAPTURE_IDS):03d}")

    def capture(self, duration_s: float = 1.0) -> dict:
        """One duration-bounded trace; blocks for the duration and
        returns ``{path, duration_s, files, kernels}`` (``kernels``: the
        ten kernels of most device time).  Raises :class:`ProfilerBusy`
        when a capture is in flight."""
        cap = float(root.common.observe.get("profile_max_s", 30.0))
        dur = min(max(float(duration_s), 0.01), max(cap, 0.01))
        path = self._capture_dir()
        with self._lock:
            if self._active_path is not None:
                raise ProfilerBusy(self._active_path)
            self._active_path = path
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            os.makedirs(path, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.info("profiler capture -> %s (%.2fs)", path, dur)
            with profile(activities=acts) as prof:
                time.sleep(dur)
            prof.export_chrome_trace(os.path.join(path, "trace.json"))
            kernels = _kernel_summary(prof)
            with open(os.path.join(path, "kernels.json"), "w") as f:
                json.dump(kernels, f, indent=1)
            n_files = sum(len(fs) for _b, _d, fs in os.walk(path))
            with self._lock:
                self._last_path = path
                self._n += 1
            self._m_captures.inc()
            return {"path": path, "duration_s": dur, "files": n_files,
                    "kernels": kernels[:10]}
        finally:
            with self._lock:
                self._active_path = None

    def stats(self) -> dict:
        with self._lock:
            return {"active": self._active_path is not None,
                    "captures": self._n, "last_path": self._last_path}


def _kernel_summary(prof) -> list:
    """``[{name, device_ms, calls}]`` of every device kernel in the
    capture, most device time first."""
    out = []
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        t = (getattr(evt, "self_device_time_total", None)
             or getattr(evt, "self_cuda_time_total", 0) or 0)
        out.append({"name": evt.key, "device_ms": t / 1e3,
                    "calls": int(evt.count)})
    return sorted(out, key=lambda k: -k["device_ms"])


def serve_profile_post(headers, rfile) -> Tuple[int, dict]:
    """The HTTP half of ``POST /debug/profile`` both servers route to:
    the body cap (413 before any read; a negative Content-Length
    clamped), the JSON body, the capture, and the 409/400/500 mapping.
    Returns ``(status, json body)``."""
    try:
        n = max(int(headers.get("Content-Length", 0) or 0), 0)
        cap = int(float(root.common.serve.get("max_body_mb", 64))
                  * 2 ** 20)
        if n > cap:
            return 413, {"error": f"request body {n} bytes exceeds "
                                  f"the {cap} byte cap "
                                  "(root.common.serve.max_body_mb)"}
        req = json.loads(rfile.read(n)) if n else {}
        if not isinstance(req, dict):
            raise ValueError("the body must be a JSON object")
        # no client-chosen output path: captures stay under profile_dir
        return 200, profiler().capture(
            duration_s=float(req.get("duration_s", 1.0)))
    except ProfilerBusy as e:
        return 409, {"error": str(e), "active": e.path}
    except (TypeError, ValueError) as e:
        return 400, {"error": str(e)}
    except Exception as e:  # noqa: BLE001 — a failed capture answers
        return 500, {"error": f"{type(e).__name__}: {e}"}


_PROFILER_LOCK = threading.Lock()
_PROFILER: Optional[ProfilerCapture] = None  # guarded-by: _PROFILER_LOCK


def profiler() -> ProfilerCapture:
    """The process capture controller (what ``POST /debug/profile``
    runs)."""
    global _PROFILER
    with _PROFILER_LOCK:
        if _PROFILER is None:
            _PROFILER = ProfilerCapture()
        return _PROFILER
