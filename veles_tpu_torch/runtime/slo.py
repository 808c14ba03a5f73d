"""Rolling SLO windows: is the service meeting its latency target NOW.

A copy of veles_tpu/runtime/slo.py (188 lines, no JAX), rewired to the
port's ``runtime/metrics.py``.

The since-boot histograms in the registry answer "what happened ever";
an operator (and `/ready`) needs "what happened over the last minute" —
a cumulative distribution hides a fresh regression behind hours of good
history.  This module keeps a :class:`~.metrics.HistogramWindow` ring
over the serving latency histograms (TTFT, queue wait) and serves
windowed p50/p95/p99 plus **burn rate** against configurable targets at
``GET /slo.json`` (docs/observability.md "Rolling SLO windows").

Burn rate is the standard error-budget consumption ratio: a target
"p99 TTFT <= X ms" grants a 1% budget of requests over X; burn =
(observed fraction over X in the window) / 1%.  Burn 1.0 = exactly on
target, 2.0 = burning budget twice as fast as granted.  With
``root.common.observe.slo.degrade_ready`` on, a window whose burn
reaches ``slo.burn_threshold`` flips ``GET /ready`` to 503 so a load
balancer sheds traffic *before* the tail melts — the window length IS
the "sustained" filter (one slow request cannot trip it; a minimum
sample count guards cold starts).

Everything here is host-side: windows snapshot registry histograms,
nothing runs inside a captured step.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..config import root
from .metrics import (HistogramWindow, fraction_over,
                      quantile_from_cumulative, registry)

#: slo key -> the registry histogram its window snapshots
_TRACKED = (
    ("ttft", "vt_request_ttft_seconds"),
    ("queue_wait", "vt_request_queue_wait_seconds"),
)

#: the percentile every target key refers to (p99 — the budget is 1%).
_TARGET_Q = 0.99

#: a window with fewer samples than this can never "burn": the first
#: request after boot must not 503 the whole server.
_MIN_COUNT = 10


class SloTracker:
    """Windowed latency views + burn-rate evaluation over the process
    registry.  ``clock`` / ``window_s`` / ``slices`` are injectable for
    deterministic tests; production uses :func:`slo_tracker` which reads
    ``root.common.observe.slo.*`` once at first use."""

    def __init__(self, *, window_s: Optional[float] = None,
                 slices: Optional[int] = None,
                 targets_ms: Optional[Dict[str, float]] = None,
                 burn_threshold: Optional[float] = None,
                 clock=time.monotonic):
        slo = root.common.observe.slo
        self.window_s = float(window_s if window_s is not None
                              else slo.get("window_s", 60.0))
        self.slices = int(slices if slices is not None
                          else slo.get("slices", 12))
        self.burn_threshold = float(
            burn_threshold if burn_threshold is not None
            else slo.get("burn_threshold", 2.0))
        if targets_ms is None:
            # literal reads: the VK3xx drift rule cross-references them
            # against the config.py declarations and the docs table
            targets_ms = {
                "ttft": slo.get("ttft_p99_ms", 0.0),
                "queue_wait": slo.get("queue_wait_p99_ms", 0.0),
            }
        self.targets_ms: Dict[str, float] = {
            key: float(targets_ms.get(key, 0.0) or 0.0)
            for key, _m in _TRACKED}
        reg = registry()
        self._g_burn = reg.gauge(
            "vt_slo_burn_rate",
            "error-budget burn rate over the rolling window, by slo "
            "(fraction of requests over the p99 target / the 1% budget; "
            "0 when no target is configured)", labels=("slo",))
        self.windows: Dict[str, HistogramWindow] = {
            key: HistogramWindow((lambda m=metric: reg.get(m)),
                                 self.window_s, self.slices, clock=clock)
            for key, metric in _TRACKED}

    def tick(self) -> None:
        """Rotate every window ring (cheap, idempotent) — called from
        the decode scheduler tick and any endpoint read.  When a slice
        actually rotated, the derived burn-rate gauges are recomputed
        too, so a bare ``/metrics`` scrape sees a live
        ``vt_slo_burn_rate`` without anything ever reading
        ``/slo.json``."""
        rotated = False
        for w in self.windows.values():
            rotated = w.tick() or rotated
        if rotated:
            for key, _metric in _TRACKED:
                self._one(key)          # sets the burn gauge per slo

    def _one(self, key: str) -> dict:
        w = self.windows[key]
        _hist, pairs, count, total = w.delta()
        out = {"count": int(count),
               "sum_seconds": round(float(total), 6)}
        for q in (0.5, 0.95, 0.99):
            out[f"p{int(q * 100)}_ms"] = round(
                1e3 * quantile_from_cumulative(pairs, q), 3)
        target_ms = self.targets_ms.get(key, 0.0)
        out["target_p99_ms"] = target_ms
        if target_ms > 0:
            frac = fraction_over(pairs, target_ms / 1e3)
            burn = frac / (1.0 - _TARGET_Q)
            out["frac_over_target"] = round(frac, 5)
            out["burn_rate"] = round(burn, 3)
            out["burning"] = (burn >= self.burn_threshold
                              and count >= _MIN_COUNT)
            self._g_burn.labels(slo=key).set(burn)
        else:
            out["frac_over_target"] = 0.0
            out["burn_rate"] = 0.0
            out["burning"] = False
            self._g_burn.labels(slo=key).set(0.0)
        return out

    def doc(self) -> dict:
        """The ``GET /slo.json`` body: windowed percentiles + burn per
        tracked latency, and whether /ready degradation would fire."""
        metrics = {key: self._one(key) for key, _m in _TRACKED}
        burning = any(m["burning"] for m in metrics.values())
        return {
            "window_s": self.window_s,
            "slices": self.slices,
            "burn_threshold": self.burn_threshold,
            "metrics": metrics,
            "burning": burning,
            "degrade_ready": bool(
                root.common.observe.slo.get("degrade_ready", False)),
        }

    def max_burn(self) -> float:
        """Worst burn rate across the tracked SLOs right now — the
        admission controller's sensor (runtime/admission.py).  A window
        with fewer than the minimum sample count contributes 0, for the
        same reason one slow request after boot must not 503 the server:
        it must not slam the admission window shut either."""
        worst = 0.0
        for key, _m in _TRACKED:
            m = self._one(key)
            if m["count"] >= _MIN_COUNT:
                worst = max(worst, m["burn_rate"])
        return worst

    def burning(self) -> bool:
        """Any tracked SLO at/over the burn threshold right now (with
        enough window samples to mean it)."""
        return any(self._one(key)["burning"] for key, _m in _TRACKED)

    def degrading(self) -> bool:
        """True when /ready should answer 503: degradation enabled AND
        a window is burning."""
        if not bool(root.common.observe.slo.get("degrade_ready", False)):
            return False
        return self.burning()


_TRACKER_LOCK = threading.Lock()
_TRACKER: Optional[SloTracker] = None  # guarded-by: _TRACKER_LOCK


def slo_tracker() -> SloTracker:
    """THE process SLO tracker (what ``GET /slo.json`` renders), built
    from ``root.common.observe.slo.*`` at first use."""
    global _TRACKER
    with _TRACKER_LOCK:
        if _TRACKER is None:
            _TRACKER = SloTracker()
        return _TRACKER


def reset_slo_tracker() -> None:
    """Drop the process tracker so the next :func:`slo_tracker` re-reads
    config — a test/config-reload hook, not a serving-path call."""
    global _TRACKER
    with _TRACKER_LOCK:
        _TRACKER = None
